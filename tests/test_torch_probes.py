"""The port's card probes against the JAX package's probe kernels.

``benchmarks/bw_probe.py`` keeps its three Pallas kernels as closures inside
``main()`` and ``benchmarks/tap_probe.py`` runs its whole benchmark when it
is imported, so neither file is imported here: the kernel bodies, the
jitted ``pallas_call`` functions around them and the constants are taken
out of their source with ``ast`` and run unchanged, at small shapes, with a
``pl`` whose ``pallas_call`` adds ``interpret=True``. The port's side is the
plain versions of ``ops/kernels/probes.py`` (what the wrappers run on the
CPU). The same numpy inputs go into both.
"""

import ast
import functools
import io
import json
import os
import subprocess
import sys
import types
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sift_scale_space_extrema_detection_tpu_torch.benchmarks import (
    ba_bench,
    bench,
    bw_probe,
    descriptor_bench,
    frontend_bench,
    multihost_bench,
    scaling_bench,
    scatter_probe,
    slam_bench,
    tap_probe,
)
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import (
    launch_counts,
    launches_since,
    probes,
)

REPO = Path(__file__).resolve().parents[1]
BW_SOURCE = REPO / "benchmarks" / "bw_probe.py"
TAP_SOURCE = REPO / "benchmarks" / "tap_probe.py"

# float32's unit roundoff: a sum of n terms in any order lies within
# (n - 1)·u·Σ|x| of the exact sum, so two orders within twice that.
U32 = 2.0**-24

# The bf16 modes against the original on the CPU. Both sides round the data
# and the taps to bf16, but XLA:CPU keeps a bf16 product exact where it is
# converted to float32 (excess precision inside a jitted bf16 chain), while
# the port rounds every bf16 product and sum, as the source asks. A bf16
# rounding moves a value by at most 2^-8 of it (8 significant bits), so an
# element differs by at most 2^-8·S with S = Σ|x_t·tap_t| over its 832
# products (bf16_carry; bf16_full, where both sides round each sum), and
# 2^-7·S where the pair sums are rounded too (bf16_pair); plus the float32
# sums' own rounding on either side, 831·2^-24·S each.
BF16_BOUND = {"bf16_carry": 2.0**-8, "bf16_full": 2.0**-8, "bf16_pair": 2.0**-7}

interpret_pl = types.SimpleNamespace(
    pallas_call=functools.partial(pl.pallas_call, interpret=True),
    BlockSpec=pl.BlockSpec,
    program_id=pl.program_id,
    when=pl.when,
)


def _tree(path):
    return ast.parse(path.read_text(), filename=str(path))


def _bw_main():
    return next(
        n for n in _tree(BW_SOURCE).body if isinstance(n, ast.FunctionDef) and n.name == "main"
    )


def _assigned(body, name):
    """The statements of ``body`` that assign ``name``, in order."""
    return [
        n for n in body
        if isinstance(n, ast.Assign)
        and any(isinstance(t, ast.Name) and t.id == name for t in n.targets)
    ]


def _run(nodes, ns, path):
    exec(compile(ast.Module(body=nodes, type_ignores=[]), str(path), "exec"), ns)
    return ns


def _literal(body, name):
    (node,) = _assigned(body, name)
    return ast.literal_eval(node.value)


def bw_original(block_rows, lane_w, n_rows):
    """``bw_probe.py``'s ``pl_write``, ``pl_copy`` and ``pl_read`` (with their
    kernels) at ``(n_rows, lane_w)`` in blocks of ``block_rows``."""
    main = _bw_main()
    wanted = {"_write_kernel", "_copy_kernel", "_read_kernel", "pl_write", "pl_copy", "pl_read"}
    nodes = _assigned(main.body, "bspec") + [
        n for n in main.body if isinstance(n, ast.FunctionDef) and n.name in wanted
    ]
    ns = dict(jax=jax, jnp=jnp, pl=interpret_pl, block_rows=block_rows, lane_w=lane_w,
              n_rows=n_rows, grid=(n_rows // block_rows,))
    return _run(nodes, ns, BW_SOURCE)


def tap_original(rows, width, reps):
    """``tap_probe.py``'s constants, taps, input and ``make`` with ``ROWS``,
    ``W`` and ``REPS`` set to the given small values."""
    body = _tree(TAP_SOURCE).body
    consts = [n for name in ("ROWS", "W", "NTAPS", "REPS", "ITERS") for n in _assigned(body, name)]
    ns = _run(consts + _assigned(body, "taps"), dict(np=np), TAP_SOURCE)
    original = {k: ns[k] for k in ("ROWS", "W", "NTAPS", "REPS", "ITERS")}
    ns.update(ROWS=rows, W=width, REPS=reps, jax=jax, jnp=jnp, pl=interpret_pl)
    make = [n for n in body if isinstance(n, ast.FunctionDef) and n.name == "make"]
    _run(_assigned(body, "x_np") + make, ns, TAP_SOURCE)
    return ns, original


# --- the constants ---------------------------------------------------------


def test_bw_probe_constants_match_the_original():
    body = _bw_main().body
    assert _literal(body, "lane_w") == probes.LANE_W == 4096
    assert _literal(body, "block_rows") == probes.BLOCK_ROWS == 128
    # The row count: both of the original's statements, at several sizes.
    for gb in (0.001, 0.002, 0.1, 0.5, 1.0, 2.5):
        ns = dict(args=types.SimpleNamespace(gb=gb), lane_w=4096, block_rows=128, int=int)
        _run(_assigned(body, "n_rows"), ns, BW_SOURCE)
        assert probes.probe_rows(gb) == ns["n_rows"]
    assert probes.probe_rows(1.0) == 65_536
    assert bw_probe.SPEC_PEAK_GB_S == 3350.0


def test_tap_probe_constants_taps_and_input_match_the_original():
    ns, original = tap_original(16, 128, 4)
    assert original == {"ROWS": probes.ROWS, "W": probes.W, "NTAPS": probes.NTAPS,
                        "REPS": probes.REPS, "ITERS": tap_probe.ITERS}
    assert original == {"ROWS": 256, "W": 1024, "NTAPS": 13, "REPS": 64, "ITERS": 60}
    np.testing.assert_array_equal(probes.probe_taps().numpy(), ns["taps"])
    assert probes.probe_taps().dtype == torch.float32
    np.testing.assert_array_equal(tap_probe.probe_input(16, 128).numpy(), ns["x_np"])


# --- write, copy, read -------------------------------------------------------


@pytest.mark.parametrize("n_rows, lane_w, block_rows", [(32, 256, 16), (256, 512, 128)])
def test_write_and_copy_equal_the_original_kernels(n_rows, lane_w, block_rows):
    orig = bw_original(block_rows, lane_w, n_rows)
    want = np.asarray(orig["pl_write"]())
    got = probes.probe_write(n_rows, lane_w, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (n_rows, lane_w)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(want == probes.WRITE_VALUE)
    x = np.random.default_rng(3).standard_normal((n_rows, lane_w)).astype(np.float32)
    np.testing.assert_array_equal(
        probes.probe_copy(torch.from_numpy(x)).numpy(), np.asarray(orig["pl_copy"](jnp.asarray(x)))
    )


@pytest.mark.parametrize("fill", ["normal", "half"])
def test_read_equals_the_original_kernel_within_the_order_of_its_sums(fill):
    n_rows, lane_w = 256, 512  # the port's block of 128 rows; two of them
    orig = bw_original(128, lane_w, n_rows)
    if fill == "half":  # the original's buffer: every sum exact in float32
        x = np.full((n_rows, lane_w), 0.5, np.float32)
    else:
        x = np.random.default_rng(7).standard_normal((n_rows, lane_w)).astype(np.float32)
    want = np.asarray(orig["pl_read"](jnp.asarray(x)))
    got = probes.probe_read(torch.from_numpy(x)).numpy()
    assert got.shape == (8, 128) and got.dtype == np.float32
    terms = (n_rows // 8) * (lane_w // 128)
    abs_sum = np.abs(x).reshape(n_rows // 8, 8, lane_w // 128, 128).sum(axis=(0, 2))
    exact = x.astype(np.float64).reshape(n_rows // 8, 8, lane_w // 128, 128).sum(axis=(0, 2))
    bound = (terms - 1) * U32 * abs_sum
    assert np.all(np.abs(got - exact) <= bound)
    assert np.all(np.abs(got - want) <= 2 * bound)
    if fill == "half":
        np.testing.assert_array_equal(got, want)


def test_read_plain_version_follows_the_kernel_order_of_sums():
    # Block k of 128 rows, rows in order, 128-column groups in order within
    # a row; then the blocks' partials in block order.
    x = np.random.default_rng(11).standard_normal((384, 256)).astype(np.float32)
    want = np.zeros((8, 128), np.float32)
    for k in range(3):
        part = np.zeros((8, 128), np.float32)
        for r in range(128 * k, 128 * k + 128, 8):
            for j in range(2):
                part = part + x[r : r + 8, 128 * j : 128 * j + 128]
        want = want + part
    np.testing.assert_array_equal(probes.probe_read(torch.from_numpy(x)).numpy(), want)


# --- the tap chain ---------------------------------------------------------


@pytest.mark.parametrize("reps", [4, 64])
def test_f32_tap_chain_equals_the_original_kernel(reps):
    ns, _ = tap_original(16, 128, reps)
    x = ns["x_np"]
    want = np.asarray(ns["make"]("f32")(jnp.asarray(x)))
    got = probes.tap_chain_reference(torch.from_numpy(x), probes.probe_taps(), "f32", reps=reps)
    np.testing.assert_array_equal(got.numpy(), want)
    if reps == probes.REPS:
        np.testing.assert_array_equal(
            probes.tap_chain(torch.from_numpy(x), probes.probe_taps(), "f32").numpy(), want
        )


def _bf16(v):
    """``v`` rounded to bf16 (to nearest, ties to even), as float64."""
    return torch.from_numpy(np.asarray(v, np.float64)).to(torch.bfloat16).double().numpy()


@pytest.mark.parametrize("mode", ["bf16_carry", "bf16_full", "bf16_pair"])
def test_bf16_tap_chains_match_the_original_kernel(mode):
    ns, _ = tap_original(16, 128, probes.REPS)
    x = ns["x_np"]
    want = np.asarray(ns["make"](mode)(jnp.asarray(x)))
    taps = probes.probe_taps()
    got = probes.tap_chain(torch.from_numpy(x), taps, mode).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (16, 128)
    xb, tb = _bf16(x), _bf16(taps.numpy())
    s = probes.REPS * sum(np.abs(xb[t : t + 16] * tb[t]) for t in range(probes.NTAPS))
    bound = (BF16_BOUND[mode] + 2 * 831 * U32) * s
    assert np.all(np.abs(got - want) <= bound), (np.abs(got - want) / s).max()


def _emulated(mode, x, taps, reps):
    """The chain in numpy: float32 operations in float32, each bf16
    product and sum exact in float64 and then rounded to bf16."""
    rows = x.shape[0] - probes.NTAPS
    xb, tb = _bf16(x), _bf16(taps)

    def prod(t):
        return _bf16(xb[t : t + rows] * tb[t])

    acc = prod(0) if mode == "bf16_full" else prod(0).astype(np.float32)
    for rep in range(reps):
        ts = list(range(1 if rep == 0 else 0, probes.NTAPS))
        if mode == "bf16_full":
            for t in ts:
                acc = _bf16(acc + prod(t))
        elif mode == "bf16_carry":
            for t in ts:
                acc = acc + prod(t).astype(np.float32)
        else:
            for k in range(0, len(ts) - 1, 2):
                acc = acc + _bf16(prod(ts[k]) + prod(ts[k + 1])).astype(np.float32)
            if len(ts) % 2:
                acc = acc + prod(ts[-1]).astype(np.float32)
    return acc.astype(np.float32)


@pytest.mark.parametrize("mode", ["bf16_carry", "bf16_full", "bf16_pair"])
def test_bf16_plain_versions_round_each_operation_once(mode):
    x = tap_probe.probe_input(3, 8, seed=5)
    taps = probes.probe_taps()
    got = probes.tap_chain_reference(x, taps, mode, reps=3).numpy()
    np.testing.assert_array_equal(got, _emulated(mode, x.numpy(), taps.numpy(), 3))


# --- the wrappers ----------------------------------------------------------


def test_wrappers_run_the_plain_versions_on_the_cpu_without_a_launch():
    before = launch_counts()
    x = torch.ones((128, 128))
    probes.probe_write(8, 16, device="cpu")
    probes.probe_copy(x)
    probes.probe_read(x)
    probes.tap_chain(torch.ones((14, 4)), probes.probe_taps(), "bf16_full")
    since = launches_since(before)
    assert [since[p.__name__] for p in probes.PROBES] == [0] * len(probes.PROBES)


@pytest.mark.parametrize(
    "call, error",
    [
        (lambda: probes.probe_copy(torch.ones(8, dtype=torch.float64)), TypeError),
        (lambda: probes.probe_copy(torch.ones((4, 8)).t()), ValueError),
        (lambda: probes.probe_copy(torch.ones(6)), ValueError),
        (lambda: probes.probe_copy(torch.ones(8, device="meta")), ValueError),
        (lambda: probes.probe_read(torch.ones((100, 128))), ValueError),
        (lambda: probes.probe_read(torch.ones((128, 100))), ValueError),
        (lambda: probes.probe_read(torch.ones((128, 128), device="meta")), ValueError),
        (lambda: probes.probe_write(8, 16, device="meta"), ValueError),
        (lambda: probes.probe_write(3, 1, device="cpu"), ValueError),
        (lambda: probes.tap_chain(torch.ones((14, 4)), probes.probe_taps(), "f16"), ValueError),
        (lambda: probes.tap_chain(torch.ones((14, 3)), probes.probe_taps(), "bf16_pair"), ValueError),
        (lambda: probes.tap_chain(torch.ones((12, 4)), probes.probe_taps(), "f32"), ValueError),
        (lambda: probes.tap_chain(torch.ones((14, 4)), torch.ones(12), "f32"), ValueError),
        (lambda: probes.tap_chain(torch.ones((14, 4), device="meta"),
                                  probes.probe_taps().to("meta"), "f32"), ValueError),
        # contiguous views of 8, of 128 x 128 and of 14 x 4 elements one element into their
        # buffers: every other check passes, the kernels' 16-byte (8-byte) accesses would fault
        (lambda: probes.probe_copy(torch.arange(12.0)[1:9]), ValueError),
        (lambda: probes.probe_read(torch.ones(128 * 128 + 1)[1:].view(128, 128)), ValueError),
        (lambda: probes.tap_chain(torch.ones(14 * 4 + 1)[1:].view(14, 4), probes.probe_taps(),
                                  "bf16_pair"), ValueError),
    ],
)
def test_wrappers_refuse_what_the_kernels_do_not_take(call, error):
    with pytest.raises(error):
        call()


def test_wrappers_take_views_on_the_kernels_access_boundaries():
    base = torch.arange(4 + 128 * 128, dtype=torch.float32)
    x = base[4:].view(128, 128)  # 16 bytes into its buffer
    assert torch.equal(probes.probe_copy(x), x)
    assert torch.equal(probes.probe_read(x), probes.probe_read_reference(x.clone()))
    xt = torch.ones(2 + 14 * 4)[2:].view(14, 4)  # 8 bytes in: the bf16 modes' float2 reads
    assert torch.equal(probes.tap_chain(xt, probes.probe_taps(), "bf16_pair"),
                       probes.tap_chain(xt.clone(), probes.probe_taps(), "bf16_pair"))


# --- the entry points --------------------------------------------------------


def _json_line(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    (line,) = buf.getvalue().strip().splitlines()
    return json.loads(line)


def test_bw_probe_on_the_cpu_prints_the_original_keys():
    (out_assign,) = _assigned(_bw_main().body, "out")
    keys = [k.value for k in out_assign.value.keys]
    got = _json_line(bw_probe.main, ["--gb", "0.002", "--iters", "1", "--device", "cpu"])
    assert set(keys) <= set(got) and "smi" in got
    assert got["platform"] == "cpu" and got["spec_peak_gb_s"] == 3350.0
    assert got["buffer_gb"] == round(4 * 128 * 4096 / 1e9, 3)
    assert all(got[k] > 0 for k in keys if k.endswith("_gb_s"))


def test_tap_probe_on_the_cpu_prints_the_original_keys():
    source = TAP_SOURCE.read_text()
    got = _json_line(tap_probe.main, ["--rows", "4", "--width", "8", "--iters", "1", "--device", "cpu"])
    for mode in probes.TAP_MODES:
        assert f'"{mode}"' in source
        want = {"ms", "ps_per_el_tap"} | ({"speedup", "max_rel_err"} if mode != "f32" else set())
        assert all(f'"{k}"' in source for k in want)
        assert set(got[mode]) == want
    assert got["rows"] == 4 and got["width"] == 8 and got["platform"] == "cpu"


@pytest.mark.parametrize("main", [bw_probe.main, tap_probe.main, bench.main, frontend_bench.main,
                                  ba_bench.main, slam_bench.main, descriptor_bench.main,
                                  scatter_probe.main, scaling_bench.main, multihost_bench.main])
def test_probes_exit_without_a_card_unless_asked_for_the_cpu(main, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        main([])
    assert capsys.readouterr().out == ""


def test_entry_points_load_no_jax_in_a_fresh_interpreter():
    """Every measuring entry point of the port runs in one fresh interpreter
    at a toy size (the probes through ``main``, the benchmarks through
    ``run``: one warp, 8 frames of 160×120, a BA of 6 × 120 × 40, a scatter
    probe of 2,048 × 256 × 10; the scaling runs, which start ranks of their
    own, are imported), and none loads jax or the JAX package."""
    code = (
        "import sys\n"
        "from sift_scale_space_extrema_detection_tpu_torch.benchmarks import (\n"
        "    ba_bench, bench, bw_probe, descriptor_bench, frontend_bench, multihost_bench,\n"
        "    scaling_bench, scatter_probe, slam_bench, tap_probe)\n"
        "bw_probe.main(['--gb', '0.002', '--iters', '1', '--device', 'cpu'])\n"
        "tap_probe.main(['--rows', '2', '--width', '4', '--iters', '1', '--device', 'cpu'])\n"
        "cpu = dict(device='cpu')\n"
        "outs = [bench.run(batch=1, height=96, width=128, iters=1, **cpu),\n"
        "        frontend_bench.run(batch=1, height=96, width=128, iters=1, octaves=3,\n"
        "                           stages=True, describe=True, **cpu),\n"
        "        ba_bench.run(cams=6, pts=120, obs_per_cam=40, iters=2, **cpu),\n"
        "        slam_bench.run(frames=8, size='160x120', render_cache='', **cpu),\n"
        "        descriptor_bench.run(warps=[(20.0, 1.0)], **cpu),\n"
        "        scatter_probe.run(o=2048, l=256, c=10, iters=1, **cpu)]\n"
        "assert [out['device'] for out in outs] == ['cpu'] * 6, outs\n"
        "assert callable(scaling_bench.run) and callable(multihost_bench.run)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'sift_scale_space_extrema_detection_tpu']\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.strip().splitlines()) == 2


def test_sass_counts_read_the_tap_kernels_opcodes():
    import chip_smoke

    text = "\n".join([
        "\t\tFunction : _ZN41_GLOBAL__N__7223fd14_9_probes_cu_ec71b30514tap_f32_kernelEPKfiS1_Pfi",
        "        /*0090*/               @P0 EXIT ;                     /* 0x000000000000094d */",
        "        /*0100*/                   FMUL R4, R4, R5 ;          /* 0x0000000504047220 */",
        "        /*0110*/                   FADD R0, R0, R4 ;          /* 0x0000000400007221 */",
        "        /*0120*/              @!P1 FADD R0, R0, R6 ;          /* 0x0000000600007221 */",
        "\t\tFunction : _ZN41_GLOBAL__N__7223fd14_9_probes_cu_ec71b30515tap_bf16_kernelILi2EEEvPKfiS2_Pfi",
        "        /*02b0*/                   HMUL2.BF16_V2 R4, R18, R16.H0_H0 ;   /* 0x20000 */",
        "        /*0350*/                   HADD2.BF16_V2 R5, R15, R20 ;         /* 0x00000 */",
        "        /*0360*/                   HFMA2.MMA.BF16_V2 R4, R4, 1, 1, R15 ; /* 0x3f803 */",
        "\t\tFunction : _ZN41_GLOBAL__N__7223fd14_9_probes_cu_ec71b30511copy_kernelEPK6float4PS0_x",
        "        /*0100*/                   FADD R0, R0, R4 ;          /* 0x0000000400007221 */",
    ])
    mix = chip_smoke.sass_counts(text)
    assert set(mix) == {"f32", "bf16_full"}
    assert mix["f32"] == {"FMUL": 1, "FADD": 2, "FFMA": 0, "HMUL2": 0, "HADD2": 0, "HFMA2": 0}
    assert mix["bf16_full"] == {"FMUL": 0, "FADD": 0, "FFMA": 0, "HMUL2": 1, "HADD2": 1, "HFMA2": 1}


def test_turns_run_each_function_in_order_and_back():
    import chip_smoke

    calls = []
    fns = {name: functools.partial(calls.append, name) for name in ("plain", "kernel", "library")}
    times = chip_smoke._turns_of(torch, fns, {"plain": 2, "kernel": 1, "library": 1})
    assert set(times) == set(fns) and all(t >= 0 for t in times.values())
    warm = ["plain", "kernel", "library"]
    assert calls == warm + ["plain", "plain", "kernel", "library", "library", "kernel", "plain", "plain"]


def test_held_turns_take_a_longer_hold_where_the_host_was_late_and_say_so():
    import chip_smoke

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            pass

        def query(self):  # whether the hold had ended when the turn was enqueued
            return ended.pop(0)

        def elapsed_time(self, end):
            return 40.0

    sleeps, calls = [], []
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        Event=Event, _sleep=sleeps.append, synchronize=lambda: None))
    ended = [True, False]
    ms, host_us, held = chip_smoke._held_ms(fake, functools.partial(calls.append, 1), 4)
    assert (ms, held, len(calls)) == (10.0, True, 8) and host_us >= 0
    assert sleeps == list(chip_smoke.HOLD_CYCLES[:2]) and sleeps[1] > sleeps[0]
    sleeps.clear()
    ended = [True] * len(chip_smoke.HOLD_CYCLES)
    assert chip_smoke._held_ms(fake, lambda: None, 4)[2] is False
    assert sleeps == list(chip_smoke.HOLD_CYCLES) and not ended


def test_a_poisoned_check_runs_its_function_alone_on_the_cpu():
    import chip_smoke

    out = chip_smoke._on_poison(torch, 8, torch.device("cpu"), lambda: probes.probe_write(2, 4, "cpu"))
    assert torch.equal(out, torch.full((2, 4), probes.WRITE_VALUE))


def test_probe_designs_need_a_card_and_build_nothing_without_one(monkeypatch, capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_probe_designs",
                                                  REPO / "tools" / "torch_probe_designs.py")
    designs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(designs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(designs, "load_designs", lambda: pytest.fail("built without a card"))
    assert designs.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    sizes = designs.edge_sizes(132, 1.0)
    assert all(n % 4 == 0 and n > 0 for n in sizes.values())
    assert sizes["buffer"] == 65536 * 4096
    assert sizes["stretch+16B"] % designs.STRETCH == 4 and sizes["chunk+16B"] % designs.CHUNK == 4
    chunks = -(-sizes["ragged"] // designs.CHUNK)  # the last one short
    assert chunks % 132 == 1 and sizes["ragged"] % designs.CHUNK != 0
    assert -(-sizes["ragged"] // designs.STRETCH) % (8 * 132) != 0
