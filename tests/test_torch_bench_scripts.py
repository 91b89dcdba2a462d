"""The port's measuring entry points (``…_torch/benchmarks/``: ``bench``,
``frontend_bench``, ``ba_bench``, ``slam_bench``, ``descriptor_bench``)
against the JAX package's scripts (the root ``bench.py`` and
``benchmarks/{frontend,ba,slam,descriptor}_bench.py``).

The scripts are loaded by path: importing one runs no benchmark (each does
its work in ``main``). Their helpers are called as they are; the parts of a
``main`` a comparison needs (its parser, its configurations, its FLOP model,
its warp grid, its suite loop) are taken out of the source with ``ast`` and
run at toy sizes, without the lines that point JAX at a persistent cache or
at the TPU, and with renders not cached. JAX runs on the CPU in float32 (x64
off, as the scripts run) with its persistent compilation cache off.

Tolerances, each stated where it is held: the helpers and the renderers at
4 frames are bit-equal; where a recipe takes ``so3_exp`` in float32 the
port's (PyTorch) and the original's (XLA) may round a rotation entry apart
by up to 2 ulps (2.4e-7), and what follows from it apart by that much
relatively; counts and descriptor rows are equal; a SLAM suite row, each package's back
end in float64 on the same keypoints and RANSAC draws, has the same tracks
bit for bit, the same landmarks and an ATE within ``SLAM_ATE_F64`` (1e-6;
float64 rounding on the same tracks and draws reaches 6e-8).
"""

import argparse
import ast
import dataclasses
import importlib.util
import io
import json
import time
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sift_scale_space_extrema_detection_tpu_torch.benchmarks import (
    ba_bench,
    bench,
    descriptor_bench,
    frontend_bench,
    slam_bench,
)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = {
    "bench": REPO / "bench.py",
    "frontend_bench": REPO / "benchmarks" / "frontend_bench.py",
    "ba_bench": REPO / "benchmarks" / "ba_bench.py",
    "slam_bench": REPO / "benchmarks" / "slam_bench.py",
    "descriptor_bench": REPO / "benchmarks" / "descriptor_bench.py",
}
PORT = {
    "bench": bench,
    "frontend_bench": frontend_bench,
    "ba_bench": ba_bench,
    "slam_bench": slam_bench,
    "descriptor_bench": descriptor_bench,
}
CPU = dict(device="cpu")
ROT_ULPS = 2.0**-22  # 2 ulps of 1 in float32: so3_exp in PyTorch against XLA
# A suite row's ATE through both back ends in float64 on the same tracks and
# draws. (In float32 rounding alone moves such a row's ATE by up to 0.083,
# so the rows are compared in float64.)
SLAM_ATE_F64 = 1e-6
# The loop pass needs more than loop_min_gap + 1 = 11 frames: the loop row
# runs 16, 8 out and 8 back.
LOOP_ROW_FRAMES = 16
THREE_WARPS = [(20.0, 1.0), (45.0, 0.8), (90.0, 1.25)]


@pytest.fixture(scope="module", autouse=True)
def _jax_as_the_scripts_run():
    """float32 JAX (the scripts run with x64 off) without the persistent
    compilation cache (ROADMAP §3)."""
    x64, cache = jax.config.jax_enable_x64, jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_x64", False)
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_x64", x64)
    jax.config.update("jax_enable_compilation_cache", cache)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", SCRIPTS[name])
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _main(name) -> ast.FunctionDef:
    tree = ast.parse(SCRIPTS[name].read_text(), filename=str(SCRIPTS[name]))
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _run(nodes, ns, name):
    exec(compile(ast.Module(body=list(nodes), type_ignores=[]), str(SCRIPTS[name]), "exec"), ns)
    return ns


def _stmt(code):
    return ast.parse(code).body[0]


def _parser_args(name, argv):
    """The script's ``args`` for ``argv``: the statements of its ``main``
    that build the parser, then ``ap.parse_args(argv)``."""
    body = []
    for node in _main(name).body:
        src = ast.unparse(node)
        if src.startswith("args = ap.parse_args()"):
            break
        body.append(node)
    ns = _run(body + [_stmt("args = ap.parse_args(ARGV)")], {"argparse": argparse, "ARGV": argv},
              name)
    return ns["ap"], ns["args"]


def _options(parser) -> set:
    return {s for a in parser._actions for s in a.option_strings if s.startswith("--")}


def _keys(value) -> set:
    """Every key of every dict in a JSON object, at any depth."""
    if isinstance(value, dict):
        return set(value) | {k for v in value.values() for k in _keys(v)}
    if isinstance(value, list):
        return {k for v in value for k in _keys(v)}
    return set()


def _dict_keys(func) -> set:
    """The string keys of the dict literals and ``out["key"] = ...``
    assignments in a function of a script."""
    keys = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant)}
        elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store) and isinstance(
                node.slice, ast.Constant) and isinstance(node.slice.value, str):
            keys.add(node.slice.value)
    return keys


def test_shared_helpers_on_the_cpu():
    """The timing helpers call as they say (warm-up calls, then the timed
    ones), peak memory and the card's name are None / "cpu" on the CPU, and
    a path's kernel launched no time is an error on the card only."""
    from sift_scale_space_extrema_detection_tpu_torch import benchmarks

    cpu, calls = torch.device("cpu"), []
    assert benchmarks.host_ms(lambda: calls.append(1), cpu, reps=3, warmup=2) >= 0
    assert len(calls) == 5
    calls.clear()
    median, times = benchmarks.median_ms(lambda: calls.append(1), cpu, repeats=4, warmup=1)
    assert len(calls) == 5 and len(times) == 4 and median == float(np.median(times))
    assert benchmarks.peak_gib(lambda: 7, cpu) == (7, None)
    assert benchmarks.device_entry(cpu) == "cpu"
    assert benchmarks.path_kernels("fused", True) == (
        "fused_octave", "select_candidates", "newton_ladder", "orient_slots", "describe_pairs")
    assert benchmarks.path_kernels("fused", True, upright=True) == (
        "fused_octave", "select_candidates", "newton_ladder", "describe_pairs")
    assert benchmarks.path_kernels("pallas", False) == ("blur_fused", "newton_ladder")
    assert benchmarks.path_kernels("separable", True) == (
        "newton_ladder", "orient_slots", "describe_pairs")
    assert benchmarks.path_kernels("exact", False) == ()
    none = benchmarks.path_launches(benchmarks.launch_counts())
    assert none == dict.fromkeys(benchmarks.PATH_KERNELS, 0)
    benchmarks.require_launches(cpu, none, ("fused_octave",), "a CPU run")
    with pytest.raises(RuntimeError, match="fused_octave"):
        benchmarks.require_launches(torch.device("cuda"), none, ("fused_octave",), "a card run")


# --- (a) each pinned copy equals its original --------------------------------------


@pytest.mark.parametrize("name, helper", [("bench", "_make_batch"),
                                          ("frontend_bench", "make_batch")])
def test_make_batch_is_the_originals(name, helper):
    want = getattr(_load(name), helper)(3, 96, 128)
    got = bench.make_batch(3, 96, 128)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert frontend_bench.make_batch is bench.make_batch
    assert bench.ORACLE_BASELINE_FPS == _load("bench").ORACLE_BASELINE_FPS


@pytest.mark.parametrize("size", [(6, 120, 40), (50, 512, 64)], ids=["6x120x40", "50x512x64"])
def test_ba_problem_is_the_originals(size):
    """The random draws (points, which points each camera sees) are the
    original's bit for bit; the poses, and the pixels projected through
    them, within the float32 rounding of ``so3_exp`` (at most 2 ulps of a
    rotation entry, relatively as much in a translation of radius 12 and in
    a pixel 500 px from the centre)."""
    state, obs = _load("ba_bench").make_problem(np.random.default_rng(0), *size)
    got = ba_bench.problem_arrays(np.random.default_rng(0), *size)
    want = dict(rotations=state.rotations, translations=state.translations, points=state.points,
                k_mat=state.k_mat, camera=obs.camera, landmark=obs.landmark, uv=obs.uv)
    want = {k: np.asarray(v) for k, v in want.items()}
    assert {k: v.dtype for k, v in got.items()} == {k: v.dtype for k, v in want.items()}
    for k in ("points", "k_mat", "camera", "landmark"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["rotations"], want["rotations"], rtol=0, atol=ROT_ULPS)
    np.testing.assert_allclose(got["translations"], want["translations"], rtol=0,
                               atol=16 * ROT_ULPS)
    np.testing.assert_allclose(got["uv"], want["uv"], rtol=0, atol=1000 * ROT_ULPS)
    p_state, p_obs = ba_bench.make_problem(np.random.default_rng(0), *size)
    assert torch.equal(p_state.rotations, torch.from_numpy(got["rotations"]))
    assert bool(p_obs.valid.all()) and np.asarray(obs.valid).all()


def test_descriptor_helpers_are_the_originals():
    original = _load("descriptor_bench")
    assert (original.H, original.W, original.CORRECT_PX) == (
        descriptor_bench.H, descriptor_bench.W, descriptor_bench.CORRECT_PX)
    np.testing.assert_array_equal(descriptor_bench.textured_image(np.random.default_rng(7)),
                                  original.textured_image(np.random.default_rng(7)))
    # The original's grid: the two statements of its main that make it.
    body = [n for n in _main("descriptor_bench").body
            if ast.unparse(n).startswith(("grid = ", "grid.remove"))]
    grid = _run(body, {}, "descriptor_bench")["grid"]
    assert descriptor_bench.warp_grid() == grid and len(grid) == 11
    rng = np.random.default_rng(3)
    for rdeg, s in grid:
        a_mat = descriptor_bench.warp_matrix(rdeg, s)
        np.testing.assert_array_equal(a_mat, original.warp_matrix(rdeg, s))
        pa = rng.uniform(0, [320, 240], size=(50, 2))
        pb = pa @ a_mat[:, :2].T + a_mat[:, 2] + rng.normal(0, 2.0, size=(50, 2))
        matches = np.stack([rng.permutation(50)[:30], rng.permutation(50)[:30]], -1)
        matches[:15, 1] = matches[:15, 0]
        assert descriptor_bench.score_warp(pa, pb, matches, a_mat) == original.score_warp(
            pa, pb, matches, a_mat)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", list(slam_bench.RENDERS))
def test_renderers_are_the_originals(shape, seed):
    """4 frames of 80×64: frames, rotations, translations and intrinsics
    bit-equal (``so3_exp`` rounds the same in both at these angles)."""
    fn = slam_bench.RENDERS[shape]
    original = getattr(_load("slam_bench"), fn.__name__)
    got = fn(np.random.default_rng(seed), 4, 80, 64)
    want = original(np.random.default_rng(seed), 4, 80, 64)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", ["dolly", "zigzag"])
def test_longer_renders_part_only_by_so3_rounding(shape):
    """40 frames of 80×64: where ``so3_exp`` in PyTorch and in XLA round a
    rotation entry apart (up to 2 ulps), the translation follows by as much
    relatively, and a pixel of the frame can move by one 8-bit level of the
    renderer's quantisation; the scene's draws are the same."""
    fn = slam_bench.RENDERS[shape]
    original = getattr(_load("slam_bench"), fn.__name__)
    got = fn(np.random.default_rng(0), 40, 80, 64)
    want = original(np.random.default_rng(0), 40, 80, 64)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=ROT_ULPS)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=16 * ROT_ULPS)
    moved = np.abs(got[0] - want[0])
    assert moved.max() <= 1 / 255 + 1e-12 and (moved > 0).mean() <= 1e-3


@pytest.mark.parametrize("argv", [[], ["--quality", "--upright", "--no-window-describe",
                                        "--ba-interval", "7", "--bootstrap", "2", "--pose-graph",
                                        "--ba-every", "2", "--desc-grid", "12", "--ba-iters", "3",
                                        "--final-rounds", "0", "--describe-compaction", "0.4"]],
                         ids=["defaults", "flags"])
def test_slam_configs_are_the_scripts(argv):
    """The original's ``SiftConfig`` and ``SlamConfig`` for the same flags,
    field by field (its statements from ``kw_cfg`` to ``slam_cfg``)."""
    from sift_scale_space_extrema_detection_tpu import SiftConfig
    from sift_scale_space_extrema_detection_tpu.models.slam import SlamConfig

    _, args = _parser_args("slam_bench", argv)
    body = [n for n in _main("slam_bench").body
            if ast.unparse(n).startswith(("kw_cfg = ", "sift_cfg = ", "slam_cfg = "))]
    ns = _run(body, {"args": args, "SiftConfig": SiftConfig, "SlamConfig": SlamConfig},
              "slam_bench")
    port_args = slam_bench.build_parser().parse_args(argv + ["--device", "cpu"])
    sift_cfg, slam_cfg = slam_bench.configs(
        port_args.quality, port_args.no_window_describe, port_args.upright,
        port_args.describe_compaction, port_args.desc_grid, port_args.ba_interval,
        port_args.ba_iters, port_args.final_rounds, port_args.bootstrap, port_args.pose_graph,
        port_args.ba_every)
    assert dataclasses.asdict(sift_cfg) == dataclasses.asdict(ns["sift_cfg"])
    assert dataclasses.asdict(slam_cfg) == dataclasses.asdict(ns["slam_cfg"])


@pytest.mark.parametrize("name", ["frontend_bench", "ba_bench", "slam_bench", "descriptor_bench"])
def test_flags_are_the_scripts(name):
    """The original's flags and no other (its ``--cpu`` is ``--device
    cpu``), each with the original's default."""
    jax_ap, jax_args = _parser_args(name, [])
    port_ap = PORT[name].build_parser()
    assert _options(port_ap) == _options(jax_ap) - {"--cpu"} | {"--device"}
    port_args = vars(port_ap.parse_args([]))
    for dest, value in vars(jax_args).items():
        if dest != "cpu":
            assert port_args[dest] == value, dest


def test_bench_constants_are_the_scripts():
    """``bench.py`` takes no flags: its batch, frame and iteration count are
    the port's constants, and the port adds only ``--blur`` and
    ``--device``."""
    src = {ast.unparse(n) for n in _main("bench").body}
    assert "batch, h, w = (64, 480, 640)" in src and "iters = 6" in src
    assert (bench.BATCH, bench.HEIGHT, bench.WIDTH, bench.ITERS) == (64, 480, 640, 6)
    assert _options(bench.build_parser()) == {"--help", "--blur", "--device"}
    cfg = bench.bench_config()
    assert (cfg.num_octaves, cfg.scales_per_octave, cfg.max_keypoints_per_trio) == (4, 5, 512)


# --- (b) each module's run on the CPU returns every key of its script ----------------


def test_bench_returns_the_scripts_keys():
    got = bench.run(batch=2, height=96, width=128, iters=1, **CPU)
    assert _dict_keys(_main("bench")) <= set(got)
    assert got["device"] == "cpu" and got["metric"] == "sift_frontend_frames_per_s_per_chip"
    assert got["unit"] == "frames/s" and got["value"] > 0 and got["vs_baseline"] > 0


def test_frontend_bench_returns_the_scripts_keys(tmp_path):
    got = frontend_bench.run(batch=2, height=96, width=128, iters=1, stages=True, describe=True,
                             octaves=3, profile=str(tmp_path), **CPU)
    assert _dict_keys(_main("frontend_bench")) <= set(got)
    assert got["device"] == "cpu" and got["blur"] == "fused" and got["batch"] == 2
    assert set(got["fused_octave"]) == {"launches", "ms", "bound_ms", "bound_by", "reach_ms",
                                        "reach_by"}
    assert Path(got["profile"]["trace"]).exists()


def test_ba_bench_returns_the_scripts_readings():
    """The original prints lines, not JSON: the port prints the same lines
    (every literal piece of each of the original's f-strings, in order) and
    holds each reading under a key."""
    got = ba_bench.run(cams=6, pts=120, obs_per_cam=40, iters=2, breakdown=True, **CPU)
    assert {"lm_iters_per_s", "ms_per_iter", "final_cost", "gflop_per_iter",
            "tflop_s_achieved"} <= set(got) and got["device"] == "cpu"
    assert set(got["breakdown"]) == {"assembly_schur_ms", "reduced_solve_ms", "lm_overhead_ms"}
    prints = [n.args[0] for n in ast.walk(_main("ba_bench")) if isinstance(n, ast.Call)
              and getattr(n.func, "id", None) == "print" and isinstance(n.args[0], ast.JoinedStr)]
    assert len(prints) == len(got["lines"]) == 3
    for fstring, line in zip(prints, got["lines"]):
        at = 0
        for piece in fstring.values:
            if isinstance(piece, ast.Constant):
                at = line.index(piece.value, at) + len(piece.value)


def test_slam_bench_returns_the_scripts_keys(tmp_path):
    """The headline run with ``--breakdown``, ``--streaming`` and
    ``--suite`` (8 frames of 160×120, one seed) together hold every key
    of the original's rows and summaries."""
    kw = dict(frames=8, size="160x120", render_cache=str(tmp_path), **CPU)
    rows = []
    outs = [slam_bench.run(**kw, breakdown=True), slam_bench.run(**kw, streaming=True),
            slam_bench.run(**kw, suite=True, seeds=1, on_row=rows.append)]
    assert _dict_keys(_main("slam_bench")) <= set().union(*map(_keys, outs))
    assert all(out["device"] == "cpu" for out in outs)
    assert outs[2]["rows"] == rows and len(rows) == 4
    assert len(list(tmp_path.glob("*.npz"))) == 4  # the dolly rendered once


def test_descriptor_bench_returns_the_scripts_keys():
    original = _load("descriptor_bench")
    got = descriptor_bench.run(warps=THREE_WARPS[:1], **CPU)
    want = _dict_keys(_main("descriptor_bench")) | set(
        original.score_warp(np.zeros((0, 2)), np.zeros((0, 2)), [], np.eye(2, 3)))
    assert want <= _keys(got) and got["device"] == "cpu" and got["warps"] == 1


# --- (c) non-timing outputs agree with the script's on the same inputs ---------------


@pytest.mark.parametrize("solver, size, cg_iters", [
    ("dense", (50, 4096, 512), 32), ("dense", (6, 120, 40), 32), ("cg", (1000, 100_000, 300), 32),
    ("cg", (6, 120, 40), 8)])
def test_flop_model_is_the_scripts(solver, size, cg_iters):
    """Exactly the original's count (its ``if args.solver == "dense"``
    statement)."""
    node = next(n for n in _main("ba_bench").body
                if ast.unparse(n).startswith("if args.solver == 'dense':"))
    c, l, opc = size
    ns = _run([node], {"args": argparse.Namespace(solver=solver, cg_iters=cg_iters), "c": c,
                       "l": l, "n_obs": c * opc}, "ba_bench")
    assert ba_bench.flop_model(solver, c, l, c * opc, cg_iters) == ns["flops_iter"]


@pytest.mark.parametrize("blur", ["fused", "separable"])
def test_keypoint_counts_are_the_jax_packages(blur):
    """``keypoints_per_image`` of ``frontend_bench`` on its frames (2 of
    96×128, 3 octaves × 5 scales, 512 a trio) against the original's count
    (``sum(kp.valid)`` of ``detect_batched_jit``) on the same frames: equal.
    The original runs ``blur="fused"`` on the TPU; its CPU path is the
    separable one."""
    from sift_scale_space_extrema_detection_tpu import SiftConfig, detect_batched_jit

    cfg = SiftConfig(num_octaves=3, scales_per_octave=5, max_keypoints_per_trio=512)
    kp, _ = detect_batched_jit(jax.numpy.asarray(bench.make_batch(2, 96, 128)), cfg, "separable")
    got = frontend_bench.run(batch=2, height=96, width=128, iters=1, octaves=3, blur=blur, **CPU)
    assert got["keypoints_per_image"] == round(int(np.asarray(kp.valid).sum()) / 2, 1) > 50


def _descriptor_rows(argv, warps):
    """The original's JSON object for ``warps`` of its grid: its ``main``
    without the cache line, the grid cut to ``warps`` after it is made."""
    body = []
    for node in _main("descriptor_bench").body:
        src = ast.unparse(node)
        if "jax_compilation_cache_dir" in src or src.startswith("if args.cpu"):
            continue
        body.append(_stmt("args = ap.parse_args(ARGV)") if src.startswith("args = ap.parse_args(")
                    else node)
        if src.startswith("grid.remove"):
            body.append(_stmt("grid = [g for g in grid if g in WARPS]"))
    original = _load("descriptor_bench")
    ns = dict(vars(original), ARGV=argv, WARPS=warps)
    out = io.StringIO()
    with redirect_stdout(out):
        _run(body, ns, "descriptor_bench")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _same_descriptor_rows(argv, warps):
    want = _descriptor_rows(argv, warps)
    ratio = 0.8 if not argv else float(argv[argv.index("--ratio") + 1])
    got = descriptor_bench.run(ratio=ratio, warps=warps, **CPU)
    assert {k: v for k, v in got.items() if k in want} == want
    assert all(row["ours"]["kp_a"] > 20 for row in got["rows"])


def test_descriptor_rows_are_the_scripts_on_three_warps():
    """Ours and OpenCV's rows equal, number for number, on three warps."""
    _same_descriptor_rows([], THREE_WARPS)


@pytest.mark.slow
def test_descriptor_rows_are_the_scripts_on_the_whole_grid():
    """All 11 warps, ``--ratio 0.8`` and ``0.7``."""
    _same_descriptor_rows([], descriptor_bench.warp_grid())
    _same_descriptor_rows(["--ratio", "0.7"], descriptor_bench.warp_grid())


def _suite_rows(argv, shapes):
    """The original's ``--suite`` rows for ``shapes``: its ``main`` up to
    the suite loop and the loop itself, renders not cached."""
    body = []
    for node in _main("slam_bench").body:
        src = ast.unparse(node)
        if "jax.config.update" in src and not src.startswith("if args.suite"):
            continue
        if src.startswith("args = ap.parse_args("):
            node = _stmt("args = ap.parse_args(ARGV)")
        if src.startswith("if args.suite"):
            body.append(_stmt("renders = {k: v for k, v in renders.items() if k in SHAPES}"))
            body.extend(node.body[:-1])  # the rows and the summary, not the return
            break
        body.append(node)
    original = _load("slam_bench")
    ns = dict(vars(original), ARGV=argv, SHAPES=shapes, time=time, json=json,
              _cached_render=lambda fn, shape, seed, n, w, h: fn(np.random.default_rng(seed), n,
                                                                 w, h))
    with redirect_stdout(io.StringIO()):
        _run(body, ns, "slam_bench")
    return ns["rows"]


def _same_suite_rows(monkeypatch, tmp_path, argv, shapes, frames, **kw):
    """The original's suite rows for ``shapes`` against the port's, each
    package's SLAM on the port's keypoints (handed to the JAX package in
    place of its frontend), the JAX package's RANSAC draws (the port's own
    cannot be the JAX package's, ROADMAP §3) and its back end in float64:
    the same tracks bit for bit, the same landmarks, the unrounded ATE
    within ``SLAM_ATE_F64`` and the rows' ATE (4 decimals) within one unit
    of the last. Returns each row's tracks."""
    from sift_scale_space_extrema_detection_tpu.models import frontend as jfrontend
    from sift_scale_space_extrema_detection_tpu.models import slam as jslam
    from sift_scale_space_extrema_detection_tpu.ops.descriptor import (
        DescribedKeypoints as JDescribed,
    )
    from sift_scale_space_extrema_detection_tpu_torch.models import slam as pslam
    from sift_scale_space_extrema_detection_tpu_torch.ops import ransac as pransac

    from tests.torch_port_helpers import jax_ransac_draws

    sift_cfg = slam_bench.configs()[0]
    seen = {"jax": [], "port": []}

    def x64(fn):
        def run(*args, **kwargs):
            jax.config.update("jax_enable_x64", True)
            try:
                return fn(*args, **kwargs)
            finally:
                jax.config.update("jax_enable_x64", False)
        return run

    def port_frontend(images, cfg, blur="separable"):
        got = pslam.describe_frames(np.asarray(images), sift_cfg, device="cpu", blur=blur)
        return JDescribed(**{f.name: jax.numpy.asarray(getattr(got, f.name).numpy())
                             for f in dataclasses.fields(got)})

    def backend(name, fn, **extra):
        def run(pixels, visible, *args, **kwargs):
            seen[name].append({"tracks": (np.array(pixels), np.array(visible))})
            return x64(fn)(pixels, visible, *args, **{**kwargs, **extra})
        return run

    def ate(name, fn):
        def run(*args, **kwargs):
            value = x64(fn)(*args, **kwargs)
            seen[name][-1]["ate"] = float(value)
            return value
        return run

    monkeypatch.setattr(jfrontend, "detect_and_describe_batched_jit", port_frontend)
    monkeypatch.setattr(jslam, "run_slam", backend("jax", jslam.run_slam))
    monkeypatch.setattr(jslam, "evaluate_ate", ate("jax", jslam.evaluate_ate))
    want = _suite_rows(argv, shapes)
    monkeypatch.setattr(pransac, "sample_minimal_sets", jax_ransac_draws)
    monkeypatch.setattr(pslam, "_pair_draws", jax_ransac_draws)
    monkeypatch.setattr(pslam, "run_slam", backend("port", pslam.run_slam, dtype=torch.float64))
    monkeypatch.setattr(slam_bench, "evaluate_ate", ate("port", slam_bench.evaluate_ate))
    got = slam_bench.run(frames=frames, size="160x120", suite=True, seeds=1, shapes=shapes,
                         render_cache=str(tmp_path), **kw, **CPU)["rows"]
    assert [(r["shape"], r["seed"]) for r in got] == [(r["shape"], r["seed"]) for r in want]
    for g, w, gs, ws in zip(got, want, seen["port"], seen["jax"]):
        for a, b in zip(gs["tracks"], ws["tracks"]):
            np.testing.assert_array_equal(a, b)
        assert g["lm"] == w["lm"] > 20, (g, w)
        assert abs(gs["ate"] - ws["ate"]) <= SLAM_ATE_F64, (gs["ate"], ws["ate"])
        assert abs(g["ate"] - w["ate"]) <= 1.01e-4, (g, w)
    return [s["tracks"] for s in seen["port"]]


def _loop_row_tracks():
    """The tables of the loop row's keypoints (seed 0, 16 × 160×120, the
    suite's upload and configuration) associated with the loop pass
    (``--loop-stride 1``) and without it."""
    from sift_scale_space_extrema_detection_tpu_torch.models import slam as pslam

    images = slam_bench.to_uint16(slam_bench.render_loop_sequence(
        np.random.default_rng(0), LOOP_ROW_FRAMES, 160, 120)[0])
    described = pslam.describe_frames(images, slam_bench.configs()[0], device="cpu",
                                      blur="separable")
    k_mat = slam_bench._intrinsics(160, 120)
    return [pslam.build_tracks_from_described(described, k_mat, reassoc_window=2,
                                              loop_stride=stride, device="cpu")[1]
            for stride in (1, 0)]


def test_suite_row_of_the_loop_runs_the_loop_pass(monkeypatch, tmp_path):
    """The port's loop row with ``loop_stride=1`` (16 × 160×120): its SLAM
    gets the tracks of the association with the loop pass on the row's
    keypoints, which merged tracks that the association without it leaves
    apart. (The row against the JAX script's: the test below.)"""
    from sift_scale_space_extrema_detection_tpu_torch.models import slam as pslam

    seen, real = [], pslam.run_slam

    def run_slam(pixels, visible, *args, **kwargs):
        seen.append(np.array(visible))
        return real(pixels, visible, *args, **kwargs)

    monkeypatch.setattr(pslam, "run_slam", run_slam)
    row, = slam_bench.run(frames=LOOP_ROW_FRAMES, size="160x120", suite=True, seeds=1,
                          shapes=("loop",), loop_stride=1, render_cache=str(tmp_path),
                          **CPU)["rows"]
    merged, apart = _loop_row_tracks()
    np.testing.assert_array_equal(seen[0], merged)
    assert merged.shape[1] < apart.shape[1] - 20 and row["lm"] > 20


@pytest.mark.slow
def test_suite_row_of_the_loop_with_loop_association_is_the_scripts(monkeypatch, tmp_path):
    """The loop row with ``--loop-stride 1`` at 16 × 160×120 against the
    script's, and the loop pass merged tracks in both packages (slow: the
    JAX package compiles its association and its float64 back end, ~80 s)."""
    argv = ["--suite", "--seeds", "1", "--frames", str(LOOP_ROW_FRAMES), "--size", "160x120",
            "--loop-stride", "1"]
    (_, visible), = _same_suite_rows(monkeypatch, tmp_path, argv, ("loop",), LOOP_ROW_FRAMES,
                                     loop_stride=1)
    merged, apart = _loop_row_tracks()
    np.testing.assert_array_equal(visible, merged)
    assert merged.shape[1] < apart.shape[1] - 20


@pytest.mark.slow
def test_suite_of_the_four_shapes_is_the_scripts(monkeypatch, tmp_path):
    _same_suite_rows(monkeypatch, tmp_path,
                     ["--suite", "--seeds", "1", "--frames", "8", "--size", "160x120"],
                     tuple(slam_bench.RENDERS), 8)
