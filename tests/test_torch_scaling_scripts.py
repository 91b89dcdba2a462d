"""The port's scaling scripts (``…_torch/benchmarks/``: ``scatter_probe``,
``scaling_bench``, ``multihost_bench``) against the JAX package's
``benchmarks/{scatter_probe,scaling_bench,multihost_bench}.py``, on the CPU.

The scripts are read with ``ast``, never imported: ``scatter_probe.py``
runs its whole probe at import and turns on JAX's persistent compilation
cache; the other two do their work in ``main``. Their parsers, key
patterns, input lines and the probe's functions are taken out of the
source and run here; JAX runs on the CPU with its persistent compilation
cache off.

- Flags and defaults: the script's, with ``--device`` added; the one
  exception is ``scaling_bench --devices`` (the visible cards, 2 gloo ranks
  on the CPU: the script's 8 was the size of its virtual CPU mesh).
- Keys: the script's key pattern at the flag values, plus ``device``,
  ``launches`` (scaling) and ``transport`` (multihost), and the probe's
  sorted row.
- ``scatter_probe``: the inputs equal the script's lines run with numpy;
  A, B and C equal the script's functions run in JAX on the same inputs
  within 1e-5 of the largest magnitude; D's relative error is finite in
  both (recorded as properties of the test).
- ``scaling_bench``: its three legs at world 1 and 2 on gloo, one run of
  each world per test run (``tests/torch_dist_ranks.py::shared_run``), at a
  toy size: the frontend's fields bit-equal across worlds, the BA's cost
  within 1e-3 of world 1's and of the JAX package's
  ``distributed_bundle_adjust`` on one CPU device, the SLAM ATE within 0.02
  of world 1's.
- ``multihost_bench``: its two legs through ``torchrun`` on gloo reach the
  same cost; a gap between them raises.
"""

import argparse
import ast
import copy
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_scale_space_extrema_detection_tpu.parallel import (
    distributed_bundle_adjust as jax_distributed_bundle_adjust,
    make_mesh as jax_make_mesh,
)
from sift_scale_space_extrema_detection_tpu.sfm.ba import (
    BAState as JaxBAState,
    Observations as JaxObservations,
)
from sift_scale_space_extrema_detection_tpu_torch.benchmarks import (
    ba_bench,
    multihost_bench,
    scaling_bench,
    scatter_probe,
)

from tests.torch_dist_ranks import shared_run

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = {name: REPO / "benchmarks" / f"{name}.py"
           for name in ("scatter_probe", "scaling_bench", "multihost_bench")}
PORT = {"scatter_probe": scatter_probe, "scaling_bench": scaling_bench,
        "multihost_bench": multihost_bench}
CPU = dict(device="cpu")
REL = 1e-5  # A, B and C against the script's functions, of the largest magnitude
# scaling_bench's legs at a toy size: 2 frames of 48×64 a rank, a BA of
# 6 × 120 × 40, 8 frames of 160×120 of composed SLAM.
SCALING_SPEC = dict(device="cpu", devices=2, batch_per_device=2, frame_size=[48, 64],
                    ba=[6, 120, 40], repeats=1, slam_frames=8,
                    slam_size=[160, 120])
TOY_BA = (6, 120, 40)


@pytest.fixture(scope="module", autouse=True)
def _no_persistent_jax_cache():
    before = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", before)


def _tree(name) -> ast.Module:
    return ast.parse(SCRIPTS[name].read_text(), filename=str(SCRIPTS[name]))


def _main(name) -> ast.FunctionDef:
    return next(n for n in _tree(name).body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _exec(nodes, ns, name):
    exec(compile(ast.Module(body=list(nodes), type_ignores=[]), str(SCRIPTS[name]), "exec"), ns)
    return ns


def _script_parser(name) -> argparse.ArgumentParser:
    """The statements of the script's ``main`` that build its parser."""
    body = []
    for node in _main(name).body:
        if ast.unparse(node).startswith("args = ap.parse_args()"):
            break
        body.append(node)
    return _exec(body, {"argparse": argparse}, name)["ap"]


def _options(parser) -> set:
    return {s for a in parser._actions for s in a.option_strings if s.startswith("--")}


def _f_key(node, **names) -> str:
    """A key the script writes as an f-string, at ``names``' values."""
    return eval(compile(ast.Expression(node), "<key>", "eval"), dict(names))


def _module_statements(name, first: str, last: str) -> list:
    """The script's module-level statements from the one that starts with
    ``first`` to the one that starts with ``last``."""
    body = _tree(name).body
    src = [ast.unparse(n) for n in body]
    i = next(k for k, s in enumerate(src) if s.startswith(first))
    j = next(k for k, s in enumerate(src) if k >= i and s.startswith(last))
    return body[i:j + 1]


def _e_loop() -> ast.For:
    """The script's loop over E's widths."""
    return next(n for n in _tree("scatter_probe").body
                if isinstance(n, ast.For) and getattr(n.target, "id", None) == "w")


def _constants(name) -> dict:
    return {n.targets[0].id: n.value.value for n in _tree(name).body
            if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
            and isinstance(n.value, ast.Constant)}


# --- (a) flags and defaults ------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_flags_are_the_scripts(name):
    """The script's flags plus ``--device`` (``scatter_probe.py`` has none),
    each with the script's default, but for ``scaling_bench --devices``."""
    port_ap = PORT[name].build_parser()
    port_args = vars(port_ap.parse_args([]))
    if name == "scatter_probe":
        assert not any(isinstance(n, ast.FunctionDef) and n.name == "main"
                       for n in _tree(name).body)
        assert _options(port_ap) == {"--help", "--device"}
        return
    jax_ap = _script_parser(name)
    assert _options(port_ap) == _options(jax_ap) | {"--device"}
    for dest, value in vars(jax_ap.parse_args([])).items():
        if (name, dest) == ("scaling_bench", "devices"):
            assert value == 8 and port_args[dest] is None
        else:
            assert port_args[dest] == value, dest
    assert port_args["device"] == "cuda"


def test_scatter_probe_constants_are_the_scripts():
    want = _constants("scatter_probe")
    assert (scatter_probe.O, scatter_probe.L, scatter_probe.C, scatter_probe.ITERS) == (
        want["O"], want["L"], want["C"], want["ITERS"])
    loop = _e_loop()
    assert scatter_probe.GATHER_WIDTHS == ast.literal_eval(loop.iter)


@pytest.mark.parametrize("main, argv, cards", [
    (scaling_bench.main, ["--devices", "2"], 1),
    (scaling_bench.main, ["--devices", "0"], 1),
    (multihost_bench.main, [], 1),
    (multihost_bench.main, ["--nproc", "3"], 4),
    (multihost_bench.main, ["--nproc", "1"], 4),
], ids=["scaling-over-the-cards", "scaling-no-rank", "multihost-one-card",
        "multihost-uneven-hosts", "multihost-one-host"])
def test_a_world_the_cards_cannot_hold_exits(main, argv, cards, monkeypatch, capsys):
    """A world larger than the visible cards (or that does not split into
    the hosts asked for) exits non-zero before anything runs; it is never
    shrunk."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


# --- scatter_probe: inputs, rows and keys ---------------------------------------------


def _script_inputs() -> dict:
    """The script's inputs by its own lines, numpy only: the input lines
    (``rng = ...`` to ``pad_mask = ...``), C's one-hot lines and the draws
    of E's loop (its first two statements, ``jax.device_put`` left out)."""
    ns = dict(np=np, **{k: v for k, v in _constants("scatter_probe").items()
                        if k in ("O", "L", "C")})
    _exec(_module_statements("scatter_probe", "rng = np.random.default_rng(0)", "pad_mask = "),
          ns, "scatter_probe")
    _exec(_module_statements("scatter_probe", "onehot_np = ", "onehot_np[np.arange(L)"), ns,
          "scatter_probe")
    loop = _e_loop()
    draws = ast.For(target=loop.target, iter=loop.iter, orelse=[],
                    body=loop.body[:2] + [ast.parse("gather[w] = (dw, gi)").body[0]])
    ns.update(gather={}, jax=argparse.Namespace(device_put=lambda a: a))
    return _exec([ast.fix_missing_locations(draws)], ns, "scatter_probe")


def test_scatter_inputs_are_the_scripts():
    want = _script_inputs()
    got = scatter_probe.make_inputs()
    assert got["M"] == want["M"]
    for key in ("counts", "seg_sorted", "perm", "seg_unsorted", "cam_ids", "data12", "data18",
                "starts", "pad_idx", "pad_mask", "cam_pad"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(got["onehot"], want["onehot_np"])
    np.testing.assert_array_equal(got["ends"], want["starts"] + want["counts"] - 1)
    assert list(got["gather"]) == list(want["gather"])
    for w, (rows, idx) in got["gather"].items():
        np.testing.assert_array_equal(rows, want["gather"][w][0])
        np.testing.assert_array_equal(idx, want["gather"][w][1])


def _script_functions(inp) -> dict:
    """The script's A-D functions, jitted as it jits them, with its globals
    (``L``, ``C``, ``M``, D's ``ends`` and ``starts_d``) for ``inp``."""
    names = ("seg_scatter12", "seg_scatter18_pair", "padded_gather_sum", "w_onehot",
             "w_onehot_build", "cumsum_bound")
    defs = [n for n in _tree("scatter_probe").body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    ns = dict(jax=jax, jnp=jnp, np=np, L=inp["l"], C=inp["c"], M=inp["M"],
              starts=inp["starts"], counts=inp["counts"])
    _exec(_module_statements("scatter_probe", "ends = ", "starts_d = "), ns, "scatter_probe")
    return _exec(defs, ns, "scatter_probe")


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= REL * scale, (got, want)


def test_scatter_rows_are_the_scripts_functions(record_property):
    """A, B and C of the port against the script's JAX functions on the
    script's inputs; D's relative error (against the scatter on sorted ids,
    as the script takes it) finite in both; the production route equal to
    A within the same tolerance and the same bits on a rerun."""
    inp = scatter_probe.make_inputs()
    fns = _script_functions(inp)
    l, c = inp["l"], inp["c"]
    t = {k: torch.from_numpy(np.ascontiguousarray(inp[k]))
         for k in ("data12", "data18", "pad_mask", "onehot")}
    ids = {k: torch.from_numpy(inp[k]).long()
           for k in ("seg_unsorted", "seg_sorted", "cam_ids", "pad_idx", "cam_pad", "starts",
                     "ends")}
    j = {k: jnp.asarray(inp[k]) for k in ("data12", "data18", "pad_mask", "onehot", "cam_pad")}
    j_ids = {k: jnp.asarray(inp[k].astype(np.int32))
             for k in ("seg_unsorted", "seg_sorted", "cam_ids", "pad_idx")}

    a12 = scatter_probe.segment_scatter(t["data12"], ids["seg_unsorted"], l)
    _close(a12, fns["seg_scatter12"](j["data12"], j_ids["seg_unsorted"]))
    _close(scatter_probe.pair_scatter(t["data18"], ids["seg_unsorted"], ids["cam_ids"], l, c),
           fns["seg_scatter18_pair"](j["data18"], j_ids["seg_unsorted"], j_ids["cam_ids"]))
    _close(scatter_probe.padded_gather_sum(t["data12"], ids["pad_idx"], t["pad_mask"]),
           fns["padded_gather_sum"](j["data12"], j_ids["pad_idx"], j["pad_mask"]))
    _close(scatter_probe.w_onehot(t["data18"], ids["pad_idx"], t["pad_mask"], t["onehot"]),
           fns["w_onehot"](j["data18"], j_ids["pad_idx"], j["pad_mask"], j["onehot"]))
    _close(scatter_probe.w_onehot_build(t["data18"], ids["pad_idx"], t["pad_mask"],
                                        ids["cam_pad"], c),
           fns["w_onehot_build"](j["data18"], j_ids["pad_idx"], j["pad_mask"], j["cam_pad"]))

    got_d = scatter_probe.cumsum_bound(t["data12"], ids["starts"], ids["ends"])
    ref_d = scatter_probe.segment_scatter(t["data12"], ids["seg_sorted"], l)
    port_err = float((ref_d - got_d).abs().max() / (ref_d.abs().max() + 1e-9))
    want_ref = jax.ops.segment_sum(j["data12"], j_ids["seg_sorted"], l)
    want_d = fns["cumsum_bound"](j["data12"])
    jax_err = float(jnp.max(jnp.abs(want_ref - want_d)) / (jnp.max(jnp.abs(want_ref)) + 1e-9))
    record_property("D_rel_err_port", port_err)
    record_property("D_rel_err_script", jax_err)
    assert np.isfinite(port_err) and np.isfinite(jax_err)
    _close(got_d, want_d)

    sorted_sum = scatter_probe.sorted_segment_sum(t["data12"], ids["seg_unsorted"], l)
    _close(sorted_sum, a12.numpy())
    assert torch.equal(sorted_sum,
                       scatter_probe.sorted_segment_sum(t["data12"], ids["seg_unsorted"], l))


def _scatter_script_rows() -> dict:
    """Every row the script writes into ``results`` with its inner keys (E's
    at each width of its loop)."""
    tree = _tree("scatter_probe")
    widths = ast.literal_eval(_e_loop().iter)
    rows = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or not isinstance(node.targets[0], ast.Subscript):
            continue
        target = node.targets[0]
        if isinstance(target.value, ast.Subscript):  # results[row][key] = ...
            rows[target.value.slice.value].add(target.slice.value)
        elif getattr(target.value, "id", None) == "results":
            keys = {k.value for k in node.value.keys}
            if isinstance(target.slice, ast.JoinedStr):
                rows.update({_f_key(target.slice, w=w): set(keys) for w in widths})
            else:
                rows[target.slice.value] = keys
    return rows


def test_scatter_probe_returns_the_scripts_rows():
    """The script's rows, each with its keys, the production route's row
    and ``device``; every reading finite. (A smaller probe: the keys do not
    depend on the size.)"""
    got = scatter_probe.run(o=2048, l=256, c=10, iters=1, **CPU)
    want = _scatter_script_rows()
    assert len(want) == 11
    assert set(got) == set(want) | {"A_sorted_segment_sum_12w", "device"}
    for row, keys in want.items():
        assert keys <= set(got[row]), row
        assert all(np.isfinite(v) for v in got[row].values()), row
    assert got["device"] == "cpu"
    assert got["A_sorted_segment_sum_12w"]["rerun_max_diff"] == 0.0
    assert got["A_sorted_segment_sum_12w"]["abs_err_vs_A"] <= 1e-5


# --- scaling_bench: the legs at world 1 and 2 ------------------------------------------


@pytest.fixture(scope="module")
def scaling_records(tmp_path_factory) -> dict:
    """World → every rank's record of ``scaling_bench``'s legs at
    ``SCALING_SPEC``, one run of each world per test run."""
    inputs = {"scaling_legs/spec": np.asarray(json.dumps(SCALING_SPEC))}
    records = {}
    for world in (1, 2):
        out, _ = shared_run(tmp_path_factory, f"scaling_w{world}", ["scaling_legs"],
                            lambda: inputs, world=world)
        records[world] = json.loads(str(out["scaling_legs/records"]))
    return records


def test_scaling_legs_agree_across_worlds(scaling_records):
    """Every rank the same bits; the frontend's fields of world 1's frames
    bit-equal at world 2; the BA's reruns bit-equal, its cost within 1e-3 of
    world 1's (and world 1's of ``bundle_adjust``'s); the SLAM ATE within
    0.02 of world 1's. ``scaling_bench.check`` holds the same bars."""
    one, two = scaling_records[1], scaling_records[2]
    assert [len(one), len(two)] == [1, 2]
    for leg in ("frontend", "ba", "slam"):
        assert two[0][leg]["digest"] == two[1][leg]["digest"], leg
    frames = one[0]["frontend"]["frame_digests"]
    assert len(frames) == 2 and two[0]["frontend"]["frame_digests"][:2] == frames
    assert one[0]["ba"]["reruns_equal"] and two[0]["ba"]["reruns_equal"]
    cost1 = one[0]["ba"]["cost"]
    assert abs(two[0]["ba"]["cost"] - cost1) <= 1e-3 * max(1.0, cost1)
    assert abs(one[0]["ba"]["single_cost"] - cost1) <= 1e-3 * max(1.0, cost1)
    assert np.isfinite(one[0]["slam"]["ate"])
    assert abs(two[0]["slam"]["ate"] - one[0]["slam"]["ate"]) <= 0.02
    scaling_bench.check(scaling_records)


def test_scaling_ba_cost_is_the_jax_packages(scaling_records):
    """World 1's cost against the JAX package's ``distributed_bundle_adjust``
    on one CPU device, on the same arrays (``ba_bench.problem_arrays``)."""
    p = ba_bench.problem_arrays(np.random.default_rng(0), *TOY_BA)
    state = JaxBAState(*(jnp.asarray(p[k]) for k in ("rotations", "translations", "points",
                                                      "k_mat")))
    obs = JaxObservations(jnp.asarray(p["camera"]), jnp.asarray(p["landmark"]),
                          jnp.asarray(p["uv"]), jnp.ones(p["camera"].shape[0], bool))
    _, cost = jax_distributed_bundle_adjust(state, obs, jax_make_mesh(1),
                                            num_iterations=scaling_bench.BA_ITERATIONS)
    want = float(cost)
    assert abs(scaling_records[1][0]["ba"]["cost"] - want) <= 1e-3 * max(1.0, want)


def _scaling_script_keys(devices: int) -> set:
    """The keys the script's ``main`` writes at ``--devices devices``."""
    keys = set()
    for node in ast.walk(_main("scaling_bench")):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys}
        elif (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
              and getattr(node.value, "id", None) == "results"):
            if isinstance(node.slice, ast.JoinedStr):
                keys |= {_f_key(node.slice, n_dev=n) for n in (1, devices)}
            elif isinstance(node.slice, ast.Constant):
                keys.add(node.slice.value)
    return keys


def test_scaling_bench_returns_the_scripts_keys(scaling_records):
    """``summarize`` of the legs' records (``run`` adds ``device``): the
    script's keys at ``--devices 2``, plus ``launches`` (each leg's counts of
    the three path kernels: none on the CPU)."""
    got = scaling_bench.summarize(scaling_records, 2, os.cpu_count())
    assert set(got) | {"device"} == _scaling_script_keys(2) | {"device", "launches"}
    assert got["devices"] == 2 and got["host_cores"] == os.cpu_count()
    assert all(np.isfinite(v) for v in got.values() if isinstance(v, float))
    assert set(got["launches"]) == {"frontend", "slam"}
    assert all(v == 0 for leg in got["launches"].values() for v in leg.values())


@pytest.mark.parametrize("gap", ["ranks", "frontend", "ba_rerun", "ba_cost", "ba_single",
                                 "slam_ate"])
def test_scaling_check_refuses_a_gap(scaling_records, gap):
    records = copy.deepcopy(scaling_records)
    two = records[2]
    if gap == "ranks":
        two[1]["slam"]["digest"] = "0"
    elif gap == "frontend":
        two[0]["frontend"]["frame_digests"][0] = "0"
    elif gap == "ba_rerun":
        two[0]["ba"]["reruns_equal"] = False
    elif gap == "ba_cost":
        two[0]["ba"]["cost"] = 1.01 * max(1.0, records[1][0]["ba"]["cost"])
    elif gap == "ba_single":
        records[1][0]["ba"]["single_cost"] = 1.01 * max(1.0, records[1][0]["ba"]["cost"])
    else:
        two[0]["slam"]["ate"] = records[1][0]["slam"]["ate"] + 0.03
    with pytest.raises(RuntimeError, match="scaling_bench"):
        scaling_bench.check(records)


# --- multihost_bench: two legs through torchrun on gloo --------------------------------


def test_multihost_legs_reach_the_same_cost_and_the_scripts_keys():
    """Both legs (2 gloo ranks each, started by torchrun) end at the same
    cost; the output holds the script's keys with 8 replaced by the world,
    ``transport`` and ``device``."""
    legs, real = [], multihost_bench.run_leg

    def recorded(*args, **kw):
        legs.append(real(*args, **kw))
        return legs[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(multihost_bench, "run_leg", recorded)
        got = multihost_bench.run(ba_size=TOY_BA, repeats=1, **CPU)
    assert len(legs) == 2 and legs[0]["cost"] == legs[1]["cost"]
    printed = next(n for n in ast.walk(_main("multihost_bench")) if isinstance(n, ast.Dict))
    want = {(k.value if isinstance(k, ast.Constant)
             else _f_key(k, args=argparse.Namespace(nproc=2))).replace("_8dev", "_2dev")
            for k in printed.keys}
    assert set(got) == want | {"transport", "device"}
    assert got["transport"] == {"1proc": ["gloo"], "2proc": ["gloo"]}
    assert got["process_boundary_retention"] > 0


def test_multihost_refuses_legs_that_part(monkeypatch):
    costs = iter([10.0, 10.5])
    monkeypatch.setattr(multihost_bench, "run_leg", lambda *a, **k: dict(
        iters_per_s=1.0, cost=next(costs), transport=["gloo"]))
    with pytest.raises(RuntimeError, match="costs 10.0 and 10.5"):
        multihost_bench.run(**CPU)


@pytest.mark.parametrize("log, want", [
    ("NCCL INFO Channel 00/0 : 0[0] -> 1[1] via P2P/CUMEM/read\n"
     "NCCL INFO Channel 01/0 : 1[1] -> 0[0] via P2P/CUMEM/read\n", ["P2P/CUMEM/read"]),
    ("Channel 00/0 : 1[1] -> 2[2] [send] via NET/Socket/0\n"
     "Channel 00/0 : 0[0] -> 1[1] via P2P/CUMEM/read\n", ["NET/Socket/0", "P2P/CUMEM/read"]),
], ids=["one-host", "two-hosts"])
def test_multihost_reads_the_transports_nccl_names(log, want):
    assert multihost_bench.transports(log) == want
    assert multihost_bench.host_id(3, 4, 2) == "sift-host-1"
