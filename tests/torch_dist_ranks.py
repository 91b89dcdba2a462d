"""The ranks of the port's gloo process groups in the CPU tests.

A test module hands :func:`shared_run` the names of scenarios and their
numpy inputs. ``world`` processes of this file join one gloo group over a
file store (no TCP port) through ``parallel.initialize_multihost``, build a
CPU mesh, and run every scenario in order on the same inputs. Rank 0 writes
every scenario's outputs; the SHA-256 of each rank's outputs is gathered,
so that a test can require all ranks to agree bit for bit. Every collective
has a 60 s limit, the parent kills every rank when one fails or the run
outlives its limit, and the group is destroyed at the end.

Run as a script only by :func:`run_ranks`:
``python tests/torch_dist_ranks.py RANK WORLD WORKDIR NAME...``.
"""

from __future__ import annotations

import datetime
import fcntl
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
THREADS = 2  # torch threads of each rank
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)

# The mirrors' configurations (tests/test_distributed.py, tests/test_multihost.py,
# tests/test_slam.py:167, tests/test_visual_slam.py:100 and :145).
FRONTEND_CFG = dict(num_octaves=2, max_keypoints_per_trio=64)
TRACKS_CFG = dict(num_octaves=2, max_keypoints_per_trio=128)
VISUAL_CFG = dict(num_octaves=3, max_keypoints_per_trio=256)
ORBIT_SLAM_CFG = dict(ba_interval=4)
VISUAL_SLAM_CFG = dict(ba_interval=3, ba_window=6, bootstrap_baseline=2)
REFERENCE_THRESHOLD = 4096  # SlamConfig.dist_ba_min_landmarks
THRESHOLDS = (REFERENCE_THRESHOLD, 0)

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _cpu():
    return dict(device="cpu")


def _state_obs(inp, prefix, mesh):
    """The port's ``BAState`` and ``Observations`` of the arrays under
    ``prefix``, replicated from rank 0 (``replicate_global``)."""
    import torch

    from sift_scale_space_extrema_detection_tpu_torch.parallel import replicate_global
    from sift_scale_space_extrema_detection_tpu_torch.sfm.ba import BAState, Observations

    def get(key):
        return replicate_global(torch.from_numpy(inp[f"{prefix}.{key}"]), mesh)

    state = BAState(*(get(k) for k in ("rotations", "translations", "points", "k_mat")))
    obs = Observations(*(get(k) for k in ("camera", "landmark", "uv", "valid")))
    return state, obs


def _problems(inp):
    return sorted({k.split(".")[0] for k in inp if k.endswith(".rotations")})


@scenario
def bundle_adjust(inp, mesh):
    """``distributed_bundle_adjust`` on every problem of the inputs, each
    with its ``<name>.iterations`` and ``<name>.huber`` (NaN: none)."""
    from sift_scale_space_extrema_detection_tpu_torch.parallel import (
        distributed_bundle_adjust,
    )

    out = {}
    for name in _problems(inp):
        state, obs = _state_obs(inp, name, mesh)
        huber = float(inp[f"{name}.huber"])
        refined, cost = distributed_bundle_adjust(
            state, obs, mesh, num_iterations=int(inp[f"{name}.iterations"]),
            huber_delta=None if np.isnan(huber) else huber,
        )
        for key in ("rotations", "translations", "points"):
            out[f"{name}.{key}"] = getattr(refined, key).numpy()
        out[f"{name}.cost"] = cost.numpy()
        again, cost_again = distributed_bundle_adjust(
            state, obs, mesh, num_iterations=int(inp[f"{name}.iterations"]),
            huber_delta=None if np.isnan(huber) else huber,
        )
        out[f"{name}.rerun_equal"] = np.asarray(
            all(np.array_equal(getattr(again, k).numpy(), out[f"{name}.{k}"])
                for k in ("rotations", "translations", "points"))
            and np.array_equal(cost_again.numpy(), out[f"{name}.cost"])
        )
    return out


def _described(out):
    import dataclasses

    return {f.name: getattr(out, f.name).numpy() for f in dataclasses.fields(out)}


@scenario
def frontend(inp, mesh):
    """The data-parallel frontend on ``images`` (tests/test_distributed.py's
    configuration), on the fused path and, under ``separable.``, blur by
    blur (``blur="separable"``)."""
    import sift_scale_space_extrema_detection_tpu_torch as port
    from sift_scale_space_extrema_detection_tpu_torch.parallel import (
        detect_and_describe_data_parallel,
    )

    cfg = port.SiftConfig(**FRONTEND_CFG)
    got = detect_and_describe_data_parallel(inp["images"], cfg, mesh)
    blurred = detect_and_describe_data_parallel(inp["images"], cfg, mesh, blur="separable")
    return {**_described(got),
            **{f"separable.{k}": v for k, v in _described(blurred).items()}}


@scenario
def keyframe_matching(inp, mesh):
    import torch

    from sift_scale_space_extrema_detection_tpu_torch.parallel import (
        match_against_keyframes_sharded,
    )

    idx, dist_, valid = match_against_keyframes_sharded(
        *(torch.from_numpy(inp[k]) for k in ("q", "qv", "kf", "kfv")), mesh
    )
    return dict(index=idx.numpy(), distance=dist_.numpy(), valid=valid.numpy())


@scenario
def multihost(inp, mesh):
    """``put_global`` and ``replicate_global`` on their own: every rank's
    slice gathered back, and rank 0's copy of a rank-dependent array."""
    import torch
    import torch.distributed as dist

    from sift_scale_space_extrema_detection_tpu_torch.parallel import (
        put_global,
        replicate_global,
    )
    from sift_scale_space_extrema_detection_tpu_torch.parallel.distributed import (
        all_gather_rows,
    )

    rows = inp["rows"]
    shard = put_global(rows, mesh)
    mine = torch.full((3,), float(dist.get_rank() + 7))
    return dict(
        shard_rows=np.asarray(shard.shape[0]),
        gathered=all_gather_rows(shard, mesh).numpy(),
        replicated=replicate_global(mine, mesh).numpy(),
    )


@scenario
def card_exchange(inp, mesh):
    """``parallel/multihost.py``'s exchange of every rank's card identity
    through the group's store, as ``global_mesh`` runs it under NCCL, once
    for each case ``inp[name]``: row 0 each rank's card index, row 1 the
    physical card it names (its UUID); ``_require_own_cards`` must pass
    where the physical cards differ and raise where two ranks meet on one."""
    import torch.distributed as dist

    from sift_scale_space_extrema_detection_tpu_torch.parallel import multihost

    rank = dist.get_rank()
    out = {}
    for name in sorted(k for k in inp if k != "cfg"):
        card, physical = (int(v) for v in inp[name][:, rank])
        cards = multihost._rank_cards(["host", card, f"GPU-{physical}"])
        out[f"{name}.cards"] = np.asarray([c for _, c, _ in cards])
        try:
            multihost._require_own_cards(cards)
            out[f"{name}.error"] = np.asarray("")
        except RuntimeError as exc:
            out[f"{name}.error"] = np.asarray(str(exc))
    return out


def _counting(slam):
    """Count the single-device BAs of ``models/slam.py`` (a wrapper of its
    ``bundle_adjust``); returns a function that reads ``(single, sharded)``
    calls since the wrapper was installed."""
    from sift_scale_space_extrema_detection_tpu_torch.parallel import (
        distributed_bundle_adjust,
    )

    inner = slam.bundle_adjust
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return inner(*args, **kwargs)

    slam.bundle_adjust = counted
    base = distributed_bundle_adjust.calls

    def read():
        return np.asarray([calls[0], distributed_bundle_adjust.calls - base])

    def restore():
        slam.bundle_adjust = inner

    return read, restore


def _result(prefix, result):
    return {
        f"{prefix}.rotations": result.rotations,
        f"{prefix}.translations": result.translations,
        f"{prefix}.points": result.points,
        f"{prefix}.landmark_valid": result.landmark_valid,
        f"{prefix}.num_observations": np.asarray(result.num_observations),
    }


@scenario
def slam_orbit(inp, mesh):
    """``run_slam(mesh=…)`` on the orbit sequences of the inputs
    (``<name>.pixels``, ``.visible``, ``.k_mat``, ``.cfg`` as JSON), at the
    reference's threshold and at 0, with the BA counts of each run."""
    import sift_scale_space_extrema_detection_tpu_torch as port
    from sift_scale_space_extrema_detection_tpu_torch.models import slam

    out = {}
    names = sorted({k.split(".")[0] for k in inp if k.endswith(".pixels")})
    for name in names:
        cfg = json.loads(str(inp[f"{name}.cfg"]))
        for threshold in THRESHOLDS:
            read, restore = _counting(slam)
            try:
                result = port.run_slam(
                    inp[f"{name}.pixels"], inp[f"{name}.visible"], inp[f"{name}.k_mat"],
                    port.SlamConfig(**cfg, dist_ba_min_landmarks=threshold), mesh=mesh,
                    **_cpu(),
                )
            finally:
                out[f"{name}_{threshold}.ba_calls"] = read()
                restore()
            out.update(_result(f"{name}_{threshold}", result))
    return out


@scenario
def tracks(inp, mesh):
    """``build_tracks_from_images(mesh=…)`` on ``images``
    (tests/test_visual_slam.py:100's configuration)."""
    import sift_scale_space_extrema_detection_tpu_torch as port

    pixels, visible, counts = port.build_tracks_from_images(
        inp["images"], port.SiftConfig(**TRACKS_CFG), k_mat=inp["k_mat"], mesh=mesh, **_cpu()
    )
    return dict(pixels=pixels, visible=visible, counts=counts)


@scenario
def visual_slam(inp, mesh):
    """``run_slam_from_images(mesh=…)`` on ``images`` at the reference's
    threshold and at 0, and ``SlamSession(mesh=…)`` over the same frames at
    0, each with its BA counts (tests/test_visual_slam.py:145's sequence).
    The back end runs in float64: in float32 this short sequence turns the
    last bits that the sums over the ranks move into a trajectory outside
    the mirror's bars; in float64 the two runs meet them."""
    import torch

    import sift_scale_space_extrema_detection_tpu_torch as port
    from sift_scale_space_extrema_detection_tpu_torch.models import slam

    sift = port.SiftConfig(**VISUAL_CFG)
    out = {}
    for threshold in THRESHOLDS:
        cfg = port.SlamConfig(**VISUAL_SLAM_CFG, dist_ba_min_landmarks=threshold)
        read, restore = _counting(slam)
        try:
            result = port.run_slam_from_images(
                inp["images"], inp["k_mat"], sift, cfg, mesh=mesh, reassoc_window=2,
                dtype=torch.float64, **_cpu()
            )
        finally:
            out[f"batch_{threshold}.ba_calls"] = read()
            restore()
        out.update(_result(f"batch_{threshold}", result))
    cfg = port.SlamConfig(**VISUAL_SLAM_CFG, dist_ba_min_landmarks=0)
    read, restore = _counting(slam)
    try:
        sess = port.SlamSession(inp["k_mat"], sift, cfg, reassoc_window=2, mesh=mesh,
                                dtype=torch.float64, **_cpu())
        updates = sum(sess.add_frame(image) is not None for image in inp["images"])
        result = sess.finalize()
    finally:
        out["stream.ba_calls"] = read()
        restore()
    out["stream.updates"] = np.asarray(updates)
    out.update(_result("stream", result))
    return out


def _digest(out: dict) -> str:
    h = hashlib.sha256()
    for key in sorted(out):
        h.update(key.encode())
        h.update(np.ascontiguousarray(out[key]).tobytes())
    return h.hexdigest()


def _rank_main(rank: int, world: int, workdir: Path, names: list[str]) -> None:
    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist

    from sift_scale_space_extrema_detection_tpu_torch.parallel import (
        initialize_multihost,
        make_mesh,
    )

    torch.set_num_threads(THREADS)
    initialize_multihost(
        f"file://{workdir / 'store'}", world, rank, backend="gloo", timeout=COLLECTIVE_TIMEOUT
    )
    try:
        mesh = make_mesh(world, device_type="cpu")
        inputs = dict(np.load(workdir / "inputs.npz"))
        results, digests = {}, {}
        for name in names:
            prefix = f"{name}/"
            got = SCENARIOS[name](
                {k[len(prefix):]: v for k, v in inputs.items() if k.startswith(prefix)}, mesh
            )
            digests[name] = _digest(got)
            results.update({prefix + k: np.asarray(v) for k, v in got.items()})
        every = [None] * world
        dist.all_gather_object(every, digests)
        if rank == 0:
            np.savez(workdir / "outputs.npz", **results)
            (workdir / "digests.json").write_text(json.dumps(every))
    finally:
        dist.destroy_process_group()


def run_ranks(names, inputs: dict, workdir: Path, world: int = WORLD, timeout: float = 300.0):
    """Run the scenarios ``names`` on ``inputs`` (keys ``"<scenario>/<key>"``)
    in ``world`` ranks; returns ``(rank 0's outputs, every rank's digests)``.
    Raises with the ranks' output when one fails or the run outlives
    ``timeout`` seconds (every rank is killed then)."""
    workdir.mkdir(parents=True, exist_ok=True)
    np.savez(workdir / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS))
    logs, procs = [], []
    for rank in range(world):
        log = open(workdir / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(rank), str(world), str(workdir), *names],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
        ))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if any(p.returncode != 0 for p in procs):
        text = "\n".join(
            f"--- rank {r} (exit {p.returncode}):\n{(workdir / f'rank{r}.log').read_text()[-4000:]}"
            for r, p in enumerate(procs)
        )
        raise RuntimeError(f"the ranks failed or outlived {timeout} s:\n{text}")
    return _read(workdir)


def _read(workdir: Path):
    outputs = dict(np.load(workdir / "outputs.npz"))
    return outputs, json.loads((workdir / "digests.json").read_text())


def shared_run(tmp_path_factory, tag: str, names, make_inputs, timeout: float = 300.0,
               world: int = WORLD):
    """:func:`run_ranks` at ``world`` once per test run, whichever
    pytest-xdist workers ask for it: the first runs it under a file lock in
    the run's shared temporary directory, the others wait and read its
    result (or its error). ``make_inputs()`` builds the inputs."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # shared by the workers of this run only
    workdir = root / f"ranks_{tag}"
    with open(root / f"ranks_{tag}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        failed = workdir / "failed.txt"
        if failed.exists():
            raise RuntimeError(failed.read_text())
        if not (workdir / "digests.json").exists():
            try:
                return run_ranks(names, make_inputs(), workdir, world, timeout)
            except Exception as exc:
                workdir.mkdir(parents=True, exist_ok=True)
                failed.write_text(str(exc))
                raise
    return _read(workdir)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]), sys.argv[4:])
