"""Parallel efficiency of the port's sharded paths: one rank against N.

The port of the JAX package's ``benchmarks/scaling_bench.py``. The script
measured N virtual devices of one XLA process on the host's cores; the port
measures cards over NCCL, one rank a card (with ``--device cpu``, gloo ranks
on the host), each world started by ``python -m torch.distributed.run
--standalone`` (:func:`~.torchrun_ranks`). World 1 runs through torchrun
too, so both worlds pay the same costs. Three legs, each at world 1 and at
world ``--devices``, on the same inputs:

- the data-parallel frontend: ``detect_and_describe_data_parallel`` at the
  port's default ``blur="fused"`` (K1, R2, R1, R3 and R4) on ``--batch-per-device``
  frames of 120×160 a rank (``default_rng(0).random``), 2 octaves, 128
  keypoints a trio; one warm-up call, then 3 timed: ``frontend_fps_{n}dev``
  and ``frontend_scaling_efficiency``;
- the landmark-sharded BA: ``distributed_bundle_adjust`` on
  ``ba_bench.make_problem(default_rng(0), 48, 32768, 512)``, 5 LM
  iterations, one warm-up and 3 timed repeats: ``ba_iters_per_s_{n}dev``,
  ``ba_speedup``, ``ba_scaling_efficiency``; ``ba_1dev_cores_busy``, rank
  0's process time over wall time at world 1 (the host's busy share, as in
  the script), and ``ba_speedup_vs_core_ceiling`` against the script's
  ceiling ``host_cores / busy``, which still holds: the ranks share one
  host's cores;
- composed SLAM: 16 frames of ``slam_bench.render_sequence(default_rng(1),
  16, 320, 240)`` through ``run_slam_from_images(mesh=…,
  reassoc_window=2, blur="separable", frontend_chunk=16 // n)`` (R1, R3 and R4), one
  warm-up and one timed run: ``composed_slam_fps_{n}dev``,
  ``composed_slam_ate`` (world N's, a reading) and
  ``composed_slam_speedup``.

Timing: rank 0's host clock, from a synchronise plus a barrier to the next
(:func:`~.rank_clock`); the frontend's and the BA's times are the mean of
the timed calls. Bars (``RuntimeError``): every rank returns the same bits;
the frontend's fields are bit-equal across worlds; the BA's reruns are
bit-equal, world 1's cost is within 1e-3 of ``bundle_adjust``'s and world
N's within 1e-3 of world 1's; world N's SLAM ATE is within 0.02 of world
1's; on the card each leg launches its kernels (``launches``: each leg's
path kernels over every call of every rank of both worlds), and no rank builds
the kernels (the parent builds them first).

``--devices`` defaults to the visible cards (the script's 8 was the size of
its virtual CPU mesh), and to 2 gloo ranks with ``--device cpu``; a world
larger than the visible cards exits non-zero. Other sizes go through
:func:`run`.

Run: ``python -m sift_scale_space_extrema_detection_tpu_torch.benchmarks.scaling_bench
[--devices N] [--batch-per-device 2] [--device cuda|cpu]``. Prints one JSON
line: the script's keys, ``device`` (the card's ``nvidia-smi`` name and
power limit) and ``launches``.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import SiftConfig
from ..models.slam import SlamConfig, evaluate_ate, run_slam_from_images
from ..ops.kernels import _build
from ..parallel import (
    detect_and_describe_data_parallel,
    distributed_bundle_adjust,
    initialize_multihost,
    make_mesh,
)
from ..parallel.multihost import mesh_device
from ..sfm.ba import bundle_adjust
from . import (
    PATH_KERNELS,
    device_entry,
    digest,
    launch_counts,
    path_kernels,
    path_launches,
    probe_device,
    rank_clock,
    require_launches,
    sync,
    torchrun_ranks,
)
from .ba_bench import make_problem
from .slam_bench import render_sequence

FRAME_SIZE = (120, 160)
FRONTEND_CFG = dict(num_octaves=2, max_keypoints_per_trio=128)
BA_SIZE = (48, 32768, 512)  # cameras, landmarks, observations a camera
BA_ITERATIONS = 5
REPEATS = 3
SLAM_FRAMES = 16
SLAM_SIZE = (320, 240)  # width, height
SLAM_ATE_GAP = 0.02  # world N against world 1 (chip_smoke.py phase 17's bar)
COST_RTOL = 1e-3
COLLECTIVE_TIMEOUT_S = 300
RANKS_TIMEOUT_S = 900
CPU_WORLD = 2
NOTE = ("cards over NCCL, one rank a card (gloo ranks on the host with --device cpu); "
        "relative parallel efficiency")


def world_size(devices, dev: torch.device) -> int:
    """The world of ranks: ``devices``, by default the visible cards (two
    gloo ranks on the CPU). ``SystemExit`` where it exceeds the visible
    cards or is below 1: the world is never shrunk."""
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        n = cards if devices is None else devices
        if n > cards:
            raise SystemExit(f"--devices {n}: {cards} CUDA devices are visible, one rank a card")
    else:
        n = CPU_WORLD if devices is None else devices
    if n < 1:
        raise SystemExit(f"--devices {n}: at least one rank")
    return n


def frontend_leg(mesh, dev, images: np.ndarray, repeats: int = REPEATS) -> dict:
    """The data-parallel frontend on ``images``: one warm-up call, then
    ``repeats`` timed; seconds, launches, the result's digest and each
    frame's."""
    cfg = SiftConfig(**FRONTEND_CFG)
    before = launch_counts()
    out = detect_and_describe_data_parallel(images, cfg, mesh)
    t0 = rank_clock(dev)
    for _ in range(repeats):
        out = detect_and_describe_data_parallel(images, cfg, mesh)
        sync(dev)
    seconds = rank_clock(dev) - t0
    fields = [getattr(out, f.name) for f in dataclasses.fields(out)]
    return dict(seconds=seconds / repeats, frames=len(images), launches=path_launches(before),
                digest=digest(*fields), frame_digests=[digest(*(t[i] for t in fields))
                                                       for i in range(len(images))])


def ba_leg(mesh, dev, size=BA_SIZE, repeats: int = REPEATS, reference: bool = False) -> dict:
    """``distributed_bundle_adjust`` on ``make_problem(default_rng(0),
    *size)`` for ``BA_ITERATIONS`` LM iterations: one warm-up solve, then
    ``repeats`` timed; seconds a solve, the LM iterations, this process's CPU seconds over wall seconds, the
    cost, the digest, whether every solve gave the same bits, and with
    ``reference`` ``bundle_adjust``'s cost on the same problem."""
    state, obs = make_problem(np.random.default_rng(0), *size, device=dev)

    def solve():
        out, cost = distributed_bundle_adjust(state, obs, mesh, num_iterations=BA_ITERATIONS)
        float(cost)
        return out, cost

    solves = [solve()]
    t0 = rank_clock(dev)
    c0 = time.process_time()
    for _ in range(repeats):
        solves.append(solve())
    seconds = rank_clock(dev) - t0
    cpu = time.process_time() - c0
    digests = [digest(s.rotations, s.translations, s.points, cost) for s, cost in solves]
    rec = dict(seconds=seconds / repeats, iterations=BA_ITERATIONS, busy=cpu / seconds,
               cost=solves[-1][1].item(), digest=digests[-1],
               reruns_equal=len(set(digests)) == 1)
    if reference:
        rec["single_cost"] = bundle_adjust(state, obs, num_iterations=BA_ITERATIONS,
                                           device=dev)[1].item()
    return rec


def slam_leg(mesh, dev, world: int, frames: int = SLAM_FRAMES, size=SLAM_SIZE) -> dict:
    """Composed SLAM over the mesh on ``frames`` frames of the dolly: one
    warm-up run, one timed; seconds, ATE, launches, the trajectory's
    digest."""
    images, gt_r, gt_t, k_mat = render_sequence(np.random.default_rng(1), frames, *size)
    sift = SiftConfig(num_octaves=3, max_keypoints_per_trio=256)
    cfg = SlamConfig(ba_interval=4, ba_window=6)
    kw = dict(mesh=mesh, reassoc_window=2, blur="separable",
              frontend_chunk=max(1, frames // world), device=dev)
    before = launch_counts()
    run_slam_from_images(images, k_mat, sift, cfg, **kw)
    t0 = rank_clock(dev)
    res = run_slam_from_images(images, k_mat, sift, cfg, **kw)
    seconds = rank_clock(dev) - t0
    return dict(seconds=seconds, frames=frames, ate=evaluate_ate(res, gt_r, gt_t, device=dev),
                launches=path_launches(before),
                digest=digest(res.rotations, res.translations))


def rank_legs(spec: dict, mesh) -> dict:
    """This rank's record of the three legs as ``spec`` sizes them."""
    dev = mesh_device(mesh)
    world, n = dist.get_world_size(), spec["devices"]
    bpd = spec["batch_per_device"]
    images = np.random.default_rng(0).random((bpd * n, *spec["frame_size"])).astype(np.float32)
    return dict(
        rank=dist.get_rank(), world=world,
        frontend=frontend_leg(mesh, dev, images[:bpd * world], spec["repeats"]),
        ba=ba_leg(mesh, dev, spec["ba"], spec["repeats"], reference=world == 1),
        slam=slam_leg(mesh, dev, world, spec["slam_frames"], spec["slam_size"]),
    )


def join_ranks(spec: dict):
    """Join the group ``torchrun`` describes (NCCL on the card, gloo on the
    CPU) and make the mesh; returns ``(mesh, the kernel build directory's
    files before)``."""
    on_card = spec["device"] == "cuda"
    built = set(os.listdir(_build.BUILD_DIR)) if on_card else set()
    initialize_multihost(backend="nccl" if on_card else "gloo",
                         timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return make_mesh(device_type=spec["device"]), built


def finish_rank(workdir: str, rec: dict, built: set, on_card: bool) -> None:
    """Record whether this rank built kernels (it must load the parent's
    build) and write ``rank<r>.json``."""
    if on_card:
        rec["rebuilt"] = sorted(set(os.listdir(_build.BUILD_DIR)) - built)
    with open(os.path.join(workdir, f"rank{dist.get_rank()}.json"), "w") as f:
        json.dump(rec, f)


def rank_main(workdir: str) -> None:
    """One rank of a world, started by ``torchrun`` (:func:`run`)."""
    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    mesh, built = join_ranks(spec)
    try:
        finish_rank(workdir, rank_legs(spec, mesh), built, spec["device"] == "cuda")
    finally:
        dist.destroy_process_group()


def check(records: dict) -> None:
    """The bars of the module docstring on ``records`` (world → the ranks'
    records); ``RuntimeError`` on the first that fails."""
    def fail(what):
        raise RuntimeError(f"scaling_bench: {what}")

    first = records[1]
    for world, ranks in records.items():
        for leg in ("frontend", "ba", "slam"):
            if len({r[leg]["digest"] for r in ranks}) != 1:
                fail(f"the ranks of world {world} differ in the {leg} leg")
        if not ranks[0]["ba"]["reruns_equal"]:
            fail(f"two BA solves at world {world} differ")
        if any(r.get("rebuilt") for r in ranks):
            fail(f"a rank of world {world} built the kernels")
        frames = first[0]["frontend"]["frame_digests"]
        if ranks[0]["frontend"]["frame_digests"][:len(frames)] != frames:
            fail(f"the frontend's fields at world {world} differ from world 1's on its frames")
        cost, cost1 = ranks[0]["ba"]["cost"], first[0]["ba"]["cost"]
        if abs(cost - cost1) > COST_RTOL * max(1.0, cost1):
            fail(f"the BA's cost at world {world}, {cost}, parts from world 1's, {cost1}")
        ate, ate1 = ranks[0]["slam"]["ate"], first[0]["slam"]["ate"]
        if abs(ate - ate1) > SLAM_ATE_GAP:
            fail(f"the SLAM ATE at world {world}, {ate}, parts from world 1's, {ate1}")
    cost1, single = first[0]["ba"]["cost"], first[0]["ba"]["single_cost"]
    if abs(cost1 - single) > COST_RTOL * max(1.0, single):
        fail(f"the BA's cost at world 1, {cost1}, parts from bundle_adjust's, {single}")


def summarize(records: dict, devices: int, host_cores: int) -> dict:
    """The script's keys from ``records`` (world → the ranks' records; world
    1 and ``devices``), by the script's arithmetic, and ``launches``."""
    out = {"host_cores": host_cores}
    one, many = records[1][0], records[devices][0]
    for n, rec in ((1, one), (devices, many)):
        out[f"frontend_fps_{n}dev"] = round(rec["frontend"]["frames"] / rec["frontend"]["seconds"],
                                            2)
    out["frontend_scaling_efficiency"] = round(
        out[f"frontend_fps_{devices}dev"] / (out["frontend_fps_1dev"] * devices), 3)
    for n, rec in ((1, one), (devices, many)):
        out[f"ba_iters_per_s_{n}dev"] = round(rec["ba"]["iterations"] / rec["ba"]["seconds"], 2)
    speedup = out[f"ba_iters_per_s_{devices}dev"] / out["ba_iters_per_s_1dev"]
    out["ba_speedup"] = round(speedup, 2)
    out["ba_scaling_efficiency"] = round(speedup / devices, 3)
    busy = one["ba"]["busy"]
    ceiling = max(host_cores / max(busy, 1e-6), 1.0)
    out["ba_1dev_cores_busy"] = round(busy, 2)
    out["ba_speedup_vs_core_ceiling"] = round(min(speedup / ceiling, 1.0), 3)
    for n, rec in ((1, one), (devices, many)):
        out[f"composed_slam_fps_{n}dev"] = round(rec["slam"]["frames"] / rec["slam"]["seconds"], 3)
    out["composed_slam_ate"] = round(many["slam"]["ate"], 4)
    out["composed_slam_speedup"] = round(
        out[f"composed_slam_fps_{devices}dev"] / out["composed_slam_fps_1dev"], 2)
    out["devices"] = devices
    out["note"] = NOTE
    out["launches"] = {leg: {k: sum(r[leg]["launches"][k] for ranks in records.values()
                                    for r in ranks) for k in PATH_KERNELS}
                       for leg in ("frontend", "slam")}
    return out


def run(devices=None, batch_per_device: int = 2, device="cuda", *, frame_size=FRAME_SIZE,
        ba_size=BA_SIZE, repeats: int = REPEATS, slam_frames: int = SLAM_FRAMES,
        slam_size=SLAM_SIZE) -> dict:
    """The benchmark's JSON object: world 1 and world ``devices`` (see
    :func:`world_size`), each in ranks of its own."""
    dev = probe_device(str(device))
    n = world_size(devices, dev)
    spec = dict(device=dev.type, devices=n, batch_per_device=batch_per_device,
                frame_size=list(frame_size), ba=list(ba_size), repeats=repeats, slam_frames=slam_frames, slam_size=list(slam_size))
    if dev.type == "cuda":
        _build.load_kernels()  # the ranks load this build
        torch.cuda.empty_cache()  # the ranks need the memory this process caches
    records = {world: torchrun_ranks(f"{__spec__.name}:rank_main", dict(spec, world=world), world,
                                     RANKS_TIMEOUT_S)[0]
               for world in sorted({1, n})}
    check(records)
    out = summarize(records, n, os.cpu_count())
    require_launches(dev, out["launches"]["frontend"], path_kernels("fused", True),
                     "scaling_bench's frontend")
    require_launches(dev, out["launches"]["slam"], path_kernels("separable", True),
                     "scaling_bench's composed SLAM")
    out["device"] = device_entry(dev)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks of the larger world (default: the visible cards; 2 on the CPU)")
    ap.add_argument("--batch-per-device", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    probe_device(args.device)
    out = run(devices=args.devices, batch_per_device=args.batch_per_device, device=args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
