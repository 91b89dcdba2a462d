#!/usr/bin/env python3
"""The port's multi-rank dry run: the two steps of the JAX package's
``__graft_entry__.py::dryrun_multichip`` over a ``torch.distributed`` group.

1. The data-parallel frontend (``detect_and_describe_data_parallel``) on a
   batch of 2 frames a rank at 32×32, 2 octaves, capacity 64.
2. Composed sharded SLAM: ``run_slam(mesh=…)`` on
   ``orbit_sequence(default_rng(0), 8, 64, radius=8.0, noise_px=0.2)`` with
   ``SlamConfig(ba_interval=3, final_ba_iterations=6,
   dist_ba_min_landmarks=0)``, so that every BA goes through the sharded
   solver; the ATE must be below 1 % of the radius (0.08), the bar of
   BASELINE config[3].

Run from the repository root: ``python3 tools/torch_dryrun_multichip.py
[--world N] [--device cpu|cuda]`` (defaults: 2 ranks, the card). It starts
N ranks (``torch.multiprocessing``, spawn) in one group over a file store in
a temporary directory: NCCL when each rank has a card of its own, gloo
otherwise (on the CPU, and for ranks that share a card). Rank 0 prints one
line with the keypoints, the ATE and the count of sharded BAs; every rank
checks that its trajectory is bit-equal to rank 0's. Exits non-zero on any
failure, and when ``--device cuda`` finds no card.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RADIUS = 8.0
ATE_BAR = 0.01 * RADIUS
TIMEOUT = datetime.timedelta(seconds=60)


def _example_batch(batch: int, h: int, w: int) -> np.ndarray:
    """``__graft_entry__.py::_example_batch``: a smooth pattern, one blob
    and noise, quantised to 8-bit levels."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 0.4 + 0.2 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    img = img + 0.3 * np.exp(-((yy - h / 2) ** 2 + (xx - w / 2) ** 2) / 18.0)
    img = img[None] + 0.05 * rng.standard_normal((batch, h, w))
    return (np.round(np.clip(img, 0.0, 1.0) * 255.0) / 255.0).astype(np.float32)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: FAILED: {what}")


def _rank(rank: int, world: int, device: str, backend: str, store: str) -> None:
    import torch
    import torch.distributed as dist

    import sift_scale_space_extrema_detection_tpu_torch as port
    from sift_scale_space_extrema_detection_tpu_torch.parallel import (
        detect_and_describe_data_parallel,
        distributed_bundle_adjust,
        initialize_multihost,
        make_mesh,
    )
    from sift_scale_space_extrema_detection_tpu_torch.utils.synthetic import orbit_sequence

    torch.set_num_threads(2)
    initialize_multihost(f"file://{store}", world, rank, backend=backend, timeout=TIMEOUT)
    try:
        mesh = make_mesh(world, device_type=device)
        batch = 2 * world
        cfg = port.SiftConfig(num_octaves=2, max_keypoints_per_trio=64)
        described = detect_and_describe_data_parallel(_example_batch(batch, 32, 32), cfg, mesh)
        _require(described.octave.shape[0] == batch, f"batch {described.octave.shape[0]}")
        n_valid = int(described.valid.sum())

        seq = orbit_sequence(np.random.default_rng(0), num_frames=8, num_landmarks=64,
                             radius=RADIUS, noise_px=0.2)
        slam_cfg = port.SlamConfig(ba_interval=3, final_ba_iterations=6, dist_ba_min_landmarks=0)
        calls = distributed_bundle_adjust.calls
        result = port.run_slam(seq.pixels, seq.visible, seq.k_mat, slam_cfg, mesh=mesh,
                               device=device)
        sharded = distributed_bundle_adjust.calls - calls
        ate = port.evaluate_ate(result, seq.rotations, seq.translations, device=device)
        every = [None] * world
        dist.all_gather_object(every, result.translations.tobytes())
        same = all(t == every[0] for t in every)
        if rank == 0:
            print(
                f"dryrun_multichip: {world} ranks on {device} ({backend}): DP frontend batch "
                f"{batch} ({n_valid} keypoints), composed sharded SLAM ATE {ate:.4f} (bound "
                f"{ATE_BAR:.2f}), sharded BAs {sharded}, every rank's trajectory bit-equal "
                f"{same}",
                flush=True,
            )
        _require(n_valid > 0, "the frontend found no keypoint")
        _require(sharded > 0, "no BA went through the sharded solver")
        _require(ate < ATE_BAR, f"distributed SLAM ATE {ate:.4f}")
        _require(np.isfinite(result.points[result.landmark_valid]).all(), "points not finite")
        _require(same, "the ranks' trajectories differ")
    finally:
        dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu", file=sys.stderr)
        return 1
    own_cards = args.device == "cuda" and args.world <= torch.cuda.device_count()
    backend = "nccl" if own_cards else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(args.world, args.device, backend, os.path.join(tmp, "store")),
                 nprocs=args.world)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
