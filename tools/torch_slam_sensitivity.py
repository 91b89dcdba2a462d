#!/usr/bin/env python3
"""How far rounding alone moves the SLAM trajectory of ``chip_smoke.py``
phase 15, on the bench recipe's tracks and on the gated tracks SLAM solves.

Run from the repository root: ``python3 tools/torch_slam_sensitivity.py``
(``--device cpu`` by default, about four minutes on four threads;
``--device cuda`` on a machine with a card, where it also runs the back end
on the CPU). It takes ``chip_smoke.slam_bench_recipe`` (40 × 480×640 uint16
frames of ``benchmarks/slam_bench.py``'s default sequence, seed 0), describes
the frames once, tracks them three times (the recipe's association; with the
recipe's ``solved`` match gate and track room; with the JAX package's
documented 60 px gate, ``BASELINE.md`` round 5, and the same track room),
and prints JSON lines:

- ``bootstrap``: the first frames' estimated camera centres against the true
  ones (both scaled to a unit first step), for each track set;
- ``perturbed``: the ATE of ``run_slam`` in float32 and float64 on each
  track set with every pixel scaled by ``1 + eps``, for a few ``eps`` at
  float64 and at float32 rounding: the spread is what a rounding difference
  (another device, another reduction order, another thread count on the
  CPU) can do to the ATE;
- ``devices`` (with ``--device cuda``): the float32 ATE on the card and on
  the CPU for each track set.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

EPSILONS = (0.0, 1e-15, -1e-15, 1e-7, -1e-7, 1e-6)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--frames", type=int, default=chip_smoke.SLAM_FRAMES)
    ap.add_argument("--threads", type=int, default=4, help="CPU threads (they set the CPU's sums)")
    args = ap.parse_args()

    import torch

    import sift_scale_space_extrema_detection_tpu_torch as port
    from sift_scale_space_extrema_detection_tpu_torch.models.slam import (
        build_tracks_from_described,
        describe_frames,
    )

    torch.set_num_threads(args.threads)
    dev = torch.device(args.device)
    recipe = chip_smoke.slam_bench_recipe(port, args.frames)
    gt_r, gt_t, k_mat, cfg = (recipe[k] for k in ("gt_r", "gt_t", "k_mat", "slam_cfg"))
    described = describe_frames(recipe["images"], recipe["sift_cfg"], chip_smoke.SLAM_CHUNK,
                                device=dev)
    track = dict(reassoc_window=recipe["reassoc_window"], device=dev)
    sets = {
        "recipe": build_tracks_from_described(described, k_mat, **track)[:2],
        "gate60": build_tracks_from_described(
            described, k_mat, **track, **{**recipe["solved"], "max_match_px": 60.0})[:2],
        "solved": build_tracks_from_described(described, k_mat, **track, **recipe["solved"])[:2],
    }

    def ate(result):
        return port.evaluate_ate(result, gt_r, gt_t, device="cpu")

    def centres(rotations, translations):
        c = -np.einsum("fji,fj->fi", rotations, translations)
        return np.round(c[:4] / np.linalg.norm(c[1] - c[0]), 4).tolist()

    for name, (pixels, visible) in sets.items():
        base = port.run_slam(pixels, visible, k_mat, cfg, device=dev)
        print(json.dumps(dict(
            kind="bootstrap", tracks=name, estimated=centres(base.rotations, base.translations),
            true=centres(gt_r, gt_t), ate=ate(base),
        )), flush=True)
        for dtype in (torch.float32, torch.float64):
            readings = [
                ate(port.run_slam(pixels * (1.0 + eps), visible, k_mat, cfg, device=dev,
                                  dtype=dtype))
                for eps in EPSILONS
            ]
            print(json.dumps(dict(kind="perturbed", tracks=name, dtype=str(dtype), eps=EPSILONS,
                                  ate=readings, spread=max(readings) - min(readings))), flush=True)
        if dev.type == "cuda":
            cpu = ate(port.run_slam(pixels, visible, k_mat, cfg, device="cpu"))
            print(json.dumps(dict(kind="devices", tracks=name, card=ate(base), cpu=cpu)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
