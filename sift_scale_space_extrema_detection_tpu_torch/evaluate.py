"""Dataset evaluation CLI: images → SLAM trajectory → ATE/RPE.

The port of the JAX package's ``evaluate.py``: one command runs the full
pipeline on a TUM-RGBD or KITTI odometry directory. It decodes the frames
with the native batch loader (``core/native_io.py``), edge-pads them
(``core/image.py::pad_to_tpu_friendly``, unless ``--no-pad``), runs visual
SLAM (``models/slam.py::run_slam_from_images``: the SIFT frontend's kernels,
descriptor tracks, PnP, windowed and global BA) on the card unless
``--device cpu`` is given, Umeyama-aligns against ground truth
(``sfm/evaluate.py``, float64) and reports ATE/RPE, an exported TUM-format
trajectory and, as its last line, the metrics as JSON.

The JAX package's ``--blur`` is gone: the port's SLAM frontend is the fused
octave kernel only. ``--max-tracks`` is new: the JAX package's evaluator
fixes the track room at 4096, which a long sequence fills.

Usage:
    python -m sift_scale_space_extrema_detection_tpu_torch.evaluate DIR \
        [--format tum|kitti|auto] [--sequence NN] [--max-frames N]
        [--stride K] [--out-traj est.txt] [--octaves N] [--scales N]
        [--match-gate PX] [--reassoc N] [--max-tracks N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sift-torch-evaluate",
        description="Run visual SLAM on a TUM-RGBD/KITTI sequence and report ATE/RPE",
    )
    p.add_argument("root", help="dataset directory (TUM sequence dir or KITTI odometry root)")
    p.add_argument("--format", choices=["tum", "kitti", "auto"], default="auto")
    p.add_argument("--sequence", default="00", help="KITTI sequence id")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--out-traj", default=None, help="write estimated trajectory (TUM format)")
    p.add_argument("--octaves", type=int, default=4)
    p.add_argument("--scales", type=int, default=3)
    p.add_argument("--capacity", type=int, default=512, help="max keypoints per trio")
    p.add_argument("--match-ratio", type=float, default=0.9)
    p.add_argument("--ba-interval", type=int, default=5)
    p.add_argument(
        "--upright", action="store_true",
        help="skip orientation assignment (video: inter-frame rotation "
        "<< bin width; ~2x cheaper describe)",
    )
    p.add_argument(
        "--match-gate", type=float, default=None, metavar="PX",
        help="motion-prior match gate in px/frame",
    )
    p.add_argument(
        "--reassoc", type=int, default=0,
        help="window re-association depth",
    )
    p.add_argument(
        "--max-tracks", type=int, default=4096,
        help="track room: once it is full no new track opens (the JAX "
        "package's evaluate fixes it at 4096)",
    )
    p.add_argument(
        "--bootstrap", type=int, default=1,
        help="monocular init pair = frames (0, K); wider = more parallax",
    )
    p.add_argument(
        "--ba-every", type=int, default=1,
        help="windowed BA every N tracking windows",
    )
    p.add_argument(
        "--loop-topk", type=int, default=8,
        help="place-recognition prune: full matching only for each "
        "query's K most sketch-similar candidates (0 = brute force)",
    )
    p.add_argument(
        "--loop-stride", type=int, default=0,
        help="loop-closure data association against every S-th old frame "
        "(0 = off; price O(F^2/stride))",
    )
    p.add_argument(
        "--pose-graph", action="store_true",
        help="measured-loop-edge pose graph before the final BA",
    )
    p.add_argument(
        "--no-pad",
        action="store_true",
        help="skip the edge padding of the frames to aligned dims (core/image.py)",
    )
    p.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where SLAM runs (default: cuda)",
    )
    return p


def detect_format(root: str) -> str:
    if os.path.exists(os.path.join(root, "rgb.txt")):
        return "tum"
    if os.path.isdir(os.path.join(root, "sequences")):
        return "kitti"
    raise SystemExit(
        f"{root}: neither a TUM sequence dir (rgb.txt) nor a KITTI root (sequences/)"
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device: this command runs on the card; pass --device cpu "
            "for the plain PyTorch versions on the CPU"
        )
    fmt = args.format if args.format != "auto" else detect_format(args.root)

    from .data import kitti, tum, write_tum_trajectory

    t0 = time.perf_counter()
    if fmt == "tum":
        seq = tum.load_tum_sequence(
            args.root, max_frames=args.max_frames, stride=args.stride
        )
    else:
        seq = kitti.load_kitti_sequence(
            args.root,
            sequence=args.sequence,
            max_frames=args.max_frames,
            stride=args.stride,
        )
    images = seq.load_images()
    t_load = time.perf_counter() - t0
    orig_hw = images.shape[1:3]
    if not args.no_pad:
        # Real dataset dims (KITTI 1241x376) miss every aligned plane;
        # bottom/right edge padding is transparent to the blur
        # (clamp-to-edge border rule) and to the intrinsics.
        from .core.image import pad_to_tpu_friendly

        images = pad_to_tpu_friendly(images)
    print(
        f"{fmt}: {len(seq.image_paths)} frames "
        f"{orig_hw[1]}x{orig_hw[0]}"
        + (
            f" (padded to {images.shape[2]}x{images.shape[1]})"
            if images.shape[1:3] != orig_hw
            else ""
        )
        + f", loaded in {t_load:.2f}s"
    )

    from . import SiftConfig
    from .models.slam import SlamConfig, run_slam_from_images

    sift_cfg = SiftConfig(
        num_octaves=args.octaves,
        scales_per_octave=args.scales,
        max_keypoints_per_trio=args.capacity,
        upright=args.upright,
    )
    slam_cfg = SlamConfig(
        ba_interval=args.ba_interval,
        bootstrap_baseline=args.bootstrap,
        ba_every=args.ba_every,
        use_pose_graph=args.pose_graph,
    )

    t1 = time.perf_counter()
    result = run_slam_from_images(
        images,
        np.asarray(seq.k_mat),
        sift_cfg,
        slam_cfg,
        match_ratio=args.match_ratio,
        reassoc_window=args.reassoc,
        max_match_px=args.match_gate,
        max_tracks=args.max_tracks,
        loop_stride=args.loop_stride,
        loop_topk=args.loop_topk,
        device=args.device,
    )
    t_slam = time.perf_counter() - t1  # the result is host numpy: synchronised
    fps = len(seq.image_paths) / t_slam
    print(f"slam: {t_slam:.2f}s ({fps:.2f} frames/s), "
          f"{int(result.landmark_valid.sum())} landmarks, "
          f"{result.num_observations} observations")

    metrics = {
        "format": fmt,
        "frames": len(seq.image_paths),
        "slam_frames_per_s": round(fps, 3),
        "landmarks": int(result.landmark_valid.sum()),
    }
    if seq.gt_rotations is not None:
        from .sfm.evaluate import (
            absolute_trajectory_error,
            relative_pose_error,
            relative_rotation_error,
        )

        def tensor(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=args.device)

        est_r, est_t = tensor(result.rotations), tensor(result.translations)
        gt_r, gt_t = tensor(seq.gt_rotations), tensor(seq.gt_translations)
        ate = float(absolute_trajectory_error(est_r, est_t, gt_r, gt_t))
        rpe = float(relative_pose_error(est_r, est_t, gt_r, gt_t))
        rre = float(relative_rotation_error(est_r, gt_r))
        metrics["ate_rmse"] = round(ate, 6)
        metrics["rpe_trans_rmse"] = round(rpe, 6)
        metrics["rpe_rot_rmse_deg"] = round(np.degrees(rre), 4)
        print(
            f"ATE RMSE: {ate:.4f}  RPE trans RMSE: {rpe:.4f} (gt units)  "
            f"RPE rot RMSE: {np.degrees(rre):.3f} deg"
        )
    else:
        print("no ground truth available; skipping ATE/RPE")

    if args.out_traj:
        write_tum_trajectory(
            args.out_traj,
            seq.timestamps,
            result.rotations,
            result.translations,
        )
        print(f"trajectory → {args.out_traj}")

    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
