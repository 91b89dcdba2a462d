"""Descriptor repeatability and recall of the port against OpenCV over a warp grid.

The port of the JAX package's ``benchmarks/descriptor_bench.py``: both
pipelines run over a grid of similarity warps (rotations 0/20/45/90° ×
scales 0.8/1.0/1.25, the identity left out: 11 warps) of a textured
synthetic 240×320 image (:func:`textured_image`, seed 7), and each warp is
scored, per pipeline, by the same protocol (:func:`score_warp`):

- ``kp_a``, ``kp_b``: keypoints detected in the source and the warped image;
- ``covisible``: source keypoints whose true warped position lies in the
  frame and within 3 px of a keypoint detected in the warped image;
- ``repeatability``: covisible over in-frame keypoints (the detector);
- ``matches``: ratio (``--ratio``, 0.8) and mutual matches;
- ``recall``: correct matches over covisible (the descriptor);
- ``precision``: correct matches over matches.

"Correct" is a match within 3 px of the truly warped source point. Ours is
``detect_and_describe`` through the separable blur (the original's call,
the JAX package's default) and ``match_descriptors``; theirs is
``cv2.SIFT_create`` with a brute-force 2-NN ratio test. ``--quality`` takes
``SiftConfig.quality()`` (OpenCV-equivalent thresholds). The describe
stages' kernels (R3, R4) run in every describe on the card.

Run: ``python -m sift_scale_space_extrema_detection_tpu_torch.benchmarks.descriptor_bench
[--ratio 0.8] [--quality] [--device cuda|cpu]``. Prints
one line per warp on stderr and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..config import SiftConfig
from ..models.frontend import detect_and_describe
from ..ops.matching import match_descriptors
from . import (
    device_entry,
    launch_counts,
    path_kernels,
    path_launches,
    probe_device,
    require_launches,
)

H, W = 240, 320
CORRECT_PX = 3.0
BLUR = "separable"  # the original's detect_and_describe_jit(image, cfg)


def textured_image(rng: np.random.Generator) -> np.ndarray:
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = 0.45 + 0.08 * np.sin(xx / 7.0) * np.cos(yy / 9.0)
    for _ in range(60):
        cy, cx = rng.uniform(15, H - 15), rng.uniform(15, W - 15)
        r = rng.uniform(2.0, 7.0)
        a = rng.uniform(-0.4, 0.4)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
    return np.clip(img, 0.0, 1.0)


def warp_matrix(theta_deg: float, s: float) -> np.ndarray:
    theta = np.deg2rad(theta_deg)
    c, sn = np.cos(theta), np.sin(theta)
    cx0, cy0 = W / 2, H / 2
    return np.array(
        [
            [s * c, -s * sn, cx0 - s * (c * cx0 - sn * cy0) + 6.0],
            [s * sn, s * c, cy0 - s * (sn * cx0 + c * cy0) - 4.0],
        ]
    )


def score_warp(pa, pb, matches_ab, a_mat):
    """Repeatability/recall/precision for one warp.

    ``pa (Na, 2)``/``pb (Nb, 2)``: detected keypoint positions;
    ``matches_ab (M, 2)``: (a index, b index) accepted match pairs.
    """
    pred = pa @ a_mat[:, :2].T + a_mat[:, 2]
    inb = (
        (pred[:, 0] >= 0)
        & (pred[:, 0] < W)
        & (pred[:, 1] >= 0)
        & (pred[:, 1] < H)
    )
    if len(pb):
        d = np.linalg.norm(pred[:, None, :] - pb[None, :, :], axis=-1)
        has_partner = d.min(axis=1) < CORRECT_PX
    else:
        has_partner = np.zeros(len(pa), bool)
    covis = inb & has_partner

    correct = 0
    for ia, ib in matches_ab:
        if inb[ia] and np.linalg.norm(pred[ia] - pb[ib]) < CORRECT_PX:
            correct += 1
    n_match = len(matches_ab)
    return {
        "kp_a": int(len(pa)),
        "kp_b": int(len(pb)),
        "inbounds": int(inb.sum()),
        "covisible": int(covis.sum()),
        "repeatability": round(covis.sum() / max(inb.sum(), 1), 3),
        "matches": n_match,
        "recall": round(correct / max(int(covis.sum()), 1), 3),
        "precision": round(correct / max(n_match, 1), 3),
    }


def warp_grid() -> list[tuple[float, float]]:
    """The 11 warps: rotations × scales, the identity left out."""
    grid = [(r, s) for r in (0.0, 20.0, 45.0, 90.0) for s in (0.8, 1.0, 1.25)]
    grid.remove((0.0, 1.0))  # identity tells us nothing
    return grid


def run(ratio: float = 0.8, quality: bool = False, device="cuda", warps=None) -> dict:
    """The benchmark's JSON object; ``warps``: a part of :func:`warp_grid`
    (default all of it)."""
    import cv2

    dev = probe_device(str(device))
    rng = np.random.default_rng(7)
    img = textured_image(rng)
    kw = dict(num_octaves=3, max_keypoints_per_trio=256)
    cfg = SiftConfig.quality(**kw) if quality else SiftConfig(**kw)

    def ours(image):
        d = detect_and_describe(torch.as_tensor(image, dtype=torch.float32), cfg, BLUR,
                                device=dev)
        v = d.valid.cpu().numpy()
        p = np.stack([d.abs_x.cpu().numpy(), d.abs_y.cpu().numpy()], -1)
        return p[v], d.descriptor.cpu().numpy()[v]

    sift = cv2.SIFT_create()

    def theirs(image):
        kp, desc = sift.detectAndCompute((image * 255).astype(np.uint8), None)
        if desc is None:
            return np.zeros((0, 2)), np.zeros((0, 128), np.float32)
        return np.array([k.pt for k in kp]), desc

    before = launch_counts()
    pa_o, da_o = ours(img)
    pa_c, dc_o = theirs(img)

    rows = []
    for rdeg, s in warp_grid() if warps is None else warps:
        a_mat = warp_matrix(rdeg, s)
        img2 = cv2.warpAffine(
            img, a_mat, (W, H),
            flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT,
        )

        pb_o, db_o = ours(img2)
        m = match_descriptors(
            torch.from_numpy(da_o),
            torch.ones(len(da_o), dtype=torch.bool),
            torch.from_numpy(db_o),
            torch.ones(len(db_o), dtype=torch.bool),
            ratio=ratio,
            device=dev,
        )
        sel = np.where(m.valid.cpu().numpy())[0]
        ours_matches = np.stack([sel, m.index.cpu().numpy()[sel]], -1)
        row_o = score_warp(pa_o, pb_o, ours_matches, a_mat)

        pb_c, dcb = theirs(img2)
        if len(dc_o) and len(dcb):
            knn = cv2.BFMatcher().knnMatch(dc_o, dcb, k=2)
            good = [
                (mm.queryIdx, mm.trainIdx)
                for pair in knn
                if len(pair) == 2
                for mm, nn in [pair]
                if mm.distance < ratio * nn.distance
            ]
        else:
            good = []
        row_c = score_warp(pa_c, pb_c, np.array(good).reshape(-1, 2), a_mat)

        rows.append({"rot_deg": rdeg, "scale": s, "ours": row_o, "opencv": row_c})
        print(
            f"rot {rdeg:5.1f} scale {s:.2f} | ours kp {row_o['kp_a']:4d}"
            f" covis {row_o['covisible']:4d} rep {row_o['repeatability']:.2f}"
            f" recall {row_o['recall']:.2f} prec {row_o['precision']:.2f}"
            f" | cv kp {row_c['kp_a']:4d} covis {row_c['covisible']:4d}"
            f" rep {row_c['repeatability']:.2f} recall {row_c['recall']:.2f}"
            f" prec {row_c['precision']:.2f}",
            file=sys.stderr,
        )
    launches = path_launches(before)
    require_launches(dev, launches, path_kernels(BLUR, True), "descriptor_bench")

    def mean(k, who):
        return round(float(np.mean([r[who][k] for r in rows])), 3)

    return {
        "warps": len(rows),
        "ours_mean_repeatability": mean("repeatability", "ours"),
        "ours_mean_recall": mean("recall", "ours"),
        "ours_mean_precision": mean("precision", "ours"),
        "opencv_mean_repeatability": mean("repeatability", "opencv"),
        "opencv_mean_recall": mean("recall", "opencv"),
        "opencv_mean_precision": mean("precision", "opencv"),
        "ours_mean_kp": mean("kp_a", "ours"),
        "opencv_mean_kp": mean("kp_a", "opencv"),
        "rows": rows,
        "opencv": cv2.__version__,
        "launches": launches,
        "device": device_entry(dev),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ratio", type=float, default=0.8)
    ap.add_argument("--quality", action="store_true",
                    help="SiftConfig.quality() preset (OpenCV-equivalent detection thresholds; "
                    "documented parity divergence)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    probe_device(args.device)
    out = run(ratio=args.ratio, quality=args.quality, device=args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
