#!/usr/bin/env python3
"""How fragile the full-width two-view scene of ``chip_smoke.py`` is.

Run from the repository root: ``python3 tools/torch_two_view_fields.py``
(on the CPU, about three seconds a field). For each blob field (blobs ×
satellites, seeds 0-5) it renders the two 480×640 views, runs the PyTorch
port's detect + describe, matching and RANSAC with ``device="cpu"`` at the
sizes of phase 13, and prints one JSON line: valid descriptors a frame,
matches, inliers, rotation error, translation cosine and whether the pose
lies inside the phase's bars. ``tests/test_torch_two_view.py -m slow``
holds three of these fields against the JAX package.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

FIELDS = ((150, 5), (300, 3), (300, 5))
SEEDS = range(6)


def main() -> int:
    import torch

    import sift_scale_space_extrema_detection_tpu_torch as port
    from sift_scale_space_extrema_detection_tpu_torch.sfm import geometry as geo
    from sift_scale_space_extrema_detection_tpu_torch.utils import synthetic

    cfg = port.SiftConfig(num_octaves=4, scales_per_octave=5, max_keypoints_per_trio=512)
    thresh = chip_smoke.RANSAC_PX / chip_smoke.TWO_VIEW_FOCAL
    for blobs, satellites in FIELDS:
        passed = 0
        for seed in SEEDS:
            frames, k_np, r2, t_dir = chip_smoke._two_view_scene(synthetic, blobs, satellites, seed)
            d = port.detect_and_describe_batched(torch.from_numpy(frames), cfg, device="cpu")
            m = port.match_descriptors(
                d.descriptor[0], d.valid[0], d.descriptor[1], d.valid[1], device="cpu"
            )
            k_mat = torch.from_numpy(k_np).float()
            uv1 = torch.stack([d.abs_x[0], d.abs_y[0]], dim=-1)
            uv2 = torch.stack([d.abs_x[1], d.abs_y[1]], dim=-1)[m.index.long()]
            result = port.estimate_essential_ransac(
                geo.backproject(uv1, k_mat), geo.backproject(uv2, k_mat), m.valid,
                torch.Generator().manual_seed(0), num_hypotheses=chip_smoke.RANSAC_HYPOTHESES,
                inlier_threshold=thresh, device="cpu",
            )
            rot = chip_smoke._rotation_angle_deg(result.rotation.numpy(), r2)
            cos_t = abs(float(result.translation.double().numpy() @ (t_dir / np.linalg.norm(t_dir))))
            ok = rot < chip_smoke.MAX_ROTATION_DEG and cos_t > chip_smoke.MIN_TRANSLATION_COS
            passed += ok
            print(json.dumps(dict(
                blobs=blobs, satellites=satellites, seed=seed,
                valid_descriptors=d.valid.sum(dim=1).tolist(), matches=int(m.valid.sum()),
                inliers=int(result.num_inliers), rotation_deg=round(rot, 4),
                translation_cos=round(cos_t, 6), inside_the_bars=bool(ok),
            )), flush=True)
        print(f"{blobs} blobs x {satellites} satellites: {passed} of {len(SEEDS)} fields inside "
              f"the bars", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
