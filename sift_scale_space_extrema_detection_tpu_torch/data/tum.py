"""TUM-RGBD dataset ingestion (BASELINE.json accuracy metric; SURVEY §7 step 8).

The JAX package's ``data/tum.py``, copied; its writer encodes PNGs with
the port's ``core/image.py::write_png`` instead of PIL, to the same pixels.

A TUM-RGBD sequence directory contains:

- ``rgb.txt``        — ``timestamp filename`` lines (``#`` comments)
- ``groundtruth.txt``— ``timestamp tx ty tz qx qy qz qw`` lines at a
  different (higher) rate than the camera
- ``rgb/``           — the PNG frames

Loading therefore requires timestamp *association*: each image is
matched to the nearest ground-truth pose within ``max_difference``
seconds, greedily by smallest time gap (the protocol of the dataset's
official ``associate.py``). Images decode through the native batch
loader (core/native_io.py, PNG via zlib); PIL only for a file it refuses.

Intrinsics are not shipped per sequence; the dataset publishes fixed
per-camera calibrations (freiburg1/2/3), selected here by directory
name, with the ROS default as fallback.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .poses import cam_to_world_to_wc, quat_to_rotation

# Published TUM-RGBD pinhole intrinsics (fx, fy, cx, cy) per camera.
TUM_INTRINSICS = {
    "freiburg1": (517.3, 516.5, 318.6, 255.3),
    "freiburg2": (520.9, 521.0, 325.1, 249.7),
    "freiburg3": (535.4, 539.2, 320.1, 247.6),
    # ROS default (the rectified-image calibration).
    "default": (525.0, 525.0, 319.5, 239.5),
}


@dataclasses.dataclass
class TumSequence:
    timestamps: np.ndarray  # (F,) image timestamps (associated subset)
    image_paths: list[str]  # (F,) absolute paths
    gt_rotations: np.ndarray  # (F, 3, 3) world→camera
    gt_translations: np.ndarray  # (F, 3)
    k_mat: np.ndarray  # (3, 3) pinhole intrinsics

    def load_images(self, threads: int = 8) -> np.ndarray:
        """Decode all frames → (F, H, W) float32 grayscale in [0,1]."""
        from ..core.native_io import load_batch_gray

        return load_batch_gray(self.image_paths, threads=threads)

    def stream_frames(self, threads: int = 4, depth: int = 8):
        """Prefetching frame iterator for online consumption.

        Decodes ``depth`` frames ahead across a native pthread pool
        (core/native_io.py::SequencePrefetcher) so disk decode overlaps
        an online consumer's device work (e.g. SlamSession.add_frame).
        """
        from ..core.native_io import SequencePrefetcher

        return SequencePrefetcher(
            self.image_paths, threads=threads, depth=depth
        )


def _read_stamped_file(path: str):
    """Parse ``timestamp v1 v2 ...`` lines, skipping ``#`` comments."""
    stamps, payloads = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            stamps.append(float(parts[0]))
            payloads.append(parts[1:])
    return np.asarray(stamps), payloads


def associate(
    stamps_a: np.ndarray,
    stamps_b: np.ndarray,
    max_difference: float = 0.02,
    offset: float = 0.0,
):
    """Greedy nearest-timestamp association (TUM ``associate.py`` protocol).

    Candidate pairs within ``max_difference`` are sorted by |Δt| and
    accepted greedily, each stream index used at most once. Returns
    ``(idx_a, idx_b)`` index arrays sorted by stream-a timestamp.
    """
    # ALL candidate pairs within the window enter the greedy pass (the
    # official associate.py enumerates every (a, b) combination): an
    # ``a`` whose nearest ``b`` is claimed by a closer ``a`` must fall
    # back to its second-nearest, not drop out.
    order = np.argsort(stamps_b, kind="stable")
    sb = stamps_b[order] + offset
    pairs = []
    for i, ta in enumerate(stamps_a):
        lo = int(np.searchsorted(sb, ta - max_difference, side="left"))
        hi = int(np.searchsorted(sb, ta + max_difference, side="right"))
        for k in range(lo, hi):
            d = float(abs(sb[k] - ta))
            if d < max_difference:
                pairs.append((d, i, int(order[k])))
    pairs.sort()
    used_a, used_b, out = set(), set(), []
    for _, i, j in pairs:
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        out.append((i, j))
    out.sort(key=lambda ij: stamps_a[ij[0]])
    if not out:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    idx_a, idx_b = zip(*out)
    return np.asarray(idx_a, np.int64), np.asarray(idx_b, np.int64)


def intrinsics_for(path: str) -> np.ndarray:
    """Pick the published calibration by sequence directory name."""
    name = os.path.basename(os.path.normpath(path)).lower()
    for key, (fx, fy, cx, cy) in TUM_INTRINSICS.items():
        if key in name:
            break
    else:
        fx, fy, cx, cy = TUM_INTRINSICS["default"]
    return np.asarray(
        [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], np.float64
    )


def load_tum_sequence(
    root: str,
    max_frames: int | None = None,
    stride: int = 1,
    max_difference: float = 0.02,
) -> TumSequence:
    """Load a TUM-RGBD sequence directory with rgb↔groundtruth association."""
    rgb_stamps, rgb_files = _read_stamped_file(os.path.join(root, "rgb.txt"))
    gt_stamps, gt_vals = _read_stamped_file(
        os.path.join(root, "groundtruth.txt")
    )
    idx_rgb, idx_gt = associate(rgb_stamps, gt_stamps, max_difference)
    idx_rgb = idx_rgb[::stride]
    idx_gt = idx_gt[::stride]
    if max_frames is not None:
        idx_rgb = idx_rgb[:max_frames]
        idx_gt = idx_gt[:max_frames]

    gt = np.asarray(
        [[float(v) for v in gt_vals[j]] for j in idx_gt], np.float64
    )  # (F, 7): tx ty tz qx qy qz qw, camera→world
    r_cw = quat_to_rotation(gt[:, 3:7])
    rot, t = cam_to_world_to_wc(r_cw, gt[:, 0:3])

    return TumSequence(
        timestamps=rgb_stamps[idx_rgb],
        image_paths=[
            os.path.join(root, rgb_files[i][0]) for i in idx_rgb
        ],
        gt_rotations=rot,
        gt_translations=t,
        k_mat=intrinsics_for(root),
    )


def write_tum_sequence(
    root: str,
    images: np.ndarray,
    timestamps: np.ndarray,
    gt_rotations: np.ndarray,
    gt_translations: np.ndarray,
    gt_rate_multiplier: int = 4,
    gt_offset: float = 0.002,
) -> None:
    """Write a sequence in the exact TUM-RGBD on-disk format (test fixtures).

    ``images``: (F, H, W) float in [0,1] → 8-bit gray PNGs under
    ``rgb/``. Ground truth (world→camera in, stored camera→world) is
    written at ``gt_rate_multiplier``× the camera rate with a small
    timestamp offset, so loaders must do real association — matching
    the real dataset's shape, where groundtruth runs at 100 Hz vs 30 Hz
    rgb and timestamps never align exactly.
    """
    from ..core.image import write_png

    from .poses import rotation_to_quat, wc_to_cam_to_world

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("# color images\n# timestamp filename\n")
        for ts, img in zip(timestamps, images):
            name = f"rgb/{ts:.6f}.png"
            write_png(
                os.path.join(root, name),
                np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8),
            )
            f.write(f"{ts:.6f} {name}\n")

    r_cw, centers = wc_to_cam_to_world(gt_rotations, gt_translations)
    quats = rotation_to_quat(r_cw)
    dt = (
        (timestamps[1] - timestamps[0]) if len(timestamps) > 1 else 1.0 / 30.0
    ) / gt_rate_multiplier
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("# ground truth trajectory\n# timestamp tx ty tz qx qy qz qw\n")
        for k, (ts, c, q) in enumerate(zip(timestamps, centers, quats)):
            # The pose nearest to the frame, plus gt_rate_multiplier-1
            # decoy samples between frames (linear interp toward the
            # next pose would be more faithful; constant-hold decoys
            # exercise the association logic identically). gt_offset
            # must stay < frame_dt/(2*multiplier) so each frame's TRUE
            # sample is strictly nearest — the last decoy of frame k
            # sits frame_dt*(1/multiplier) - gt_offset before frame k+1.
            f.write(
                f"{ts + gt_offset:.6f} {c[0]:.9f} {c[1]:.9f} {c[2]:.9f} "
                f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
            )
            for m in range(1, gt_rate_multiplier):
                f.write(
                    f"{ts + gt_offset + m * dt:.6f} "
                    f"{c[0]:.9f} {c[1]:.9f} {c[2]:.9f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
                )
