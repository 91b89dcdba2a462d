"""KITTI odometry dataset ingestion (BASELINE.json accuracy metric).

The JAX package's ``data/kitti.py``, copied; its writer encodes PNGs with
the port's ``core/image.py::write_png`` instead of PIL, to the same pixels.

KITTI odometry layout (the official devkit structure):

    dataset/
      sequences/NN/
        image_0/000000.png ...   (left gray camera)
        times.txt                (one timestamp per frame, seconds)
        calib.txt                ("P0: <12 floats>" projection rows)
      poses/NN.txt               (3×4 camera→world per line, row-major;
                                  only sequences 00-10 have poses)

Images decode through the native batch loader (PNG via zlib); PIL only
for a file it refuses. Poses convert to the repo's world→camera convention
(data/poses.py).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .poses import cam_to_world_to_wc


@dataclasses.dataclass
class KittiSequence:
    timestamps: np.ndarray  # (F,)
    image_paths: list[str]  # (F,)
    gt_rotations: np.ndarray | None  # (F, 3, 3) world→camera, None if no poses
    gt_translations: np.ndarray | None  # (F, 3)
    k_mat: np.ndarray  # (3, 3) intrinsics of camera 0

    def load_images(self, threads: int = 8) -> np.ndarray:
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


def read_calib(path: str, camera: int = 0) -> np.ndarray:
    """Intrinsics K from a KITTI ``calib.txt`` ``P{camera}:`` line.

    ``P = K [I | t]`` for the rectified cameras, so K is the left 3×3.
    """
    key = f"P{camera}:"
    with open(path) as f:
        for line in f:
            if line.startswith(key):
                vals = [float(v) for v in line.split()[1:]]
                p = np.asarray(vals, np.float64).reshape(3, 4)
                return p[:, :3].copy()
    raise ValueError(f"no '{key}' line in {path}")


def read_poses(path: str):
    """KITTI pose file → world→camera ``(R, t)`` arrays."""
    mats = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            vals = [float(v) for v in line.split()]
            mats.append(np.asarray(vals, np.float64).reshape(3, 4))
    mats = np.stack(mats)  # (F, 3, 4) camera→world
    return cam_to_world_to_wc(mats[:, :, :3], mats[:, :, 3])


def load_kitti_sequence(
    root: str,
    sequence: str = "00",
    camera: int = 0,
    max_frames: int | None = None,
    stride: int = 1,
) -> KittiSequence:
    """Load one KITTI odometry sequence from the dataset root."""
    seq_dir = os.path.join(root, "sequences", sequence)
    img_dir = os.path.join(seq_dir, f"image_{camera}")
    times = np.asarray(
        [float(line) for line in open(os.path.join(seq_dir, "times.txt"))],
        np.float64,
    )
    frames = sorted(
        f for f in os.listdir(img_dir) if f.endswith(".png")
    )
    n = min(len(times), len(frames))
    idx = np.arange(n)[::stride]
    if max_frames is not None:
        idx = idx[:max_frames]

    pose_file = os.path.join(root, "poses", f"{sequence}.txt")
    rot = t = None
    if os.path.exists(pose_file):
        rot_all, t_all = read_poses(pose_file)
        rot, t = rot_all[idx], t_all[idx]

    return KittiSequence(
        timestamps=times[idx],
        image_paths=[os.path.join(img_dir, frames[i]) for i in idx],
        gt_rotations=rot,
        gt_translations=t,
        k_mat=read_calib(os.path.join(seq_dir, "calib.txt"), camera),
    )


def write_kitti_sequence(
    root: str,
    sequence: str,
    images: np.ndarray,
    timestamps: np.ndarray,
    gt_rotations: np.ndarray,
    gt_translations: np.ndarray,
    k_mat: np.ndarray,
    camera: int = 0,
) -> None:
    """Write a sequence in the exact KITTI odometry on-disk format
    (test fixtures): gray PNGs, times.txt, calib.txt with P0–P3 rows,
    poses/NN.txt with camera→world 3×4 matrices."""
    from ..core.image import write_png

    from .poses import wc_to_cam_to_world

    seq_dir = os.path.join(root, "sequences", sequence)
    img_dir = os.path.join(seq_dir, f"image_{camera}")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)

    for i, img in enumerate(images):
        write_png(
            os.path.join(img_dir, f"{i:06d}.png"),
            np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8),
        )
    with open(os.path.join(seq_dir, "times.txt"), "w") as f:
        for ts in timestamps:
            f.write(f"{ts:.6e}\n")

    p = np.zeros((3, 4))
    p[:, :3] = k_mat
    row = " ".join(f"{v:.12e}" for v in p.reshape(-1))
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        for cam in range(4):
            f.write(f"P{cam}: {row}\n")

    r_cw, centers = wc_to_cam_to_world(gt_rotations, gt_translations)
    with open(os.path.join(root, "poses", f"{sequence}.txt"), "w") as f:
        for rot, c in zip(r_cw, centers):
            m = np.concatenate([rot, c[:, None]], axis=1)
            f.write(" ".join(f"{v:.9e}" for v in m.reshape(-1)) + "\n")
