"""Pose conventions and trajectory file IO (host-side, numpy).

The JAX package's ``data/poses.py``, copied (``tests/test_torch_io.py``
pins the copy to the original).

The SLAM stack (models/slam.py, sfm/evaluate.py) works in world→camera
convention: ``x_cam = R @ x_world + t``, camera center ``-Rᵀt``. Dataset
ground-truth files store the opposite (camera→world): TUM-RGBD lines are
``timestamp tx ty tz qx qy qz qw`` with the quaternion rotating
camera-frame vectors into the world frame; KITTI pose lines are the
3×4 camera→world matrix row-major. This module holds the conversions
and the TUM-format trajectory writer used to export estimates for
external tooling (evo / TUM scripts read this format).
"""

from __future__ import annotations

import numpy as np


def quat_to_rotation(q: np.ndarray) -> np.ndarray:
    """Unit quaternion(s) ``(..., 4)`` as ``(qx, qy, qz, qw)`` → ``(..., 3, 3)``."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rot = np.empty(q.shape[:-1] + (3, 3), np.float64)
    rot[..., 0, 0] = 1 - 2 * (y * y + z * z)
    rot[..., 0, 1] = 2 * (x * y - z * w)
    rot[..., 0, 2] = 2 * (x * z + y * w)
    rot[..., 1, 0] = 2 * (x * y + z * w)
    rot[..., 1, 1] = 1 - 2 * (x * x + z * z)
    rot[..., 1, 2] = 2 * (y * z - x * w)
    rot[..., 2, 0] = 2 * (x * z - y * w)
    rot[..., 2, 1] = 2 * (y * z + x * w)
    rot[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return rot


def rotation_to_quat(rot: np.ndarray) -> np.ndarray:
    """Rotation matrix(es) ``(..., 3, 3)`` → quaternion ``(..., 4)`` (qx,qy,qz,qw).

    Shepperd's method (branch on the largest diagonal term) for numerical
    stability near all rotation angles.
    """
    rot = np.asarray(rot, np.float64)
    batch = rot.shape[:-2]
    r = rot.reshape((-1, 3, 3))
    out = np.empty((r.shape[0], 4), np.float64)
    for i, m in enumerate(r):
        tr = m[0, 0] + m[1, 1] + m[2, 2]
        if tr > 0:
            s = np.sqrt(tr + 1.0) * 2
            out[i] = [
                (m[2, 1] - m[1, 2]) / s,
                (m[0, 2] - m[2, 0]) / s,
                (m[1, 0] - m[0, 1]) / s,
                0.25 * s,
            ]
        elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
            s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
            out[i] = [
                0.25 * s,
                (m[0, 1] + m[1, 0]) / s,
                (m[0, 2] + m[2, 0]) / s,
                (m[2, 1] - m[1, 2]) / s,
            ]
        elif m[1, 1] > m[2, 2]:
            s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
            out[i] = [
                (m[0, 1] + m[1, 0]) / s,
                0.25 * s,
                (m[1, 2] + m[2, 1]) / s,
                (m[0, 2] - m[2, 0]) / s,
            ]
        else:
            s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
            out[i] = [
                (m[0, 2] + m[2, 0]) / s,
                (m[1, 2] + m[2, 1]) / s,
                0.25 * s,
                (m[1, 0] - m[0, 1]) / s,
            ]
    out /= np.linalg.norm(out, axis=-1, keepdims=True)
    return out.reshape(batch + (4,))


def cam_to_world_to_wc(r_wc_cam: np.ndarray, centers: np.ndarray):
    """Camera→world poses (R_cw rotation, camera centers) → world→camera.

    ``x_world = R_cw @ x_cam + c``  ⇒  ``R = R_cwᵀ, t = -R_cwᵀ c``.
    """
    rot = np.swapaxes(np.asarray(r_wc_cam, np.float64), -1, -2)
    t = -np.einsum("...ij,...j->...i", rot, np.asarray(centers, np.float64))
    return rot, t


def wc_to_cam_to_world(rotations: np.ndarray, translations: np.ndarray):
    """World→camera poses → (camera→world rotations, camera centers)."""
    r_cw = np.swapaxes(np.asarray(rotations, np.float64), -1, -2)
    centers = -np.einsum(
        "...ij,...j->...i", r_cw, np.asarray(translations, np.float64)
    )
    return r_cw, centers


def write_tum_trajectory(
    path: str,
    timestamps: np.ndarray,
    rotations: np.ndarray,
    translations: np.ndarray,
) -> None:
    """Write world→camera poses as a TUM trajectory file.

    One line per frame: ``timestamp tx ty tz qx qy qz qw`` in
    camera→world convention (the format ground-truth files and external
    evaluators use).
    """
    r_cw, centers = wc_to_cam_to_world(rotations, translations)
    quats = rotation_to_quat(r_cw)
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for ts, c, q in zip(timestamps, centers, quats):
            f.write(
                f"{ts:.6f} {c[0]:.9f} {c[1]:.9f} {c[2]:.9f} "
                f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
            )


def read_tum_trajectory(path: str):
    """Read a TUM trajectory file → (timestamps, world→camera R, t).

    Raises ``ValueError`` naming the offending line for truncated rows
    (e.g. a partially written export) instead of an opaque ragged-array
    failure; an all-comment/empty file returns empty arrays.
    """
    ts, rows = [], []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) < 8:
                raise ValueError(
                    f"{path}:{lineno}: expected 8 fields "
                    f"(ts tx ty tz qx qy qz qw), got {len(vals)}"
                )
            ts.append(vals[0])
            rows.append(vals[1:8])
    if not rows:
        return (
            np.zeros(0),
            np.zeros((0, 3, 3)),
            np.zeros((0, 3)),
        )
    rows = np.asarray(rows, np.float64)
    r_cw = quat_to_rotation(rows[:, 3:7])
    rot, t = cam_to_world_to_wc(r_cw, rows[:, 0:3])
    return np.asarray(ts), rot, t
