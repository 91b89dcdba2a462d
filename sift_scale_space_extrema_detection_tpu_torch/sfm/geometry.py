"""Projective geometry primitives: SO(3)/SE(3), projection, triangulation.

Port of the JAX package's ``sfm/geometry.py``. Batched over leading
dimensions, on the device and in the dtype of the inputs (float32 on the
card, float64 in the CPU tests). Conventions:

- World-to-camera: ``x_cam = R @ x_world + t`` (pose = (R, t)).
- Pixel projection: ``u = K @ normalize(x_cam)`` with K upper-triangular
  ``[[fx, 0, cx], [0, fy, cy], [0, 0, 1]]``.
- so(3)/se(3) exp/log use the closed-form Rodrigues series with Taylor
  branches near θ=0 so that forward-mode derivatives stay finite (the pose
  graph differentiates through these maps with ``torch.func.jacfwd``).
"""

from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat map: ``(..., 3) -> (..., 3, 3)`` skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _small_angle(w: torch.Tensor):
    """``(theta2, small, theta2_safe, theta)`` of ``(..., 3)`` axis-angles,
    each ``(..., 1, 1)``. The untaken branch of a ``where`` must not
    compute 0/0, or its NaN poisons the tangent: where θ² is small the
    closed forms divide by 1 in its place."""
    theta2 = (w * w).sum(dim=-1)[..., None, None]
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    return theta2, small, theta2_safe, torch.sqrt(theta2_safe)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle ``(..., 3)`` → rotation matrix ``(..., 3, 3)``.

    Taylor expansions below θ²≈1e-8 keep the map and its JVP finite at 0.
    """
    theta2, small, theta2_safe, theta = _small_angle(w)
    k = hat(w)
    k2 = k @ k
    sin_t = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cos_t = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe
    )
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + sin_t * k + cos_t * k2


def so3_log(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``(..., 3, 3)`` → axis-angle ``(..., 3)``."""
    # The trace keeps its last axis: under ``vmap(jacfwd(...))`` a 0-dim
    # float32 value combined with a Python scalar gets a float64 tangent.
    trace = rot.diagonal(dim1=-2, dim2=-1).sum(dim=-1, keepdim=True)
    cos_theta = ((trace - 1.0) / 2.0).clamp(-1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.acos(cos_theta)
    vee = torch.stack(
        [
            rot[..., 2, 1] - rot[..., 1, 2],
            rot[..., 0, 2] - rot[..., 2, 0],
            rot[..., 1, 0] - rot[..., 0, 1],
        ],
        dim=-1,
    )
    # The threshold must sit above the floor the cos clamp imposes
    # (acos(1 − 1e-7) ≈ 4.5e-4) or the Taylor branch is dead code; 1e-3
    # keeps θ/(2·sinθ) comfortably stable on the other side.
    small = theta < 1e-3
    scale = torch.where(
        small, 0.5 + theta**2 / 12.0, theta / (2.0 * torch.sin(theta))
    )
    return scale * vee


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """se(3) twist ``(..., 6)`` = (ω, v) → ``(R, t)``."""
    w, v = xi[..., :3], xi[..., 3:]
    rot = so3_exp(w)
    theta2, small, theta2_safe, theta = _small_angle(w)
    k = hat(w)
    k2 = k @ k
    a = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe
    )
    b = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2_safe * theta),
    )
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    jl = eye + a * k + b * k2
    return rot, (jl @ v[..., None])[..., 0]


def se3_log(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``(R, t)`` → twist ``(..., 6)`` = (ω, v) with ``v = J_l(ω)⁻¹ t``.

    Inverse left-Jacobian in closed form with a Taylor branch near 0;
    valid for θ < π (the branch caveat of :func:`so3_log`).
    """
    w = so3_log(rot)
    theta2, small, theta2_safe, theta = _small_angle(w)
    k = hat(w)
    k2 = k @ k
    b = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 / theta2_safe)
        - (1.0 + torch.cos(theta)) / (2.0 * theta * torch.sin(theta)),
    )
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    jl_inv = eye - 0.5 * k + b * k2
    v = (jl_inv @ t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def compose(r1, t1, r2, t2):
    """(R1,t1)·(R2,t2): apply pose2 then pose1."""
    return r1 @ r2, (r1 @ t2[..., None])[..., 0] + t1


def invert(rot, t):
    rt = rot.transpose(-1, -2)
    return rt, -(rt @ t[..., None])[..., 0]


def transform(rot, t, pts):
    """Apply ``(..., 3, 3)``, ``(..., 3)`` to points ``(..., N, 3)``."""
    return pts @ rot.transpose(-1, -2) + t[..., None, :]


def project(pts_cam: torch.Tensor, k_mat: torch.Tensor) -> torch.Tensor:
    """Pinhole projection of camera-frame points ``(..., N, 3)`` → px.

    Depth is clamped away from zero (sign-preserving) so points at/behind
    the camera produce finite-but-wrong pixels instead of NaNs; callers
    mask by depth.
    """
    z = pts_cam[..., 2:3]
    eps = torch.where(z < 0, torch.full_like(z, -1e-6), torch.full_like(z, 1e-6))
    z_safe = torch.where(z.abs() < 1e-6, eps, z)
    uv1 = pts_cam / z_safe
    fx = k_mat[..., 0, 0]
    fy = k_mat[..., 1, 1]
    cx = k_mat[..., 0, 2]
    cy = k_mat[..., 1, 2]
    u = fx[..., None] * uv1[..., 0] + cx[..., None]
    v = fy[..., None] * uv1[..., 1] + cy[..., None]
    return torch.stack([u, v], dim=-1)


def backproject(uv: torch.Tensor, k_mat: torch.Tensor) -> torch.Tensor:
    """Pixels ``(..., N, 2)`` → normalized camera rays ``(..., N, 3)``."""
    fx = k_mat[..., 0, 0]
    fy = k_mat[..., 1, 1]
    cx = k_mat[..., 0, 2]
    cy = k_mat[..., 1, 2]
    x = (uv[..., 0] - cx[..., None]) / fx[..., None]
    y = (uv[..., 1] - cy[..., None]) / fy[..., None]
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def triangulate_midpoint(
    r1, t1, r2, t2, rays1: torch.Tensor, rays2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Midpoint triangulation of ray pairs in world frame.

    ``(r_i, t_i)`` are world→camera poses, ``(..., 3, 3)`` and ``(..., 3)``;
    ``rays_i`` are camera-frame unit-ish rays ``(..., N, 3)``. Solves the
    2×2 normal equations for the closest points along each ray in closed
    form and returns ``(points (..., N, 3), depths (..., N, 2))``: depths
    in each camera, for cheirality tests.
    """
    c1 = invert(r1, t1)
    c2 = invert(r2, t2)
    o1 = c1[1][..., None, :]  # camera centres in world
    o2 = c2[1][..., None, :]
    d1 = rays1 @ r1  # rays · (Rᵀ)ᵀ: the rays in the world frame
    d2 = rays2 @ r2

    b = o2 - o1
    d11 = (d1 * d1).sum(dim=-1)
    d22 = (d2 * d2).sum(dim=-1)
    d12 = (d1 * d2).sum(dim=-1)
    rb1 = (d1 * b).sum(dim=-1)
    rb2 = (d2 * b).sum(dim=-1)
    det = d11 * d22 - d12 * d12
    det_safe = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    s = (rb1 * d22 - rb2 * d12) / det_safe
    u = (rb1 * d12 - rb2 * d11) / det_safe
    p1 = o1 + s[..., None] * d1
    p2 = o2 + u[..., None] * d2
    points = (p1 + p2) / 2.0

    z1 = transform(r1, t1, points)[..., 2]
    z2 = transform(r2, t2, points)[..., 2]
    return points, torch.stack([z1, z2], dim=-1)
