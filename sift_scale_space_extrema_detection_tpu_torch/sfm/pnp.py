"""Perspective-n-Point: camera pose from 2D-3D correspondences.

Port of the JAX package's ``sfm/pnp.py``: a linear DLT initialization
(12-unknown SVD) plus a branchless Levenberg-Marquardt reprojection
refinement with optional Huber IRLS, all fixed-shape masked tensor code on
the device of its inputs. In a sequential SLAM loop the previous keyframe's
pose is the natural init and DLT is only needed for relocalization.

The refinement uses the closed-form Jacobian of the reprojection residual
(:func:`_reprojection_terms`; held against forward-mode autodiff of
:func:`_pnp_residuals` in the tests), and nothing in its loop reads a value
back to the host.
"""

from __future__ import annotations

import torch

from ..core.device import Device, resolve_device
from .geometry import so3_exp


def pnp_dlt(
    points: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor, k_mat: torch.Tensor
):
    """Linear PnP: fit P = K[R|t] by SVD, orthogonalize R.

    ``points``: (N, 3) world; ``uv``: (N, 2) pixels; masked by ``valid``.
    Returns (R, t). Needs ≥6 well-spread correspondences; refine with
    :func:`solve_pnp` afterwards.
    """
    dtype, dev = points.dtype, points.device
    fx, fy = k_mat[0, 0], k_mat[1, 1]
    cx, cy = k_mat[0, 2], k_mat[1, 2]
    x = (uv[:, 0] - cx) / fx  # normalized image coordinates
    y = (uv[:, 1] - cy) / fy

    wv = valid.to(dtype)
    # Hartley-style normalization of the 3D points (centre + scale to mean
    # norm √3): the raw DLT columns span X, 1, and x·X magnitudes, and
    # unnormalized float32 fits fail outright on conditioning for scenes
    # offset from the origin. P is denormalized afterwards.
    n_valid = wv.sum().clamp(min=1.0)
    centroid = (points * wv[:, None]).sum(dim=0) / n_valid
    centered = points - centroid
    mean_norm = (torch.linalg.norm(centered, dim=-1) * wv).sum() / n_valid
    norm_scale = 3.0**0.5 / mean_norm.clamp(min=1e-12)
    pts_n = centered * norm_scale

    ones = torch.ones_like(x)[:, None]
    zeros = torch.zeros((points.shape[0], 4), dtype=dtype, device=dev)
    xh = torch.cat([pts_n, ones], dim=-1)  # (N, 4)
    w = wv[:, None]
    rows_u = torch.cat([xh, zeros, -x[:, None] * xh], dim=-1) * w
    rows_v = torch.cat([zeros, xh, -y[:, None] * xh], dim=-1) * w
    a = torch.cat([rows_u, rows_v], dim=0)  # (2N, 12)

    _, _, vt = torch.linalg.svd(a, full_matrices=True)
    p_n = vt[-1].reshape(3, 4)
    # Denormalize: x ~ P_n·(T·X_h) with T = [[s·I, −s·c], [0, 1]].
    t_mat = torch.cat(
        [
            norm_scale * torch.eye(3, dtype=dtype, device=dev),
            (-norm_scale * centroid)[:, None],
        ],
        dim=-1,
    )
    last = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=dtype, device=dev)
    p = p_n @ torch.cat([t_mat, last], dim=0)

    xh_raw = torch.cat([points, ones], dim=-1)
    # Sign: points must have positive depth on average (a total choice:
    # sign() could return 0 on exact cancellation and zero the pose).
    depth_sum = ((xh_raw @ p[2]) * wv).sum()
    depth_sign = torch.where(depth_sum >= 0, 1.0, -1.0).to(dtype)
    m = p[:, :3] * depth_sign
    t_raw = p[:, 3] * depth_sign

    # Orthogonalize: R = UVᵀ of M; scale t by the mean singular value.
    u, s, vt2 = torch.linalg.svd(m)
    rot = u @ vt2
    rot = rot * torch.sign(torch.linalg.det(rot))
    return rot, t_raw / s.mean().clamp(min=1e-12)


def _project_residuals(xc, uv, k_mat):
    """``(res (N, 2), z (N,))`` of camera-frame points: predicted −
    observed pixels, with the sign-preserving depth clamp of
    ``geometry.project``: a point marginally behind the camera must not be
    projected as if in front, which would flip the residual's sign and
    inject a wrong-direction row into JᵀJ."""
    z = xc[:, 2]
    eps = torch.where(z < 0, torch.full_like(z, -1e-6), torch.full_like(z, 1e-6))
    z = torch.where(z.abs() < 1e-6, eps, z)
    u = k_mat[0, 0] * xc[:, 0] / z + k_mat[0, 2]
    v = k_mat[1, 1] * xc[:, 1] / z + k_mat[1, 2]
    return torch.stack([u - uv[:, 0], v - uv[:, 1]], dim=-1), z


def _pnp_residuals(params, rot, t, points, uv, k_mat, weights):
    """Weighted reprojection residuals ``(2N,)`` under the pose increment
    ``params`` = (ω, v): ``R ← exp(ω)·R``, ``t ← t + v``. The autodiff
    reference that :func:`_reprojection_terms` is tested against."""
    r_new = so3_exp(params[:3]) @ rot
    xc = points @ r_new.T + t + params[3:]
    res, _ = _project_residuals(xc, uv, k_mat)
    return (res * weights[:, None]).reshape(-1)


def _reprojection_terms(rot, t, points, uv, k_mat, weights):
    """Residuals ``(2N,)`` of :func:`_pnp_residuals` at a zero increment
    and their Jacobian ``(2N, 6)`` in closed form:

        xc = exp(ω)·R·X + t + v,  ∂xc/∂ω = −[R·X]×,  ∂xc/∂v = I
        ∂(u,v)/∂xc = [[fx/z, 0, −fx·x/z²], [0, fy/z, −fy·y/z²]]
    """
    y = points @ rot.T  # R·X
    xc = y + t
    res, z = _project_residuals(xc, uv, k_mat)
    fx, fy = k_mat[0, 0], k_mat[1, 1]
    zero = torch.zeros_like(z)
    inv_z = 1.0 / z
    dp = torch.stack(  # (N, 2, 3)
        [
            torch.stack([fx * inv_z, zero, -fx * xc[:, 0] * inv_z * inv_z], -1),
            torch.stack([zero, fy * inv_z, -fy * xc[:, 1] * inv_z * inv_z], -1),
        ],
        dim=-2,
    )
    y0, y1, y2 = y[:, 0], y[:, 1], y[:, 2]
    neg_hat = torch.stack(  # −[y]× (N, 3, 3)
        [
            torch.stack([zero, y2, -y1], -1),
            torch.stack([-y2, zero, y0], -1),
            torch.stack([y1, -y0, zero], -1),
        ],
        dim=-2,
    )
    jac = torch.cat([dp @ neg_hat, dp], dim=-1) * weights[:, None, None]
    return (res * weights[:, None]).reshape(-1), jac.reshape(-1, 6)


def solve_pnp(
    points: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    k_mat: torch.Tensor,
    init_rotation: torch.Tensor,
    init_translation: torch.Tensor,
    iterations: int = 10,
    huber_delta: float | None = 2.0,
    device: Device = None,
):
    """LM reprojection refinement of a camera pose (world→camera).

    Branchless accept/reject LM (see ``ops/ransac.refine_relative_pose``
    for why plain Gauss-Newton is not enough). ``huber_delta`` in pixels
    enables IRLS robust weighting; None = plain least squares. Returns
    ``(R, t, rms)`` with rms over valid observations. ``device``: see
    ``core/device.py``.
    """
    target = resolve_device(points, device)
    points, uv, valid, k_mat, rot, t = (
        a.to(target)
        for a in (points, uv, valid, k_mat, init_rotation, init_translation)
    )
    dtype = points.dtype
    wv = valid.to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=target)

    def unweighted(rot, t):
        return _project_residuals(points @ rot.T + t, uv, k_mat)[0]

    def irls_weights(rot, t):
        if huber_delta is None:
            return wv
        res = unweighted(rot, t) * wv[:, None]
        nrm = torch.sqrt((res * res).sum(dim=-1) + 1e-12)
        return wv * torch.sqrt(
            torch.where(nrm <= huber_delta, torch.ones_like(nrm), huber_delta / nrm)
        )

    def lm_rounds(rot, t, weight_fn, n_iter):
        lam = torch.full((), 1e-3, dtype=dtype, device=target)
        for _ in range(n_iter):
            weights = weight_fn(rot, t)
            # The reference cost is taken under the same weights as the
            # proposal's: against a cost carried over from the previous
            # iteration's weights the accept test is inconsistent once
            # IRLS re-weighting kicks in, and LM stalls.
            res, jac = _reprojection_terms(rot, t, points, uv, k_mat, weights)
            cost = (res * res).sum()
            jtj = jac.T @ jac
            jtj_d = jtj + lam * torch.diag(jtj.diagonal().clamp(min=1e-8)) + 1e-9 * eye6
            step = -torch.linalg.solve(jtj_d, jac.T @ res)
            rot_new = so3_exp(step[:3]) @ rot
            t_new = t + step[3:]
            res_new = unweighted(rot_new, t_new) * weights[:, None]
            accept = (res_new * res_new).sum() < cost
            rot = torch.where(accept, rot_new, rot)
            t = torch.where(accept, t_new, t)
            lam = torch.where(accept, lam * 0.33, lam * 8.0).clamp(1e-9, 1e6)
        return rot, t

    rot, t = lm_rounds(rot, t, irls_weights, iterations)

    if huber_delta is not None:
        # Second phase: hard-gate outliers (> 3·δ px) to weight 0 and
        # re-polish: IRLS alone leaves a residual bias from downweighted
        # but nonzero outlier pull.
        res0 = unweighted(rot, t) * wv[:, None]
        nrm = torch.sqrt((res0 * res0).sum(dim=-1) + 1e-12)
        gate = wv * (nrm < 3.0 * huber_delta)
        rot, t = lm_rounds(rot, t, lambda *_: gate, max(iterations // 2, 3))

    res = unweighted(rot, t) * wv[:, None]
    rms = torch.sqrt((res * res).sum() / wv.sum().clamp(min=1.0))
    return rot, t, rms
