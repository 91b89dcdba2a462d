"""Trajectory evaluation: ATE / RPE.

Port of the JAX package's ``sfm/evaluate.py``. Absolute trajectory error
with Umeyama similarity alignment (the standard TUM-RGBD evaluation
protocol): estimated camera centres are aligned to ground truth with the
closed-form similarity (R, t, s), then ATE is the RMS of residual centre
distances. RPE measures frame-to-frame relative pose drift.
"""

from __future__ import annotations

import torch


def camera_centers(rotations, translations):
    """World-space camera centres from world→camera poses: ``-Rᵀt``."""
    return -(rotations.transpose(-1, -2) @ translations[..., None])[..., 0]


def umeyama_alignment(src, dst, with_scale: bool = True):
    """Closed-form similarity aligning ``src`` → ``dst`` (N, 3) each.

    Returns ``(s, R, t)`` with ``dst ≈ s·R·src + t``.
    """
    mu_s = src.mean(dim=0)
    mu_d = dst.mean(dim=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    u, d, vt = torch.linalg.svd(cov)
    sgn = torch.sign(torch.linalg.det(u @ vt))
    signs = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn])
    rot = u @ torch.diag(signs) @ vt
    if with_scale:
        var_s = (xs * xs).sum(dim=-1).mean()
        scale = (d * signs).sum() / var_s.clamp(min=1e-12)
    else:
        scale = torch.ones_like(sgn)
    t = mu_d - scale * (rot @ mu_s)
    return scale, rot, t


def absolute_trajectory_error(
    est_rotations,
    est_translations,
    gt_rotations,
    gt_translations,
    with_scale: bool = True,
):
    """ATE RMSE after Umeyama alignment of camera centres.

    ``with_scale=True`` is the monocular convention (scale is
    unobservable). Returns a scalar RMSE in ground-truth units.
    """
    est_c = camera_centers(est_rotations, est_translations)
    gt_c = camera_centers(gt_rotations, gt_translations)
    s, rot, t = umeyama_alignment(est_c, gt_c, with_scale)
    aligned = s * est_c @ rot.T + t
    err2 = ((aligned - gt_c) ** 2).sum(dim=-1)
    return torch.sqrt(err2.mean())


def relative_pose_error(
    est_rotations,
    est_translations,
    gt_rotations,
    gt_translations,
    delta: int = 1,
    with_scale: bool = True,
):
    """Translational RPE, TUM ``evaluate_rpe.py`` protocol.

    Per pair ``(i, i+delta)`` the error motion is
    ``E_i = (Q_i⁻¹ Q_{i+δ})⁻¹ (P_i⁻¹ P_{i+δ})`` (Q ground truth, P
    estimate, both cam→world); the reported value is the RMSE of
    ``‖trans(E_i)‖``, which reduces to ``‖R_i^est·(c_{i+δ}−c_i)^est −
    R_i^gt·(c_{i+δ}−c_i)^gt‖`` for world→camera inputs. A monocular
    estimate is pre-scaled by the Umeyama similarity scale of the ATE
    alignment (the official script's ``--scale`` argument);
    ``with_scale=False`` skips that.
    """
    est_c = camera_centers(est_rotations, est_translations)
    gt_c = camera_centers(gt_rotations, gt_translations)
    s = umeyama_alignment(est_c, gt_c)[0] if with_scale else 1.0
    tb = s * (est_rotations[:-delta] @ (est_c[delta:] - est_c[:-delta])[..., None])[..., 0]
    ta = (gt_rotations[:-delta] @ (gt_c[delta:] - gt_c[:-delta])[..., None])[..., 0]
    err2 = ((tb - ta) ** 2).sum(dim=-1)
    return torch.sqrt(err2.mean())


def relative_rotation_error(est_rotations, gt_rotations, delta: int = 1):
    """Rotational RPE (radians, RMSE): angle of ``rot(E_i)`` per pair
    ``(i, i+delta)`` under the TUM protocol (scale-free)."""
    rb = est_rotations[:-delta] @ est_rotations[delta:].transpose(-1, -2)
    ra = gt_rotations[:-delta] @ gt_rotations[delta:].transpose(-1, -2)
    rel = ra.transpose(-1, -2) @ rb  # Raᵀ·Rb
    trace = rel.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
    ang = torch.acos(((trace - 1.0) / 2.0).clamp(-1.0, 1.0))
    return torch.sqrt((ang * ang).mean())
