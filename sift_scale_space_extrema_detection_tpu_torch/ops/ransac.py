"""Vectorized RANSAC essential-matrix estimation + pose recovery.

Port of the JAX package's ``ops/ransac.py``. Instead of the classic
sequential hypothesize-and-verify loop, all hypotheses are processed as
one batch:

- sample ``(H, 8)`` distinct correspondence indices: the 8 largest of
  per-hypothesis random keys,
- solve all 8-point problems with one batched SVD (Hartley-normalized),
- score every hypothesis against every correspondence with one
  contraction (Sampson error, ``(H, N)``),
- polish the top-K hypotheses as one batch (pose recovery + annealed IRLS
  Levenberg-Marquardt on the essential manifold) and keep the winner by
  final inlier count.

Where the JAX package maps a per-hypothesis function over the batch, the
functions here take leading batch dimensions themselves, and the
Levenberg-Marquardt step uses the closed-form Jacobian of the Sampson
residual (:func:`_sampson_terms`; held against forward-mode autodiff of
:func:`_sampson_residuals` in the tests). Nothing in the pipeline reads a
value back to the host.

Inputs are normalized camera rays (pixels through K⁻¹,
``sfm.geometry.backproject``), so thresholds are in normalized image
units (pixel_thresh / focal_length).

The sign of a singular vector differs between LAPACK and cuSOLVER; ``E``
and ``−E`` give the same four pose candidates, so compare poses and inlier
sets across devices, never ``E`` or the hypotheses.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.device import Device, resolve_device
from ..sfm.geometry import hat, so3_exp, triangulate_midpoint


@dataclasses.dataclass
class EssentialResult:
    e_mat: torch.Tensor  # (3, 3) best essential matrix (refit on inliers)
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int32
    rotation: torch.Tensor  # (3, 3) world->cam2 rotation (cam1 = identity)
    translation: torch.Tensor  # (3,) unit-norm translation


def _eight_point_nullvec(a_rows: torch.Tensor) -> torch.Tensor:
    """Least-squares null vector of batched ``(..., K, 9)`` constraint rows.

    Uses the right-singular vector of A directly (batched SVD), not the
    smallest eigenvector of AᵀA: squaring doubles the condition number's
    exponent, which in float32 turns minimal-sample fits into noise.
    ``full_matrices=True`` is load-bearing: an 8×9 minimal system's null
    vector is the 9th right-singular vector, which the reduced SVD (8 rows
    of Vᵀ) drops.
    """
    _, _, vt = torch.linalg.svd(a_rows, full_matrices=True)
    return vt[..., -1, :]


def _project_to_essential(e_mat: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix: SVD with singular values (1, 1, 0)."""
    u, _, vt = torch.linalg.svd(e_mat)
    s = torch.tensor([1.0, 1.0, 0.0], dtype=e_mat.dtype, device=e_mat.device)
    return u @ (s[:, None] * vt)


def _epipolar_rows(rays1: torch.Tensor, rays2: torch.Tensor) -> torch.Tensor:
    """Constraint rows ``kron(ray2, ray1)``: ``(..., N, 9)``.

    Row·vec(E) = ray2ᵀ E ray1 with E flattened row-major.
    """
    return (rays2[..., :, None] * rays1[..., None, :]).reshape(
        rays1.shape[:-1] + (9,)
    )


def _normalizing_transform(rays: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Hartley normalization: similarity T centring weighted (x, y) at 0
    with RMS radius √2. Essential for float32: κ(A) of raw-ray constraint
    rows exceeds the usable float32 margin even with the direct-SVD
    nullspace solve."""
    wsum = weight.sum().clamp(min=1.0)
    mean = (rays[:, :2] * weight[:, None]).sum(dim=0) / wsum
    d2 = ((rays[:, :2] - mean) ** 2).sum(dim=-1)
    rms = torch.sqrt(((d2 * weight).sum() / wsum).clamp(min=1e-12))
    s = 2.0**0.5 / rms
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack(
        [
            torch.stack([s, zero, -s * mean[0]]),
            torch.stack([zero, s, -s * mean[1]]),
            torch.stack([zero, zero, one]),
        ]
    )


def _epipolar_lines(e_mat, rays1, rays2):
    """``(E·r1, Eᵀ·r2)``, each ``(..., N, 3)``, of ``(..., 3, 3)`` matrices
    and ``(N, 3)`` rays."""
    return rays1 @ e_mat.transpose(-1, -2), rays2 @ e_mat


def _sampson_den(er1, etr2):
    return er1[..., 0] ** 2 + er1[..., 1] ** 2 + etr2[..., 0] ** 2 + etr2[..., 1] ** 2


def sampson_error(e_mat: torch.Tensor, rays1: torch.Tensor, rays2: torch.Tensor):
    """First-order epipolar (Sampson) error, broadcast over hypotheses.

    ``e_mat``: ``(..., 3, 3)``; rays ``(N, 3)``. Returns ``(..., N)``.
    """
    er1, etr2 = _epipolar_lines(e_mat, rays1, rays2)
    num = (rays2 * er1).sum(dim=-1) ** 2
    return num / _sampson_den(er1, etr2).clamp(min=1e-12)


def decompose_essential(e_mat: torch.Tensor):
    """E → four (R, t) candidates: (R1, ±t), (R2, ±t)."""
    u, _, vt = torch.linalg.svd(e_mat)
    # Enforce proper rotations (the sign factors broadcast over any leading
    # hypothesis batch: det is (...,), the matrices (..., 3, 3)).
    u = u * torch.sign(torch.linalg.det(u))[..., None, None]
    vt = vt * torch.sign(torch.linalg.det(vt))[..., None, None]
    w = torch.tensor(
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
        dtype=e_mat.dtype,
        device=e_mat.device,
    )
    r1 = u @ w @ vt
    r2 = u @ w.T @ vt
    t = u[..., :, 2]
    return (r1, r2), t


def recover_pose(
    e_mat: torch.Tensor,
    rays1: torch.Tensor,
    rays2: torch.Tensor,
    weight: torch.Tensor,
):
    """Choose the (R, t) decomposition with maximal positive-depth support.

    ``e_mat``: ``(..., 3, 3)``; rays ``(N, 3)``; ``weight``: ``(..., N)``
    per-correspondence float mask. Returns ``(R, t)`` of the world→camera-2
    pose with camera 1 at identity, ``t`` unit norm.
    """
    (r1, r2), t = decompose_essential(e_mat)
    cands_r = torch.stack([r1, r1, r2, r2], dim=-3)  # (..., 4, 3, 3)
    cands_t = torch.stack([t, -t, t, -t], dim=-2)  # (..., 4, 3)
    eye = torch.eye(3, dtype=e_mat.dtype, device=e_mat.device)
    _, depths = triangulate_midpoint(
        eye, torch.zeros_like(eye[0]), cands_r, cands_t, rays1, rays2
    )
    good = (depths[..., 0] > 0) & (depths[..., 1] > 0)  # (..., 4, N)
    scores = (good * weight[..., None, :]).sum(dim=-1)
    best = scores.argmax(dim=-1)[..., None, None]  # the first of equal scores
    rot = cands_r.take_along_dim(best[..., None], dim=-3)[..., 0, :, :]
    return rot, cands_t.take_along_dim(best, dim=-2)[..., 0, :]


def _sampson_residuals(params, rot, t, rays1, rays2, weight):
    """Signed Sampson residuals ``(N,)`` of one pose under the increment
    ``params`` = (ω, δt): ``R ← exp(ω)·R``, ``t ← normalize(t + δt)``.

    ``(r2ᵀ·E·r1)/√den`` is smooth everywhere; ``√sampson_error`` would have
    a gradient singularity at zero residual that lets perfectly fit points
    dominate JᵀJ. Kept as the autodiff reference that the closed form of
    :func:`_sampson_terms` is tested against.
    """
    r_cur = so3_exp(params[:3]) @ rot
    t_cur = t + params[3:]
    t_cur = t_cur / torch.sqrt((t_cur * t_cur).sum() + 1e-12)
    er1, etr2 = _epipolar_lines(hat(t_cur) @ r_cur, rays1, rays2)
    num = (rays2 * er1).sum(dim=-1)
    return (num / torch.sqrt(_sampson_den(er1, etr2) + 1e-12)) * weight


def _sampson_terms(rot, t, rays1, rays2, weight):
    """Residuals ``(..., N)`` of :func:`_sampson_residuals` at a zero
    increment and their Jacobian ``(..., N, 6)``, in closed form, for
    ``(..., 3, 3)`` rotations, ``(..., 3)`` translations and ``(..., N)``
    weights over shared ``(N, 3)`` rays.

    With ``E = [t̂]× R`` and ``s = √(|t|² + 1e-12)``, ``t̂ = t/s``:

        ∂E/∂ω_k  = [t̂]× [e_k]× R
        ∂E/∂δt_k = [e_k/s − t·t_k/s³]× R
        r = num/√(den + ε):  ∂r = ∂num/√(den + ε) − ½·num·∂den/(den + ε)^{3/2}
    """
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    s = torch.sqrt((t * t).sum(dim=-1, keepdim=True) + 1e-12)
    t_hat = t / s
    er1, etr2 = _epipolar_lines(hat(t_hat) @ rot, rays1, rays2)
    num = (rays2 * er1).sum(dim=-1)
    den = _sampson_den(er1, etr2) + 1e-12
    root = torch.sqrt(den)
    res = (num / root) * weight

    basis = hat(eye)  # (3, 3, 3): [e_k]×
    d_rot = hat(t_hat)[..., None, :, :] @ basis @ rot[..., None, :, :]
    dt_hat = eye / s[..., None] - t[..., :, None] * t[..., None, :] / s[..., None] ** 3
    d_trans = hat(dt_hat) @ rot[..., None, :, :]
    d_e = torch.cat([d_rot, d_trans], dim=-3)  # (..., 6, 3, 3)
    d_er1, d_etr2 = _epipolar_lines(d_e, rays1, rays2)  # (..., 6, N, 3)
    d_num = (rays2 * d_er1).sum(dim=-1)
    d_den = 2.0 * (
        er1[..., None, :, 0] * d_er1[..., 0]
        + er1[..., None, :, 1] * d_er1[..., 1]
        + etr2[..., None, :, 0] * d_etr2[..., 0]
        + etr2[..., None, :, 1] * d_etr2[..., 1]
    )
    jac = d_num / root[..., None, :] - 0.5 * num[..., None, :] * d_den / (
        den * root
    )[..., None, :]
    return res, (jac * weight[..., None, :]).transpose(-1, -2)


def refine_relative_pose(
    rot: torch.Tensor,
    t: torch.Tensor,
    rays1: torch.Tensor,
    rays2: torch.Tensor,
    weight: torch.Tensor,
    iterations: int = 8,
    damping: float = 1e-6,
):
    """Levenberg-Marquardt polish of (R, t) minimizing weighted Sampson
    error, for a batch of poses ``(..., 3, 3)``/``(..., 3)`` with weights
    ``(..., N)`` over shared rays ``(N, 3)``.

    The linear 8-point fit minimizes algebraic error, which at realistic
    keypoint noise lands far from the Sampson optimum; this loop on the
    essential manifold closes the gap. Parameterization:
    left-multiplicative so3 increment on R, free 3-vector on t renormalized
    each step (scale is unobservable; the normalization removes the gauge
    direction up to the damping). Branchless: each iteration computes the
    step at the current damping, accepts it only if the cost drops, and
    adapts the damping, all with ``torch.where`` and no host control flow
    (plain Gauss-Newton diverges on small inlier sets).
    """
    eye6 = torch.eye(6, dtype=rot.dtype, device=rot.device)
    res, jac = _sampson_terms(rot, t, rays1, rays2, weight)
    cost = (res**2).sum(dim=-1)
    lam = torch.full_like(cost, 1e-3)
    for _ in range(iterations):
        jtj = jac.transpose(-1, -2) @ jac
        diag = jtj.diagonal(dim1=-2, dim2=-1).clamp(min=1e-9)
        jtj_damped = jtj + lam[..., None, None] * torch.diag_embed(diag) + damping * eye6
        rhs = (jac.transpose(-1, -2) @ res[..., None])[..., 0]
        step = -torch.linalg.solve(jtj_damped, rhs)
        rot_new = so3_exp(step[..., :3]) @ rot
        t_new = t + step[..., 3:]
        t_new = t_new / torch.sqrt((t_new * t_new).sum(dim=-1, keepdim=True) + 1e-12)
        res_new, jac_new = _sampson_terms(rot_new, t_new, rays1, rays2, weight)
        cost_new = (res_new**2).sum(dim=-1)
        accept = cost_new < cost
        rot = torch.where(accept[..., None, None], rot_new, rot)
        t = torch.where(accept[..., None], t_new, t)
        res = torch.where(accept[..., None], res_new, res)
        jac = torch.where(accept[..., None, None], jac_new, jac)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.where(accept, lam * 0.33, lam * 8.0).clamp(1e-9, 1e6)
    return rot, t


def sample_minimal_sets(
    valid: torch.Tensor, num_hypotheses: int, generator: torch.Generator
) -> torch.Tensor:
    """``(H, 8)`` distinct valid slots per hypothesis: the 8 largest of
    per-hypothesis uniform keys, invalid slots keyed −1. (Sampling with
    replacement makes about a third of the hypotheses rank-deficient at
    N≈64: a duplicated row leaves a 2-D nullspace.)

    The keys are drawn on the generator's own device and copied to
    ``valid``'s, so a CPU generator gives a CPU run and a card run the same
    hypotheses. A stable sort orders ties by slot (with fewer than 8 valid
    slots the row ends in ties at −1), which ``torch.topk`` does not
    promise.
    """
    u = torch.rand(
        (num_hypotheses, valid.shape[0]), generator=generator, device=generator.device
    ).to(valid.device)
    u = torch.where(valid[None, :], u, -1.0)
    return u.sort(dim=1, descending=True, stable=True).indices[:, :8]


def essential_from_samples(
    rays1: torch.Tensor,
    rays2: torch.Tensor,
    valid: torch.Tensor,
    idx: torch.Tensor,
    inlier_threshold: float = 2e-3,
) -> EssentialResult:
    """Everything of :func:`estimate_essential_ransac` after the draw: a
    function of the ``(H, 8)`` sample indices ``idx``."""
    dtype = rays1.dtype
    w = valid.to(dtype)

    # Hartley-normalize both views; the fitted Ê relates normalized rays,
    # E = T2ᵀ·Ê·T1 undoes it.
    t1 = _normalizing_transform(rays1, w)
    t2 = _normalizing_transform(rays2, w)
    rows_all = _epipolar_rows(rays1 @ t1.T, rays2 @ t2.T)  # (N, 9)
    e_flat = _eight_point_nullvec(rows_all[idx])  # (H, 8, 9) -> (H, 9)
    e_h = _project_to_essential(t2.T @ e_flat.reshape(-1, 3, 3) @ t1)

    thr2 = inlier_threshold * inlier_threshold
    inlier_mat = (sampson_error(e_h, rays1, rays2) < thr2) & valid[None, :]
    counts = inlier_mat.sum(dim=-1)

    # Local optimization (batched LO-RANSAC): minimal/algebraic fits plateau
    # far below the true inlier count at realistic noise, and the single
    # best hypothesis can sit in a degenerate basin, so polish the top-K
    # hypotheses as one batch (recover pose → IRLS Levenberg-Marquardt with
    # Cauchy weights over all correspondences) and keep the winner by final
    # inlier count. The counts tie often: a stable sort takes the lowest
    # hypothesis among equals.
    top_k = min(8, idx.shape[0])
    cand = counts.sort(descending=True, stable=True).indices[:top_k]
    rots, ts = recover_pose(e_h[cand], rays1, rays2, inlier_mat[cand].to(dtype))
    # Graduated non-convexity: start the Cauchy scale wide so points the
    # bad initial model misses still pull, then tighten. A fixed scale of
    # thr² freezes every hypothesis in its initial basin.
    for scale in (100.0, 25.0, 5.0, 1.0):
        err_c = sampson_error(hat(ts) @ rots, rays1, rays2)
        w_irls = w * (1.0 / (1.0 + err_c / (scale * thr2)))
        rots, ts = refine_relative_pose(rots, ts, rays1, rays2, w_irls, iterations=4)
    n_ins = ((sampson_error(hat(ts) @ rots, rays1, rays2) < thr2) & valid).sum(dim=-1)
    win = n_ins.argmax().reshape(1)
    rot, t = rots.index_select(0, win)[0], ts.index_select(0, win)[0]
    e_best = hat(t) @ rot
    inliers = (sampson_error(e_best, rays1, rays2) < thr2) & valid

    # Final cheirality re-validation: Sampson error is invariant to the
    # sign of t and to the twisted pair, so the polish can drift onto a
    # decomposition branch whose depths are negative even though the
    # initial pose was depth-checked. Re-pick the positive-depth
    # decomposition of the final E over the final inliers.
    rot, t = recover_pose(e_best, rays1, rays2, inliers.to(dtype))

    # With fewer than 8 valid correspondences the samples hold invalid
    # slots and the 8-point system is underdetermined: report zero inliers
    # so callers take their too-few-points path.
    inliers = inliers & (valid.sum() >= 8)

    return EssentialResult(
        e_mat=e_best,
        inliers=inliers,
        num_inliers=inliers.sum().to(torch.int32),
        rotation=rot,
        translation=t,
    )


def estimate_essential_ransac(
    rays1: torch.Tensor,
    rays2: torch.Tensor,
    valid: torch.Tensor,
    generator: torch.Generator,
    num_hypotheses: int = 512,
    inlier_threshold: float = 2e-3,
    device: Device = None,
) -> EssentialResult:
    """Batched-hypothesis RANSAC over fixed-capacity correspondence slots.

    ``rays1``/``rays2``: ``(N, 3)`` normalized rays; ``valid``: ``(N,)``.
    ``inlier_threshold`` is on the square root of the Sampson error, in
    normalized units (≈ pixel_threshold / focal_px). ``generator`` seeds
    the draw (:func:`sample_minimal_sets`); the rest is
    :func:`essential_from_samples`. ``device``: see ``core/device.py``.
    """
    target = resolve_device(rays1, device)
    rays1, rays2, valid = (t.to(target) for t in (rays1, rays2, valid))
    idx = sample_minimal_sets(valid, num_hypotheses, generator)
    return essential_from_samples(rays1, rays2, valid, idx, inlier_threshold)
