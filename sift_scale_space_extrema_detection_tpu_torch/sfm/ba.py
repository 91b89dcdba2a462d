"""Bundle adjustment with landmark-block Schur complement.

Port of the JAX package's ``sfm/ba.py``: dense-blocked and fixed-capacity
throughout, plain tensor code on the device of its inputs.

- Observations live in a struct-of-arrays buffer ``(O,)`` with
  ``(camera index, landmark index, pixel, valid)``, masked, of static shape.
- Per-observation 2×6 / 2×3 Jacobians are closed-form (the pinhole
  projection chain rule, :func:`_obs_terms`), held in the tests against
  forward-mode autodiff of :func:`_per_obs_residual`.
- The normal equations are dense per-camera ``(C, 6, 6)`` and per-landmark
  ``(L, 3, 3)`` blocks.
- Two Schur solvers:

  * ``solver="dense"`` materializes the camera-landmark coupling
    ``W (C, L, 6, 3)`` and flattens the reduction
    ``S = H_cc − W·H_ll⁻¹·Wᵀ`` into one (6C × 3L)·(3L × 6C) matrix
    product; the reduced 6C × 6C system is solved directly. Right at SLAM
    window scales (C ≲ 10², L ≲ 10⁴).
  * ``solver="cg"`` never materializes ``W``: preconditioned CG on the
    reduced camera system with the Schur product applied matrix-free
    through per-observation gathers. O(O) memory: the path that scales to
    long maps (10³ cameras × 10⁵ landmarks, where the dense ``W`` alone
    would take gigabytes).

- Levenberg-Marquardt: branchless accept/reject with adaptive λ; nothing
  inside the loop reads a value back to the host.

**Determinism.** The accept test compares two costs (``cand_cost <
cost``), so noise in the last bits can flip a step and send two runs on
the same inputs apart. ``index_add_`` on CUDA adds with atomics, in an
order that changes from run to run. Every reduction by segment here is
therefore a reduction over sorted runs (:func:`segment_sum`): the rows are
sorted by segment once per solve, from the indices alone
(:func:`segment_tables`, a stable sort, no host read), and each segment's
run is summed front to back, in O(O) memory whatever the largest segment.
The pose graph assembles its normal system by the same means. Only the
``"scatter"`` assembly's coupling ``W`` is an ``index_add_``; under the
one-observation-per-(camera, landmark) contract each of its slots receives
one addend, which no order can change. The dense solver's ``"sorted"``
assembly also keeps a padded ``(L, M)`` table of each landmark's rows, ``M``
their largest count: ``M`` is at most ``C`` under that contract, so the
table never outgrows the coupling ``W (C, L, 6, 3)`` that this solver
materializes anyway.

Every per-shard quantity is computed by :func:`shard_schur_pieces`
parameterized by the landmark slice a device owns; the single-device path
is the 1-shard case of the same function.

Gauge: the first ``num_fixed_cameras`` poses are frozen (their δ is
zeroed), the standard gauge fix for monocular BA.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.device import Device, on_device, require_full_float32_matmul, resolve_device
from .geometry import so3_exp


@dataclasses.dataclass
class Observations:
    """Fixed-capacity reprojection observations."""

    camera: torch.Tensor  # (O,) int32
    landmark: torch.Tensor  # (O,) int32
    uv: torch.Tensor  # (O, 2) float pixels
    valid: torch.Tensor  # (O,) bool

    @property
    def capacity(self) -> int:
        return self.camera.shape[-1]


@dataclasses.dataclass
class BAState:
    """Poses (world→camera), landmarks, and intrinsics."""

    rotations: torch.Tensor  # (C, 3, 3)
    translations: torch.Tensor  # (C, 3)
    points: torch.Tensor  # (L, 3)
    k_mat: torch.Tensor  # (3, 3) shared intrinsics


def _safe_depth(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)


def reprojection_residuals(state: BAState, obs: Observations) -> torch.Tensor:
    """Masked residuals ``(O, 2)``: predicted − observed pixels.

    Points behind a camera get their residual zeroed via the valid mask
    only if marked; callers should pre-filter cheirality. An index out of
    range (a slot that is not valid may hold anything) reads the nearest row.
    """
    cam = obs.camera.long().clamp(0, state.rotations.shape[0] - 1)
    lm = obs.landmark.long().clamp(0, state.points.shape[0] - 1)
    r = state.rotations[cam]  # (O, 3, 3)
    x = state.points[lm]  # (O, 3)
    xc = (r @ x[:, :, None])[:, :, 0] + state.translations[cam]
    z = _safe_depth(xc[:, 2])
    k = state.k_mat
    u = k[0, 0] * xc[:, 0] / z + k[0, 2]
    v = k[1, 1] * xc[:, 1] / z + k[1, 2]
    res = torch.stack([u, v], dim=-1) - obs.uv
    return res * obs.valid[:, None]


def _per_obs_residual(rot, t, point, uv, k_mat, dc, dl):
    """Residual of one observation under pose increment dc=(ω,v) and
    landmark increment dl: the autodiff reference the closed-form
    Jacobians are tested against."""
    r_new = so3_exp(dc[:3]) @ rot
    xc = r_new @ (point + dl) + t + dc[3:]
    z = _safe_depth(xc[2])
    u = k_mat[0, 0] * xc[0] / z + k_mat[0, 2]
    v = k_mat[1, 1] * xc[1] / z + k_mat[1, 2]
    return torch.stack([u - uv[0], v - uv[1]])


def _obs_terms(rots, ts, kmat, x, cam, uv, mask):
    """Closed-form residuals + Jacobians for all observations, masked.

    ``x`` is the (O, 3) gathered landmark positions. For the
    left-multiplicative pose increment ``R ← exp(ω)·R, t ← t + v`` and
    landmark increment ``X ← X + δ``:

        xc = exp(ω)·R·(X+δ) + t + v
        ∂xc/∂ω = −[R·X]×   ∂xc/∂v = I   ∂xc/∂δ = R
        ∂(u,v)/∂xc = [[fx/z, 0, −fx·x/z²], [0, fy/z, −fy·y/z²]]

    Returns ``(res (O,2), jc (O,2,6), jl (O,2,3))``.
    """
    r = rots[cam]  # (O, 3, 3)
    y = (r @ x[:, :, None])[:, :, 0]  # R·X
    xc = y + ts[cam]
    z = _safe_depth(xc[:, 2])
    fx, fy = kmat[0, 0], kmat[1, 1]
    u = fx * xc[:, 0] / z + kmat[0, 2]
    v = fy * xc[:, 1] / z + kmat[1, 2]
    res = torch.stack([u, v], dim=-1) - uv

    zero = torch.zeros_like(z)
    inv_z = 1.0 / z
    dp = torch.stack(  # dp/dxc (O, 2, 3)
        [
            torch.stack([fx * inv_z, zero, -fx * xc[:, 0] * inv_z * inv_z], -1),
            torch.stack([zero, fy * inv_z, -fy * xc[:, 1] * inv_z * inv_z], -1),
        ],
        dim=-2,
    )
    y0, y1, y2 = y[:, 0], y[:, 1], y[:, 2]
    neg_hat = torch.stack(  # −[y]× (O, 3, 3)
        [
            torch.stack([zero, y2, -y1], -1),
            torch.stack([-y2, zero, y0], -1),
            torch.stack([y1, -y0, zero], -1),
        ],
        dim=-2,
    )
    jc = torch.cat([dp @ neg_hat, dp], dim=-1)  # (O, 2, 6)
    jl = dp @ r  # (O, 2, 3)

    m = mask.to(x.dtype)[:, None]
    return res * m, jc * m[..., None], jl * m[..., None]


def _damp(h, lam):
    """LM damping: multiplicative on diagonals + small absolute floor."""
    diag = h.diagonal(dim1=-2, dim2=-1)
    return h + torch.diag_embed(lam * diag.clamp(min=1e-8) + 1e-8)


def huber_cost(res: torch.Tensor, delta: float | None) -> torch.Tensor:
    """Total (optionally Huber-robust) cost of masked residuals (O, 2).

    The cost definition for every BA solver: the LM accept tests compare
    costs and must agree bit for bit, so this lives in exactly one place.
    ``delta=None`` is plain least squares.
    """
    if delta is None:
        return 0.5 * (res * res).sum()
    nrm = torch.sqrt((res * res).sum(dim=-1) + 1e-12)
    quad = 0.5 * nrm * nrm
    lin = delta * (nrm - 0.5 * delta)
    return torch.where(nrm <= delta, quad, lin).sum()


def huber_weights(res: torch.Tensor, delta: float | None):
    """Per-observation IRLS weights for :func:`huber_cost`'s loss.

    ``None`` when ``delta`` is None (callers skip weighting entirely).
    """
    if delta is None:
        return None
    nrm = torch.sqrt((res * res).sum(dim=-1) + 1e-12)
    return torch.where(nrm <= delta, torch.ones_like(nrm), delta / nrm)


def _apply_sqrt_weight(res, jc, jl, obs_weight):
    """Scale residuals/Jacobians by √w (IRLS); no-op when weight is None."""
    if obs_weight is None:
        return res, jc, jl
    sw = torch.sqrt(obs_weight)[:, None]
    return res * sw, jc * sw[..., None], jl * sw[..., None]


# --- reductions by segment ----------------------------------------------


def _runs(key: torch.Tensor, num_segments: int):
    """``(order, starts, counts)`` of the rows sorted by ``key``: segment
    ``s`` owns the sorted rows ``[starts[s], starts[s] + counts[s])``. Rows
    outside every segment carry the sentinel key ``num_segments``. The sort
    is stable, so a segment's rows keep their order."""
    order = torch.argsort(key, stable=True)
    key_sorted = key[order]
    ids = torch.arange(num_segments, dtype=key.dtype, device=key.device)
    starts = torch.searchsorted(key_sorted, ids, right=False)
    ends = torch.searchsorted(key_sorted, ids, right=True)
    return order, starts, ends - starts


class Segments(NamedTuple):
    """One segmentation of ``O`` rows, sorted: ``order (O,)`` lists the rows
    segment by segment (stable), ``lengths (S + 1,)`` counts the rows of
    each segment and, last, the rows of no segment."""

    order: torch.Tensor
    lengths: torch.Tensor


def segment_tables(seg: torch.Tensor, num_segments: int) -> Segments:
    """Tables for :func:`segment_sum` over ``seg (O,)``; rows whose ``seg``
    lies outside ``[0, num_segments)`` belong to no segment.
    State-independent: built once per solve, with no host read."""
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    order, _, counts = _runs(seg, num_segments)
    rest = seg.shape[0] - counts.sum(dim=0, keepdim=True)
    return Segments(order, torch.cat([counts, rest]))


def segment_sum(data: torch.Tensor, table: Segments) -> torch.Tensor:
    """Sum of the rows of ``data (O, ...)`` by segment, ``(S, ...)``: the
    rows gathered in sorted order and each run reduced front to back. Each
    segment's rows are added in one fixed order, on any device (see the
    module)."""
    sums = torch.segment_reduce(
        data[table.order], "sum", lengths=table.lengths, axis=0, unsafe=True
    )
    return sums[:-1]


def _build_sorted_tables(camera, landmark, valid, num_landmarks, pad_m):
    """Sort-by-landmark index tables for the gather-side assembly.

    Everything here is state-independent (ids/validity only), so a solver
    computes it once per solve and reuses it every LM iteration. Invalid
    observations sort to a sentinel bucket past the last landmark and never
    enter any run. Returns ``(order (O,), pad_idx (L, pad_m) indices into
    the sorted rows, pad_mask (L, pad_m) bool, cam_pad (L, pad_m))``.

    ``pad_m`` must bound the valid observations of one landmark; 0 stands
    for their largest count. That count is read back to the host, once: a
    ``pad_m`` below it would drop rows in silence, so it raises.
    """
    key = torch.where(valid, landmark, num_landmarks)
    order, starts, counts = _runs(key, num_landmarks)
    largest = int(counts.max()) if counts.numel() else 0
    if pad_m <= 0:
        pad_m = max(largest, 1)
    elif pad_m < largest:
        raise ValueError(
            f"sorted_pad: pad {pad_m} is below the largest count of valid "
            f"observations of one landmark, {largest}"
        )
    m = torch.arange(pad_m, device=starts.device)
    pad_idx = (starts[:, None] + m[None, :]).clamp(0, max(camera.shape[0] - 1, 0))
    pad_mask = m[None, :] < counts[:, None]
    return order, pad_idx, pad_mask, camera[order][pad_idx]


class SchurPieces(NamedTuple):
    """Per-shard normal-equation/Schur contributions.

    ``h_cc, b_c, s_off, rhs_off`` are partial sums over the shard's
    observations: a caller spanning several shards must sum them over the
    shards before :func:`solve_reduced`. ``w2 (6C, 3L_local)``, ``h_ll_inv
    (L_local, 3, 3)`` and ``b_l (L_local, 3)`` stay local and feed
    :func:`backsub_landmarks`.
    """

    h_cc: torch.Tensor  # (C, 6, 6)
    b_c: torch.Tensor  # (C, 6)
    s_off: torch.Tensor  # (C, 6, C, 6)   W·H_ll⁻¹·Wᵀ contribution
    rhs_off: torch.Tensor  # (C, 6)       W·H_ll⁻¹·b_l contribution
    w2: torch.Tensor  # (6C, 3L_local)
    h_ll_inv: torch.Tensor  # (L_local, 3, 3)
    b_l: torch.Tensor  # (L_local, 3)


def _camera_blocks(res, jc, cam_table: Segments):
    """``(h_cc (C,6,6), b_c (C,6))``: the camera-side normal blocks."""
    jct = jc.transpose(-1, -2)
    h_cc = segment_sum(jct @ jc, cam_table)
    b_c = segment_sum(-(jct @ res[:, :, None])[:, :, 0], cam_table)
    return h_cc, b_c


def _landmark_blocks(res, jl, lm_table: Segments):
    """``(h_ll (S,3,3), b_l (S,3))``: the landmark-side normal blocks."""
    jlt = jl.transpose(-1, -2)
    h_ll = segment_sum(jlt @ jl, lm_table)
    b_l = segment_sum(-(jlt @ res[:, :, None])[:, :, 0], lm_table)
    return h_ll, b_l


def _schur_reduce(h_cc, b_c, w, h_ll, b_l, lam) -> SchurPieces:
    """The pieces from the normal blocks and the coupling ``w (C, L, 6, 3)``.

    The Schur reduction is flattened to one (6C × 3L)·(3L × 6C) product: a
    properly tiled large matrix product instead of a block contraction
    over (6, 3) tiles.
    """
    require_full_float32_matmul(w.device)
    c, l_local = w.shape[0], w.shape[1]
    h_ll_inv = torch.linalg.inv(_damp(h_ll, lam))
    w_hinv = w @ h_ll_inv  # (C, L, 6, 3) · (L, 3, 3)
    w2 = w.permute(0, 2, 1, 3).reshape(c * 6, l_local * 3)
    wh2 = w_hinv.permute(0, 2, 1, 3).reshape(c * 6, l_local * 3)
    s_off = (wh2 @ w2.T).reshape(c, 6, c, 6)
    rhs_off = (wh2 @ b_l.reshape(l_local * 3)).reshape(c, 6)
    return SchurPieces(h_cc, b_c, s_off, rhs_off, w2, h_ll_inv, b_l)


def _schur_pieces_sorted(
    rots,
    ts,
    kmat,
    points,
    cam,
    lm,
    uv,
    valid,
    lam,
    num_cameras: int,
    tables,
    cam_table: Segments,
    obs_weight=None,
) -> SchurPieces:
    """Dense-path Schur pieces with gather-side landmark reductions.

    One padded row gather of the sorted per-observation rows feeds all
    three landmark-side reductions (``h_ll``, ``b_l`` and the coupling
    ``W``), followed by dense masked reductions; ``W`` is a one-hot
    contraction over the pad axis. Inputs must already be in
    sorted-by-landmark order (apply ``tables[0]`` to the observation buffer
    first); ``tables`` is the :func:`_build_sorted_tables` result and
    ``cam_table`` the :func:`segment_tables` of the sorted cameras.
    """
    dtype = points.dtype
    _, pad_idx, pad_mask, cam_pad = tables
    l_total, pad_m = pad_idx.shape
    o = cam.shape[0]

    # A slot that is not valid may hold any index: gathers read the nearest
    # row, and its masked terms add nothing.
    cam = cam.clamp(0, num_cameras - 1)
    x = points[lm.clamp(0, l_total - 1)]
    res, jc, jl = _obs_terms(rots, ts, kmat, x, cam, uv, valid)
    res, jc, jl = _apply_sqrt_weight(res, jc, jl, obs_weight)
    h_cc, b_c = _camera_blocks(res, jc, cam_table)

    row = torch.cat([jl.reshape(o, 6), res, jc.reshape(o, 12)], dim=1)
    g = row[pad_idx] * pad_mask[:, :, None].to(dtype)  # (L, M, 20)
    jl_p = g[..., :6].reshape(l_total, pad_m, 2, 3)
    res_p = g[..., 6:8]
    jc_p = g[..., 8:20].reshape(l_total, pad_m, 2, 6)

    require_full_float32_matmul(points.device)
    h_ll = torch.einsum("lmki,lmkj->lij", jl_p, jl_p)
    b_l = -torch.einsum("lmki,lmk->li", jl_p, res_p)
    wblk = jc_p.transpose(-1, -2) @ jl_p  # (L, M, 6, 3)
    cams = torch.arange(num_cameras, device=cam_pad.device)
    onehot = (cam_pad[:, :, None] == cams).to(dtype)  # (L, M, C)
    w = torch.einsum("lmc,lmij->clij", onehot, wblk)
    return _schur_reduce(h_cc, b_c, w, h_ll, b_l, lam)


def shard_schur_pieces(
    rots,
    ts,
    kmat,
    points_local,
    cam,
    lm_local,
    uv,
    own,
    lam,
    num_cameras: int,
    obs_weight=None,
    segments: tuple[Segments, Segments] | None = None,
) -> SchurPieces:
    """Schur contribution of one landmark shard (the shared BA core).

    ``points_local (L_local, 3)`` is the shard's landmark slice;
    ``lm_local (O,)`` indexes into it (any value for un-owned rows);
    ``own (O,)`` marks observations whose landmark lives on this shard.
    The single-device solver is the 1-shard call (``own = valid``,
    ``lm_local = landmark``). ``segments`` are the camera and landmark
    :func:`segment_tables` (the latter over ``where(own, lm_local,
    L_local)``); a solver builds them once per solve, and they are built
    here when not given.
    """
    l_local = points_local.shape[0]
    cam, lm_local = cam.long().clamp(0, num_cameras - 1), lm_local.long()
    x = points_local[lm_local.clamp(0, l_local - 1)]
    res, jc, jl = _obs_terms(rots, ts, kmat, x, cam, uv, own)
    res, jc, jl = _apply_sqrt_weight(res, jc, jl, obs_weight)

    seg = torch.where(own, lm_local, l_local)  # overflow bucket for un-owned
    if segments is None:
        segments = (
            segment_tables(cam, num_cameras),
            segment_tables(seg, l_local),
        )
    h_cc, b_c = _camera_blocks(res, jc, segments[0])
    h_ll, b_l = _landmark_blocks(res, jl, segments[1])

    # Dense coupling W: one scatter-add of per-observation (6, 3) blocks
    # into the flattened (C·(L_local+1)) pair axis. A pair's slot receives
    # one addend under the one-observation-per-pair contract.
    pair = cam * (l_local + 1) + seg
    w = torch.zeros(
        (num_cameras * (l_local + 1), 6, 3), dtype=jc.dtype, device=jc.device
    ).index_add_(0, pair, jc.transpose(-1, -2) @ jl)
    w = w.reshape(num_cameras, l_local + 1, 6, 3)[:, :l_local]
    return _schur_reduce(h_cc, b_c, w, h_ll, b_l, lam)


def solve_reduced(
    h_cc, b_c, s_off, rhs_off, lam, num_fixed_cameras: int
) -> torch.Tensor:
    """Solve the reduced (gauge-fixed, damped) camera system → δc (C, 6)."""
    c = h_cc.shape[0]
    dtype = h_cc.dtype
    eye6 = torch.eye(6, dtype=dtype, device=h_cc.device)
    cam_ids = torch.arange(c, device=h_cc.device)

    free = (cam_ids >= num_fixed_cameras).to(dtype)
    # The diagonal blocks: each index pair occurs once, so the indexed
    # assignment adds every block.
    s_mat = -s_off
    s_mat[cam_ids, :, cam_ids, :] += _damp(h_cc, lam)
    s_mat = s_mat * (free[:, None, None, None] * free[None, None, :, None])
    s_mat[cam_ids, :, cam_ids, :] += (1.0 - free)[:, None, None] * eye6
    rhs = (b_c - rhs_off) * free[:, None]

    delta_c = torch.linalg.solve(
        s_mat.reshape(c * 6, c * 6), rhs.reshape(c * 6)
    ).reshape(c, 6)
    return delta_c * free[:, None]


def backsub_landmarks(pieces: SchurPieces, delta_c) -> torch.Tensor:
    """Back-substitute the shard's landmarks: δl = H_ll⁻¹ (b_l − Wᵀ δc)."""
    l_local = pieces.b_l.shape[0]
    wt_dc = (pieces.w2.T @ delta_c.reshape(-1)).reshape(l_local, 3)
    return (pieces.h_ll_inv @ (pieces.b_l - wt_dc)[:, :, None])[:, :, 0]


def apply_step(state: BAState, delta_c, delta_l) -> BAState:
    return dataclasses.replace(
        state,
        rotations=so3_exp(delta_c[:, :3]) @ state.rotations,
        translations=state.translations + delta_c[:, 3:],
        points=state.points + delta_l,
    )


# --- matrix-free (CG) Schur path --------------------------------------


def _cg_delta(
    state: BAState,
    obs: Observations,
    lam,
    num_fixed_cameras: int,
    cg_iterations: int,
    obs_weight,
    segments: tuple[Segments, Segments],
):
    """One damped LM step via matrix-free PCG on the reduced system.

    Never materializes ``W``: every ``S·x`` product routes through the
    observation buffer (two small contractions + reductions by segment),
    so memory is O(O + C·36 + L·9). Block-Jacobi preconditioner from the
    damped ``H_cc`` diagonal blocks. ``segments``: the camera and landmark
    :func:`segment_tables` (the latter over ``where(valid, landmark, L)``).
    """
    num_cameras = state.rotations.shape[0]
    num_points = state.points.shape[0]
    dtype = state.points.dtype
    cam_table, lm_table = segments
    # A slot that is not valid may hold any index: gathers read the nearest
    # row, and its masked terms add nothing.
    cam = obs.camera.long().clamp(0, num_cameras - 1)
    lm = obs.landmark.long().clamp(0, num_points - 1)
    res, jc, jl = _obs_terms(
        state.rotations, state.translations, state.k_mat, state.points[lm],
        cam, obs.uv, obs.valid,
    )
    res, jc, jl = _apply_sqrt_weight(res, jc, jl, obs_weight)
    h_cc, b_c = _camera_blocks(res, jc, cam_table)
    h_ll, b_l = _landmark_blocks(res, jl, lm_table)

    h_cc_d = _damp(h_cc, lam)
    h_ll_inv = torch.linalg.inv(_damp(h_ll, lam))
    jct, jlt = jc.transpose(-1, -2), jl.transpose(-1, -2)

    cam_ids = torch.arange(num_cameras, device=cam.device)
    free = (cam_ids >= num_fixed_cameras).to(dtype)[:, None]

    def mv(mats, vecs):
        # A product and a sum over the last axis. As a batched matrix
        # product the 300,000 (2, 6)·(6,) pairs of the 1,000-camera problem
        # go through cuBLAS's batched gemv, which held the device four times
        # as long (153 against 38 ms for three LM iterations on an NVIDIA
        # H100 80GB HBM3 at 700 W, ``tools/torch_solver_profile.py``).
        return (mats * vecs[..., None, :]).sum(dim=-1)

    def wt_x(xc):  # Wᵀ·x : (C,6) → (L,3)
        return segment_sum(mv(jlt, mv(jc, xc[cam])), lm_table)

    def w_y(y):  # W·y : (L,3) → (C,6)
        return segment_sum(mv(jct, mv(jl, y[lm])), cam_table)

    def schur_mv(xc):  # gauge-projected S·x, identity on frozen cameras
        xm = xc * free
        sx = mv(h_cc_d, xm) - w_y(mv(h_ll_inv, wt_x(xm)))
        return sx * free + xc * (1.0 - free)

    rhs = (b_c - w_y(mv(h_ll_inv, b_l))) * free

    # Block-Jacobi preconditioner (frozen cameras are identity-safe: their
    # damped diagonal block is well-conditioned and their residual is zero
    # throughout).
    m_inv = torch.linalg.inv(h_cc_d)

    eps = 1e-30
    xk = torch.zeros_like(rhs)
    rk = rhs
    pk = mv(m_inv, rk)
    rzk = (rk * pk).sum()
    for _ in range(cg_iterations):
        sp = schur_mv(pk)
        alpha = rzk / ((pk * sp).sum() + eps)
        xk = xk + alpha * pk
        rk = rk - alpha * sp
        zk = mv(m_inv, rk)
        rzk1 = (rk * zk).sum()
        pk = zk + (rzk1 / (rzk + eps)) * pk
        rzk = rzk1

    delta_c = xk * free
    delta_l = mv(h_ll_inv, b_l - wt_x(delta_c))
    return delta_c, delta_l


def bundle_adjust(
    state: BAState,
    obs: Observations,
    num_iterations: int = 10,
    num_fixed_cameras: int = 1,
    huber_delta: float | None = None,
    solver: str = "dense",
    cg_iterations: int = 32,
    assembly: str = "sorted",
    sorted_pad: int = 0,
    device: Device = None,
) -> tuple[BAState, torch.Tensor]:
    """Levenberg-Marquardt BA. Returns (refined state, final cost).

    ``huber_delta`` (pixels) enables IRLS robust weighting of
    observations; ``None`` is plain least squares. ``solver="dense"``
    materializes the coupling block (fast at SLAM-window scale);
    ``solver="cg"`` is the matrix-free path for large maps.

    ``assembly``: ``"sorted"`` (default; dense solver only) sorts the
    observation buffer by landmark once per solve and runs the
    landmark-side reductions from one padded row gather
    (:func:`_schur_pieces_sorted`); ``"scatter"`` reduces by segment and
    scatters the coupling (:func:`shard_schur_pieces`, what a sharded
    solver runs per shard). ``sorted_pad`` bounds the valid observations of
    one landmark: 0 takes their largest count, a bound below it raises.
    ``device``: see ``core/device.py``. Two runs on the same inputs give
    the same bits (see the module).
    """
    if solver not in ("dense", "cg"):
        raise ValueError(f"bundle_adjust: unknown solver {solver!r}")
    if assembly not in ("sorted", "scatter"):
        raise ValueError(f"bundle_adjust: unknown assembly {assembly!r}")
    target = resolve_device(state.rotations, device)
    require_full_float32_matmul(target)
    state, obs = on_device(state, target), on_device(obs, target)
    num_cameras = state.rotations.shape[0]
    num_points = state.points.shape[0]
    dtype = state.points.dtype

    def cost_of(s):
        return huber_cost(reprojection_residuals(s, obs), huber_delta)

    def weights_of(s):
        return huber_weights(reprojection_residuals(s, obs), huber_delta)

    # The index tables depend on the ids and the validity alone: built once.
    use_sorted = assembly == "sorted" and solver == "dense"
    if use_sorted:
        tables = _build_sorted_tables(
            obs.camera.long(), obs.landmark.long(), obs.valid, num_points,
            min(sorted_pad, obs.capacity),
        )
        order = tables[0]
        obs = Observations(
            camera=obs.camera[order],
            landmark=obs.landmark[order],
            uv=obs.uv[order],
            valid=obs.valid[order],
        )
    cam, lm = obs.camera.long(), obs.landmark.long()
    cam_table = segment_tables(cam, num_cameras)
    if not use_sorted:
        lm_table = segment_tables(torch.where(obs.valid, lm, num_points), num_points)

    lam = torch.full((), 1e-4, dtype=dtype, device=target)
    cost = cost_of(state)
    for _ in range(num_iterations):
        if solver == "cg":
            delta_c, delta_l = _cg_delta(
                state, obs, lam, num_fixed_cameras, cg_iterations,
                weights_of(state), (cam_table, lm_table),
            )
        else:
            args = (
                state.rotations, state.translations, state.k_mat, state.points,
                cam, lm, obs.uv, obs.valid, lam, num_cameras,
            )
            if use_sorted:
                pieces = _schur_pieces_sorted(
                    *args, tables, cam_table, weights_of(state)
                )
            else:
                pieces = shard_schur_pieces(
                    *args, weights_of(state), (cam_table, lm_table)
                )
            delta_c = solve_reduced(
                pieces.h_cc, pieces.b_c, pieces.s_off, pieces.rhs_off,
                lam, num_fixed_cameras,
            )
            delta_l = backsub_landmarks(pieces, delta_c)
        cand = apply_step(state, delta_c, delta_l)
        cand_cost = cost_of(cand)
        accept = cand_cost < cost
        state = dataclasses.replace(
            state,
            rotations=torch.where(accept, cand.rotations, state.rotations),
            translations=torch.where(accept, cand.translations, state.translations),
            points=torch.where(accept, cand.points, state.points),
        )
        cost = torch.where(accept, cand_cost, cost)
        lam = torch.where(accept, lam * 0.3, lam * 6.0).clamp(1e-9, 1e5)
    return state, cost
