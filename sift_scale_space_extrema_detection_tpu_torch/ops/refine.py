"""Quadratic keypoint refinement (Newton iteration on the DoG cube).

Port of the JAX package's ``ops/refine.py`` (the reference's per-keypoint
loop, reference/background.js:455-685) as plain tensor code over every
candidate slot of every image of the batch at once. Each iteration
gathers the 19 used points of the 3×3×3 DoG neighbourhood, forms the
gradient and Hessian by central differences (reference/src/sift.js:333-446),
solves ``α = -H⁻¹ g`` with the closed-form adjugate inverse in the
reference's operation order (reference/src/matrix2d.js:464-509), and
applies the reference's accept/reject ladder:

- convergence: all ``|α_i| < 0.6`` (background.js:558)
- contrast: ``|ω| < thr`` rejects, ω = value + ½·αᵀg (background.js:565-583)
- edge: tr²/det of the spatial sub-Hessian > (c+1)²/c (background.js:589-604)
- non-converged: step to ``floor((s,m,n) + α + 0.5)`` (JS ``Math.round``,
  not round-half-even) and reject on leaving the interior
  (background.js:638-664)
- singular Hessian: |det| < 2⁻⁵² — the reference crashes (matrix2d.js:482);
  we reject with REJECT_SINGULAR_HESSIAN.

ω uses the *original* extremum value even after the point moves — a
reference quirk (background.js:565 reads ``extrema.value``) kept for parity.

Every operation is a separate tensor op in the dtype of the DoG (float32
on the fused path, float64 on the oracle leg), so each product and sum is
rounded on its own, as in the JAX package and in the reference.
"""

from __future__ import annotations

import functools
import math

import torch

from ..config import SiftConfig
from ..core.types import (
    ACCEPTED,
    REJECT_EDGE,
    REJECT_LOW_CONTRAST,
    REJECT_MAX_ITERATIONS,
    REJECT_OUT_OF_BOUNDS,
    REJECT_SINGULAR_HESSIAN,
    Extrema,
    Keypoints,
    exact_scalar,
)

JS_EPSILON = 2.0**-52  # Number.EPSILON

# The 19 points of the 3×3×3 cube the differences use (corners unused),
# as (ds, dm, dn) offsets in the JAX package's order.
_POINTS = [
    (a, b, c)
    for a in (-1, 0, 1)
    for b in (-1, 0, 1)
    for c in (-1, 0, 1)
    if abs(a) + abs(b) + abs(c) < 3
]
_COLUMN = {p: i for i, p in enumerate(_POINTS)}


@functools.lru_cache(maxsize=None)
def _cube_offsets(device: torch.device):
    """(ds, dm, dn) of :data:`_POINTS` as int64 tensors, made once per
    device: a tensor built from host data is a blocking copy on CUDA."""
    return tuple(
        torch.tensor([p[i] for p in _POINTS], device=device) for i in range(3)
    )


def _octave_geometry(octave: int, cfg: SiftConfig):
    """(delta, sigma_coeff) for an octave (reference/background.js:610-614)."""
    delta = math.pow(2.0, octave - 1)
    return delta, (delta / cfg.min_interpixel_distance) * cfg.min_blur_level


def _ladder_caps(cfg: SiftConfig, n_slots: int) -> list[int]:
    """Slots allowed to keep iterating before iterations 2..max: the first
    ``max(64, int(n_slots * schedule[min(k-1, len-1)]))`` still-active
    slots, in slot order (the JAX package's compaction ladder)."""
    schedule = tuple(cfg.refine_compaction_schedule) or (
        cfg.refine_active_compaction,
    )
    return [
        max(64, int(n_slots * schedule[min(i, len(schedule) - 1)]))
        for i in range(cfg.max_refine_iterations - 1)
    ]


def _step(dog_flat, base, d_scales, h, w, st, cfg):
    """One Newton iteration for every slot; returns the updated state.

    Only slots with ``st["run"]`` change. Positions of the others are
    clipped into the interior so every gather index stays legal.
    """
    s, m, n = st["s"], st["m"], st["n"]
    dtype = dog_flat.dtype
    sc = s.clamp(1, d_scales - 2).long()
    mc = m.clamp(1, h - 2).long()
    nc = n.clamp(1, w - 2).long()
    ds_, dm_, dn_ = _cube_offsets(dog_flat.device)
    idx = (
        base[:, None]
        + ((sc[:, None] + ds_) * h + (mc[:, None] + dm_)) * w
        + (nc[:, None] + dn_)
    )
    cube = dog_flat[idx]

    def v(a, b, c):
        return cube[:, _COLUMN[(a - 1, b - 1, c - 1)]]

    ctr = v(1, 1, 1)
    g0 = (v(2, 1, 1) - v(0, 1, 1)) / 2
    g1 = (v(1, 2, 1) - v(1, 0, 1)) / 2
    g2 = (v(1, 1, 2) - v(1, 1, 0)) / 2
    h11 = v(2, 1, 1) + v(0, 1, 1) - (2 * ctr)
    h22 = v(1, 2, 1) + v(1, 0, 1) - (2 * ctr)
    h33 = v(1, 1, 2) + v(1, 1, 0) - (2 * ctr)
    h12 = (v(2, 2, 1) - v(2, 0, 1) - v(0, 2, 1) + v(0, 0, 1)) / 4
    h13 = (v(2, 1, 2) - v(2, 1, 0) - v(0, 1, 2) + v(0, 1, 0)) / 4
    h23 = (v(1, 2, 2) - v(1, 2, 0) - v(1, 0, 2) + v(1, 0, 0)) / 4

    m00 = (h22 * h33) - (h23 * h23)
    m01 = (h12 * h33) - (h23 * h13)
    m02 = (h12 * h23) - (h22 * h13)
    m10 = (h12 * h33) - (h13 * h23)
    m11 = (h11 * h33) - (h13 * h13)
    m12 = (h11 * h23) - (h12 * h13)
    m20 = (h12 * h23) - (h13 * h22)
    m21 = (h11 * h23) - (h13 * h12)
    m22 = (h11 * h22) - (h12 * h12)
    det = (h11 * m00) - (h12 * m01) + (h13 * m02)

    singular = det.abs() < exact_scalar(JS_EPSILON, dtype)
    det_safe = torch.where(singular, torch.ones_like(det), det)

    i00 = m00 / det_safe
    i01 = -(m10 / det_safe)
    i02 = m20 / det_safe
    i10 = -(m01 / det_safe)
    i11 = m11 / det_safe
    i12 = -(m21 / det_safe)
    i20 = m02 / det_safe
    i21 = -(m12 / det_safe)
    i22 = m22 / det_safe
    a0 = ((-i00) * g0) + ((-i01) * g1) + ((-i02) * g2)
    a1 = ((-i10) * g0) + ((-i11) * g1) + ((-i12) * g2)
    a2 = ((-i20) * g0) + ((-i21) * g1) + ((-i22) * g2)

    lim = exact_scalar(cfg.convergence_threshold, dtype)
    converged = (a0.abs() < lim) & (a1.abs() < lim) & (a2.abs() < lim)

    omega = st["value"] + (((0.5 * a0) * g0) + ((0.5 * a1) * g1) + ((0.5 * a2) * g2))
    contrast_fail = omega.abs() < exact_scalar(cfg.contrast_threshold_scaled, dtype)

    tr = h22 + h33
    det2 = (h22 * h33) - (h23 * h23)
    edge_fail = ((tr * tr) / det2) > exact_scalar(cfg.edge_threshold, dtype)

    sf = s.to(dtype)
    mf = m.to(dtype)
    nf = n.to(dtype)
    new_s = torch.floor((sf + a0) + 0.5).to(torch.int32)
    new_m = torch.floor((mf + a1) + 0.5).to(torch.int32)
    new_n = torch.floor((nf + a2) + 0.5).to(torch.int32)
    oob = (
        (new_s < 1)
        | (new_s >= d_scales - 1)
        | (new_m < 1)
        | (new_m >= h - 1)
        | (new_n < 1)
        | (new_n >= w - 1)
    )

    run = st["run"]
    finish_singular = run & singular
    finish_converged = run & ~singular & converged
    stepping = run & ~singular & ~converged
    finish_oob = stepping & oob

    reason = st["reason"]
    reason = torch.where(finish_singular, REJECT_SINGULAR_HESSIAN, reason)
    verdict = torch.where(
        contrast_fail,
        REJECT_LOW_CONTRAST,
        torch.where(edge_fail, REJECT_EDGE, ACCEPTED),
    ).to(torch.int32)
    reason = torch.where(finish_converged, verdict, reason)
    reason = torch.where(finish_oob, REJECT_OUT_OF_BOUNDS, reason)

    record = finish_converged & ~contrast_fail & ~edge_fail
    # A tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which rounds differently (1/spo is inexact).
    spo = torch.full((), float(cfg.scales_per_octave), dtype=dtype, device=s.device)
    out = dict(st)
    out.update(
        abs_y=torch.where(record, st["delta"] * (a1 + mf), st["abs_y"]),
        abs_x=torch.where(record, st["delta"] * (a2 + nf), st["abs_x"]),
        abs_sigma=torch.where(
            record, st["sigc"] * torch.exp2((a0 + sf) / spo), st["abs_sigma"]
        ),
        omega=torch.where(record, omega, st["omega"]),
        s=torch.where(stepping & ~oob, new_s, s),
        m=torch.where(stepping & ~oob, new_m, m),
        n=torch.where(stepping & ~oob, new_n, n),
        done=st["done"] | finish_singular | finish_converged | finish_oob,
        reason=reason,
    )
    return out


def refine_keypoints(
    dog: torch.Tensor, extrema: Extrema, octave: int, cfg: SiftConfig
) -> Keypoints:
    """Refine every candidate slot of one octave for a batch of images.

    ``dog``: ``(B, D, H, W)`` float32 or float64; ``extrema`` fields ``(B, N)``. The
    batch is one flat pass over ``B × N`` slots, each addressing its own
    image through an offset into the flat DoG. Newton iteration 1 runs on
    every slot; before each later iteration only the first
    :func:`_ladder_caps` still-active slots of each image go on, the rest
    keeping REJECT_MAX_ITERATIONS — the same outputs as the JAX package's
    compaction ladder, from one running count per iteration.
    """
    b, d_scales, h, w = dog.shape
    n_slots = extrema.y.shape[-1]
    dev = dog.device
    delta, sigma_coeff = _octave_geometry(octave, cfg)
    image = torch.arange(b, device=dev).repeat_interleave(n_slots)
    valid = extrema.valid.reshape(-1)
    zero = torch.zeros(b * n_slots, dtype=dog.dtype, device=dev)
    st = dict(
        s=extrema.scale_level.reshape(-1).to(torch.int32),
        m=extrema.y.reshape(-1).to(torch.int32),
        n=extrema.x.reshape(-1).to(torch.int32),
        value=extrema.value.reshape(-1).to(dog.dtype),
        done=~valid,
        run=valid,
        reason=torch.where(valid, REJECT_MAX_ITERATIONS, -1).to(torch.int32),
        abs_y=zero,
        abs_x=zero,
        abs_sigma=zero,
        omega=zero,
        delta=torch.full_like(zero, exact_scalar(delta, dog.dtype)),
        sigc=torch.full_like(zero, exact_scalar(sigma_coeff, dog.dtype)),
    )
    dog_flat = dog.reshape(-1)
    base = image * (d_scales * h * w)
    st = _step(dog_flat, base, d_scales, h, w, st, cfg)
    live = torch.ones_like(valid)  # slots the ladder still admits
    for cap in _ladder_caps(cfg, n_slots):
        active = (live & ~st["done"]).reshape(b, n_slots)
        rank = active.cumsum(dim=1, dtype=torch.int32)
        live = (active & (rank <= cap)).reshape(-1)
        st["run"] = live
        st = _step(dog_flat, base, d_scales, h, w, st, cfg)

    return _keypoints_from_state(st, octave, (b, n_slots))


def _keypoints_from_state(st, octave: int, shape) -> Keypoints:
    """The final refinement state as ``Keypoints`` of the given shape."""
    reason = st["reason"].reshape(shape)
    return Keypoints(
        octave=torch.full_like(reason, octave),
        scale_level=st["s"].reshape(shape),
        local_y=st["m"].reshape(shape),
        local_x=st["n"].reshape(shape),
        abs_y=st["abs_y"].reshape(shape),
        abs_x=st["abs_x"].reshape(shape),
        abs_sigma=st["abs_sigma"].reshape(shape),
        value=st["omega"].reshape(shape),
        valid=reason == ACCEPTED,
        reject_reason=reason,
    )
