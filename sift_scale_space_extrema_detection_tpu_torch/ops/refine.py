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

Two routes, chosen by the DoGs' dtype and device alone (:func:`takes_kernel`):
float32 DoGs on a CUDA device go to the hand-written kernel
(``kernels/refine.py::newton_ladder``, ``csrc/refine.cu``), which runs the
whole ladder in one launch and equals this tensor code bit for bit; every
other input (the CPU, the float64 oracle leg) runs the tensor code, its
plain version (:func:`newton_ladder_reference`). With counters on
(``utils/profile.py``) a call adds 1 to ``refine.route.kernel`` or
``refine.route.plain``.

On the plain route each Newton step runs in the span ``sift.refine.step``.
On both, with counters on, step ``i`` of octave ``k`` adds the slots it ran
over to ``refine.slots_stepped.o<k>.s<i>`` and the slots still running to
``refine.slots_live.o<k>.s<i>`` (``o<a>-<b>`` for a pool of octaves).
"""

from __future__ import annotations

import dataclasses
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
from ..utils.profile import count, counting, span
from .kernels import refine as refine_kernel

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


def _kernel_caps(cfg: SiftConfig, n_slots: int, pool_cap: int | None) -> list[int]:
    """The caps the kernel is handed, one a Newton step: ``pool_cap`` (or
    ``n_slots``, which caps nothing) before step 1, then the ladder's."""
    return [n_slots if pool_cap is None else pool_cap, *_ladder_caps(cfg, n_slots)]


def _pool_cap(cfg: SiftConfig, n_slots: int) -> int:
    """Valid slots of an image that a pool of ``n_slots`` slots lets into
    Newton iteration 1 (the JAX package's pool compaction)."""
    return min(n_slots, max(256, int(n_slots * cfg.refine_pool_compaction)))


def takes_kernel(dtype: torch.dtype, device: torch.device) -> bool:
    """Whether DoGs of ``dtype`` on ``device`` are refined by the kernel:
    float32 on a CUDA device. Else the tensor code refines them."""
    return dtype == torch.float32 and device.type == "cuda"


def _clip_interior(x: torch.Tensor, extent) -> torch.Tensor:
    """``x`` clipped to ``[1, extent - 2]``; ``extent`` an int or a tensor
    of one extent per slot."""
    if isinstance(extent, int):
        return x.clamp(1, extent - 2).long()
    return torch.minimum(x.clamp(min=1), extent - 2).long()


def _step(dog_flat, base, d_scales, h, w, st, cfg):
    """One Newton iteration for every slot; returns the updated state.

    ``h``/``w``: the plane's extent, an int, or an int64 tensor of one
    extent per slot where the slots come from several octaves. Only slots
    with ``st["run"]`` change. Positions of the others are clipped into the
    interior so every gather index stays legal.
    """
    s, m, n = st["s"], st["m"], st["n"]
    dtype = dog_flat.dtype
    sc = s.clamp(1, d_scales - 2).long()
    mc = _clip_interior(m, h)
    nc = _clip_interior(n, w)
    hc, wc = (h, w) if isinstance(h, int) else (h[:, None], w[:, None])
    ds_, dm_, dn_ = _cube_offsets(dog_flat.device)
    idx = (
        base[:, None]
        + ((sc[:, None] + ds_) * hc + (mc[:, None] + dm_)) * wc
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


def _first_active(active: torch.Tensor, shape, cap: int) -> torch.Tensor:
    """The first ``cap`` set slots of each image's row of ``active`` (flat,
    ``shape = (B, n)``), in slot order."""
    active = active.reshape(shape)
    rank = active.cumsum(dim=1, dtype=torch.int32)
    return (active & (rank <= cap)).reshape(-1)


def _iterate(dog_flat, base, d_scales, h, w, st, cfg, shape, octaves, pool_cap=None):
    """Newton iteration 1, then the compaction ladder, over a state of
    ``shape = (B, n)`` slots of ``octaves`` (first, last). Before iteration
    1 only the first ``pool_cap`` valid slots of each image go on when
    ``pool_cap`` is given and below ``n``; before each later iteration only
    the first :func:`_ladder_caps` still-active slots the previous level
    admitted. The rest keep REJECT_MAX_ITERATIONS: the outputs of the JAX
    package's compactions, from one running count per level. Each step
    runs in a span and is counted (see the module)."""
    counted = counting()
    live = torch.ones_like(st["run"])  # slots the ladder still admits
    if pool_cap is not None and pool_cap < shape[1]:
        live = st["run"] = _first_active(st["run"], shape, pool_cap)
    for i, cap in enumerate([None, *_ladder_caps(cfg, shape[1])], 1):
        if cap is not None:
            live = st["run"] = _first_active(live & ~st["done"], shape, cap)
        if counted:
            _count_step(octaves, i, shape, st["run"].sum())
        with span("refine.step"):
            st = _step(dog_flat, base, d_scales, h, w, st, cfg)
    return st


def _count_step(octaves, step: int, shape, live) -> None:
    """Step ``step``'s counters: the slots it runs over, the slots live."""
    first, last = octaves
    tag = f"o{first}" if first == last else f"o{first}-{last}"
    count(f"refine.slots_stepped.{tag}.s{step}", shape[0] * shape[1])
    count(f"refine.slots_live.{tag}.s{step}", live)


def _initial_state(extrema_list, dtype, delta, sigc) -> dict:
    """The refinement state of candidate slots ``(B, n)`` concatenated
    along the slots, flat; ``delta``/``sigc`` one value per slot."""

    def cat(name, to):
        return torch.cat([getattr(e, name).to(to) for e in extrema_list], dim=1).reshape(-1)

    valid = cat("valid", torch.bool)
    zero = torch.zeros_like(delta)
    return dict(
        s=cat("scale_level", torch.int32),
        m=cat("y", torch.int32),
        n=cat("x", torch.int32),
        value=cat("value", dtype),
        done=~valid,
        run=valid,
        reason=torch.where(valid, REJECT_MAX_ITERATIONS, -1).to(torch.int32),
        abs_y=zero,
        abs_x=zero,
        abs_sigma=zero,
        omega=zero,
        delta=delta,
        sigc=sigc,
    )


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
    compaction ladder, from one running count per iteration. Routed by the
    DoG's dtype and device (see the module).
    """
    return _refine([dog], [extrema], octave, cfg)


def refine_keypoints_multi(
    dogs: list[torch.Tensor],
    extrema_list: list[Extrema],
    cfg: SiftConfig,
    octave_offset: int = 0,
) -> Keypoints:
    """One refinement pass over every octave's candidate slots.

    The JAX package's ``refine_keypoints_multi`` (``cfg.unified_refine``,
    and ``cfg.refine_tail_pool`` with ``octave_offset=1``): ``dogs[i]``
    ``(B, D, H_i, W_i)`` of octave ``i + octave_offset``, all of one dtype
    and depth; ``extrema_list[i]`` fields ``(B, n_i)``. Each image's slots
    are one state, octave after octave; every slot carries its octave's
    plane extent, offset into the concatenated flat DoG, ``delta`` and
    sigma constant. Before Newton iteration 1 the first
    :func:`_pool_cap` valid slots of each image go on (``n = Σ n_i``), and
    the ladder's caps are taken on ``n``; the rest keep
    REJECT_MAX_ITERATIONS. Where nothing overflows, the result is
    ``concat_keypoints`` of :func:`refine_keypoints` per octave; keypoints
    ``(B, n)`` in that slot order. Routed as :func:`refine_keypoints`.
    """
    if len({(d.dtype, d.shape[:2]) for d in dogs}) != 1:
        raise ValueError("refine_keypoints_multi: the DoGs differ in dtype, batch or depth")
    n_slots = sum(e.y.shape[-1] for e in extrema_list)
    return _refine(dogs, extrema_list, octave_offset, cfg, _pool_cap(cfg, n_slots))


def _refine(dogs, extrema_list, first_octave: int, cfg: SiftConfig, pool_cap=None) -> Keypoints:
    """Refinement of ``dogs`` (octaves from ``first_octave`` on) on the
    route :func:`takes_kernel` picks, counted by route and by step. The
    kernel gets the candidates' fields in its types, cast as
    :func:`_initial_state` casts them for the tensor code."""
    dtype = dogs[0].dtype
    if not takes_kernel(dtype, dogs[0].device):
        count("refine.route.plain", 1)
        return newton_ladder_reference(dogs, extrema_list, first_octave, cfg, pool_cap)
    count("refine.route.kernel", 1)
    extrema_list = [
        dataclasses.replace(
            e, y=e.y.to(torch.int32), x=e.x.to(torch.int32),
            scale_level=e.scale_level.to(torch.int32), value=e.value.to(dtype),
            valid=e.valid.to(torch.bool),
        )
        for e in extrema_list
    ]
    n_slots = sum(e.y.shape[-1] for e in extrema_list)
    keypoints, live = refine_kernel.newton_ladder(
        [d.contiguous() for d in dogs], extrema_list, first_octave, cfg,
        _kernel_caps(cfg, n_slots, pool_cap),
        [_octave_geometry(first_octave + i, cfg) for i in range(len(dogs))],
    )
    if counting():
        octaves = (first_octave, first_octave + len(dogs) - 1)
        per_step = live.sum(0, dtype=torch.int64)
        for i in range(live.shape[1]):
            _count_step(octaves, i + 1, keypoints.valid.shape, per_step[i])
    return keypoints


def newton_ladder_reference(
    dogs: list[torch.Tensor],
    extrema_list: list[Extrema],
    first_octave: int,
    cfg: SiftConfig,
    pool_cap: int | None = None,
) -> Keypoints:
    """The tensor code: the plain version of the kernel's
    ``newton_ladder``, on any device and in float32 or float64. One octave
    without ``pool_cap`` is :func:`refine_keypoints`'s state; else the
    octaves are one pool, as in :func:`refine_keypoints_multi`, with
    ``pool_cap`` (None: no cap) before iteration 1."""
    if len(dogs) == 1 and pool_cap is None:
        return _refine_octave(dogs[0], extrema_list[0], first_octave, cfg)
    return _refine_pool(dogs, extrema_list, first_octave, cfg, pool_cap)


def _refine_octave(dog, extrema, octave, cfg) -> Keypoints:
    """The tensor code of one octave (:func:`refine_keypoints`)."""
    b, d_scales, h, w = dog.shape
    n_slots = extrema.y.shape[-1]
    delta, sigma_coeff = _octave_geometry(octave, cfg)
    image = torch.arange(b, device=dog.device).repeat_interleave(n_slots)
    slot = torch.zeros(b * n_slots, dtype=dog.dtype, device=dog.device)
    st = _initial_state(
        [extrema],
        dog.dtype,
        torch.full_like(slot, exact_scalar(delta, dog.dtype)),
        torch.full_like(slot, exact_scalar(sigma_coeff, dog.dtype)),
    )
    base = image * (d_scales * h * w)
    st = _iterate(dog.reshape(-1), base, d_scales, h, w, st, cfg, (b, n_slots), (octave, octave))
    return _keypoints_from_state(st, octave, (b, n_slots))


def _refine_pool(dogs, extrema_list, octave_offset, cfg, pool_cap) -> Keypoints:
    """The tensor code of a pool of octaves (:func:`refine_keypoints_multi`)."""
    b, d_scales = dogs[0].shape[:2]
    dtype, dev = dogs[0].dtype, dogs[0].device
    bases, hs, ws, deltas, sigcs, octs = [], [], [], [], [], []
    flat_off = 0
    for i, (d, e) in enumerate(zip(dogs, extrema_list)):
        octave = i + octave_offset
        h, w = d.shape[-2:]
        n = e.y.shape[-1]
        delta, sigc = _octave_geometry(octave, cfg)

        def per_slot(value, dt):
            return torch.full((b, n), value, dtype=dt, device=dev)

        image = torch.arange(b, device=dev)[:, None].expand(b, n)
        bases.append(flat_off + image * (d_scales * h * w))
        hs.append(per_slot(h, torch.int64))
        ws.append(per_slot(w, torch.int64))
        deltas.append(per_slot(exact_scalar(delta, dtype), dtype))
        sigcs.append(per_slot(exact_scalar(sigc, dtype), dtype))
        octs.append(per_slot(octave, torch.int32))
        flat_off += d.numel()

    def cat(parts):
        return torch.cat(parts, dim=1).reshape(-1)

    n_slots = sum(e.y.shape[-1] for e in extrema_list)
    st = _initial_state(extrema_list, dtype, cat(deltas), cat(sigcs))
    dog_flat = torch.cat([d.reshape(-1) for d in dogs])
    octaves = (octave_offset, octave_offset + len(dogs) - 1)
    st = _iterate(
        dog_flat, cat(bases), d_scales, cat(hs), cat(ws), st, cfg, (b, n_slots), octaves, pool_cap
    )
    return _keypoints_from_state(st, cat(octs), (b, n_slots))


def _keypoints_from_state(st, octave, shape) -> Keypoints:
    """The final refinement state as ``Keypoints`` of the given shape;
    ``octave``: an int, or one octave per slot."""
    reason = st["reason"].reshape(shape)
    return Keypoints(
        octave=(
            torch.full_like(reason, octave)
            if isinstance(octave, int)
            else octave.reshape(shape).to(reason.dtype)
        ),
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
