"""Orientation assignment and 128-D SIFT descriptors.

Port of the JAX package's ``ops/descriptor.py``. The reference implements
neither stage (reference/readme.md:11); the constants follow the IPOL
*Anatomy of the SIFT Method* paper bundled with it (λ_ori = 1.5,
λ_descr = 6, 36 orientation bins, 4×4×8 histograms, 0.8 peak ratio, 0.2
descriptor clamp).

Every keypoint samples a fixed G×G grid in its (rotated, σ-scaled) local
frame. The samples of the scale-space gradient come from
``ops/kernels/describe.py::window_sample_pair`` — the hand-written CUDA
kernel for CUDA tensors, its plain version for CPU tensors — and all the
histogram math around it is tensor code over every slot of every image at
once; the batch axis is written out. Histograms are contractions with
one-hot bin assignments (deterministic, unlike ``index_add_`` on CUDA);
they are matrix products and need full float32, so the entry points refuse
to run with TF32 matrix products switched on.

Geometry: the octave's inter-pixel distance is ``δ_o = 2^(o-1)``
(reference/background.js:610-614); a keypoint's octave-local position is
``abs/δ_o`` and its octave-local scale ``σ_loc = abs_sigma/δ_o``.

Against the JAX package the sample positions differ in one documented
place: it folds the scale level into the row coordinate (``y + s·H``, a
layout of its gather and DMA engines), which rounds ``y`` to the float32
grid of that larger number (up to 2.4e-4 px on a 960-row octave); the port
indexes the plane and keeps ``y`` as it is.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..config import SiftConfig
from ..core.device import require_full_float32_matmul
from ..core.types import Keypoints
from ..utils.profile import count, counting, span
from .budget import budget_capacity, keep_strongest
from .extrema import first_k_set_indices
from .kernels.describe import window_sample_pair

TWO_PI = 2.0 * math.pi


@dataclasses.dataclass
class DescribedKeypoints:
    """Oriented keypoints + descriptors, fixed capacity struct-of-arrays.

    One slot per (keypoint slot, orientation peak). A batched result
    carries a leading batch axis on every field.
    """

    octave: torch.Tensor  # (..., N) int32
    scale_level: torch.Tensor  # (..., N) int32
    abs_y: torch.Tensor  # (..., N) float32
    abs_x: torch.Tensor  # (..., N) float32
    abs_sigma: torch.Tensor  # (..., N) float32
    theta: torch.Tensor  # (..., N) float32 orientation in [0, 2π)
    descriptor: torch.Tensor  # (..., N, 128) float32, unit norm
    valid: torch.Tensor  # (..., N) bool

    @property
    def capacity(self) -> int:
        return self.octave.shape[-1]


def concat_described(parts: list[DescribedKeypoints]) -> DescribedKeypoints:
    """Concatenate described-keypoint buffers along the slot axis."""
    return DescribedKeypoints(
        **{
            f.name: torch.cat(
                [getattr(p, f.name) for p in parts],
                dim=-2 if f.name == "descriptor" else -1,
            )
            for f in dataclasses.fields(DescribedKeypoints)
        }
    )


def _ruler(half_width: float, n: int) -> np.ndarray:
    """``n`` float32 points from ``-half_width`` to ``half_width``, by the
    formula of ``jnp.linspace`` (``lo·(1−t) + hi·t`` with ``t = i/(n−1)``,
    the last point set to ``hi``), each step rounded to float32. The grid
    is a constant of the configuration, built on the host; each point lies
    within one float32 ulp of ``half_width`` of the JAX package's, whose
    compiler fuses the formula."""
    t = np.arange(n - 1, dtype=np.float32) / np.float32(n - 1)
    lo, hi = np.float32(-half_width), np.float32(half_width)
    return np.append(lo * (np.float32(1.0) - t) + hi * t, hi).astype(np.float32)


def _grid(ruler: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(uy, ux)`` of ``(G²,)``: the ruler's outer grid, x fastest."""
    g = len(ruler)
    return np.repeat(ruler, g), np.tile(ruler, g)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim float32 tensor beside ``like``. Dividing by it
    is a true division; on CUDA, dividing by a Python scalar multiplies by
    its reciprocal and rounds differently from the CPU."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _inbounds_mask(ys, xs, h, w):
    """Interior mask: gradients need one pixel margin (central diffs)."""
    return (ys >= 1.0) & (ys <= h - 2.0) & (xs >= 1.0) & (xs <= w - 2.0)


# ---------------------------------------------------------------------------
# Orientation assignment
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _orientation_grid(g: int, device: torch.device):
    """The unit orientation grid ``(uy, ux)`` on ``device``, made once: a
    tensor built from host data is a blocking copy on CUDA."""
    uy, ux = _grid(_ruler(1.0, g))
    return torch.tensor(uy, device=device), torch.tensor(ux, device=device)


def _orientation_coords(y_loc, x_loc, sigma_loc, cfg: SiftConfig):
    """Sample coordinates of the axis-aligned orientation grid.

    ``y_loc``/``x_loc``/``sigma_loc``: ``(...,)`` float32. Returns
    ``(ys, xs, d2)`` of ``(..., G²)``.
    """
    uy, ux = _orientation_grid(cfg.orientation_grid_size, y_loc.device)
    radius = sigma_loc * (3.0 * cfg.lambda_ori)
    dy = uy * radius[..., None]
    dx = ux * radius[..., None]
    return y_loc[..., None] + dy, x_loc[..., None] + dx, dy * dy + dx * dx


def _orientation_post(gy, gx, ys, xs, d2, h, w, sigma_loc, cfg: SiftConfig):
    """``(..., nbins)`` orientation histograms from gradient samples.

    ``h``/``w``: the slots' plane sizes, Python numbers or tensors
    broadcastable to ``ys``.
    """
    nbins = cfg.n_orientation_bins
    two_pi = _scalar(TWO_PI, gy)
    radius = sigma_loc * (3.0 * cfg.lambda_ori)
    mag = torch.sqrt(gy * gy + gx * gx)
    theta = torch.remainder(torch.atan2(gy, gx), two_pi)

    sig2 = 2.0 * (cfg.lambda_ori * sigma_loc) ** 2
    weight = torch.exp(-d2 / sig2[..., None]) * mag
    weight = torch.where(d2 <= (radius * radius)[..., None], weight, 0.0)
    weight = torch.where(_inbounds_mask(ys, xs, h, w), weight, 0.0)

    # θ/2π·nbins can round up to nbins, hence the second modulo.
    bin_idx = torch.floor(theta / two_pi * nbins).long() % nbins
    bins = torch.arange(nbins, device=gy.device)
    onehot = (bin_idx[..., None] == bins).to(gy.dtype)  # (..., G², nbins)
    return torch.einsum("...s,...sb->...b", weight, onehot)


def _smooth_circular(hist: torch.Tensor, iterations: int) -> torch.Tensor:
    """IPOL smoothing: circular [1,1,1]/3 box filter applied N times."""
    three = _scalar(3.0, hist)
    for _ in range(iterations):
        hist = (hist.roll(1, dims=-1) + hist + hist.roll(-1, dims=-1)) / three
    return hist


def _extract_peaks(hist: torch.Tensor, cfg: SiftConfig):
    """The strongest orientation peaks, with parabolic interpolation.

    A bin is a peak iff it strictly exceeds both circular neighbours and
    reaches ``peak_ratio * max`` (IPOL §4.1). Returns ``(theta, valid)`` of
    ``(..., max_orientations)``. Of two equal peaks the lower bin comes
    first, as ``jax.lax.top_k`` orders them; ``torch.topk`` promises no
    order of ties, hence the stable sort.
    """
    nbins = cfg.n_orientation_bins
    prev = hist.roll(1, dims=-1)
    nxt = hist.roll(-1, dims=-1)
    is_peak = (hist > prev) & (hist > nxt)
    is_peak &= hist >= cfg.orientation_peak_ratio * hist.amax(dim=-1, keepdim=True)

    score = torch.where(is_peak, hist, -torch.inf)
    top_vals, top_idx = torch.sort(score, dim=-1, descending=True, stable=True)
    k = cfg.max_orientations_per_keypoint
    top_vals, top_idx = top_vals[..., :k], top_idx[..., :k]
    valid = torch.isfinite(top_vals) & (top_vals > 0.0)

    hk = hist.gather(-1, top_idx)
    hp = prev.gather(-1, top_idx)
    hn = nxt.gather(-1, top_idx)
    denom = hp - 2.0 * hk + hn
    offset = torch.where(denom.abs() > 1e-12, (hp - hn) / (2.0 * denom), 0.0)
    two_pi = _scalar(TWO_PI, hist)
    theta = ((top_idx.to(hist.dtype) + 0.5 + offset) / _scalar(nbins, hist)) * two_pi
    return torch.remainder(theta, two_pi), valid


# ---------------------------------------------------------------------------
# 128-D descriptor
# ---------------------------------------------------------------------------


def _bilinear_cells(a: np.ndarray, n: int) -> np.ndarray:
    """``(G², n)`` float32 soft assignment of cell coordinates ``a`` to
    ``n`` cells: weight ``1−f`` on ``floor(a)``, ``f`` on the next, each
    dropped where its cell lies outside ``[0, n)``."""
    i0 = np.floor(a)
    f = (a - i0).astype(np.float32)
    i0 = i0.astype(np.int64)
    out = np.zeros((len(a), n), np.float32)
    for cell, weight in ((i0, np.float32(1.0) - f), (i0 + 1, f)):
        inside = (cell >= 0) & (cell < n)
        out[np.nonzero(inside)[0], cell[inside]] += weight[inside]
    return out


@functools.lru_cache(maxsize=None)
def _descriptor_constants(g: int, nh: int, lam: float, device: torch.device):
    """Keypoint-independent constants of the descriptor grid on ``device``,
    made once: ``yhat``, ``xhat`` ``(G²,)`` (normalised sample coordinates
    in ``[-r̂, r̂]``, ``r̂ = λ·(nh+1)/nh``; the margin feeds the outer cells'
    bilinear support), the Gaussian window ``exp(-(x̂²+ŷ²)/2λ²)`` ``(G²,)``,
    and the spatial weights ``wy[p, y]·wx[p, x]`` as ``(G², nh·nh)``."""
    rhat = lam * (nh + 1.0) / nh
    yhat, xhat = _grid(_ruler(rhat, g))
    window = np.exp(-(yhat * yhat + xhat * xhat) / np.float32(2.0 * lam * lam))
    # Cell centres sit at ĉ_i = (i - (nh-1)/2)·(2λ/nh); cell coordinate:
    scale, shift = np.float32(2.0 * lam), np.float32((nh - 1.0) / 2.0)
    wy = _bilinear_cells(yhat * np.float32(nh) / scale + shift, nh)
    wx = _bilinear_cells(xhat * np.float32(nh) / scale + shift, nh)
    spatial = (wy[:, :, None] * wx[:, None, :]).reshape(g * g, nh * nh)
    return tuple(
        torch.tensor(v.astype(np.float32), device=device)
        for v in (yhat, xhat, window, spatial)
    )


def _descriptor_grid(cfg: SiftConfig, device: torch.device):
    return _descriptor_constants(
        cfg.descriptor_grid_size, cfg.descriptor_n_hist, cfg.lambda_descr, device
    )


def _descriptor_coords(y_loc, x_loc, sigma_loc, theta, cfg: SiftConfig):
    """Rotated, σ-scaled sample coordinates ``(ys, xs)`` of ``(..., G²)``."""
    yhat, xhat, _, _ = _descriptor_grid(cfg, y_loc.device)
    ct = torch.cos(theta)[..., None]
    st = torch.sin(theta)[..., None]
    sig = sigma_loc[..., None]
    ys = y_loc[..., None] + sig * (st * xhat + ct * yhat)
    xs = x_loc[..., None] + sig * (ct * xhat - st * yhat)
    return ys, xs


def _normalize_descriptor(desc: torch.Tensor, clip: float) -> torch.Tensor:
    """Normalise, clamp at ``clip·‖d‖``, renormalise (Lowe/IPOL)."""
    norm = torch.sqrt((desc * desc).sum(dim=-1, keepdim=True) + 1e-12)
    desc = torch.minimum(desc, clip * norm)
    norm2 = torch.sqrt((desc * desc).sum(dim=-1, keepdim=True) + 1e-12)
    return desc / norm2


def _descriptor_post(gy, gx, ys, xs, h, w, theta, cfg: SiftConfig):
    """``(..., nh·nh·no)`` descriptors from gradient samples: 4×4 spatial
    cells (bilinear) × 8 orientation bins (circular linear), normalised."""
    no = cfg.descriptor_n_ori
    _, _, window, spatial = _descriptor_grid(cfg, gy.device)
    two_pi = _scalar(TWO_PI, gy)

    mag = torch.sqrt(gy * gy + gx * gx)
    ang = torch.remainder(torch.atan2(gy, gx) - theta[..., None], two_pi)
    weight = window * mag
    weight = torch.where(_inbounds_mask(ys, xs, h, w), weight, 0.0)

    b = ang / two_pi * no
    b0 = torch.floor(b)
    fb = b - b0
    b0i = b0.long() % no
    b1i = (b0i + 1) % no
    bins = torch.arange(no, device=gy.device)[:, None]
    # (..., no, G²): each sample's weight split over its two orientation bins.
    split = (b0i[..., None, :] == bins) * (1.0 - fb)[..., None, :] + (
        b1i[..., None, :] == bins
    ) * fb[..., None, :]
    # Σ_p weight[p]·split[o, p]·spatial[p, yx] → (..., no, nh·nh) → (yx, o).
    desc = torch.matmul(split * weight[..., None, :], spatial).transpose(-1, -2)
    desc = desc.reshape(*desc.shape[:-2], -1)
    return _normalize_descriptor(desc, cfg.descriptor_clip)


# ---------------------------------------------------------------------------
# The two stages over flat slots, and the entry points built from them
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _plane_sizes(sizes: tuple, device: torch.device):
    """Per-octave plane heights and widths as float32 tensors on ``device``."""
    h, w = zip(*sizes)
    f32 = dict(dtype=torch.float32, device=device)
    return torch.tensor(h, **f32), torch.tensor(w, **f32)


class _Slots:
    """Flat slots ``(M,)`` of one describe stage: where each one samples."""

    def __init__(self, stacks, batch, octave_id, scale_level, y_loc, x_loc, sigma_loc, valid):
        self.stacks = stacks
        self.table = torch.stack(
            [batch, octave_id, scale_level, valid.to(torch.int32)], dim=-1
        ).to(torch.int32)
        self.y_loc, self.x_loc, self.sigma_loc = y_loc, x_loc, sigma_loc
        hs, ws = _plane_sizes(
            tuple(tuple(s.shape[-2:]) for s in stacks), y_loc.device
        )
        index = octave_id.long().clamp(0, len(stacks) - 1)
        self.h, self.w = hs[index][:, None], ws[index][:, None]


def _orientation_stage(slots: _Slots, cfg: SiftConfig, sample_fn):
    """``(theta, valid)`` of ``(M, max_orientations)`` for flat slots."""
    ys, xs, d2 = _orientation_coords(slots.y_loc, slots.x_loc, slots.sigma_loc, cfg)
    gy, gx = sample_fn(slots.stacks, slots.table, ys, xs)
    hist = _orientation_post(
        gy, gx, ys, xs, d2, slots.h, slots.w, slots.sigma_loc, cfg
    )
    hist = _smooth_circular(hist, cfg.orientation_smooth_iterations)
    return _extract_peaks(hist, cfg)


def _descriptor_stage(slots: _Slots, theta, cfg: SiftConfig, sample_fn):
    """``(M, 128)`` descriptors for flat slots with orientations ``theta``."""
    ys, xs = _descriptor_coords(slots.y_loc, slots.x_loc, slots.sigma_loc, theta, cfg)
    gy, gx = sample_fn(slots.stacks, slots.table, ys, xs)
    return _descriptor_post(gy, gx, ys, xs, slots.h, slots.w, theta, cfg)


def _batch_column(like: torch.Tensor) -> torch.Tensor:
    """Each slot's image index for ``(B, n)`` fields, as ``(B·n,)`` int32."""
    b, n = like.shape
    index = torch.arange(b, dtype=torch.int32, device=like.device)
    return index[:, None].expand(b, n).reshape(-1)


def _octave_slots(octave_stack, keypoints: Keypoints, octave: int, valid):
    """One octave's ``(B, N)`` keypoint slots as flat slots; with ``valid``
    of ``(B, N·r)`` each keypoint is repeated ``r`` times in place."""
    delta = 2.0 ** (octave - 1)  # a power of two: the divisions are exact
    repeat = valid.shape[-1] // keypoints.valid.shape[-1]

    def flat(a):
        return a.repeat_interleave(repeat, dim=-1).reshape(-1)

    return _Slots(
        [octave_stack],
        _batch_column(valid),
        torch.zeros_like(flat(keypoints.octave)),
        flat(keypoints.scale_level),
        flat(keypoints.abs_y) / delta,
        flat(keypoints.abs_x) / delta,
        flat(keypoints.abs_sigma) / delta,
        valid.reshape(-1),
    )


def assign_orientations(
    octave_stack: torch.Tensor,
    keypoints: Keypoints,
    octave: int,
    cfg: SiftConfig,
    sample_fn=window_sample_pair,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Orientations for all keypoint slots of one octave.

    ``octave_stack``: Gaussian images ``(B, S, H, W)``; keypoint fields
    ``(B, N)``. Returns ``(theta, valid)`` of ``(B, N, max_orientations)``;
    ``valid`` is ANDed with the keypoint slot validity. ``sample_fn`` as in
    :func:`describe_compact`.
    """
    require_full_float32_matmul(octave_stack.device)
    slots = _octave_slots(octave_stack, keypoints, octave, keypoints.valid)
    theta, valid = _orientation_stage(slots, cfg, sample_fn)
    shape = (*keypoints.valid.shape, cfg.max_orientations_per_keypoint)
    return theta.reshape(shape), valid.reshape(shape) & keypoints.valid[..., None]


def compute_descriptors(
    octave_stack: torch.Tensor,
    keypoints: Keypoints,
    theta: torch.Tensor,
    ori_valid: torch.Tensor,
    octave: int,
    cfg: SiftConfig,
    sample_fn=window_sample_pair,
) -> DescribedKeypoints:
    """Descriptors for one octave's keypoints × orientation peaks.

    ``theta``/``ori_valid``: ``(B, N, max_orientations)`` from
    :func:`assign_orientations`. Output capacity ``N * max_orientations``;
    an invalid pair is not sampled and its descriptor is zero.
    """
    require_full_float32_matmul(octave_stack.device)
    n_ori = cfg.max_orientations_per_keypoint
    b = keypoints.valid.shape[0]
    flat_theta = theta.reshape(b, -1)
    valid = ori_valid.reshape(b, -1)
    slots = _octave_slots(octave_stack, keypoints, octave, valid)
    desc = _descriptor_stage(slots, flat_theta.reshape(-1), cfg, sample_fn)

    def rep(a):
        return a.repeat_interleave(n_ori, dim=-1)

    return DescribedKeypoints(
        octave=rep(keypoints.octave),
        scale_level=rep(keypoints.scale_level),
        abs_y=rep(keypoints.abs_y),
        abs_x=rep(keypoints.abs_x),
        abs_sigma=rep(keypoints.abs_sigma),
        theta=flat_theta,
        descriptor=desc.reshape(b, -1, desc.shape[-1]),
        valid=valid,
    )


def describe_octave(
    octave_stack: torch.Tensor,
    keypoints: Keypoints,
    octave: int,
    cfg: SiftConfig,
    sample_fn=window_sample_pair,
) -> DescribedKeypoints:
    """Orientation assignment + descriptors for one octave of a batch, in
    the spans ``sift.describe`` and, nested, ``sift.describe.orientation``
    and ``sift.describe.descriptor``."""
    with span("describe"):
        with span("describe.orientation"):
            theta, ori_valid = assign_orientations(
                octave_stack, keypoints, octave, cfg, sample_fn
            )
        with span("describe.descriptor"):
            return compute_descriptors(
                octave_stack, keypoints, theta, ori_valid, octave, cfg, sample_fn
            )


def describe_compact(
    stacks: list[torch.Tensor],
    keypoints_list: list[Keypoints],
    cfg: SiftConfig,
    sample_fn=window_sample_pair,
    max_features: int | None = None,
) -> DescribedKeypoints:
    """One describe pass over all octaves and images, on compacted valid
    keypoints.

    ``stacks[o]``: ``(B, S, H_o, W_o)``; ``keypoints_list[o]`` fields
    ``(B, n_o)``. The counterpart of the JAX package's
    ``describe_compact`` and ``describe_compact_batched_windowed``:

    1. every image's valid keypoints, all octaves concatenated, are
       compacted in order into ``cfg.describe_capacity()`` slots;
    2. orientation runs on those slots only;
    3. valid (slot, orientation peak) pairs are compacted into
       ``cfg.descriptor_pair_capacity()`` slots, and the descriptor stage
       runs on those.

    Per kept keypoint the math is that of :func:`describe_octave`. Without
    a budget, keypoints and pairs are lost only to capacity overflow: the
    first slots in emission order are kept, and while counters are on
    ``describe.keypoints_over_capacity`` and ``describe.pairs_over_capacity``
    count what steps 1 and 3 drop. With ``cfg.upright`` the orientation
    stage is skipped and θ = 0 for every keypoint.

    ``max_features`` N: each image keeps its N strongest pairs, by
    ``|value|`` with ties at the N-th kept (``ops/budget.py::keep_strongest``),
    in the span ``sift.describe.budget``; step 3 compacts those alone, in
    (octave, slot, orientation) order, into
    ``ops/budget.py::budget_capacity(N, ...)`` slots. Under ``cfg.upright``
    a pair is a keypoint. ``None`` describes every pair, as above.

    Returns fields ``(B, pairs)`` and descriptors ``(B, pairs, 128)``.
    ``sample_fn`` is :func:`window_sample_pair` or a function with its
    contract, such as its plain version. The pass runs in the span
    ``sift.describe``, its two sampling stages in ``sift.describe.orientation``
    and ``sift.describe.descriptor``.
    """
    with span("describe"):
        return _describe_compact(stacks, keypoints_list, cfg, sample_fn, max_features)


def _count_overflow(name: str, total: torch.Tensor, capacity: int) -> None:
    """While counters are on, add to ``name`` the set entries that a
    compaction to ``capacity`` slots dropped (``total``: ``(B,)`` uncapped
    counts)."""
    if counting():
        count(name, (total - capacity).clamp(min=0).sum())


def _compact_pairs(pair_valid, capacity: int):
    """``(index, valid)`` of ``(B, capacity)``: the valid pairs compacted
    in order, those past ``capacity`` counted as dropped."""
    pidx, pok, total = first_k_set_indices(pair_valid, capacity)
    _count_overflow("describe.pairs_over_capacity", total, capacity)
    return pidx, pok & pair_valid.gather(-1, pidx)


def _budget_pairs(strength, pair_valid, max_features: int):
    """:func:`_compact_pairs` of the pairs that the budget keeps."""
    with span("describe.budget"):
        keep = keep_strongest(strength, pair_valid, max_features)
        return _compact_pairs(keep, budget_capacity(max_features, keep.shape[-1]))


def _describe_compact(stacks, keypoints_list, cfg: SiftConfig, sample_fn, max_features):
    require_full_float32_matmul(stacks[0].device)
    n_ori = cfg.max_orientations_per_keypoint

    def cat(field):
        return torch.cat([getattr(k, field) for k in keypoints_list], dim=-1)

    all_valid = cat("valid")  # (B, total)
    capacity = cfg.describe_capacity()
    idx, ok, total = first_k_set_indices(all_valid, capacity)
    _count_overflow("describe.keypoints_over_capacity", total, capacity)
    names = ("octave", "scale_level", "abs_y", "abs_x", "abs_sigma")
    if max_features is not None:
        names += ("value",)
    fields = {name: cat(name).gather(-1, idx) for name in names}
    kvalid = ok & all_valid.gather(-1, idx)
    batch = _batch_column(kvalid).reshape(kvalid.shape)
    # δ_o = 2^(o-1) is a power of two: the divisions are exact.
    delta = torch.exp2((fields["octave"] - 1).to(torch.float32))
    fields.update(
        batch=batch,
        y_loc=fields["abs_y"] / delta,
        x_loc=fields["abs_x"] / delta,
        sigma_loc=fields["abs_sigma"] / delta,
    )

    def slots_of(f, valid):
        return _Slots(
            stacks,
            *(f[k].reshape(-1) for k in (
                "batch", "octave", "scale_level", "y_loc", "x_loc", "sigma_loc"
            )),
            valid.reshape(-1),
        )

    if cfg.upright:
        pair_valid = kvalid
        if max_features is not None:
            slot, pair_valid = _budget_pairs(fields["value"].abs(), kvalid, max_features)
            fields = {k: v.gather(-1, slot) for k, v in fields.items()}
        theta_pairs = torch.zeros_like(fields["abs_y"])
    else:
        with span("describe.orientation"):
            theta, ori_valid = _orientation_stage(slots_of(fields, kvalid), cfg, sample_fn)
        b, cap = kvalid.shape
        theta = theta.reshape(b, cap * n_ori)
        ori_valid = (ori_valid.reshape(b, cap, n_ori) & kvalid[:, :, None]).reshape(
            b, cap * n_ori
        )
        if max_features is None:
            pidx, pair_valid = _compact_pairs(ori_valid, cfg.descriptor_pair_capacity())
        else:
            strength = fields["value"].abs().repeat_interleave(n_ori, dim=-1)
            pidx, pair_valid = _budget_pairs(strength, ori_valid, max_features)
        slot = pidx // n_ori
        theta_pairs = theta.gather(-1, pidx)
        fields = {k: v.gather(-1, slot) for k, v in fields.items()}

    with span("describe.descriptor"):
        desc = _descriptor_stage(
            slots_of(fields, pair_valid), theta_pairs.reshape(-1), cfg, sample_fn
        )
    return DescribedKeypoints(
        octave=fields["octave"],
        scale_level=fields["scale_level"],
        abs_y=fields["abs_y"],
        abs_x=fields["abs_x"],
        abs_sigma=fields["abs_sigma"],
        theta=theta_pairs,
        descriptor=desc.reshape(*pair_valid.shape, desc.shape[-1]),
        valid=pair_valid,
    )
