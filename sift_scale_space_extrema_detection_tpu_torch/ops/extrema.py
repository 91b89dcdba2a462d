"""26-neighbour extrema: the scan, the packed codes and the selections.

The reference scans interior pixels of each DoG trio with strict
comparisons against all 26 neighbours plus a contrast pre-filter
(reference/src/sift.js:212-316, background.js:359-450). Here the scan is a
dense masked computation over the whole ``(B, D, H, W)`` DoG stack
(:func:`_neighborhood_min_max`, :func:`_trio_masks`), in the dtype of the
stack. Two routes lead from it to the candidate buffer that refinement
consumes:

- the mask-free route of the float64 oracle leg: :func:`find_extrema`
  scans and compacts each trio into its own fixed-capacity segment (slot
  order trio-major, row-major: the reference's emission order), and
  :func:`compact_extrema` squeezes the segments into the refinement
  capacity; :func:`find_low_contrast_extrema` gives the positions of the
  pre-filter's rejects, :func:`find_extrema_from_masks` the same buffers
  from a packed plane;
- the fused route: the octave kernel emits the scan as one packed plane per
  octave, 2 bits per trio (:func:`pack_extrema_codes` is its plain
  version), and :func:`select_refine_candidates` selects across trios in
  one pass: on the card through the hand-written selection kernels
  (``kernels/select.py``, ``csrc/select.cu``), elsewhere through its tensor
  code, their plain version (:func:`select_refine_candidates_reference`).

Every function takes a leading batch axis.
"""

from __future__ import annotations

import torch

from ..config import SiftConfig
from ..core.types import Extrema, exact_scalar
from ..utils.profile import count
from .kernels import select as select_kernel


def mask_dtype(n_trios: int) -> torch.dtype:
    """Storage type of the packed plane: int16 holds 8 trios of 2 bits."""
    return torch.int16 if n_trios <= 8 else torch.int32


def _neighborhood_min_max(dog: torch.Tensor):
    """Per-plane separable 3×3 min/max over the interior, shared by trios.

    ``dog``: ``(B, D, H, W)``. Each plane's 3×3-neighbourhood extrema are
    formed once by a row pass and a column pass and reused by every trio
    that touches the plane. Returns ``(min3, max3)`` ``(B, D, H-2, W-2)``.
    """
    h, w = dog.shape[-2], dog.shape[-1]
    left, mid, right = dog[..., 0 : w - 2], dog[..., 1 : w - 1], dog[..., 2:w]
    row_min = torch.minimum(torch.minimum(left, mid), right)
    row_max = torch.maximum(torch.maximum(left, mid), right)
    min3 = torch.minimum(
        torch.minimum(row_min[..., 0 : h - 2, :], row_min[..., 1 : h - 1, :]),
        row_min[..., 2:h, :],
    )
    max3 = torch.maximum(
        torch.maximum(row_max[..., 0 : h - 2, :], row_max[..., 1 : h - 1, :]),
        row_max[..., 2:h, :],
    )
    return min3, max3


def _trio_masks(dog, min3, max3, s: int, contrast_thr: float):
    """Candidate / low-contrast masks of the trio centred at DoG scale ``s``.

    Boolean masks ``(B, H-2, W-2)`` over interior pixels. Strict
    extremality: centre > max(26 neighbours) or < min(26), so ties and
    plateaus are rejected (reference/src/sift.js:261-266). The adjacent
    planes use the shared full-3×3 ``min3``/``max3``; the centre plane
    uses its 8-neighbour ring (centre excluded: the full 3×3 would include
    the centre and break strictness). ``contrast_thr`` must be an exact
    value of the stack's dtype (:func:`exact_scalar`).
    """
    h, w = dog.shape[-2], dog.shape[-1]
    plane = dog[:, s]
    centre = plane[:, 1 : h - 1, 1 : w - 1]
    left, mid, right = plane[..., 0 : w - 2], plane[..., 1 : w - 1], plane[..., 2:w]
    row_min = torch.minimum(torch.minimum(left, mid), right)
    row_max = torch.maximum(torch.maximum(left, mid), right)
    ring_min = torch.minimum(
        torch.minimum(row_min[:, 0 : h - 2], row_min[:, 2:h]),
        torch.minimum(left, right)[:, 1 : h - 1],
    )
    ring_max = torch.maximum(
        torch.maximum(row_max[:, 0 : h - 2], row_max[:, 2:h]),
        torch.maximum(left, right)[:, 1 : h - 1],
    )
    nb_min = torch.minimum(torch.minimum(min3[:, s - 1], min3[:, s + 1]), ring_min)
    nb_max = torch.maximum(torch.maximum(max3[:, s - 1], max3[:, s + 1]), ring_max)
    is_extremum = (centre > nb_max) | (centre < nb_min)
    passes = centre.abs() >= contrast_thr
    return is_extremum & passes, is_extremum & ~passes


def pack_extrema_codes(dog: torch.Tensor, contrast_thr: float) -> torch.Tensor:
    """``(B, D, H, W)`` DoG → ``(B, H, W)`` packed 2-bit trio codes.

    Trio ``t`` (centred on DoG plane ``t+1``) owns bits ``[2t, 2t+2)``:
    1 = strict 26-neighbour extremum with ``|centre| >= contrast_thr``
    (:func:`_trio_masks`), 2 = one below it, 0 otherwise; only the interior
    is set. ``contrast_thr`` must be a float32 value.
    """
    b, d, h, w = dog.shape
    n_trios = d - 2
    packed = torch.zeros((b, h, w), dtype=torch.int32, device=dog.device)
    if h < 3 or w < 3:  # no interior pixel
        return packed.to(mask_dtype(n_trios))
    min3, max3 = _neighborhood_min_max(dog)
    inner = packed[..., 1 : h - 1, 1 : w - 1]
    for t in range(n_trios):
        cand, low = _trio_masks(dog, min3, max3, t + 1, contrast_thr)
        inner |= (cand.to(torch.int32) + 2 * low.to(torch.int32)) << (2 * t)
    return packed.to(mask_dtype(n_trios))


def unpack_mask_codes(packed: torch.Tensor, n_trios: int) -> torch.Tensor:
    """``(..., H, W)`` packed plane → ``(..., T, H, W)`` int32 codes 0/1/2.

    The plane is widened to int32 before shifting (an int16 plane holding
    trio 7's code 2 is negative).
    """
    shifts = 2 * torch.arange(n_trios, dtype=torch.int32, device=packed.device)
    return (packed.to(torch.int32).unsqueeze(-3) >> shifts[:, None, None]) & 3


def first_k_set_indices(
    mask: torch.Tensor, capacity: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Indices of the first ``capacity`` set bits along the last axis, in order.

    ``mask``: ``(..., N)`` bool. Returns ``idx`` ``(..., capacity)`` int64,
    ``valid`` ``(..., capacity)`` bool and ``total`` ``(...,)`` int32, the
    uncapped count of set bits. Slot ``j`` holds the position of the
    ``(j+1)``-th set bit, found by a binary search of the running count: no
    sort and no host sync. Invalid slots hold index 0.
    """
    running = mask.cumsum(dim=-1, dtype=torch.int32)
    slot = torch.arange(capacity, dtype=torch.int32, device=mask.device)
    wanted = (slot + 1).expand(*mask.shape[:-1], capacity).contiguous()
    idx = torch.searchsorted(running, wanted)  # first i with running[i] > j
    total = running[..., -1]
    valid = slot < total.unsqueeze(-1)
    return torch.where(valid, idx, 0), valid, total


def takes_kernel(packed: torch.Tensor, dog: torch.Tensor) -> bool:
    """Whether :func:`select_refine_candidates` selects through the kernels:
    a packed plane on a CUDA device with a float32 DoG on the same device.
    Else the tensor code selects."""
    return (packed.device.type == "cuda" and dog.device == packed.device
            and dog.dtype == torch.float32)


def select_refine_candidates(
    packed: torch.Tensor, dog: torch.Tensor, cfg: SiftConfig, capacity: int
) -> Extrema:
    """The first ``capacity`` candidates (code 1) of each image, in
    (trio-major, row-major) order — the reference's emission order
    (background.js:433-436).

    ``packed``: ``(B, H, W)``; ``dog``: ``(B, D, H, W)``. Slot ``j`` holds
    the ``(j+1)``-th code-1 pixel of the flattened ``(T, H, W)`` volume.
    Invalid slots are parked at ``(scale 1, y 1, x 1)`` with ``value``
    read from the DoG there. The per-trio counters are uncapped, so
    candidates beyond capacity stay observable. On the route
    :func:`takes_kernel` picks, counted in ``select.route.kernel`` or
    ``select.route.plain`` with counters on (``utils/profile.py``).
    """
    b, h, w = packed.shape
    if h < 2 or w < 2:
        raise ValueError(
            f"select_refine_candidates: a {h}x{w} octave has no pixel (1, 1) "
            "to park invalid slots at; use fewer octaves for this image size"
        )
    if not takes_kernel(packed, dog):
        count("select.route.plain", 1)
        return select_refine_candidates_reference(packed, dog, cfg, capacity)
    count("select.route.kernel", 1)
    return select_kernel.select_candidates(packed.contiguous(), dog.contiguous(), capacity)


def select_refine_candidates_reference(
    packed: torch.Tensor, dog: torch.Tensor, cfg: SiftConfig, capacity: int
) -> Extrema:
    """The tensor code of :func:`select_refine_candidates`, on any device
    and dtype: the plain version of ``kernels/select.py::select_candidates``.
    Slot ``j`` holds the ``(j+1)``-th set bit of the flattened code-1
    volume (:func:`first_k_set_indices`)."""
    b, h, w = packed.shape
    n_trios = cfg.dog_per_octave - 2
    plane = h * w
    codes = unpack_mask_codes(packed, n_trios)  # (B, T, H, W)
    cand = codes == 1
    n_cand = cand.sum(dim=(2, 3), dtype=torch.int32)
    n_low = (codes == 2).sum(dim=(2, 3), dtype=torch.int32)
    idx, valid, _ = first_k_set_indices(cand.reshape(b, -1), capacity)
    trio = idx // plane
    rem = idx - trio * plane
    y = torch.where(valid, rem // w, 1).to(torch.int32)
    x = torch.where(valid, rem % w, 1).to(torch.int32)
    scale_level = torch.where(valid, trio + 1, 1).to(torch.int32)
    image = torch.arange(b, device=packed.device)[:, None]
    value = dog[image, scale_level.long(), y.long(), x.long()]
    return Extrema(
        y=y,
        x=x,
        scale_level=scale_level,
        value=value,
        valid=valid,
        num_candidates=n_cand,
        num_low_contrast=n_low,
    )


def _compact(mask: torch.Tensor, values: torch.Tensor, capacity: int, offset: int = 1):
    """Compact ``(B, h, w)`` masks into ``(y, x, value, valid, total)``.

    Slot order is row-major, the reference's scan order
    (src/sift.js:221-222). ``offset`` maps mask coordinates to image
    coordinates: 1 for interior-cropped masks, 0 for full-plane masks with
    a zero border. Invalid slots are parked at pixel ``(1, 1)`` in both
    cases, with the value read there. ``total`` is the uncapped count.
    """
    b, hh, ww = mask.shape
    safe, valid, total = first_k_set_indices(mask.reshape(b, -1), capacity)
    if offset == 0:
        safe = torch.where(valid, safe, ww + 1)
    y = (safe // ww + offset).to(torch.int32)
    x = (safe % ww + offset).to(torch.int32)
    value = values.reshape(b, -1).gather(1, safe)
    return y, x, value, valid, total


def _per_trio_extrema(cfg: SiftConfig, capacity: int | None, trio_fn) -> Extrema:
    """One segment of ``capacity`` slots per trio, concatenated in trio
    order. ``trio_fn(s)`` gives the trio's ``(mask, values, offset,
    num_candidates, num_low_contrast)``; a count of ``None`` stands for the
    mask's own uncapped count."""
    cap = cfg.max_keypoints_per_trio if capacity is None else capacity
    ys, xs, levels, vals, valids, n_cand, n_low = [], [], [], [], [], [], []
    for s in range(1, cfg.dog_per_octave - 1):
        mask, values, offset, cand, low = trio_fn(s)
        y, x, value, valid, total = _compact(mask, values, cap, offset)
        ys.append(y)
        xs.append(x)
        levels.append(torch.full_like(y, s))
        vals.append(value)
        valids.append(valid)
        n_cand.append(total if cand is None else cand)
        n_low.append(total if low is None else low)
    return Extrema(
        y=torch.cat(ys, dim=-1),
        x=torch.cat(xs, dim=-1),
        scale_level=torch.cat(levels, dim=-1),
        value=torch.cat(vals, dim=-1),
        valid=torch.cat(valids, dim=-1),
        num_candidates=torch.stack(n_cand, dim=-1),
        num_low_contrast=torch.stack(n_low, dim=-1),
    )


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dim=(-2, -1), dtype=torch.int32)


def find_extrema(
    dog: torch.Tensor, cfg: SiftConfig, capacity: int | None = None
) -> Extrema:
    """Candidate extrema of one octave's DoG stacks ``(B, D, H, W)``.

    Trios are centred at DoG scales ``1..D-2`` (background.js:377); the
    buffer concatenates per-trio compactions (segment ``t`` = slots
    ``[t·cap, (t+1)·cap)``), so the global slot order is the reference's
    (trio, row-major) iteration order (background.js:468-479).
    ``capacity`` overrides the per-trio slot count
    (``SiftConfig.keypoints_per_trio``).
    """
    h, w = dog.shape[-2], dog.shape[-1]
    thr = exact_scalar(cfg.contrast_prefilter_threshold, dog.dtype)
    min3, max3 = _neighborhood_min_max(dog)

    def trio(s):
        cand, low = _trio_masks(dog, min3, max3, s, thr)
        return cand, dog[:, s, 1 : h - 1, 1 : w - 1], 1, None, _count(low)

    return _per_trio_extrema(cfg, capacity, trio)


def find_low_contrast_extrema(
    dog: torch.Tensor, cfg: SiftConfig, capacity: int | None = None
) -> Extrema:
    """Positions of the low-contrast pre-filter rejects, per trio.

    The reference keeps rejected low-contrast extrema as first-class
    records (reference/src/sift.js:296-307, background.js:408-421). The
    detect path keeps only their per-trio counts; this diagnostic function
    compacts their positions with the slot order of :func:`find_extrema`.
    ``num_candidates`` and ``num_low_contrast`` both count the rejects.
    """
    h, w = dog.shape[-2], dog.shape[-1]
    thr = exact_scalar(cfg.contrast_prefilter_threshold, dog.dtype)
    min3, max3 = _neighborhood_min_max(dog)

    def trio(s):
        _, low = _trio_masks(dog, min3, max3, s, thr)
        return low, dog[:, s, 1 : h - 1, 1 : w - 1], 1, None, None

    return _per_trio_extrema(cfg, capacity, trio)


def find_extrema_from_masks(
    packed: torch.Tensor, dog: torch.Tensor, cfg: SiftConfig, capacity: int | None = None
) -> Extrema:
    """The buffers of :func:`find_extrema` from a packed plane ``(B, H, W)``
    (:func:`pack_extrema_codes`, or the octave kernel's) and the DoG stacks
    ``(B, D, H, W)``: same slot order, same counters, no second scan."""
    codes = unpack_mask_codes(packed, cfg.dog_per_octave - 2)

    def trio(s):
        code = codes[:, s - 1]
        return code == 1, dog[:, s], 0, None, _count(code == 2)

    return _per_trio_extrema(cfg, capacity, trio)


def compact_extrema(extrema: Extrema, capacity: int) -> Extrema:
    """Squeeze the valid candidate slots into ``capacity`` slots.

    The per-trio segments are sized for the worst-case density, and
    refinement pays per slot. One more in-order selection keeps the order
    (ascending slot = trio-major, row-major). Overflow drops trailing
    candidates; the per-trio counters still count everything.
    """
    if capacity >= extrema.capacity:
        return extrema
    slot, ok, _ = first_k_set_indices(extrema.valid, capacity)
    return Extrema(
        y=extrema.y.gather(-1, slot),
        x=extrema.x.gather(-1, slot),
        scale_level=extrema.scale_level.gather(-1, slot),
        value=extrema.value.gather(-1, slot),
        valid=ok & extrema.valid.gather(-1, slot),
        num_candidates=extrema.num_candidates,
        num_low_contrast=extrema.num_low_contrast,
    )
