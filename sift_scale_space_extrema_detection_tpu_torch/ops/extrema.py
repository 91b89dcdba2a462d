"""26-neighbour extrema codes and the selection of refinement candidates.

The reference scans interior pixels of each DoG trio with strict
comparisons against all 26 neighbours plus a contrast pre-filter
(reference/src/sift.js:212-316, background.js:359-450). The fused octave
kernel emits the result as one packed plane per octave, 2 bits per trio;
:func:`pack_extrema_codes` is its plain version, and
:func:`select_refine_candidates` turns the packed plane into the
fixed-capacity candidate buffer that refinement consumes.
"""

from __future__ import annotations

import torch

from ..config import SiftConfig
from ..core.types import Extrema


def mask_dtype(n_trios: int) -> torch.dtype:
    """Storage type of the packed plane: int16 holds 8 trios of 2 bits."""
    return torch.int16 if n_trios <= 8 else torch.int32


def pack_extrema_codes(dog: torch.Tensor, contrast_thr: float) -> torch.Tensor:
    """``(B, D, H, W)`` DoG → ``(B, H, W)`` packed 2-bit trio codes.

    Trio ``t`` (centred on DoG plane ``t+1``) owns bits ``[2t, 2t+2)``:
    1 = strict 26-neighbour extremum with ``|centre| >= contrast_thr``,
    2 = one below it, 0 otherwise; only the interior is set. Each plane's
    3×3 min/max is formed once by separable row/column passes and shared
    by the trios that touch it; the centre plane uses its 8-neighbour ring
    (centre excluded), so the comparison stays strict
    (reference/src/sift.js:261-266). ``contrast_thr`` must be a float32
    value.
    """
    b, d, h, w = dog.shape
    n_trios = d - 2
    packed = torch.zeros((b, h, w), dtype=torch.int32, device=dog.device)
    if h < 3 or w < 3:  # no interior pixel
        return packed.to(mask_dtype(n_trios))
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
    ring_min = torch.minimum(
        torch.minimum(row_min[..., 0 : h - 2, :], row_min[..., 2:h, :]),
        torch.minimum(left, right)[..., 1 : h - 1, :],
    )
    ring_max = torch.maximum(
        torch.maximum(row_max[..., 0 : h - 2, :], row_max[..., 2:h, :]),
        torch.maximum(left, right)[..., 1 : h - 1, :],
    )
    centre = dog[..., 1 : h - 1, 1 : w - 1]
    inner = packed[..., 1 : h - 1, 1 : w - 1]
    for t in range(n_trios):
        c = centre[:, t + 1]
        nb_min = torch.minimum(
            torch.minimum(min3[:, t], min3[:, t + 2]), ring_min[:, t + 1]
        )
        nb_max = torch.maximum(
            torch.maximum(max3[:, t], max3[:, t + 2]), ring_max[:, t + 1]
        )
        is_ext = (c > nb_max) | (c < nb_min)
        code = torch.where(c.abs() >= contrast_thr, 1, 2).to(torch.int32)
        inner |= torch.where(is_ext, code, 0) << (2 * t)
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


def select_refine_candidates(
    packed: torch.Tensor, dog: torch.Tensor, cfg: SiftConfig, capacity: int
) -> Extrema:
    """The first ``capacity`` candidates (code 1) of each image, in
    (trio-major, row-major) order — the reference's emission order
    (background.js:433-436).

    ``packed``: ``(B, H, W)``; ``dog``: ``(B, D, H, W)``. Slot ``j`` holds
    the ``(j+1)``-th set bit of the flattened ``(T, H, W)`` candidate
    volume (:func:`first_k_set_indices`). Invalid slots are parked at ``(scale 1, y 1, x 1)`` with
    ``value`` read from the DoG there. The per-trio counters are uncapped,
    so candidates beyond capacity stay observable.
    """
    b, h, w = packed.shape
    if h < 2 or w < 2:
        raise ValueError(
            f"select_refine_candidates: a {h}x{w} octave has no pixel (1, 1) "
            "to park invalid slots at; use fewer octaves for this image size"
        )
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
