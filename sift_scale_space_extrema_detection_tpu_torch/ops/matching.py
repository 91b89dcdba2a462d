"""Descriptor matching: all-pairs distances + ratio/mutual tests.

Port of the JAX package's ``ops/matching.py``. All-pairs squared-L2
distances are ``‖a‖² + ‖b‖² − 2·a@bᵀ`` with the cross term as one matrix
product in full float32 (TF32 is refused: ``d`` cancels, and the ratio
test compares its results); the two-nearest-neighbour reduction and the
Lowe ratio test are masked dense reductions over fixed-capacity descriptor
buffers, with no dynamic shapes.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.device import Device, require_full_float32_matmul, resolve_device

BIG = 3.4e38  # marks pairs with an invalid side; below float32's largest value


@dataclasses.dataclass
class Matches:
    """Fixed-capacity match set from image A slots to image B slots.

    ``index[i]`` is the matched B slot for A slot ``i`` (the nearest B slot
    when invalid); ``distance`` is the squared descriptor L2 distance.
    """

    index: torch.Tensor  # (N,) int32
    distance: torch.Tensor  # (N,) float32
    valid: torch.Tensor  # (N,) bool

    @property
    def capacity(self) -> int:
        return self.index.shape[-1]


def descriptor_distances(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """All-pairs squared L2 distances ``(N, M)``; the cross term is one
    matrix product."""
    require_full_float32_matmul(desc_a.device)
    sq_a = (desc_a * desc_a).sum(dim=-1, keepdim=True)
    sq_b = (desc_b * desc_b).sum(dim=-1, keepdim=True)
    d = sq_a + sq_b.T - 2.0 * (desc_a @ desc_b.T)
    return d.clamp(min=0.0)


def _two_smallest(d: torch.Tensor):
    """``(d1, d2, best)`` of each row: the smallest and second smallest
    value and the lowest index that holds the smallest. ``torch.topk``
    promises no order among ties, and a row holds ``BIG`` at every invalid
    slot; two ``min`` passes with the winner masked out tie toward the
    lower index, as ``jax.lax.top_k`` does."""
    d1, best = d.min(dim=1)
    masked = d.scatter(1, best[:, None], float("inf"))
    return d1, masked.min(dim=1).values, best


def match_descriptors(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
    ratio: float = 0.8,
    mutual: bool = True,
    device: Device = None,
) -> Matches:
    """Lowe-ratio matches A→B over fixed-capacity descriptor buffers.

    A slot matches iff its nearest valid B descriptor beats the second
    nearest by the ratio test ``d1 < ratio²·d2`` (squared distances) and,
    with ``mutual=True``, the B slot's nearest valid A descriptor is that
    same A slot (cross-check). ``device``: see ``core/device.py``.
    """
    target = resolve_device(desc_a, device)
    require_full_float32_matmul(target)
    desc_a, valid_a, desc_b, valid_b = (
        t.to(target) for t in (desc_a, valid_a, desc_b, valid_b)
    )
    d = descriptor_distances(desc_a, desc_b)
    d = torch.where(valid_a[:, None] & valid_b[None, :], d, BIG)
    d1, d2, best = _two_smallest(d)

    # d2 == BIG means B had fewer than two valid descriptors: without a
    # genuine second neighbour the ratio test is vacuous, so reject.
    ok = valid_a & (d1 < BIG) & (d2 < BIG) & (d1 < (ratio * ratio) * d2)

    if mutual:
        back = d.argmin(dim=0)  # best A slot for each B slot
        ok = ok & (back[best] == torch.arange(d.shape[0], device=target))

    return Matches(
        index=best.to(torch.int32), distance=d1.to(torch.float32), valid=ok
    )
