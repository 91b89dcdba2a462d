"""A frozen copy of the port's ``core/types.py`` (see ``reference/__init__.py``).

Fixed-capacity result types of the frontend, as dataclasses of tensors.

Same fields, shapes and reject codes as the JAX package's
``core/types.py``. Keypoints live in fixed-capacity struct-of-array
buffers with validity masks; a batched result carries a leading batch
axis on every field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Rejection taxonomy mirroring the reference's console.log categories
# (reference/background.js:581, :602, :648-663, :672), plus
# SINGULAR_HESSIAN: the reference crashes on a singular Hessian
# (matrix2d.js:482 returns null, caller never checks); we reject instead.
ACCEPTED = 0
REJECT_LOW_CONTRAST = 1
REJECT_EDGE = 2
REJECT_OUT_OF_BOUNDS = 3
REJECT_MAX_ITERATIONS = 4
REJECT_SINGULAR_HESSIAN = 5

REJECT_REASON_NAMES = (
    "accepted",
    "low_contrast",
    "edge",
    "out_of_bounds",
    "max_iterations",
    "singular_hessian",
)
NUM_REJECT_REASONS = len(REJECT_REASON_NAMES)


def exact_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: an exact value of
    that type, which no later conversion can round another way. float64
    values pass through."""
    return float(np.float32(value)) if dtype == torch.float32 else float(value)


@dataclasses.dataclass
class Extrema:
    """Fixed-capacity candidate extrema for one octave (all trios).

    Invalid slots have ``valid == False``; ``num_candidates`` /
    ``num_low_contrast`` count *all* pre-filter decisions (not capped).
    """

    y: torch.Tensor  # (..., N) int32 row (m)
    x: torch.Tensor  # (..., N) int32 column (n)
    scale_level: torch.Tensor  # (..., N) int32 DoG scale s in [1, spo]
    value: torch.Tensor  # (..., N) float32 DoG value at the extremum
    valid: torch.Tensor  # (..., N) bool
    num_candidates: torch.Tensor  # (..., trios) int32 accepted counts
    num_low_contrast: torch.Tensor  # (..., trios) int32 pre-filter rejects

    @property
    def capacity(self) -> int:
        return self.y.shape[-1]


@dataclasses.dataclass
class Keypoints:
    """Refined keypoints, fixed capacity, struct-of-arrays.

    Field names follow the reference keypoint record schema
    (reference/background.js:619-628). ``reject_reason`` carries the
    rejection taxonomy for slots with ``valid == False`` (-1 for slots
    that never held a candidate).
    """

    octave: torch.Tensor  # (..., N) int32
    scale_level: torch.Tensor  # (..., N) int32 (s at acceptance)
    local_y: torch.Tensor  # (..., N) int32 (m at acceptance)
    local_x: torch.Tensor  # (..., N) int32 (n at acceptance)
    abs_y: torch.Tensor  # (..., N) float32
    abs_x: torch.Tensor  # (..., N) float32
    abs_sigma: torch.Tensor  # (..., N) float32
    value: torch.Tensor  # (..., N) float32 interpolatedValue
    valid: torch.Tensor  # (..., N) bool
    reject_reason: torch.Tensor  # (..., N) int32

    @property
    def capacity(self) -> int:
        return self.octave.shape[-1]

    def reject_counts(self) -> torch.Tensor:
        """``(..., NUM_REJECT_REASONS)`` int32 histogram over occupied slots."""
        reasons = torch.arange(
            NUM_REJECT_REASONS, device=self.reject_reason.device
        )
        hits = self.reject_reason.unsqueeze(-1) == reasons
        return hits.sum(dim=-2, dtype=torch.int32)


def concat_keypoints(parts: list[Keypoints]) -> Keypoints:
    """Concatenate fixed-capacity keypoint buffers along the slot axis."""
    return Keypoints(
        **{
            f.name: torch.cat([getattr(p, f.name) for p in parts], dim=-1)
            for f in dataclasses.fields(Keypoints)
        }
    )


def split_keypoints(keypoints: Keypoints, sizes: list[int]) -> list[Keypoints]:
    """The inverse of :func:`concat_keypoints`: slot segments of ``sizes``."""
    parts = {
        f.name: torch.split(getattr(keypoints, f.name), sizes, dim=-1)
        for f in dataclasses.fields(Keypoints)
    }
    return [Keypoints(**{k: v[i] for k, v in parts.items()}) for i in range(len(sizes))]
