"""Nearest-neighbor resampling matching the reference's ``Matrix2D_linearResize``
(reference/src/matrix2d.js:112-138): rate 0.5 repeats each pixel 2×2,
rate 2.0 keeps even indices (output dims ``ceil(n/2)``)."""

from __future__ import annotations

import torch


def upsample2x_nn(image: torch.Tensor) -> torch.Tensor:
    """2× nearest-neighbor upsample over the trailing two axes
    (reference/background.js:84 with rate 0.5)."""
    return image.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def downsample2x_nn(image: torch.Tensor) -> torch.Tensor:
    """2× decimation over the trailing two axes, keeping even indices
    (reference/background.js:118 with rate 2.0). Output dims ceil(n/2)."""
    return image[..., ::2, ::2]
