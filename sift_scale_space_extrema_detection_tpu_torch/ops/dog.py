"""Difference-of-Gaussians with the reference's sign.

The reference computes ``DoG[s-1] = L(σ_{s-1}) − L(σ_s)``
(reference/background.js:276-277, reference/src/sift.js:172), the
negative of the conventional DoG; every accept/reject test uses absolute
values, so the keypoint set is unchanged, and the sign is kept for parity.
"""

from __future__ import annotations

import torch


def difference_of_gaussians(scale_space: torch.Tensor) -> torch.Tensor:
    """``(..., S, H, W)`` Gaussian stack → ``(..., S-1, H, W)`` DoG stack."""
    return scale_space[..., :-1, :, :] - scale_space[..., 1:, :, :]
