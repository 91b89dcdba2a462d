"""Gaussian kernel construction and the separable blur.

``js_round``, ``kernel_radius`` and ``gaussian_kernel_1d`` are verbatim
numpy copies of the JAX package's functions (``ops/gaussian.py``): the
taps must be the same float64 numbers before they are rounded to
float32, and the JAX package cannot be imported without jax.

:func:`blur_separable` is an explicit edge-clamp and tap loop, never a
convolution: cuDNN runs float32 convolutions in TF32 by default, and a
reduced-precision blur creates spurious extrema (the reference measured
~60 % with the TPU's bf16 default). The loop rounds every product and
every sum in float32 in tap order, row pass first, exactly like the CUDA
kernel (``ops/kernels/csrc/octave.cu``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def js_round(x: float) -> int:
    """JavaScript ``Math.round``: floor(x + 0.5) — half away from zero for
    positive inputs (ties go toward +inf). Used for kernel sizing
    (reference/src/sift.js:38,44)."""
    return int(math.floor(x + 0.5))


def kernel_radius(sigma: float, radius_sigmas: float = 3.0) -> int:
    """Kernel half-width ``round(3σ)`` (reference/src/sift.js:38)."""
    return js_round(radius_sigmas * sigma)


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(sigma: float, radius_sigmas: float = 3.0) -> np.ndarray:
    """Separable 1-D factor ``g / Σg`` of the reference kernel.

    The reference's normalized 2-D kernel equals the outer product of this
    1-D kernel with itself up to float rounding, because the 2-D normalizer
    factors: ``Σ_{ij} g(i)g(j) = (Σg)²``.
    """
    radius = kernel_radius(sigma, radius_sigmas)
    size = 2 * radius + 1
    g = np.empty((size,), dtype=np.float64)
    for i in range(size):
        ii = i - radius
        g[i] = math.exp(((ii * ii) / (sigma * sigma)) * -0.5)
    return g / g.sum()


def taps_f32(sigma: float) -> tuple[float, ...]:
    """The 1-D taps rounded to float32, as Python floats that are exact
    float32 values (so no later conversion can round them differently)."""
    return tuple(float(v) for v in gaussian_kernel_1d(sigma).astype(np.float32))


def _clamped(n: int, radius: int, device) -> torch.Tensor:
    """Source indices ``clamp(i - radius, 0, n - 1)`` for ``i < n + 2r``:
    the clamp-to-edge border (reference/src/sift.js:116-119)."""
    return torch.arange(-radius, n + radius, device=device).clamp(0, n - 1)


def blur_separable(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of ``(..., H, W)`` float32 with clamp-to-edge.

    Row pass (x taps) first, then column pass (y taps), each accumulated
    as ``acc = v0*t0; acc = acc + v_t*t_t`` in tap order.
    """
    taps = taps_f32(sigma)
    r = (len(taps) - 1) // 2
    h, w = image.shape[-2], image.shape[-1]
    padded = image.index_select(-1, _clamped(w, r, image.device))
    rows = padded[..., 0:w] * taps[0]
    for t in range(1, len(taps)):
        rows = rows + padded[..., t : t + w] * taps[t]
    padded = rows.index_select(-2, _clamped(h, r, image.device))
    out = padded[..., 0:h, :] * taps[0]
    for t in range(1, len(taps)):
        out = out + padded[..., t : t + h, :] * taps[t]
    return out


@functools.lru_cache(maxsize=256)
def device_taps(sigmas: tuple, device: torch.device):
    """The float32 taps of every sigma concatenated on ``device``, with each
    sigma's offset into them and its radius; cached per tuple of sigmas (the
    256 most recent), since a tensor built from host data is a blocking
    copy on CUDA. ``None``
    stands for the unblurred image: the one-tap identity (``v * 1.0f == v``)."""
    taps = [(1.0,) if s is None else taps_f32(s) for s in sigmas]
    offsets = np.cumsum([0] + [len(t) for t in taps[:-1]]).tolist()
    radii = [(len(t) - 1) // 2 for t in taps]
    flat = [v for t in taps for v in t]
    return torch.tensor(flat, dtype=torch.float32, device=device), offsets, radii
