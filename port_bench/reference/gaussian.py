"""A frozen copy of the port's ``ops/gaussian.py``, the functions of its
separable blur (see ``reference/__init__.py``).

``js_round``, ``kernel_radius`` and ``gaussian_kernel_1d`` build the taps
as the JS reference does. :func:`blur_separable` is the benchmark's own:
the edge-clamped separable blur as two float32 matrix products with
banded matrices of the taps. It sums the products in another order than
the port's tap loop does, so the comparison holds the program to the
blur's arithmetic and not to one order of its sums; and the control's
TF32 matrix products reach the scale space, the DoG and every stage
after them.
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


def _band(n: int, sigma: float, device) -> torch.Tensor:
    """``(n, n)`` float32 matrix ``M`` of the clamp-to-edge blur along one
    axis: ``out[i] = Σ_j x[j]·M[j, i]``, where ``M[j, i]`` sums the taps
    whose clamped source index ``clamp(i - r + t, 0, n - 1)`` is ``j``
    (reference/src/sift.js:116-119)."""
    taps = torch.tensor(taps_f32(sigma), dtype=torch.float64, device=device)
    r = (len(taps) - 1) // 2
    out = torch.arange(n, device=device)
    band = torch.zeros((n, n), dtype=torch.float64, device=device)
    for t in range(len(taps)):
        band.index_put_(((out - r + t).clamp(0, n - 1), out), taps[t], accumulate=True)
    return band.to(torch.float32)


def blur_separable(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of ``(..., H, W)`` float32 with clamp-to-edge,
    row pass first: two matrix products with the banded matrices of the
    taps (:func:`_band`). The same float32 products as a tap loop, summed
    in the order of the matrix product, in full float32 where TF32 is
    off; with TF32 on (the control) each product is rounded to TF32."""
    h, w = image.shape[-2], image.shape[-1]
    rows = torch.matmul(image, _band(w, sigma, image.device))
    return torch.matmul(_band(h, sigma, image.device).transpose(0, 1), rows)
