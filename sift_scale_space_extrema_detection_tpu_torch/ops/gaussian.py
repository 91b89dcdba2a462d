"""Gaussian kernel construction, the separable blur and the exact blur.

``js_round``, ``kernel_radius``, ``gaussian_kernel_1d`` and
``gaussian_kernel_2d`` are verbatim numpy copies of the JAX package's
functions (``ops/gaussian.py``): the taps must be the same float64 numbers
before they are rounded to float32, and the JAX package cannot be imported
without jax.

:func:`blur_exact` is the bit-parity path: the full 2-D kernel in the
reference's accumulation order (reference/src/sift.js:96-131), for float64
images, on the CPU or on the card.

:func:`blur_separable` is an explicit edge-clamp and tap loop, never a
convolution: cuDNN runs float32 convolutions in TF32 by default, and a
reduced-precision blur creates spurious extrema (the reference measured
~60 % with the TPU's bf16 default). The loop rounds every product and
every sum in float32 in tap order, row pass first, exactly like the CUDA
kernel (``ops/kernels/csrc/octave.cu``).

:func:`blur_matmul` is the JAX package's banded-product blur ``B_v @ X @
B_hᵀ``, the clamp-to-edge weights folded into the band matrices; it is no
TPU kernel, so it stays two ``torch.matmul`` calls, which refuse TF32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.device import require_full_float32_matmul


def js_round(x: float) -> int:
    """JavaScript ``Math.round``: floor(x + 0.5) — half away from zero for
    positive inputs (ties go toward +inf). Used for kernel sizing
    (reference/src/sift.js:38,44)."""
    return int(math.floor(x + 0.5))


def kernel_radius(sigma: float, radius_sigmas: float = 3.0) -> int:
    """Kernel half-width ``round(3σ)`` (reference/src/sift.js:38)."""
    return js_round(radius_sigmas * sigma)


@functools.lru_cache(maxsize=None)
def gaussian_kernel_2d(sigma: float, radius_sigmas: float = 3.0) -> np.ndarray:
    """Dense 2-D Gaussian kernel, float64, exact reference construction.

    Replays reference/src/sift.js:31-67: sample
    ``exp(((i²+j²)/σ²)·-0.5) / (2π·σ²)`` on the grid, accumulate the sum in
    row-major order, then divide elementwise. The sequential accumulation
    order matters for bit-parity of the normalizer.
    """
    radius = kernel_radius(sigma, radius_sigmas)
    size = 2 * radius + 1
    kernel = np.empty((size, size), dtype=np.float64)
    total = 0.0
    for i in range(size):
        ii = i - radius
        for j in range(size):
            jj = j - radius
            value = math.exp(
                (((ii * ii) + (jj * jj)) / (sigma * sigma)) * -0.5
            ) / (2.0 * math.pi * (sigma * sigma))
            kernel[i, j] = value
            total += value
    return kernel / total


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


def blur_exact(image: torch.Tensor, sigma: float, radius_sigmas: float = 3.0) -> torch.Tensor:
    """Full 2-D Gaussian blur of ``(..., H, W)`` in the reference's
    accumulation order, clamp-to-edge.

    Per output pixel the reference does
    ``pixel_sum += input[clamp(y + (j-R))][clamp(x + (i-R))] * k[i][j]``
    with ``i`` (x offset) outer and ``j`` (y offset) inner
    (reference/src/sift.js:96-131). Each tap is one multiply and one add,
    two tensor operations and so two roundings; a fused multiply-add
    (``torch.addcmul``) would round once and break bit parity. The first
    tap starts the sum: ``0 + p`` is ``p`` exactly. The taps are Python
    floats, exact float64 values, so a float64 image sees the reference's
    kernel; ``(2R+1)²`` taps make this the slow path by design.
    """
    radius = kernel_radius(sigma, radius_sigmas)
    kernel = gaussian_kernel_2d(sigma, radius_sigmas).tolist()
    h, w = image.shape[-2], image.shape[-1]
    padded = image.index_select(-1, _clamped(w, radius, image.device))
    padded = padded.index_select(-2, _clamped(h, radius, image.device))
    acc = None
    for i, column in enumerate(kernel):  # x offset
        for j, k in enumerate(column):  # y offset
            product = padded[..., j : j + h, i : i + w] * k
            acc = product if acc is None else acc + product
    return acc


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


@functools.lru_cache(maxsize=None)
def _blur_band_matrix(n: int, sigma: float, radius_sigmas: float) -> np.ndarray:
    """(n, n) matrix M with ``(M @ v)[y] = Σ_t k1[t+R] · v[clamp(y+t)]``.

    Clamp-to-edge is folded in by accumulating out-of-range tap weights
    into the edge columns, which is exactly the reference's border rule
    (reference/src/sift.js:116-119) applied along one axis. A verbatim
    copy of the JAX package's function.
    """
    radius = kernel_radius(sigma, radius_sigmas)
    k1 = gaussian_kernel_1d(sigma, radius_sigmas)
    m = np.zeros((n, n), dtype=np.float64)
    for y in range(n):
        for t in range(-radius, radius + 1):
            col = min(max(y + t, 0), n - 1)
            m[y, col] += k1[t + radius]
    return m


def blur_matmul(image: torch.Tensor, sigma: float, radius_sigmas: float = 3.0) -> torch.Tensor:
    """Gaussian blur of ``(..., H, W)`` as two banded matrix products,
    ``B_v @ X @ B_hᵀ``, in the image's dtype.

    The products must run in full float32: the JAX package measured a
    reduced-precision (bf16) blur at ~60 % spurious extrema and 27 %
    keypoint agreement, so on the card this raises where TF32 is allowed.
    """
    require_full_float32_matmul(image.device)
    h, w = image.shape[-2], image.shape[-1]

    def band(n):
        return torch.from_numpy(_blur_band_matrix(n, sigma, radius_sigmas)).to(
            device=image.device, dtype=image.dtype
        )

    return torch.matmul(torch.matmul(band(h), image), band(w).T)
