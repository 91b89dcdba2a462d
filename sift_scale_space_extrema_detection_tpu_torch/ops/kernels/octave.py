"""One octave of the detect path: Gaussian scales, DoG, seed and extrema masks.

:func:`fused_octave` is the wrapper of the hand-written CUDA kernel
(``csrc/octave.cu``) that replaces the JAX package's Pallas TPU kernel
``ops/pallas/octave.py::fused_octave``. :func:`fused_octave_reference` is
its plain PyTorch version with the same contract; the wrapper runs it
only for a tensor on the CPU. On a CUDA tensor the wrapper launches the
kernel or raises — it never falls back.

Contract for one octave of a batch (the layout is plane-major; the TPU
kernel's stripe-major DoG is a TPU write-DMA workaround, not part of it):

- ``base``: ``(B, H, W)`` float32, contiguous. With ``upsample2x`` it is
  the half-resolution original and the octave is ``2H × 2W`` (the
  reference's 2× nearest upsample, reference/background.js:84).
- ``sigmas[s]``: the offset sigma that blurs the base to scale ``s``
  (semigroup relation, reference/background.js:157-177), or ``None`` for
  the unblurred base (scale 0 of octaves ≥ 1, background.js:110-143).
- Returns ``dog`` ``(B, S-1, H, W)`` float32 with
  ``dog[:, s-1] = L[s-1] − L[s]``, ``seed = L[spo]`` ``(B, H, W)``, and
  ``masks`` ``(B, H, W)`` (int16 up to 8 trios, else int32) holding trio
  ``t``'s 2-bit code in bits ``[2t, 2t+2)`` (see
  ``ops/extrema.py::pack_extrema_codes``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..dog import difference_of_gaussians
from ..extrema import mask_dtype, pack_extrema_codes
from ..gaussian import blur_separable, taps_f32
from ..resize import upsample2x_nn
from ._build import load_kernels

_MAX_GRID_Z = 65535  # CUDA's limit on the grid's z extent (the batch)


def _check_base(base: torch.Tensor) -> None:
    if base.dtype != torch.float32:
        raise TypeError(f"fused_octave: base must be float32, got {base.dtype}")
    if base.dim() != 3 or min(base.shape) < 1:
        raise ValueError(
            f"fused_octave: base must be a non-empty (B, H, W), got {tuple(base.shape)}"
        )
    if not base.is_contiguous():
        raise ValueError("fused_octave: base must be contiguous")


@functools.lru_cache(maxsize=None)
def _device_taps(sigmas: tuple, device: torch.device):
    """All scales' float32 taps concatenated on ``device``, with each
    scale's offset and radius; made once per octave geometry, since a
    tensor built from host data is a blocking copy on CUDA. The unblurred
    base is the one-tap identity blur (``v * 1.0f == v``)."""
    taps = [(1.0,) if s is None else taps_f32(s) for s in sigmas]
    offsets = np.cumsum([0] + [len(t) for t in taps[:-1]]).tolist()
    radii = [(len(t) - 1) // 2 for t in taps]
    flat = [v for t in taps for v in t]
    return torch.tensor(flat, dtype=torch.float32, device=device), offsets, radii


def fused_octave_reference(
    base: torch.Tensor,
    sigmas: list[float | None],
    spo: int,
    contrast_thr: float,
    upsample2x: bool = False,
):
    """Plain PyTorch version of :func:`fused_octave`, on any device."""
    _check_base(base)
    if upsample2x:
        base = upsample2x_nn(base)
    planes = [base if s is None else blur_separable(base, s) for s in sigmas]
    dog = difference_of_gaussians(torch.stack(planes, dim=1))
    masks = pack_extrema_codes(dog, float(np.float32(contrast_thr)))
    return dog, planes[spo], masks


def fused_octave(
    base: torch.Tensor,
    sigmas: list[float | None],
    spo: int,
    contrast_thr: float,
    upsample2x: bool = False,
):
    """All scales, DoG, seed and extrema masks of one octave (see module).

    CUDA tensors go through the hand-written kernel, counted in
    ``fused_octave.launches``; CPU tensors through
    :func:`fused_octave_reference`. Any other device raises.
    """
    _check_base(base)
    if base.device.type == "cpu":
        return fused_octave_reference(base, sigmas, spo, contrast_thr, upsample2x)
    if base.device.type != "cuda":
        raise ValueError(
            f"fused_octave: no kernel for device {base.device}; "
            "pass a CUDA tensor, or a CPU tensor for the plain version"
        )
    b, h, w = base.shape
    if b > _MAX_GRID_Z:
        raise ValueError(f"fused_octave: batch {b} exceeds {_MAX_GRID_Z}")
    if upsample2x:
        h, w = 2 * h, 2 * w
    n_scales = len(sigmas)
    if not 0 <= spo < n_scales or n_scales < 2:
        raise ValueError(f"fused_octave: spo {spo} with {n_scales} scales")
    n_trios = n_scales - 3
    if n_trios > 16:
        raise ValueError(f"fused_octave: {n_trios} trios do not fit 32 mask bits")
    dev = base.device
    taps_dev, offsets, radii = _device_taps(tuple(sigmas), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    stack = torch.empty((b, n_scales, h, w), **f32)
    tmp = torch.empty((b, h, w), **f32)
    dog = torch.empty((b, n_scales - 1, h, w), **f32)
    seed = torch.empty((b, h, w), **f32)
    mdtype = mask_dtype(n_trios)
    masks = torch.empty((b, h, w), dtype=mdtype, device=dev)
    lib = load_kernels()
    int_array = ctypes.c_int * n_scales
    with torch.cuda.device(dev):
        rc = lib.sift_fused_octave(
            base.data_ptr(), b, h, w, int(upsample2x),
            taps_dev.data_ptr(), int_array(*offsets), int_array(*radii),
            n_scales, spo, float(np.float32(contrast_thr)),
            stack.data_ptr(), tmp.data_ptr(), dog.data_ptr(),
            seed.data_ptr(), masks.data_ptr(), int(mdtype == torch.int16),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.sift_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_octave: kernel launch failed: CUDA error {rc} ({msg})")
    fused_octave.launches += 1
    return dog, seed, masks


fused_octave.launches = 0
