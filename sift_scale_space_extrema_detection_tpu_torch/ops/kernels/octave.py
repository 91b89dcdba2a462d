"""One octave of the detect path: Gaussian scales, DoG, seed and extrema masks.

:func:`fused_octave` is the wrapper of the hand-written CUDA kernel
(``csrc/octave.cu``) that replaces the JAX package's Pallas TPU kernel
``ops/pallas/octave.py::fused_octave``. :func:`fused_octave_reference` is
its plain PyTorch version with the same contract; the wrapper runs it
only for a tensor on the CPU. On a CUDA tensor the wrapper launches the
kernel or raises — it never falls back. The kernel is one launch per
octave: a block owns a tile of the plane and keeps the Gaussian scales in
shared memory; :func:`octave_tile_plan` picks the tile from the plane's
shape and the octave's radii alone (and, for a radius whose window fits no
tile, the passes' clamped mode, counted as ``fused_octave.clamped`` as
well).

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
- With ``emit_scales`` a fourth result follows: the Gaussian stack
  ``(B, S, H, W)`` float32, which the describe stages sample.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..dog import difference_of_gaussians
from ..extrema import mask_dtype, pack_extrema_codes
from ..gaussian import blur_separable, device_taps
from ..resize import upsample2x_nn
from ._build import check_launch, load_kernels
from .tiles import TilePlan, plan_tiles

_MAX_GRID_Z = 65535  # CUDA's limit on the grid's z extent (the batch)
# A thread of the kernel keeps the scan state of 4 pixels in registers.
MAX_TILE_PIXELS = 2048


def octave_tile_plan(h: int, w: int, radii: tuple[int, ...]) -> TilePlan:
    """The fused octave kernel's tile for an ``h × w`` octave plane blurred
    with ``radii`` (0 for an unblurred scale): a ring of one pixel for the
    scan's 3×3 neighbourhood and the ``L`` and ``D`` planes beside the
    window. Raises ``ValueError`` where no tile fits either mode."""
    return plan_tiles(
        h, w, tuple(radii), ring=1, planes=2, max_tile_pixels=MAX_TILE_PIXELS
    )


def _check_base(base: torch.Tensor) -> None:
    if base.dtype != torch.float32:
        raise TypeError(f"fused_octave: base must be float32, got {base.dtype}")
    if base.dim() != 3 or min(base.shape) < 1:
        raise ValueError(
            f"fused_octave: base must be a non-empty (B, H, W), got {tuple(base.shape)}"
        )
    if not base.is_contiguous():
        raise ValueError("fused_octave: base must be contiguous")


def fused_octave_reference(
    base: torch.Tensor,
    sigmas: list[float | None],
    spo: int,
    contrast_thr: float,
    upsample2x: bool = False,
    emit_scales: bool = False,
):
    """Plain PyTorch version of :func:`fused_octave`, on any device."""
    _check_base(base)
    if upsample2x:
        base = upsample2x_nn(base)
    planes = [base if s is None else blur_separable(base, s) for s in sigmas]
    scales = torch.stack(planes, dim=1)
    dog = difference_of_gaussians(scales)
    masks = pack_extrema_codes(dog, float(np.float32(contrast_thr)))
    if emit_scales:
        return dog, planes[spo], masks, scales
    return dog, planes[spo], masks


def fused_octave(
    base: torch.Tensor,
    sigmas: list[float | None],
    spo: int,
    contrast_thr: float,
    upsample2x: bool = False,
    emit_scales: bool = False,
):
    """All scales, DoG, seed and extrema masks of one octave (see module).

    CUDA tensors go through the hand-written kernel, each launch counted by
    ``_build.check_launch`` as ``fused_octave`` (and, where the plan is the
    clamped mode, as ``fused_octave.clamped`` too); CPU tensors through
    :func:`fused_octave_reference`. Any other device raises.
    """
    _check_base(base)
    if base.device.type == "cpu":
        return fused_octave_reference(
            base, sigmas, spo, contrast_thr, upsample2x, emit_scales
        )
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
    taps_dev, offsets, radii = device_taps(tuple(sigmas), dev)
    plan = octave_tile_plan(h, w, tuple(radii))
    f32 = dict(dtype=torch.float32, device=dev)
    stack = torch.empty((b, n_scales, h, w), **f32) if emit_scales else None
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
            plan.tile_h, plan.tile_w, int(plan.clamped), plan.shared_bytes,
            stack.data_ptr() if emit_scales else None, dog.data_ptr(),
            seed.data_ptr(), masks.data_ptr(), int(mdtype == torch.int16),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(lib, rc, "fused_octave", clamped=plan.clamped)
    if emit_scales:
        return dog, seed, masks, stack
    return dog, seed, masks
