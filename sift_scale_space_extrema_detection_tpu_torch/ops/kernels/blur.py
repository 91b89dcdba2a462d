"""One separable Gaussian blur: the stand-alone blur of ``build_scale_space``.

:func:`blur_fused` is the wrapper of the hand-written CUDA kernel
(``csrc/blur.cu``) that replaces the JAX package's Pallas TPU kernel
``ops/pallas/blur.py::blur_pallas``: both 1-D passes in one launch, on a
tile held in shared memory, with clamp-to-edge borders. Its plain PyTorch
version is ``ops/gaussian.py::blur_separable`` (an explicit tap loop, no
convolution), which the wrapper runs only for a tensor on the CPU. On a
CUDA tensor it launches the kernel or raises; it never falls back. The
TPU kernel's size gate is fast-memory sizing of that chip and is not
ported: a radius whose window does not fit a block's shared memory takes the
kernel's clamped mode (counted as ``blur_fused.clamped`` as well),
which serves a radius up to about 1,000 on any plane; a larger one on a
plane of more than about 2,000 rows raises.
"""

from __future__ import annotations

import torch

from ..gaussian import blur_separable, device_taps
from ._build import check_launch, load_kernels
from .tiles import TilePlan, plan_tiles

_MAX_GRID_Z = 65535  # CUDA's limit on the grid's z extent (the planes)


def blur_tile_plan(h: int, w: int, radius: int) -> TilePlan:
    """The blur kernel's tile for an ``h × w`` plane at ``radius``: no ring,
    nothing but the window, the row buffer and the taps in shared memory.
    Raises ``ValueError`` where no tile fits either mode."""
    return plan_tiles(h, w, (radius,), ring=0, planes=0)


def blur_fused(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur of ``(..., H, W)`` float32, contiguous, with one sigma.

    CUDA tensors go through the hand-written kernel, each launch counted by
    ``_build.check_launch`` as ``blur_fused``; CPU tensors through
    :func:`~..gaussian.blur_separable`. Any other device raises.
    """
    if image.dtype != torch.float32:
        raise TypeError(f"blur_fused: image must be float32, got {image.dtype}")
    if image.dim() < 2 or min(image.shape) < 1:
        raise ValueError(
            f"blur_fused: image must be a non-empty (..., H, W), got {tuple(image.shape)}"
        )
    if not image.is_contiguous():
        raise ValueError("blur_fused: image must be contiguous")
    if image.device.type == "cpu":
        return blur_separable(image, sigma)
    if image.device.type != "cuda":
        raise ValueError(
            f"blur_fused: no kernel for device {image.device}; "
            "pass a CUDA tensor, or a CPU tensor for the plain version"
        )
    h, w = image.shape[-2:]
    planes = image.numel() // (h * w)
    if planes > _MAX_GRID_Z:
        raise ValueError(f"blur_fused: {planes} planes exceed {_MAX_GRID_Z}")
    dev = image.device
    taps_dev, _, (radius,) = device_taps((sigma,), dev)
    plan = blur_tile_plan(h, w, radius)
    out = torch.empty_like(image)
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.sift_blur(
            image.data_ptr(), planes, h, w, taps_dev.data_ptr(), radius,
            plan.tile_h, plan.tile_w, int(plan.clamped), plan.shared_bytes,
            out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(lib, rc, "blur_fused", clamped=plan.clamped)
    return out
