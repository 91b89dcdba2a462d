"""One separable Gaussian blur: the stand-alone blur of ``build_scale_space``.

:func:`blur_fused` is the wrapper of the hand-written CUDA kernel
(``csrc/blur.cu``) that replaces the JAX package's Pallas TPU kernel
``ops/pallas/blur.py::blur_pallas``: both 1-D passes behind one call, with
clamp-to-edge borders. Its plain PyTorch version is
``ops/gaussian.py::blur_separable`` (an explicit tap loop, no
convolution), which the wrapper runs only for a tensor on the CPU. On a
CUDA tensor it launches the kernel or raises; it never falls back, and it
takes any radius (the TPU kernel's size gate is fast-memory sizing of that
chip and is not ported).
"""

from __future__ import annotations

import torch

from ..gaussian import blur_separable, device_taps
from ._build import check_launch, load_kernels

_MAX_GRID_Z = 65535  # CUDA's limit on the grid's z extent (the planes)


def blur_fused(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur of ``(..., H, W)`` float32, contiguous, with one sigma.

    CUDA tensors go through the hand-written kernel, counted in
    ``blur_fused.launches``; CPU tensors through
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
    tmp = torch.empty_like(image)
    out = torch.empty_like(image)
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.sift_blur(
            image.data_ptr(), planes, h, w, taps_dev.data_ptr(), radius,
            tmp.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(lib, rc, "blur_fused")
    blur_fused.launches += 1
    return out


blur_fused.launches = 0
