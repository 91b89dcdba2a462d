"""End-to-end SIFT detection: scale space → DoG → extrema → refinement.

The port of the JAX package's detect path (``models/frontend.py`` with
``blur="fused"``): every octave goes through the fused octave kernel
(``ops/kernels/octave.py``), which emits the DoG planes, the next
octave's seed and the packed extrema masks; selection and Newton
refinement are tensor code over the whole batch. Tensors stay on the
device of the input; a CPU input runs the kernels' plain versions.
"""

from __future__ import annotations

import torch

from ..config import SiftConfig
from ..core.types import Extrema, Keypoints, concat_keypoints
from ..ops.extrema import select_refine_candidates
from ..ops.kernels.octave import fused_octave
from ..ops.refine import refine_keypoints
from ..ops.resize import downsample2x_nn


def _as_unit_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 → ``/255`` (the reference's rule, reference/src/image-utils.js:114),
    uint16 → ``/65535``, as float32; float inputs pass through untouched.

    The divisor is a tensor on the images' device: PyTorch's CUDA division
    by a Python scalar multiplies by the reciprocal, which rounds
    differently from the reference's division.
    """
    for dtype, full_scale in ((torch.uint8, 255.0), (torch.uint16, 65535.0)):
        if images.dtype == dtype:
            divisor = torch.full((), full_scale, device=images.device)
            return images.to(torch.float32) / divisor
    return images


def build_pyramid_fused(
    images: torch.Tensor, cfg: SiftConfig, octave_fn=fused_octave
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Per-octave DoG stacks and packed extrema masks of ``(B, H, W)`` images.

    The detect path of the JAX ``build_pyramid_fused`` (``emit_scales=False,
    emit_masks=True``): the Gaussian stacks are not returned. Octave 0 is
    the 2× upsampled input, upsampled inside the kernel; octave ``o ≥ 1``
    starts from the previous octave's seed scale decimated 2×, taken
    unblurred as its scale 0 (reference/background.js:84, :110-143).
    Returns ``dogs[o]`` ``(B, S-1, H_o, W_o)`` float32 and ``masks[o]``
    ``(B, H_o, W_o)``. ``octave_fn`` is :func:`fused_octave` or a function
    with its contract, such as its plain version.
    """
    base = images.to(torch.float32).contiguous()
    dogs, masks = [], []
    for octave in range(cfg.num_octaves):
        sigmas = [
            None if (octave > 0 and s == 0) else cfg.offset_sigma(octave, s)
            for s in range(cfg.scales_per_octave_total)
        ]
        dog, seed, mask = octave_fn(
            base,
            sigmas,
            cfg.scales_per_octave,
            cfg.contrast_prefilter_threshold,
            upsample2x=octave == 0,
        )
        dogs.append(dog)
        masks.append(mask)
        base = downsample2x_nn(seed).contiguous()
    return dogs, masks


def detect_from_dog(
    dogs: list[torch.Tensor], cfg: SiftConfig, masks: list[torch.Tensor]
) -> tuple[Keypoints, list[Extrema]]:
    """Candidate selection and refinement over per-octave DoG stacks.

    ``dogs[o]``: ``(B, D, H_o, W_o)``; ``masks[o]``: ``(B, H_o, W_o)``.
    Returns keypoints ``(B, N)`` (all octaves' slots concatenated) and one
    ``Extrema`` per octave — the refinement candidates with the uncapped
    per-trio counters.
    """
    extrema = [
        select_refine_candidates(m, d, cfg, cfg.refine_capacity(octave))
        for octave, (d, m) in enumerate(zip(dogs, masks))
    ]
    keypoints = [
        refine_keypoints(d, e, octave, cfg)
        for octave, (d, e) in enumerate(zip(dogs, extrema))
    ]
    return concat_keypoints(keypoints), extrema


def detect_batched(
    images: torch.Tensor, cfg: SiftConfig
) -> tuple[Keypoints, list[Extrema]]:
    """Batched detection: ``(B, H, W)`` grayscale → keypoints ``(B, N)``.

    uint8/uint16 images are scaled to ``[0, 1]``; float images are taken as
    they are. The work runs on the images' device.
    """
    dogs, masks = build_pyramid_fused(_as_unit_float(images), cfg)
    return detect_from_dog(dogs, cfg, masks)


def detect(image: torch.Tensor, cfg: SiftConfig) -> tuple[Keypoints, list[Extrema]]:
    """Single-image detection: ``(H, W)`` grayscale → keypoints ``(N,)``."""
    keypoints, extrema = detect_batched(image[None], cfg)
    return _first(keypoints), [_first(e) for e in extrema]


def _first(result):
    """The batch's only image of a ``Keypoints`` or ``Extrema``."""
    return type(result)(**{k: v[0] for k, v in vars(result).items()})
