"""End-to-end SIFT frontend: scale space → DoG → extrema → refinement →
orientations and descriptors.

The port of the JAX package's ``models/frontend.py`` with ``blur="fused"``:
every octave goes through the fused octave kernel
(``ops/kernels/octave.py``), which emits the DoG planes, the next octave's
seed, the packed extrema masks and, for the describe path, the Gaussian
stack; selection, Newton refinement and the describe stages' histogram math
are tensor code over the whole batch, and the describe stages sample
through the window-sampling kernel (``ops/kernels/describe.py``). The
entry points are fused-only. :func:`build_scale_space` is the scale space
built blur by blur, with the stand-alone blur kernel
(``ops/kernels/blur.py``) as one of its strategies.

The entry points (:func:`detect`, :func:`detect_batched`,
:func:`detect_and_describe`, :func:`detect_and_describe_batched`,
:func:`build_pyramid_fused`, :func:`build_scale_space`) run on the card:
with ``device=None`` a CUDA input stays on its card, a CPU tensor is moved
to ``torch.device("cuda")``, and without a CUDA device they raise.
``device="cpu"`` asks for the kernels' plain versions on the CPU. Results
lie on the device the work ran on.
"""

from __future__ import annotations

import torch

from ..config import SiftConfig
from ..core.types import Extrema, Keypoints, concat_keypoints
from ..ops.descriptor import (
    DescribedKeypoints,
    concat_described,
    describe_compact,
    describe_octave,
)
from ..ops.dog import difference_of_gaussians
from ..ops.extrema import select_refine_candidates
from ..ops.gaussian import blur_separable
from ..ops.kernels.blur import blur_fused
from ..ops.kernels.octave import fused_octave
from ..ops.refine import refine_keypoints
from ..ops.resize import downsample2x_nn, upsample2x_nn

# ``"cuda"``, the default, is the stand-alone blur kernel, the counterpart of
# the JAX package's ``"pallas"`` strategy (for a CPU tensor it runs the tap
# loop); ``"separable"`` is the plain tap loop on any device, the kernel's
# reference.
BLUR_STRATEGIES = {
    "cuda": blur_fused,
    "separable": blur_separable,
}


Device = torch.device | str | None


def _on_device(images: torch.Tensor, device: Device) -> torch.Tensor:
    """``images`` on the device an entry point works on (see the module):
    ``device`` if given, else the images' own card, else the default card."""
    if device is None:
        if images.device.type == "cuda":
            return images
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the entry points run on the card; pass "
                'device="cpu" for the plain PyTorch versions on the CPU'
            )
        device = torch.device("cuda")
    return images.to(device)


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
    images: torch.Tensor,
    cfg: SiftConfig,
    octave_fn=fused_octave,
    emit_scales: bool = False,
    device: Device = None,
):
    """Per-octave DoG stacks and packed extrema masks of ``(B, H, W)`` images.

    The JAX ``build_pyramid_fused`` with ``emit_masks=True``. Octave 0 is
    the 2× upsampled input, upsampled inside the kernel; octave ``o ≥ 1``
    starts from the previous octave's seed scale decimated 2×, taken
    unblurred as its scale 0 (reference/background.js:84, :110-143).
    Returns ``dogs[o]`` ``(B, S-1, H_o, W_o)`` float32 and ``masks[o]``
    ``(B, H_o, W_o)``; with ``emit_scales`` a third list follows, the
    Gaussian stacks ``(B, S, H_o, W_o)`` that the describe stages sample.
    ``octave_fn`` is :func:`fused_octave` or a function with its contract,
    such as its plain version. ``device``: see the module.
    """
    base = _on_device(images, device).to(torch.float32).contiguous()
    dogs, masks, stacks = [], [], []
    for octave in range(cfg.num_octaves):
        sigmas = [
            None if (octave > 0 and s == 0) else cfg.offset_sigma(octave, s)
            for s in range(cfg.scales_per_octave_total)
        ]
        dog, seed, mask, *scales = octave_fn(
            base,
            sigmas,
            cfg.scales_per_octave,
            cfg.contrast_prefilter_threshold,
            upsample2x=octave == 0,
            emit_scales=emit_scales,
        )
        dogs.append(dog)
        masks.append(mask)
        stacks.extend(scales)
        base = downsample2x_nn(seed).contiguous()
    if emit_scales:
        return dogs, masks, stacks
    return dogs, masks


def build_scale_space(
    images: torch.Tensor, cfg: SiftConfig, blur: str = "cuda", device: Device = None
) -> list[torch.Tensor]:
    """Gaussian scale space, one blur at a time (reference/background.js:71-237).

    ``images``: ``(..., H, W)`` float32 grayscale in [0, 1]. Returns one
    stack per octave, ``(..., spo+3, H_o, W_o)``. Octave 0 blurs every
    scale from the 2×-upsampled image with the semigroup offset sigma;
    octaves ≥ 1 seed from the previous octave's scale ``spo`` decimated 2×,
    taken unblurred as scale 0 (background.js:110-143). ``blur`` names one
    of :data:`BLUR_STRATEGIES`. ``device``: see the module.
    """
    blur_fn = BLUR_STRATEGIES[blur]
    octaves: list[torch.Tensor] = []
    base = upsample2x_nn(_on_device(images, device)).contiguous()
    for octave in range(cfg.num_octaves):
        first = 0
        scales = []
        if octave > 0:
            seed = octaves[octave - 1][..., cfg.scales_per_octave, :, :]
            base = downsample2x_nn(seed).contiguous()
            scales.append(base)
            first = 1
        for s in range(first, cfg.scales_per_octave_total):
            scales.append(blur_fn(base, cfg.offset_sigma(octave, s)))
        octaves.append(torch.stack(scales, dim=-3))
    return octaves


def build_dog(scale_space: list[torch.Tensor]) -> list[torch.Tensor]:
    """Per-octave DoG stacks ``(..., spo+2, H_o, W_o)``."""
    return [difference_of_gaussians(octave) for octave in scale_space]


def detect_octaves(
    dogs: list[torch.Tensor], cfg: SiftConfig, masks: list[torch.Tensor]
) -> tuple[list[Keypoints], list[Extrema]]:
    """Candidate selection and refinement, octave by octave.

    ``dogs[o]``: ``(B, D, H_o, W_o)``; ``masks[o]``: ``(B, H_o, W_o)``.
    Returns one ``Keypoints`` ``(B, n_o)`` and one ``Extrema`` per octave —
    the refinement candidates with the uncapped per-trio counters.
    """
    extrema = [
        select_refine_candidates(m, d, cfg, cfg.refine_capacity(octave))
        for octave, (d, m) in enumerate(zip(dogs, masks))
    ]
    keypoints = [
        refine_keypoints(d, e, octave, cfg)
        for octave, (d, e) in enumerate(zip(dogs, extrema))
    ]
    return keypoints, extrema


def detect_from_dog(
    dogs: list[torch.Tensor], cfg: SiftConfig, masks: list[torch.Tensor]
) -> tuple[Keypoints, list[Extrema]]:
    """:func:`detect_octaves` with all octaves' slots concatenated:
    keypoints ``(B, N)`` and one ``Extrema`` per octave."""
    keypoints, extrema = detect_octaves(dogs, cfg, masks)
    return concat_keypoints(keypoints), extrema


def detect_batched(
    images: torch.Tensor, cfg: SiftConfig, device: Device = None
) -> tuple[Keypoints, list[Extrema]]:
    """Batched detection: ``(B, H, W)`` grayscale → keypoints ``(B, N)``.

    uint8/uint16 images are scaled to ``[0, 1]``; float images are taken as
    they are. ``device``: see the module.
    """
    images = _on_device(images, device)
    dogs, masks = build_pyramid_fused(
        _as_unit_float(images), cfg, device=images.device
    )
    return detect_from_dog(dogs, cfg, masks)


def detect(
    image: torch.Tensor, cfg: SiftConfig, device: Device = None
) -> tuple[Keypoints, list[Extrema]]:
    """Single-image detection: ``(H, W)`` grayscale → keypoints ``(N,)``."""
    keypoints, extrema = detect_batched(image[None], cfg, device=device)
    return _first(keypoints), [_first(e) for e in extrema]


def detect_and_describe_batched(
    images: torch.Tensor, cfg: SiftConfig, device: Device = None
) -> DescribedKeypoints:
    """Batched frontend: ``(B, H, W)`` grayscale → oriented keypoints with
    128-D descriptors, fields ``(B, N)``.

    Detection as in :func:`detect_batched`, with the Gaussian stacks kept;
    then one compacting describe pass over the whole batch
    (``ops/descriptor.py::describe_compact``), or with
    ``cfg.compact_describe`` off the per-octave path over every slot.
    ``device``: see the module.
    """
    images = _on_device(images, device)
    dogs, masks, stacks = build_pyramid_fused(
        _as_unit_float(images), cfg, emit_scales=True, device=images.device
    )
    keypoints, _ = detect_octaves(dogs, cfg, masks)
    if cfg.compact_describe:
        return describe_compact(stacks, keypoints, cfg)
    return concat_described(
        [
            describe_octave(stack, kp, octave, cfg)
            for octave, (stack, kp) in enumerate(zip(stacks, keypoints))
        ]
    )


def detect_and_describe(
    image: torch.Tensor, cfg: SiftConfig, device: Device = None
) -> DescribedKeypoints:
    """Single-image frontend: ``(H, W)`` grayscale → described keypoints
    ``(N,)``, as a batch of one."""
    return _first(detect_and_describe_batched(image[None], cfg, device=device))


def _first(result):
    """The batch's only image of a result dataclass."""
    return type(result)(**{k: v[0] for k, v in vars(result).items()})
