"""End-to-end SIFT frontend: scale space → DoG → extrema → refinement →
orientations and descriptors.

The port of the JAX package's ``models/frontend.py``. Its entry points take
the JAX package's ``blur`` argument:

- ``blur="fused"`` (the port's default, its main path): every octave goes
  through the fused octave kernel (``ops/kernels/octave.py``), which emits
  the DoG planes, the next octave's seed, the packed extrema masks and, for
  the describe path, the Gaussian stack; candidates are capped per octave
  (:func:`~..ops.extrema.select_refine_candidates`).
- any name of :data:`BLUR_STRATEGIES`: the scale space blur by blur
  (:func:`build_scale_space`; ``"cuda"`` and ``"pallas"`` launch the
  stand-alone blur kernel, ``ops/kernels/blur.py``, once per blurred
  scale), the DoG, then each trio scanned and capped on its own
  (:func:`~..ops.extrema.find_extrema`) and the trios compacted
  (:func:`~..ops.extrema.compact_extrema`): the JAX package's
  ``blur="separable"`` default, where capacity saturates another keypoint
  set than the per-octave cap's.

Selection, Newton refinement and the describe stages' histogram math are
tensor code over the whole batch, and the describe stages sample through
the window-sampling kernel (``ops/kernels/describe.py``).

Each layer's work runs in a span (``utils/profile.py``, on only inside
``tracing()``): ``sift.frontend`` around a batched entry, ``sift.pyramid``,
``sift.select`` and ``sift.refine`` around the functions that do each
layer's work, whichever entry calls them, and ``sift.describe`` in
``ops/descriptor.py``.

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
from ..core.device import Device, on_device
from ..core.types import Extrema, Keypoints, concat_keypoints, split_keypoints
from ..ops.descriptor import (
    DescribedKeypoints,
    concat_described,
    describe_compact,
    describe_octave,
)
from ..ops.dog import difference_of_gaussians
from ..ops.extrema import compact_extrema, find_extrema, select_refine_candidates
from ..ops.gaussian import blur_exact, blur_matmul, blur_separable
from ..ops.kernels.blur import blur_fused
from ..ops.kernels.octave import fused_octave
from ..ops.refine import refine_keypoints, refine_keypoints_multi
from ..ops.resize import downsample2x_nn, upsample2x_nn
from ..utils.profile import span

# The scale space blur by blur, by name. ``"cuda"`` is the stand-alone blur
# kernel (for a CPU tensor it runs the tap loop), and ``"pallas"``, the JAX
# package's name for its blur kernel, is the same entry, so that a JAX
# command line runs unchanged; ``"separable"`` is the plain tap loop on any
# device, the kernel's reference and the JAX package's default;
# ``"matmul"`` is the banded matrix product (TF32 refused); ``"exact"`` is
# the full 2-D blur in the reference's accumulation order, for float64
# images: the oracle leg. ``"fused"`` (the whole-octave kernel) is the
# entry points' fifth name; it builds no scale space blur by blur.
BLUR_STRATEGIES = {
    "cuda": blur_fused,
    "pallas": blur_fused,
    "separable": blur_separable,
    "matmul": blur_matmul,
    "exact": blur_exact,
}


def check_blur(blur: str, dtype: torch.dtype | None = None) -> None:
    """Raise ``ValueError`` for a ``blur`` the entry points do not know, or
    for the blur kernel's names on a float64 input (the kernels are float32
    only; such an input is refused, not cast)."""
    if blur != "fused" and blur not in BLUR_STRATEGIES:
        raise ValueError(
            f"unknown blur {blur!r}: one of {['fused', *BLUR_STRATEGIES]}"
        )
    if blur in ("cuda", "pallas") and dtype == torch.float64:
        raise ValueError(
            f'blur="{blur}" is the float32 blur kernel and the input is float64: '
            'use blur="exact", "separable" or "matmul"'
        )


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
    base = on_device(images, device).to(torch.float32).contiguous()
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

    ``images``: ``(..., H, W)`` grayscale in [0, 1], float32 (float64 for
    ``blur="exact"``); the stacks keep the dtype. Returns one
    stack per octave, ``(..., spo+3, H_o, W_o)``. Octave 0 blurs every
    scale from the 2×-upsampled image with the semigroup offset sigma;
    octaves ≥ 1 seed from the previous octave's scale ``spo`` decimated 2×,
    taken unblurred as scale 0 (background.js:110-143). ``blur`` names one
    of :data:`BLUR_STRATEGIES` (else ``ValueError``). ``device``: see the
    module.
    """
    if blur not in BLUR_STRATEGIES:
        raise ValueError(
            f"build_scale_space: unknown blur {blur!r}: one of {list(BLUR_STRATEGIES)}"
            + ('; "fused" is build_pyramid_fused' if blur == "fused" else "")
        )
    blur_fn = BLUR_STRATEGIES[blur]
    octaves: list[torch.Tensor] = []
    base = upsample2x_nn(on_device(images, device)).contiguous()
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


def _select_candidates(dogs, cfg: SiftConfig, masks) -> tuple[list[Extrema], list[Extrema]]:
    """Per octave, the ``Extrema`` :func:`detect_octaves` returns and the
    refinement's candidate slots (``refine_capacity(o)`` of them)."""
    if masks is None:
        masks = [None] * len(dogs)
    extrema, selected = [], []
    with span("select"):
        for octave, (d, m) in enumerate(zip(dogs, masks)):
            capacity = cfg.refine_capacity(octave)
            if m is None:
                e = find_extrema(d, cfg, cfg.keypoints_per_trio(octave))
                sel = compact_extrema(e, capacity)
            else:
                e = sel = select_refine_candidates(m, d, cfg, capacity)
            extrema.append(e)
            selected.append(sel)
    return extrema, selected


def _refine_per_octave(dogs, selected, cfg: SiftConfig) -> list[Keypoints]:
    with span("refine"):
        return [
            refine_keypoints(d, sel, o, cfg) for o, (d, sel) in enumerate(zip(dogs, selected))
        ]


def _refine_pooled(dogs, selected, cfg: SiftConfig, first: int = 0) -> list[Keypoints]:
    """:func:`~..ops.refine.refine_keypoints_multi` over the octaves from
    ``first`` on, split back into one ``Keypoints`` per octave."""
    with span("refine"):
        pooled = refine_keypoints_multi(dogs, selected, cfg, octave_offset=first)
        return split_keypoints(pooled, [sel.capacity for sel in selected])


def detect_octaves(
    dogs: list[torch.Tensor],
    cfg: SiftConfig,
    masks: list[torch.Tensor | None] | None = None,
) -> tuple[list[Keypoints], list[Extrema]]:
    """Candidate selection and refinement, octave by octave.

    ``dogs[o]``: ``(B, D, H_o, W_o)``; ``masks[o]``: ``(B, H_o, W_o)``, the
    octave kernel's packed extrema codes, or ``None``: that octave is
    scanned here trio by trio (:func:`find_extrema`), in the dtype of its
    DoG, the route of ``build_scale_space`` and of the float64 oracle leg.
    Returns one ``Keypoints`` ``(B, refine_capacity(o))`` and one
    ``Extrema`` per octave: with a mask the refinement candidates with the
    uncapped per-trio counters, without one the per-trio segments (segment
    ``t`` = slots ``[t·cap, (t+1)·cap)``), of which refinement consumes a
    compacted copy.

    Refinement follows the JAX package's ``detect_from_dog``: with
    ``cfg.unified_refine`` (every DoG of one dtype) all octaves are refined
    as one pool; else with ``cfg.refine_tail_pool`` and more than two
    octaves, octave 0 alone and the rest as one pool
    (:func:`~..ops.refine.refine_keypoints_multi`); else octave by octave.
    The pools change results only where a pool's capacity overflows.
    """
    extrema, selected = _select_candidates(dogs, cfg, masks)
    if cfg.unified_refine and len({d.dtype for d in dogs}) == 1:
        keypoints = _refine_pooled(dogs, selected, cfg)
    elif cfg.refine_tail_pool and len(dogs) > 2 and len({d.dtype for d in dogs[1:]}) == 1:
        keypoints = _refine_per_octave(dogs[:1], selected[:1], cfg) + _refine_pooled(
            dogs[1:], selected[1:], cfg, first=1
        )
    else:
        keypoints = _refine_per_octave(dogs, selected, cfg)
    return keypoints, extrema


def detect_from_dog(
    dogs: list[torch.Tensor],
    cfg: SiftConfig,
    masks: list[torch.Tensor | None] | None = None,
) -> tuple[Keypoints, list[Extrema]]:
    """:func:`detect_octaves` with all octaves' slots concatenated:
    keypoints ``(B, N)`` and one ``Extrema`` per octave."""
    keypoints, extrema = detect_octaves(dogs, cfg, masks)
    return concat_keypoints(keypoints), extrema


def _pyramid(images: torch.Tensor, cfg: SiftConfig, blur: str, emit_scales: bool):
    """``(dogs, masks, stacks)`` of unit-range images on their device:
    the fused octave kernel's (``stacks`` only with ``emit_scales``), or
    the scale space blur by blur with no masks."""
    with span("pyramid"):
        if blur == "fused":
            dogs, masks, *stacks = build_pyramid_fused(
                images, cfg, emit_scales=emit_scales, device=images.device
            )
            return dogs, masks, stacks[0] if stacks else None
        stacks = build_scale_space(images, cfg, blur, device=images.device)
        return build_dog(stacks), None, stacks


def detect_batched(
    images: torch.Tensor, cfg: SiftConfig, blur: str = "fused", device: Device = None
) -> tuple[Keypoints, list[Extrema]]:
    """Batched detection: ``(B, H, W)`` grayscale → keypoints ``(B, N)``.

    uint8/uint16 images are scaled to ``[0, 1]``; float images are taken as
    they are. ``blur``: ``"fused"`` or a name of :data:`BLUR_STRATEGIES`
    (see the module; :func:`check_blur`). ``device``: see the module.
    """
    check_blur(blur, images.dtype)
    with span("frontend"):
        images = _as_unit_float(on_device(images, device))
        dogs, masks, _ = _pyramid(images, cfg, blur, emit_scales=False)
        return detect_from_dog(dogs, cfg, masks)


def detect(
    image: torch.Tensor, cfg: SiftConfig, blur: str = "fused", device: Device = None
) -> tuple[Keypoints, list[Extrema]]:
    """Single-image detection: ``(H, W)`` grayscale → keypoints ``(N,)``."""
    keypoints, extrema = detect_batched(image[None], cfg, blur, device=device)
    return _first(keypoints), [_first(e) for e in extrema]


def detect_and_describe_batched(
    images: torch.Tensor,
    cfg: SiftConfig,
    blur: str = "fused",
    device: Device = None,
    max_features: int | None = None,
) -> DescribedKeypoints:
    """Batched frontend: ``(B, H, W)`` grayscale → oriented keypoints with
    128-D descriptors, fields ``(B, N)``.

    Detection as in :func:`detect_batched` with the Gaussian stacks kept,
    but refined octave by octave whatever ``cfg.unified_refine`` and
    ``cfg.refine_tail_pool`` say, as the JAX package's describe paths do;
    then one compacting describe pass over the whole batch
    (``ops/descriptor.py::describe_compact``), or with
    ``cfg.compact_describe`` off the per-octave path over every slot.
    ``max_features`` N: each image keeps its N strongest (keypoint,
    orientation) pairs by ``|value|``, ties at the N-th kept, before the
    descriptors are computed (``describe_compact``; the compacting pass
    only, else ``ValueError``). ``blur`` and ``device``: see
    :func:`detect_batched`.
    """
    check_blur(blur, images.dtype)
    if max_features is not None and not cfg.compact_describe:
        raise ValueError("max_features ranks pairs across octaves in the compacting "
                         "describe pass: it needs cfg.compact_describe")
    with span("frontend"):
        images = _as_unit_float(on_device(images, device))
        dogs, masks, stacks = _pyramid(images, cfg, blur, emit_scales=True)
        _, selected = _select_candidates(dogs, cfg, masks)
        keypoints = _refine_per_octave(dogs, selected, cfg)
        if stacks[0].dtype == torch.float64:
            # The describe stages are float32 (the sampling kernel's contract):
            # a float64 scale space is described from its float32 rounding.
            stacks = [s.to(torch.float32) for s in stacks]
            keypoints = [_float32(kp) for kp in keypoints]
        if cfg.compact_describe:
            return describe_compact(stacks, keypoints, cfg, max_features=max_features)
        return concat_described(
            [
                describe_octave(stack, kp, octave, cfg)
                for octave, (stack, kp) in enumerate(zip(stacks, keypoints))
            ]
        )


def detect_and_describe(
    image: torch.Tensor,
    cfg: SiftConfig,
    blur: str = "fused",
    device: Device = None,
    max_features: int | None = None,
) -> DescribedKeypoints:
    """Single-image frontend: ``(H, W)`` grayscale → described keypoints
    ``(N,)``, as a batch of one."""
    return _first(detect_and_describe_batched(
        image[None], cfg, blur, device=device, max_features=max_features))


def _float32(keypoints: Keypoints) -> Keypoints:
    return Keypoints(**{
        k: v.to(torch.float32) if v.is_floating_point() else v for k, v in vars(keypoints).items()
    })


def _first(result):
    """The batch's only image of a result dataclass."""
    return type(result)(**{k: v[0] for k, v in vars(result).items()})
