"""The frontend's entry points in plain PyTorch: a frozen copy of the route
of the port's ``models/frontend.py`` (``detect_batched``,
``detect_and_describe_batched``) with the octave kernel's plain version
(``ops/kernels/octave.py::fused_octave_reference``) and the window-sampling
kernel's (``sampling.py::window_sample_pair``) in the kernels' places.

Two things are the benchmark's own: :func:`pad_edges`, the evaluator's
bottom/right edge padding (``core/image.py::pad_to_tpu_friendly``) in
PyTorch, and :func:`precision`, which sets the precision of the describe
stages' matrix products: full float32 for the reference, TF32 for the
control that has to fail the comparison.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from .config import SiftConfig
from .descriptor import DescribedKeypoints, describe_compact
from .extrema import compact_extrema, find_extrema, pack_extrema_codes, select_refine_candidates
from .gaussian import blur_separable
from .kp_types import Keypoints, concat_keypoints
from .refine import refine_keypoints


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 matrix products in full precision (``tf32=False``) or in
    TF32 (the control) inside the block; the previous setting after it."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        matmul.allow_tf32 = before


def pad_edges(images: torch.Tensor, multiples: tuple[int, int] | None) -> torch.Tensor:
    """``(B, H, W)`` frames edge-padded bottom and right to multiples of
    ``(h_multiple, w_multiple)`` (``core/image.py::pad_to_tpu_friendly``);
    ``None`` leaves them as they are."""
    if not multiples:
        return images
    h, w = images.shape[-2:]
    ph, pw = (-h) % multiples[0], (-w) % multiples[1]
    if not ph and not pw:
        return images
    return F.pad(images[:, None], (0, pw, 0, ph), mode="replicate")[:, 0].contiguous()


def upsample2x_nn(image: torch.Tensor) -> torch.Tensor:
    """2× nearest-neighbour upsample (reference/background.js:84)."""
    return image.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def downsample2x_nn(image: torch.Tensor) -> torch.Tensor:
    """2× decimation keeping even indices (reference/background.js:118)."""
    return image[..., ::2, ::2]


def difference_of_gaussians(scale_space: torch.Tensor) -> torch.Tensor:
    """``(..., S, H, W)`` → ``(..., S-1, H, W)``, ``L[s-1] − L[s]``."""
    return scale_space[..., :-1, :, :] - scale_space[..., 1:, :, :]


def octave(base, sigmas, spo: int, contrast_thr: float, upsample2x: bool):
    """One octave as the fused octave kernel computes it: ``(dog, seed,
    masks, stack)``; a ``None`` sigma is the unblurred base."""
    if upsample2x:
        base = upsample2x_nn(base)
    planes = [base if s is None else blur_separable(base, s) for s in sigmas]
    stack = torch.stack(planes, dim=1)
    del planes
    dog = difference_of_gaussians(stack)
    masks = pack_extrema_codes(dog, float(np.float32(contrast_thr)))
    return dog, stack[:, spo], masks, stack


def pyramid(images: torch.Tensor, cfg: SiftConfig, blur: str, emit_scales: bool):
    """``(dogs, masks, stacks)``: with ``blur="fused"`` octave by octave as
    the kernel computes them (masks, stacks only with ``emit_scales``),
    with any other blur the scale space blur by blur and the DoG, no masks
    (``models/frontend.py::_pyramid``)."""
    dogs, masks, stacks = [], [], []
    if blur == "fused":
        base = images.to(torch.float32).contiguous()
        for o in range(cfg.num_octaves):
            sigmas = [
                None if (o > 0 and s == 0) else cfg.offset_sigma(o, s)
                for s in range(cfg.scales_per_octave_total)
            ]
            dog, seed, mask, stack = octave(
                base, sigmas, cfg.scales_per_octave, cfg.contrast_prefilter_threshold, o == 0
            )
            dogs.append(dog)
            masks.append(mask)
            stacks.append(stack if emit_scales else None)
            base = downsample2x_nn(seed).contiguous()
        return dogs, masks, stacks if emit_scales else None
    base = upsample2x_nn(images).contiguous()
    for o in range(cfg.num_octaves):
        first, scales = 0, []
        if o > 0:
            base = downsample2x_nn(stacks[o - 1][:, cfg.scales_per_octave]).contiguous()
            scales.append(base)
            first = 1
        for s in range(first, cfg.scales_per_octave_total):
            scales.append(blur_separable(base, cfg.offset_sigma(o, s)))
        stacks.append(torch.stack(scales, dim=-3))
    return [difference_of_gaussians(s) for s in stacks], None, stacks


def select_and_refine(dogs, masks, cfg: SiftConfig) -> list[Keypoints]:
    """Per octave, the refinement candidates (the packed masks' selection,
    or each trio scanned and the trios compacted) refined octave by octave
    (``_select_candidates``, ``_refine_per_octave``)."""
    keypoints = []
    for o, dog in enumerate(dogs):
        capacity = cfg.refine_capacity(o)
        if masks is None:
            sel = compact_extrema(find_extrema(dog, cfg, cfg.keypoints_per_trio(o)), capacity)
        else:
            sel = select_refine_candidates(masks[o], dog, cfg, capacity)
        keypoints.append(refine_keypoints(dog, sel, o, cfg))
    return keypoints


def detect_batched(images: torch.Tensor, cfg: SiftConfig, blur: str = "fused") -> Keypoints:
    """Keypoints ``(B, N)`` of ``(B, H, W)`` float32 frames in [0, 1], all
    octaves' slots concatenated (the describe flags' per-octave refinement;
    ``cfg.unified_refine`` and ``cfg.refine_tail_pool`` are refused)."""
    _refuse_pools(cfg)
    dogs, masks, _ = pyramid(images, cfg, blur, emit_scales=False)
    return concat_keypoints(select_and_refine(dogs, masks, cfg))


def detect_and_describe_batched(
    images: torch.Tensor, cfg: SiftConfig, blur: str = "fused"
) -> DescribedKeypoints:
    """Oriented keypoints with 128-D descriptors, fields ``(B, N)``, of
    ``(B, H, W)`` float32 frames in [0, 1]: refined octave by octave, as
    the port's describe path does whatever ``cfg.unified_refine`` says, and
    described in one compacting pass."""
    if not cfg.compact_describe:
        raise ValueError("the reference describes compacted (compact_describe)")
    dogs, masks, stacks = pyramid(images, cfg, blur, emit_scales=True)
    keypoints = select_and_refine(dogs, masks, cfg)
    del dogs, masks
    return describe_compact(stacks, keypoints, cfg)


def _refuse_pools(cfg: SiftConfig) -> None:
    if cfg.unified_refine or cfg.refine_tail_pool:
        raise ValueError("the reference refines octave by octave: unified_refine and "
                         "refine_tail_pool are not copied")


ENTRIES = {
    "detect_batched": detect_batched,
    "detect_and_describe_batched": detect_and_describe_batched,
}
