"""Bilinear samples of the scale-space gradient for the describe stages.

:func:`window_sample_pair` is the wrapper of the hand-written CUDA kernel
(``csrc/describe.cu``) that replaces the JAX package's Pallas TPU kernel
``ops/pallas/describe.py::window_sample_pair``.
:func:`window_sample_pair_reference` is its plain PyTorch version with the
same contract; the wrapper runs it only for tensors on the CPU. On CUDA
tensors the wrapper launches the kernel or raises; it never falls back.

Contract (what is computed; the TPU kernel's aligned windows, padded slabs,
padded slot count and tent-weight matrix products answer that chip's DMA and
matrix unit and are no part of it):

- ``stacks[o]``: octave ``o``'s Gaussian stack ``(B, S, H_o, W_o)`` float32,
  contiguous, as the pyramid made it.
- ``slots``: ``(M, 4)`` int32, one row ``[batch, octave, scale_level,
  valid]`` per slot: a keypoint in the orientation stage, a (keypoint,
  orientation) pair in the descriptor stage.
- ``ys``, ``xs``: ``(M, N)`` float32 sample coordinates on plane
  ``scale_level`` of ``stacks[octave]``.
- Returns ``gy``, ``gx`` ``(M, N)`` float32: the central-difference
  gradients of that plane (``ops/sampling.py::scale_space_gradients``,
  border rows and columns exactly zero) sampled bilinearly at
  ``(ys, xs)`` (``ops/sampling.py::bilinear_sample``, coordinates clamped
  to the plane). A slot with ``valid == 0``, or whose octave is not in
  ``stacks``, reads nothing and gives zeros. ``batch`` and ``scale_level``
  are clamped to the stack: keypoints only hold levels ``1..spo``, and
  nothing is checked on the device before the launch.
"""

from __future__ import annotations

import ctypes

import torch

from ..sampling import bilinear_sample, scale_space_gradients
from ._build import check_launch, load_kernels

MAX_OCTAVES = 8  # the kernel's octave table (kMaxOctaves in csrc/describe.cu)


def _check(stacks, slots, ys, xs) -> None:
    """Raise on what the kernel does not take (device, type, shape, layout)."""
    if not 1 <= len(stacks) <= MAX_OCTAVES:
        raise ValueError(
            f"window_sample_pair: 1 to {MAX_OCTAVES} octave stacks, got {len(stacks)}"
        )
    lead = stacks[0].shape[:2]
    for name, t, dtype in (
        *((f"stacks[{o}]", s, torch.float32) for o, s in enumerate(stacks)),
        ("slots", slots, torch.int32),
        ("ys", ys, torch.float32),
        ("xs", xs, torch.float32),
    ):
        if t.dtype != dtype:
            raise TypeError(f"window_sample_pair: {name} must be {dtype}, got {t.dtype}")
        if t.device != ys.device:
            raise ValueError(
                f"window_sample_pair: {name} is on {t.device}, ys on {ys.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"window_sample_pair: {name} must be contiguous")
    for o, s in enumerate(stacks):
        if s.dim() != 4 or min(s.shape) < 1 or s.shape[:2] != lead:
            raise ValueError(
                f"window_sample_pair: stacks[{o}] must be a non-empty (B, S, H, W) "
                f"with (B, S) = {tuple(lead)}, got {tuple(s.shape)}"
            )
    if ys.dim() != 2 or ys.shape[1] < 1 or xs.shape != ys.shape:
        raise ValueError(
            f"window_sample_pair: ys and xs must be one (M, N) shape, got "
            f"{tuple(ys.shape)} and {tuple(xs.shape)}"
        )
    if tuple(slots.shape) != (ys.shape[0], 4):
        raise ValueError(
            f"window_sample_pair: slots must be ({ys.shape[0]}, 4), got {tuple(slots.shape)}"
        )


def window_sample_pair_reference(
    stacks: list[torch.Tensor],
    slots: torch.Tensor,
    ys: torch.Tensor,
    xs: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`window_sample_pair`, on any device.

    Forms the gradients of every whole stack and samples each octave's for
    all slots, keeping the slot's own: simple, with no host sync, and
    several times the kernel's memory.
    """
    _check(stacks, slots, ys, xs)
    batch, n_scales = stacks[0].shape[:2]
    b, octave, scale, valid = slots.unbind(dim=1)
    plane = (b.clamp(0, batch - 1) * n_scales + scale.clamp(0, n_scales - 1))[:, None]
    gy_out = torch.zeros_like(ys)
    gx_out = torch.zeros_like(xs)
    for o, stack in enumerate(stacks):
        own = ((octave == o) & (valid != 0))[:, None]
        gy, gx = scale_space_gradients(stack)
        h, w = stack.shape[-2:]
        gy_out = torch.where(
            own, bilinear_sample(gy.reshape(-1, h, w), ys, xs, plane), gy_out
        )
        gx_out = torch.where(
            own, bilinear_sample(gx.reshape(-1, h, w), ys, xs, plane), gx_out
        )
    return gy_out, gx_out


def window_sample_pair(
    stacks: list[torch.Tensor],
    slots: torch.Tensor,
    ys: torch.Tensor,
    xs: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradient samples ``(gy, gx)`` of every slot (see the module).

    CUDA tensors go through the hand-written kernel, counted in
    ``window_sample_pair.launches``; CPU tensors through
    :func:`window_sample_pair_reference`. Any other device raises.
    """
    _check(stacks, slots, ys, xs)
    dev = ys.device
    if dev.type == "cpu":
        return window_sample_pair_reference(stacks, slots, ys, xs)
    if dev.type != "cuda":
        raise ValueError(
            f"window_sample_pair: no kernel for device {dev}; "
            "pass CUDA tensors, or CPU tensors for the plain version"
        )
    if slots.data_ptr() % 16:
        raise ValueError("window_sample_pair: slots must be 16-byte aligned")
    n_oct = len(stacks)
    batch, n_scales = stacks[0].shape[:2]
    m, n = ys.shape
    gy = torch.empty_like(ys)
    gx = torch.empty_like(xs)
    # The octave table goes to the kernel by value: host arrays, no copy.
    pointers = (ctypes.c_void_p * n_oct)(*(s.data_ptr() for s in stacks))
    heights = (ctypes.c_int * n_oct)(*(s.shape[2] for s in stacks))
    widths = (ctypes.c_int * n_oct)(*(s.shape[3] for s in stacks))
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.sift_window_sample_pair(
            pointers, heights, widths, n_oct, batch, n_scales,
            slots.data_ptr(), ys.data_ptr(), xs.data_ptr(),
            gy.data_ptr(), gx.data_ptr(), m, n,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(lib, rc, "window_sample_pair")
    window_sample_pair.launches += 1
    return gy, gx


window_sample_pair.launches = 0
