"""Candidate selection from the packed extrema plane, in one call.

:func:`select_candidates` is the wrapper of the hand-written CUDA kernels
(``csrc/select.cu``: count, scan and scatter in the stream). They replace
no TPU kernel: the JAX package selects with plain array code, as the
port's ``ops/extrema.py`` does in its tensor code, which stays the
kernels' plain version (``ops/extrema.py::select_refine_candidates_reference``).
``ops/extrema.py`` owns the route: it sends a CUDA packed plane with a
float32 DoG on the same device here, and selects every other input with
its tensor code. The wrapper takes CUDA tensors alone: it launches the
kernels or raises, and never falls back.

Contract (``select_refine_candidates_reference``, bit for bit):

- ``packed``: ``(B, H, W)`` int16 or int32, contiguous, H and W at least 2;
  trio ``t``'s 2-bit code in bits ``[2t, 2t+2)`` of each word, read
  unsigned (an int16 word holds 8 trios, an int32 word 16).
- ``dog``: ``(B, T + 2, H, W)`` float32, contiguous, on the plane's device.
- Slot ``j`` of an image holds its ``(j+1)``-th code-1 pixel in
  (trio-major, row-major) order; slots from ``min(total, capacity)`` on
  are parked at ``(scale 1, y 1, x 1)`` with the DoG's value there.
  ``num_candidates`` and ``num_low_contrast`` ``(B, T)`` are the uncapped
  counts of codes 1 and 2.

The kernels' parallelism is over tiles of the flattened ``H·W`` plane
(:func:`select_tile_plan`), so images of any size and batches of any
count fill the card alike.
"""

from __future__ import annotations

import dataclasses

import torch

from ...core.types import Extrema
from ._build import check_launch, load_kernels

MAX_BATCH = 65535  # CUDA's limit on the grid's y extent (the batch)
# A tile is 256 threads x 4 chunks of 16 bytes (kThreads, kChunks in
# csrc/select.cu): 8,192 int16 words or 4,096 int32 words.
TILE_BYTES = 256 * 4 * 16
_WORD_BYTES = {torch.int16: 2, torch.int32: 4}


@dataclasses.dataclass(frozen=True)
class SelectPlan:
    """The kernels' grid for one call: ``tile`` words of the flattened
    plane a block, ``n_tiles`` blocks an image, ``scratch`` int32 words of
    per-(trio, tile) counts and first slots, and ``dog_elements``, the
    DoG's element count, which 64-bit offsets cover past 2^31."""

    tile: int
    n_tiles: int
    scratch: int
    dog_elements: int


def select_tile_plan(batch: int, depth: int, h: int, w: int, word_bytes: int) -> SelectPlan:
    """The grid of :func:`select_candidates` for ``batch`` planes ``h × w``
    of ``word_bytes``-byte words and DoGs of ``depth`` planes: it follows
    from the shapes alone."""
    tile = TILE_BYTES // word_bytes
    n_tiles = -(-(h * w) // tile)
    n_trios = depth - 2
    return SelectPlan(tile, n_tiles, 3 * batch * n_trios * n_tiles, batch * depth * h * w)


def _check(packed: torch.Tensor, dog: torch.Tensor, capacity: int) -> None:
    """Raise on what the kernels do not take (devices, types, shapes,
    layout; the device's kind last, so each refusal shows on the CPU too)."""
    if dog.device != packed.device:
        raise ValueError(
            f"select_candidates: the DoG is on {dog.device}, the plane on {packed.device}"
        )
    if dog.dtype != torch.float32:
        raise TypeError(
            f"select_candidates: the kernels take a float32 DoG, got {dog.dtype}; "
            "ops/extrema.py selects other dtypes with its tensor code"
        )
    if packed.dtype not in _WORD_BYTES:
        raise TypeError(f"select_candidates: the plane must be int16 or int32, got {packed.dtype}")
    if packed.dim() != 3 or dog.dim() != 4:
        raise ValueError(
            f"select_candidates: plane (B, H, W) and DoG (B, D, H, W); got "
            f"{tuple(packed.shape)} and {tuple(dog.shape)}"
        )
    b, h, w = packed.shape
    if tuple(dog.shape[:1] + dog.shape[2:]) != (b, h, w):
        raise ValueError(
            f"select_candidates: DoG {tuple(dog.shape)} does not match plane {tuple(packed.shape)}"
        )
    if h < 2 or w < 2:
        raise ValueError(
            f"select_candidates: a {h}x{w} plane has no pixel (1, 1) to park invalid slots at"
        )
    n_trios = dog.shape[1] - 2
    most = 4 * _WORD_BYTES[packed.dtype]
    if not 1 <= n_trios <= most:
        raise ValueError(
            f"select_candidates: {n_trios} trios; an {packed.dtype} plane holds 1 to {most}"
        )
    if not packed.is_contiguous() or not dog.is_contiguous():
        raise ValueError("select_candidates: the plane and the DoG must be contiguous")
    if b > MAX_BATCH:
        raise ValueError(f"select_candidates: batch {b} exceeds {MAX_BATCH}")
    if n_trios * h * w >= 2**31:
        raise ValueError(
            f"select_candidates: {n_trios} trios of {h}x{w} pixels overflow the int32 counts"
        )
    if capacity < 0:
        raise ValueError(f"select_candidates: capacity {capacity} < 0")
    if packed.device.type != "cuda":
        raise ValueError(
            f"select_candidates: no kernel for device {packed.device}; "
            "ops/extrema.py selects tensors off a CUDA device with its tensor code"
        )


def select_candidates(packed: torch.Tensor, dog: torch.Tensor, capacity: int) -> Extrema:
    """The first ``capacity`` candidates of each image and its counters (see
    the module), through the hand-written kernels, counted by
    ``_build.check_launch`` as ``select_candidates`` (one a call: three
    kernels in the stream). Raises for what the kernels do not take."""
    _check(packed, dog, capacity)
    b, depth, h, w = dog.shape
    n_trios = depth - 2
    word_bytes = _WORD_BYTES[packed.dtype]
    plan = select_tile_plan(b, depth, h, w, word_bytes)
    dev = packed.device
    i32 = dict(dtype=torch.int32, device=dev)
    scratch = torch.empty(plan.scratch, **i32)
    ints = torch.empty((3, b, capacity), **i32)
    value = torch.empty((b, capacity), dtype=torch.float32, device=dev)
    valid = torch.empty((b, capacity), dtype=torch.bool, device=dev)
    counts = torch.empty((2, b, n_trios), **i32)
    y, x, scale_level = ints.unbind(0)
    num_candidates, num_low_contrast = counts.unbind(0)
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.sift_select_candidates(
            packed.data_ptr(), word_bytes, dog.data_ptr(), b, depth, h, w, capacity,
            plan.n_tiles, scratch.data_ptr(), y.data_ptr(), x.data_ptr(),
            scale_level.data_ptr(), value.data_ptr(), valid.data_ptr(),
            num_candidates.data_ptr(), num_low_contrast.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(lib, rc, "select_candidates")
    return Extrema(
        y=y, x=x, scale_level=scale_level, value=value, valid=valid,
        num_candidates=num_candidates, num_low_contrast=num_low_contrast,
    )
