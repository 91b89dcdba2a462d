"""The describe layer's two sampling stages, each one launch.

:func:`orient_slots` (R3) and :func:`describe_pairs` (R4) are the wrappers of
the hand-written CUDA kernels in ``csrc/histograms.cu``. They replace no TPU
kernel: the JAX package forms its histograms with array code around the
window-sampling kernel, as the port's tensor code in ``ops/descriptor.py``
does around K2 (``describe.py::window_sample_pair``); that tensor code stays
as their plain version. ``ops/descriptor.py`` owns the route: it sends a
stage here when its stacks and fields are float32 on a CUDA device and the
caller passed no sampler of its own. The wrappers take CUDA tensors alone:
they launch the kernel or raise, and never fall back.

Contract (``ops/descriptor.py``'s tensor code, up to the order of the
histograms' sums):

- ``stacks``, ``slots``: as :func:`.describe.window_sample_pair` takes them:
  one ``[batch, octave, scale_level, valid]`` row a slot, ``(M, 4)`` int32.
- ``y_loc``, ``x_loc``, ``sigma_loc`` (and R4's ``theta``): ``(M,)`` float32,
  each slot's octave-local position, scale (and orientation).
- R3 returns ``(theta, valid)`` of ``(M, max_orientations_per_keypoint)``:
  ``_extract_peaks(_smooth_circular(_orientation_post(...)))`` of the
  samples at ``_orientation_coords``; ``theta`` is 0 where ``valid`` is
  false. ``grid``: ``_orientation_grid``'s ``(uy, ux)``.
- R4 returns ``(M, nh·nh·n_ori)`` descriptors: ``_descriptor_post`` of the
  samples at ``_descriptor_coords``. ``grid``: ``(yhat, xhat, window)`` of
  ``_descriptor_constants``; ``cells``: ``_descriptor_cells``' lists.
- A slot with ``valid == 0``, or whose octave is not in ``stacks``, reads
  nothing: θ 0 and ``valid`` false, or a zero descriptor.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...config import SiftConfig
from ._build import check_launch, load_kernels
from .describe import check_tensors, octave_table, require_cuda

MAX_SAMPLES = 1024  # kMaxSamples in csrc/histograms.cu: a 32 x 32 grid
MAX_ORIENTATION_BINS = 64  # kMaxOriBins
MAX_DESCRIPTOR_BINS = 256  # kMaxDescBins
TWO_PI = 2.0 * math.pi


def _check_slots(what, stacks, slots, fields, constants) -> torch.device:
    """Raise on the types, devices, layouts and shapes a stage's kernel does
    not take; the slots' device."""
    dev = slots.device
    m = slots.shape[0] if slots.dim() == 2 else -1
    check_tensors(what, stacks, (("slots", slots, torch.int32), *fields, *constants), dev)
    if slots.dim() != 2 or slots.shape[1] != 4:
        raise ValueError(f"{what}: slots must be (M, 4), got {tuple(slots.shape)}")
    for name, t, _ in fields:
        if tuple(t.shape) != (m,):
            raise ValueError(f"{what}: {name} must be ({m},), got {tuple(t.shape)}")
    return dev


def _check_grid(what, grid) -> int:
    """The grid's sample count, one for every array of ``grid``."""
    n = grid[0].numel()
    if not 1 <= n <= MAX_SAMPLES or any(tuple(g.shape) != (n,) for g in grid):
        raise ValueError(
            f"{what}: the grid must be (N,) arrays of one N in 1..{MAX_SAMPLES}, got "
            f"{[tuple(g.shape) for g in grid]}"
        )
    return n


def orient_slots(
    stacks: list[torch.Tensor],
    slots: torch.Tensor,
    y_loc: torch.Tensor,
    x_loc: torch.Tensor,
    sigma_loc: torch.Tensor,
    grid: tuple[torch.Tensor, torch.Tensor],
    cfg: SiftConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(theta, valid)`` of every keypoint slot (see the module), through
    the hand-written kernel, each launch counted by ``_build.check_launch``
    as ``orient_slots``."""
    what = "orient_slots"
    f32 = torch.float32
    dev = _check_slots(
        what, stacks, slots,
        (("y_loc", y_loc, f32), ("x_loc", x_loc, f32), ("sigma_loc", sigma_loc, f32)),
        (("uy", grid[0], f32), ("ux", grid[1], f32)),
    )
    n = _check_grid(what, grid)
    nbins, k = cfg.n_orientation_bins, cfg.max_orientations_per_keypoint
    if not 3 <= nbins <= MAX_ORIENTATION_BINS or not 1 <= k <= nbins:
        raise ValueError(
            f"{what}: 3 to {MAX_ORIENTATION_BINS} bins and 1 to that many orientations, "
            f"got {nbins} and {k}"
        )
    require_cuda(what, dev, slots)
    m = slots.shape[0]
    theta = torch.empty((m, k), dtype=f32, device=dev)
    valid = torch.empty((m, k), dtype=torch.bool, device=dev)
    # float32 roundings of the Python numbers the tensor code multiplies by.
    scalars = (ctypes.c_float * 4)(
        3.0 * cfg.lambda_ori, cfg.lambda_ori, cfg.orientation_peak_ratio, TWO_PI
    )
    batch, n_scales = stacks[0].shape[:2]
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.sift_orient_slots(
            *octave_table(stacks), len(stacks), batch, n_scales, slots.data_ptr(),
            y_loc.data_ptr(), x_loc.data_ptr(), sigma_loc.data_ptr(),
            grid[0].data_ptr(), grid[1].data_ptr(), n, nbins, k,
            cfg.orientation_smooth_iterations, scalars, theta.data_ptr(), valid.data_ptr(),
            m, torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(lib, rc, what)
    return theta, valid


def describe_pairs(
    stacks: list[torch.Tensor],
    slots: torch.Tensor,
    y_loc: torch.Tensor,
    x_loc: torch.Tensor,
    sigma_loc: torch.Tensor,
    theta: torch.Tensor,
    grid: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    cells: tuple[torch.Tensor, torch.Tensor],
    cfg: SiftConfig,
) -> torch.Tensor:
    """``(M, nh·nh·n_ori)`` descriptors of every pair slot (see the module),
    through the hand-written kernel, each launch counted by
    ``_build.check_launch`` as ``describe_pairs``."""
    what = "describe_pairs"
    f32 = torch.float32
    index, weight = cells
    dev = _check_slots(
        what, stacks, slots,
        (("y_loc", y_loc, f32), ("x_loc", x_loc, f32), ("sigma_loc", sigma_loc, f32),
         ("theta", theta, f32)),
        (("yhat", grid[0], f32), ("xhat", grid[1], f32), ("window", grid[2], f32),
         ("cell_index", index, torch.int32), ("cell_weight", weight, f32)),
    )
    n = _check_grid(what, grid)
    n_ori, n_cells = cfg.descriptor_n_ori, cfg.descriptor_n_hist ** 2
    if n_ori < 2 or n_cells * n_ori > MAX_DESCRIPTOR_BINS:
        raise ValueError(
            f"{what}: at least 2 orientation bins and at most {MAX_DESCRIPTOR_BINS} bins "
            f"in all, got {n_cells} cells x {n_ori}"
        )
    if index.dim() != 2 or index.shape[0] != n_cells or index.shape[1] < 1 or (
            weight.shape != index.shape):
        raise ValueError(
            f"{what}: the cell lists must be ({n_cells}, L), got "
            f"{tuple(index.shape)} and {tuple(weight.shape)}"
        )
    require_cuda(what, dev, slots)
    m = slots.shape[0]
    desc = torch.empty((m, n_cells * n_ori), dtype=f32, device=dev)
    scalars = (ctypes.c_float * 2)(cfg.descriptor_clip, TWO_PI)
    batch, n_scales = stacks[0].shape[:2]
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.sift_describe_pairs(
            *octave_table(stacks), len(stacks), batch, n_scales, slots.data_ptr(),
            y_loc.data_ptr(), x_loc.data_ptr(), sigma_loc.data_ptr(), theta.data_ptr(),
            grid[0].data_ptr(), grid[1].data_ptr(), grid[2].data_ptr(),
            index.data_ptr(), weight.data_ptr(), n, n_ori, n_cells, index.shape[1],
            scalars, desc.data_ptr(), m, torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(lib, rc, what)
    return desc
