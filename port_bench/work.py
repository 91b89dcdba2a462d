"""The least work of the frontend's layers, counted from shapes and slots,
and the card's published peaks: the numerators of the roofline shares.

``bound``, ``blur_flop``, ``scan_ops``, ``octave_sigmas``, ``octave_cost``
and ``k1_work`` are frozen copies of the port's
``benchmarks/frontend_bench.py``; :func:`window_bytes` is a frozen copy of
``chip_smoke.py::_window_bytes``. What the benchmark adds: the Gaussian
stacks that the describe path keeps (written once), the pyramid of a
path that blurs scale by scale (no masks, no scan), and the describe
stages' slots rebuilt from the describe layer's input and output, so that
the count does not depend on which kernel implements a layer.
"""

from __future__ import annotations

import torch

from .reference.config import SiftConfig
from .reference.descriptor import _descriptor_coords, _orientation_coords
from .reference.extrema import first_k_set_indices
from .reference.gaussian import kernel_radius

# The card's published peaks (NVIDIA H100 SXM data sheet, dense rates):
# memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12


def bound(n_bytes: float, flop: float) -> tuple[float, str]:
    """``(bound_ms, bound_by)`` of work that moves ``n_bytes`` and does
    ``flop`` float32 operations, at the published peaks."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
    by_flop = 1e3 * flop / PEAK_FLOP_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_flop else (by_flop, "operations")


def blur_flop(pixels: int, radius: int) -> int:
    """Two passes of ``2r+1`` products and ``2r`` sums per pixel."""
    return 2 * (2 * (2 * radius + 1) - 1) * pixels


def scan_ops(pixels: int, n_dog: int) -> int:
    """The 26-neighbour scan in operations: per DoG plane and pixel 14
    minima and maxima, per trio plane 4 more and 3 comparisons."""
    return pixels * (14 * n_dog + 7 * max(n_dog - 2, 0))


def octave_sigmas(cfg: SiftConfig, octave: int) -> list:
    """The sigmas one octave blurs, ``None`` for the unblurred seed scale of
    an octave past the first."""
    return [
        None if (octave > 0 and s == 0) else cfg.offset_sigma(octave, s)
        for s in range(cfg.scales_per_octave_total)
    ]


def octave_cost(base_numel: int, sigmas, upsample2x: bool) -> tuple[int, int, int]:
    """``(bytes, operations, scan operations)`` of one octave on a base of
    ``base_numel`` pixels: read the base; write the DoG planes, the seed and
    the 2-byte masks of its plane (twice the base's sides with
    ``upsample2x``); the blurs and DoG differences; the scan."""
    pixels = base_numel * (4 if upsample2x else 1)
    n_scales = len(sigmas)
    radii = [0 if sg is None else kernel_radius(sg) for sg in sigmas]
    n_bytes = 4 * base_numel + pixels * (4 * (n_scales - 1) + 4 + 2)
    flop = sum(blur_flop(pixels, r) for r in radii) + pixels * (n_scales - 1)
    return n_bytes, flop, scan_ops(pixels, n_scales - 1)


def k1_work(cfg: SiftConfig, batch: int, height: int, width: int) -> list[tuple[int, int, int]]:
    """:func:`octave_cost` of each octave on ``batch`` frames of ``height`` ×
    ``width`` (octave 0 upsampled 2×, each later base the previous seed
    decimated 2×)."""
    work, h, w = [], height, width
    for octave in range(cfg.num_octaves):
        work.append(octave_cost(batch * h * w, octave_sigmas(cfg, octave), octave == 0))
        if octave == 0:
            h, w = 2 * h, 2 * w
        h, w = -(-h // 2), -(-w // 2)
    return work


def octave_planes(cfg: SiftConfig, height: int, width: int) -> list[tuple[int, int]]:
    """Each octave's plane ``(h, w)``: twice the frame's sides, then halved
    (rounding up) octave by octave."""
    h, w, planes = 2 * height, 2 * width, []
    for _ in range(cfg.num_octaves):
        planes.append((h, w))
        h, w = -(-h // 2), -(-w // 2)
    return planes


def pyramid_least_s(cfg: SiftConfig, batch: int, height: int, width: int, blur: str,
                    emit_scales: bool) -> float:
    """Least seconds of the pyramid layer's work at the published peaks,
    octave by octave the larger of bytes and operations. ``blur="fused"``:
    :func:`k1_work` with its scan, plus the Gaussian stacks written once
    where the describe path keeps them (their seed plane is K1's own). Any other blur builds the scale
    space and the DoG only: the frame read once, every scale and DoG plane
    written once, the blurs and differences."""
    total = 0.0
    planes = octave_planes(cfg, height, width)
    if blur == "fused":
        for (n_bytes, flop, scan), (h, w) in zip(k1_work(cfg, batch, height, width), planes):
            if emit_scales:  # the stack holds the seed, which k1_work counts already
                n_bytes += 4 * (cfg.scales_per_octave_total - 1) * batch * h * w
            total += bound(n_bytes, flop + scan)[0]
        return total / 1e3
    for octave, (h, w) in enumerate(planes):
        pixels = batch * h * w
        sigmas = octave_sigmas(cfg, octave)
        n_scales = len(sigmas)
        n_bytes = (4 * batch * height * width if octave == 0 else 0) + pixels * 4 * (2 * n_scales - 1)
        flop = sum(blur_flop(pixels, kernel_radius(s)) for s in sigmas if s is not None)
        total += bound(n_bytes, flop + pixels * (n_scales - 1))[0]
    return total / 1e3


def window_bytes(planes, table, ys, xs) -> float:
    """Bytes the window sampling must move for these slots: the slot table,
    the samples written for every slot, and for each valid slot its
    coordinates and the window of its plane that its samples' corners and
    their central differences touch, once. ``planes``: each octave's
    ``(h, w)``; ``table``: ``(M, 4)`` ``[batch, octave, level, valid]``."""
    m, n = ys.shape
    octave = table[:, 1].long().clamp(0, len(planes) - 1)  # an empty slot's octave may be any
    valid = table[:, 3] != 0
    hs = torch.tensor([p[0] for p in planes], device=ys.device)[octave]
    ws = torch.tensor([p[1] for p in planes], device=ys.device)[octave]

    def extent(coords, size):
        corner = coords.clamp(min=0).minimum((size - 1)[:, None]).floor().long()
        lo = (corner.amin(dim=1) - 1).clamp(min=0)
        hi = (corner.amax(dim=1) + 2).minimum(size - 1)
        return hi - lo + 1

    window = (extent(ys, hs) * extent(xs, ws))[valid].sum().item()
    return 16 * m + 8 * m * n + int(valid.sum()) * 8 * n + 4 * window


def _table(octave, valid):
    zeros = torch.zeros_like(octave)
    return torch.stack([zeros, octave, zeros, valid.to(octave.dtype)], dim=-1).reshape(-1, 4)


def describe_least_s(cfg: SiftConfig, planes, keypoints, described) -> float:
    """Least seconds of the describe layer's window sampling at 3.35 TB/s,
    from its input, one keypoint buffer per octave (fields ``(B, n_o)``),
    and its output (fields ``(B, pairs)``): the orientation stage samples the
    first ``describe_capacity()`` valid keypoints of each frame on the
    orientation grid, the descriptor stage every slot of the output on the
    rotated descriptor grid."""
    def cat(field):
        return torch.cat([getattr(k, field) for k in keypoints], dim=-1)

    all_valid = cat("valid")
    idx, ok, _ = first_k_set_indices(all_valid, cfg.describe_capacity())
    octave = cat("octave").gather(-1, idx)
    valid = ok & all_valid.gather(-1, idx)
    n_bytes = 0.0
    stages = [(octave, valid, cat("abs_y").gather(-1, idx), cat("abs_x").gather(-1, idx),
               cat("abs_sigma").gather(-1, idx), None)]
    if not cfg.upright:
        stages.append((described.octave, described.valid, described.abs_y, described.abs_x,
                       described.abs_sigma, described.theta))
    else:
        stages = [stages[0][:5] + (torch.zeros_like(stages[0][2]),)]
    for octave, valid, abs_y, abs_x, abs_sigma, theta in stages:
        delta = torch.exp2((octave - 1).to(torch.float32))
        y, x, s = (abs_y / delta).reshape(-1), (abs_x / delta).reshape(-1), (abs_sigma / delta).reshape(-1)
        if theta is None:
            ys, xs, _ = _orientation_coords(y, x, s, cfg)
        else:
            ys, xs = _descriptor_coords(y, x, s, theta.reshape(-1), cfg)
        n_bytes += window_bytes(planes, _table(octave.to(torch.int32), valid), ys, xs)
    return n_bytes / PEAK_BYTES_PER_S
