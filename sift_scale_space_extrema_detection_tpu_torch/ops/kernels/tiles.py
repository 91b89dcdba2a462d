"""Host-side tile planner of the shared-memory blur kernels.

The fused octave kernel (``csrc/octave.cu``) and the stand-alone blur
(``csrc/blur.cu``) give each block one tile of a plane: the block loads
the tile's window (tile, ring and halo of the largest radius) into shared
memory and runs the row and column passes there. Where the radius is so
large that no such window fits, the passes run in their clamped mode: no
window, the row pass taps the plane in device memory over the plane's rows
only, and every tap clamps its index. :func:`tile_layout` sizes the
block's shared memory and :func:`plan_tiles` picks the tile and the mode
for a plane and its radii; the kernels' entry points take the plan's byte
count and refuse a launch whose own count (``csrc/blur_passes.cuh::
tile_layout``) differs. Pure Python: shapes and radii in, a
:class:`TilePlan` out.
"""

from __future__ import annotations

import dataclasses
import functools

SHARED_BYTES = 232_448  # what one block may take on an H100 (227 KB)
OUT = 4  # consecutive outputs of a thread along a pass (kOut)
BLOCKS_PER_SM = 2  # blocks that should share an SM's shared memory
TILE_HEIGHTS = (4, 8, 16, 32, 64, 128)
TILE_WIDTHS = (16, 32, 64, 128)  # a warp's stores cover at least 64 bytes of a row


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One block's tile, mode and shared memory, and the launch grid."""

    tile_h: int
    tile_w: int
    clamped: bool  # no window: taps read the plane and clamp their index
    window_h: int  # rows of the row buffer, and of the window where there is one
    window_w: int  # the window's row stride (odd); 0 when clamped
    shared_bytes: int
    grid: tuple[int, int]  # tiles across, tiles down


def tile_layout(
    tile_h: int,
    tile_w: int,
    ring: int,
    rmax: int,
    planes: int,
    n_taps: int,
    h: int,
    clamped: bool,
) -> tuple[int, int, int, int, int]:
    """``(extent_h, extent_w, window_h, window_w, shared_bytes)`` of a tile
    of a plane of ``h`` rows.

    The computed extent (tile plus ``ring`` each way) is rounded up to whole
    groups of :data:`OUT`; the window adds ``rmax`` each way; strides that a
    warp's lanes walk are made odd. A row buffer of the window's rows,
    ``planes`` extent-sized planes (the fused octave's ``L`` and ``D``) and
    the ``n_taps`` taps follow the window. When ``clamped`` there is no
    window (``window_w`` is 0) and the row buffer holds at most the plane's
    ``h`` rows.
    """
    extent_w = OUT * -(-(tile_w + 2 * ring) // OUT)
    extent_h = OUT * -(-(tile_h + 2 * ring) // OUT)
    window_h = extent_h + 2 * rmax
    window_w = (extent_w + 2 * rmax) | 1
    if clamped:
        window_h, window_w = min(window_h, h), 0
    row_stride = extent_w | 1
    floats = (
        window_h * window_w
        + window_h * row_stride
        + planes * extent_h * extent_w
        + n_taps
    )
    return extent_h, extent_w, window_h, window_w, 4 * floats


@functools.lru_cache(maxsize=256)
def plan_tiles(
    h: int,
    w: int,
    radii: tuple[int, ...],
    ring: int,
    planes: int,
    max_tile_pixels: int | None = None,
) -> TilePlan:
    """The tile and mode for blurring an ``h × w`` plane with each of ``radii``.

    Candidates are the tiles of :data:`TILE_HEIGHTS` × :data:`TILE_WIDTHS`
    (at most ``max_tile_pixels`` pixels) whose shared memory fits
    :data:`SHARED_BYTES`. The rule is on shape and radii only. The
    unclamped mode is taken if any tile fits it, else the clamped one. In
    the mode, first the tiles that let :data:`BLOCKS_PER_SM` blocks share an
    SM's shared memory (while one waits at a barrier the other computes), if
    there are any; among them the least work (products of the row and column
    passes over all tiles, halo included), then the widest tile. Raises
    ``ValueError`` when no tile fits either mode: the clamped mode's row
    buffer (the smallest tile's 21 or 17 columns by ``min(h, 2 * rmax + 8)``
    rows) and the taps must fit, which fails only for a radius above about
    1,000 on a plane of more than about 2,000 rows, far past any pyramid (the
    radius doubles where the plane halves). Cached per argument tuple (the 256 most recent).
    """
    if h < 1 or w < 1 or not radii or min(radii) < 0:
        raise ValueError(f"plan_tiles: plane {h}x{w} with radii {list(radii)}")
    rmax = max(radii)
    n_taps = sum(2 * r + 1 for r in radii)
    for clamped in (False, True):
        best = None
        for tile_h in TILE_HEIGHTS:
            for tile_w in TILE_WIDTHS:
                if max_tile_pixels is not None and tile_h * tile_w > max_tile_pixels:
                    continue
                extent_h, extent_w, window_h, window_w, shared = tile_layout(
                    tile_h, tile_w, ring, rmax, planes, n_taps, h, clamped
                )
                if shared > SHARED_BYTES:
                    continue
                grid = (-(-w // tile_w), -(-h // tile_h))
                # Rows of the row pass: the tile's reach at this radius, or
                # in the clamped mode every row of the row buffer.
                per_tile = sum(
                    (2 * r + 1)
                    * extent_w
                    * ((window_h if clamped else extent_h + 2 * r) + extent_h)
                    for r in radii
                )
                work = grid[0] * grid[1] * (per_tile + window_h * window_w)
                crowded = shared * BLOCKS_PER_SM > SHARED_BYTES
                key = (crowded, work, -tile_w)
                if best is None or key < best[0]:
                    plan = TilePlan(
                        tile_h, tile_w, clamped, window_h, window_w, shared, grid
                    )
                    best = (key, plan)
        if best is not None:
            return best[1]
    raise ValueError(
        f"plan_tiles: radius {rmax} on a {h}x{w} plane needs a row buffer that "
        f"no tile fits in {SHARED_BYTES} bytes of shared memory"
    )
