"""The tiled design of the fused octave kernel, proved on the CPU.

The CUDA kernel (``ops/kernels/csrc/octave.cu``) cannot run here. What can
be held here is (a) the host-side tile planner that sizes its blocks and
(b) the halo and clamp algebra of the design: a tile-by-tile emulation in
PyTorch — window filled by clamped plane coordinates, taps indexed
unclamped, per-tile row and column pass, DoG and codes on the tile plus
ring — must equal ``fused_octave_reference`` bit for bit, seams included.
"""

import numpy as np
import pytest
import torch

import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.ops.gaussian import (
    kernel_radius,
    taps_f32,
)
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.blur import blur_tile_plan
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import (
    MAX_TILE_PIXELS,
    fused_octave_reference,
    octave_tile_plan,
)
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.tiles import (
    SHARED_BYTES,
    TILE_HEIGHTS,
    TILE_WIDTHS,
    tile_layout,
)
from tests.test_torch_cuda import BLUR_CASES, CASES

torch.set_num_threads(2)


def _sigmas(cfg, octave):
    return [
        None if (octave > 0 and s == 0) else cfg.offset_sigma(octave, s)
        for s in range(cfg.scales_per_octave_total)
    ]


def _radii(cfg, octave):
    return tuple(0 if s is None else kernel_radius(s) for s in _sigmas(cfg, octave))


# The main path: 480x640 frames, 4 octaves x 5 scales; octave 0 is upsampled.
MAIN_PATH = [((960, 1280), 0), ((480, 640), 1), ((240, 320), 2), ((120, 160), 3)]
# Deep pyramids of 480x640 frames: the last octave of the default
# configuration (radius 116 on 60x80) and of 6 octaves x 5 scales (188 on
# 30x40), and octave 4 of the default configuration on 2160x3840 and
# 4320x7680 frames. No unclamped window fits there.
DEEP = [((60, 80), 4, 3), ((30, 40), 5, 5), ((270, 480), 4, 3), ((540, 960), 4, 3)]
CARD_CASES = [
    ((2 * s[1], 2 * s[2]) if up2 else tuple(s[1:]), octave, spo)
    for s, up2, octave, spo in CASES
]


@pytest.mark.parametrize(
    "plane, octave, spo", [(p, o, 5) for p, o in MAIN_PATH] + CARD_CASES
)
def test_octave_plan_fits_a_block(plane, octave, spo):
    radii = _radii(port.SiftConfig(scales_per_octave=spo), octave)
    plan = octave_tile_plan(*plane, radii)
    assert plan.shared_bytes <= SHARED_BYTES == 232_448
    assert plan.tile_h % 4 == 0 and plan.tile_h * plan.tile_w <= MAX_TILE_PIXELS
    assert plan.grid[0] >= 1 and plan.grid[1] >= 1
    # The tiles cover the plane, and none lies wholly outside it.
    assert (plan.grid[0] - 1) * plan.tile_w < plane[1] <= plan.grid[0] * plan.tile_w
    assert (plan.grid[1] - 1) * plan.tile_h < plane[0] <= plan.grid[1] * plan.tile_h
    n_taps = sum(2 * r + 1 for r in radii)
    layout = lambda th, tw, clamped: tile_layout(
        th, tw, 1, max(radii), 2, n_taps, plane[0], clamped
    )
    assert plan.shared_bytes == layout(plan.tile_h, plan.tile_w, plan.clamped)[4]
    if plan.clamped:
        # No window, a row buffer of the plane's rows at most, and no
        # unclamped window fits.
        assert plan.window_h <= plane[0] and plan.window_w == 0
        assert all(
            layout(th, tw, False)[4] > SHARED_BYTES
            for th in TILE_HEIGHTS for tw in TILE_WIDTHS if th * tw <= MAX_TILE_PIXELS
        )
    else:
        # The window holds the tile, the ring and the largest radius each way.
        assert plan.window_h >= plan.tile_h + 2 + 2 * max(radii)
        assert plan.window_w >= plan.tile_w + 2 + 2 * max(radii)
        assert plan.window_w % 2 == 1


@pytest.mark.parametrize("plane, octave, spo", DEEP)
def test_octave_plan_of_a_deep_pyramid_is_clamped(plane, octave, spo):
    radii = _radii(port.SiftConfig(num_octaves=octave + 1, scales_per_octave=spo), octave)
    plan = octave_tile_plan(*plane, radii)
    # The row buffer holds rows of the plane only, and there is no window.
    assert max(radii) == {4: 116, 5: 188}[octave]
    assert plan.clamped and plan.shared_bytes <= SHARED_BYTES
    assert plan.window_h <= plane[0] and plan.window_w == 0
    assert plan.grid == (-(-plane[1] // plan.tile_w), -(-plane[0] // plan.tile_h))
    blur = blur_tile_plan(*plane, max(radii))
    assert blur.clamped and blur.shared_bytes <= SHARED_BYTES


@pytest.mark.parametrize("frame", [(480, 640), (1080, 1920), (2160, 3840), (4320, 7680)], ids=str)
@pytest.mark.parametrize("octaves, spo", [(5, 3), (8, 5)])
def test_every_octave_of_a_frame_has_a_plan(frame, octaves, spo):
    # Any frame size at any depth: the radius doubles where the plane halves,
    # and the clamped mode needs only the plane's rows in its row buffer.
    cfg = port.SiftConfig(num_octaves=octaves, scales_per_octave=spo)
    modes = []
    for octave in range(octaves):
        plane = (2 * frame[0]) >> octave, (2 * frame[1]) >> octave
        radii = _radii(cfg, octave)
        for plan in (octave_tile_plan(*plane, radii), blur_tile_plan(*plane, max(radii))):
            assert plan.shared_bytes <= SHARED_BYTES
            assert plan.clamped == (max(radii) > 110)
        modes.append(plan.clamped)
    assert modes[0] is False and modes[-1] is True and modes == sorted(modes)


@pytest.mark.parametrize("shape, sigma", BLUR_CASES + [((64, 960, 1280), 1.23)])
def test_blur_plan_fits_a_block(shape, sigma):
    radius = kernel_radius(sigma)
    plan = blur_tile_plan(shape[-2], shape[-1], radius)
    assert plan.shared_bytes <= SHARED_BYTES
    assert plan.tile_h % 4 == 0 and plan.tile_w % 4 == 0
    assert plan.grid[0] * plan.tile_w >= shape[-1] and plan.grid[1] * plan.tile_h >= shape[-2]
    if plan.clamped:
        assert plan.window_h <= shape[-2] and plan.window_w == 0
    else:
        assert plan.window_h == plan.tile_h + 2 * radius
        assert plan.window_w >= plan.tile_w + 2 * radius


def test_plans_are_a_rule_on_shape_and_radii():
    # The main path's radii leave room for two blocks on an SM, and the
    # planner takes such a tile; a radius of 100 leaves room for one.
    for plane, octave in MAIN_PATH:
        plan = octave_tile_plan(*plane, _radii(port.SiftConfig(scales_per_octave=5), octave))
        assert 2 * plan.shared_bytes <= SHARED_BYTES
    large = octave_tile_plan(240, 320, (0, 30, 100))
    assert not large.clamped
    assert large.shared_bytes <= SHARED_BYTES < 2 * large.shared_bytes
    # The same plane and radii give the same plan, whatever ran before.
    assert large == octave_tile_plan(240, 320, (0, 30, 100))
    assert large != octave_tile_plan(240, 320, (0, 3, 10))
    # The unclamped mode is taken wherever a tile fits it.
    assert octave_tile_plan(60, 80, (0, 30, 100)).clamped is False
    assert octave_tile_plan(60, 80, (0, 30, 120)).clamped is True


def test_a_radius_no_tile_fits_raises():
    # The clamped mode's row buffer takes a radius of 130 on any plane...
    assert octave_tile_plan(480, 640, (0, 40, 130)).clamped
    assert blur_tile_plan(4320, 7680, 130).clamped
    # ... and gives out far past any pyramid's radii.
    with pytest.raises(ValueError, match="no tile fits"):
        octave_tile_plan(4000, 4000, (0, 400, 1300))
    with pytest.raises(ValueError, match="no tile fits"):
        blur_tile_plan(4000, 4000, 2000)
    with pytest.raises(ValueError):
        octave_tile_plan(0, 640, (2,))


def _codes(lo, mid, hi, thr):
    """2-bit codes of one trio on the interior of ``(B, h+2, w+2)`` planes:
    the strict 26-neighbour test written out neighbour by neighbour."""
    h, w = mid.shape[1] - 2, mid.shape[2] - 2
    shifted = lambda p: [
        p[:, dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)
    ]
    ring = shifted(mid)
    centre = ring.pop(4)
    others = torch.stack(shifted(lo) + shifted(hi) + ring)
    is_ext = (centre > others.amax(0)) | (centre < others.amin(0))
    code = torch.where(centre.abs() >= thr, 1, 2)
    return torch.where(is_ext, code, 0).to(torch.int32)


def emulate_tiled_octave(base, sigmas, spo, contrast_thr, upsample2x, tile_h, tile_w):
    """``fused_octave`` as the tiled kernel computes it, tile by tile."""
    shift = int(upsample2x)
    b, h, w = base.shape[0], base.shape[1] << shift, base.shape[2] << shift
    taps = [(1.0,) if s is None else taps_f32(s) for s in sigmas]
    radii = [(len(t) - 1) // 2 for t in taps]
    rmax, n = max(radii), len(sigmas)
    thr = float(np.float32(contrast_thr))
    dog = torch.full((b, n - 1, h, w), torch.nan)
    stack = torch.full((b, n, h, w), torch.nan)
    seed = torch.full((b, h, w), torch.nan)
    masks = torch.zeros((b, h, w), dtype=torch.int32)
    eh, ew = tile_h + 2, tile_w + 2  # the tile plus its ring
    for y0 in range(0, h, tile_h):
        for x0 in range(0, w, tile_w):
            y1, x1 = min(y0 + tile_h, h), min(x0 + tile_w, w)
            crop = (slice(None), slice(1, 1 + y1 - y0), slice(1, 1 + x1 - x0))
            # 1. The window, filled once by clamped plane coordinates.
            ys = torch.arange(y0 - 1 - rmax, y0 - 1 - rmax + eh + 2 * rmax)
            xs = torch.arange(x0 - 1 - rmax, x0 - 1 - rmax + ew + 2 * rmax)
            win = base[:, ys.clamp(0, h - 1) >> shift][:, :, xs.clamp(0, w - 1) >> shift]
            planes, prev = [], None
            for s, (t, r) in enumerate(zip(taps, radii)):
                # 2. Row pass over rows [-r-1, tile_h+r+1), columns [-1, tile_w+1),
                # then column pass, taps indexing the window unclamped.
                o = rmax - r
                rows = win[:, o : o + eh + 2 * r]
                acc = rows[:, :, o : o + ew] * t[0]
                for k in range(1, len(t)):
                    acc = acc + rows[:, :, o + k : o + k + ew] * t[k]
                cur = acc[:, 0:eh] * t[0]
                for k in range(1, len(t)):
                    cur = cur + acc[:, k : k + eh] * t[k]
                stack[:, s, y0:y1, x0:x1] = cur[crop]
                if s == spo:
                    seed[:, y0:y1, x0:x1] = cur[crop]
                # 3. DoG on the tile plus ring; its interior is written.
                if s > 0:
                    planes.append(prev - cur)
                    dog[:, s - 1, y0:y1, x0:x1] = planes[-1][crop]
                prev = cur
            packed = torch.zeros((b, tile_h, tile_w), dtype=torch.int32)
            for trio in range(n - 3):
                packed |= _codes(*planes[trio : trio + 3], thr) << (2 * trio)
            # Only 1 <= y <= h-2, 1 <= x <= w-2 is set.
            yy = torch.arange(y0, y0 + tile_h)[:, None]
            xx = torch.arange(x0, x0 + tile_w)[None, :]
            inner = (yy >= 1) & (yy <= h - 2) & (xx >= 1) & (xx <= w - 2)
            packed = torch.where(inner, packed, 0)
            masks[:, y0:y1, x0:x1] = packed[:, : y1 - y0, : x1 - x0]
    return dog, seed, masks.to(torch.int16 if n - 3 <= 8 else torch.int32), stack


@pytest.mark.parametrize("upsample2x", [False, True], ids=["octave1", "upsampled"])
@pytest.mark.parametrize("tile", [(32, 64), (64, 32), (16, 16)], ids=str)
def test_tiled_emulation_equals_plain_version(tile, upsample2x):
    rng = np.random.default_rng(5)
    base = torch.from_numpy(rng.random((2, 70, 100)).astype(np.float32))
    cfg = port.SiftConfig(scales_per_octave=5)
    sigmas = _sigmas(cfg, 0 if upsample2x else 1)
    spo, thr = cfg.scales_per_octave, cfg.contrast_prefilter_threshold
    want = fused_octave_reference(base, sigmas, spo, thr, upsample2x, emit_scales=True)
    got = emulate_tiled_octave(base, sigmas, spo, thr, upsample2x, *tile)
    assert want[2].any()  # the masks hold extrema to disagree about
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_tiled_emulation_with_a_radius_past_the_plane():
    # Octave 3's radius 47 on a 10x14 plane: the window is mostly clamped copies.
    rng = np.random.default_rng(6)
    base = torch.from_numpy(rng.random((1, 10, 14)).astype(np.float32))
    cfg = port.SiftConfig(scales_per_octave=5)
    sigmas = _sigmas(cfg, 3)
    want = fused_octave_reference(base, sigmas, 5, 0.01, emit_scales=True)
    got = emulate_tiled_octave(base, sigmas, 5, 0.01, False, 4, 8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
