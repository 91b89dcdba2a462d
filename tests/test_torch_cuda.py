"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device (decided in
a fixture, never at import). On a GPU machine, without jax installed:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX, so it runs where jax is absent.
"""

import dataclasses

import numpy as np
import pytest
import torch

import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.models.frontend import (
    _as_unit_float,
    build_pyramid_fused,
)
from sift_scale_space_extrema_detection_tpu_torch.ops.gaussian import (
    blur_separable,
    kernel_radius,
)
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import tiles
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.blur import (
    blur_fused,
    blur_tile_plan,
)
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.describe import (
    window_sample_pair,
    window_sample_pair_reference,
)
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import (
    fused_octave,
    fused_octave_reference,
    octave_tile_plan,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# (base shape, upsample2x, octave, scales_per_octave): octave 0 with the
# in-kernel upsample; an unblurred base; a radius (47) past the whole
# 10x14 plane; 9 trios in int32 masks; a ragged 33x47 plane. Then planes
# of several tiles each way whose sizes are no multiples of the tile: the
# seams; the upsampled octave 0 across seams; and the main path's octave 3
# (radius 47 on 120x160). Last, the deepest octaves of 480x640 frames at the
# default configuration (radius 116 on 60x80) and at 6 octaves x 5 scales
# (188 on 30x40), which take the kernels' clamped mode; that mode on planes
# of several tiles (octave 4 of a 2160x3840 frame), also upsampled.
CASES = [
    ((2, 24, 32), True, 0, 5),
    ((2, 24, 32), False, 1, 5),
    ((2, 10, 14), False, 3, 5),
    ((1, 24, 32), False, 1, 9),
    ((3, 33, 47), False, 2, 3),
    ((2, 100, 150), False, 1, 5),
    ((1, 70, 200), True, 0, 5),
    ((2, 120, 160), False, 3, 5),
    ((2, 60, 80), False, 4, 3),
    ((2, 30, 40), False, 5, 5),
    ((1, 270, 480), False, 4, 3),
    ((1, 100, 150), True, 4, 3),
]


@pytest.mark.parametrize("shape, up2, octave, spo", CASES)
def test_kernel_matches_plain_version_bit_for_bit(device, shape, up2, octave, spo):
    cfg = port.SiftConfig(num_octaves=octave + 1, scales_per_octave=spo)
    sigmas = [
        None if (octave > 0 and s == 0) else cfg.offset_sigma(octave, s)
        for s in range(cfg.scales_per_octave_total)
    ]
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.random(shape).astype(np.float32)).to(device)
    thr = cfg.contrast_prefilter_threshold
    before = fused_octave.launches, fused_octave.clamped_launches
    got = fused_octave(base, sigmas, spo, thr, upsample2x=up2)
    torch.cuda.synchronize()
    assert fused_octave.launches == before[0] + 1
    # The clamped mode is a second kernel: octaves 4 and 5 take it here.
    assert fused_octave.clamped_launches == before[1] + (octave >= 4)
    want = fused_octave_reference(base, sigmas, spo, thr, upsample2x=up2)
    with_scales = fused_octave(base, sigmas, spo, thr, upsample2x=up2, emit_scales=True)
    want += fused_octave_reference(
        base, sigmas, spo, thr, upsample2x=up2, emit_scales=True
    )[3:]
    got += with_scales[3:]
    assert len(got) == 4
    for g, w in zip(got + with_scales[:3], want + want[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        # Both round every product and sum separately in float32.
        assert torch.equal(g, w)


def test_a_launch_with_another_byte_count_is_refused(device, monkeypatch):
    # The planner and the kernels size a block's shared memory by the same
    # arithmetic; an entry point refuses a plan whose byte count is not its own.
    image = torch.zeros((2, 33, 47), device=device)
    kernels = tiles.__package__
    plan = blur_tile_plan(33, 47, kernel_radius(1.3))
    wrong = dataclasses.replace(plan, shared_bytes=plan.shared_bytes + 4)
    monkeypatch.setattr(f"{kernels}.blur.plan_tiles", lambda *a, **k: wrong)
    with pytest.raises(RuntimeError, match="invalid argument"):
        blur_fused(image, 1.3)
    sigmas = [None, 1.3, 1.6, 2.0]
    plan = octave_tile_plan(33, 47, (0,) + tuple(kernel_radius(s) for s in sigmas[1:]))
    wrong = dataclasses.replace(plan, shared_bytes=plan.shared_bytes - 4)
    monkeypatch.setattr(f"{kernels}.octave.plan_tiles", lambda *a, **k: wrong)
    with pytest.raises(RuntimeError, match="invalid argument"):
        fused_octave(image, sigmas, 1, 0.01)
    monkeypatch.undo()
    assert len(fused_octave(image, sigmas, 1, 0.01)) == 3


def test_detect_batched_on_card_matches_cpu(device):
    rng = np.random.default_rng(1)
    images = torch.from_numpy((rng.random((2, 48, 64)) * 255).astype(np.uint8))
    cfg = port.SiftConfig(num_octaves=3, scales_per_octave=5)
    # Bit-equal pyramids: the uint8 scaling divides like the CPU does, and
    # the kernel rounds like the plain version.
    dogs, masks = build_pyramid_fused(_as_unit_float(images.to(device)), cfg)
    cpu_dogs, cpu_masks = build_pyramid_fused(_as_unit_float(images), cfg, device="cpu")
    for d, m, cd, cm in zip(dogs, masks, cpu_dogs, cpu_masks):
        assert torch.equal(d.cpu(), cd) and torch.equal(m.cpu(), cm)
    got, _ = port.detect_batched(images, cfg)  # a CPU tensor: moved to the card
    assert got.valid.device.type == "cuda"
    want, _ = port.detect_batched(images, cfg, device="cpu")
    assert torch.equal(got.valid.cpu(), want.valid)
    assert torch.equal(got.reject_reason.cpu(), want.reject_reason)
    v = want.valid
    # Refinement is the same float32 op sequence; the card's exp2 and
    # division may differ from the CPU's in the last ulp.
    torch.testing.assert_close(got.abs_x.cpu()[v], want.abs_x[v], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.abs_y.cpu()[v], want.abs_y[v], rtol=1e-5, atol=1e-5)


def test_default_config_runs_on_card_and_matches_cpu(device):
    # 5 octaves x 3 scales: the last octave of a 96x128 frame is 12x16 with a
    # radius of 116, which takes the octave kernel's clamped mode.
    images = torch.from_numpy(_blob_images(13, 2, 96, 128))
    cfg = port.SiftConfig()
    before = fused_octave.launches
    got, got_extrema = port.detect_batched(images, cfg)
    torch.cuda.synchronize()
    assert fused_octave.launches == before + cfg.num_octaves
    want, want_extrema = port.detect_batched(images, cfg, device="cpu")
    assert want.valid.sum() > 30
    assert torch.equal(got.valid.cpu(), want.valid)
    assert torch.equal(got.reject_reason.cpu(), want.reject_reason)
    for g, w in zip(got_extrema, want_extrema):
        assert torch.equal(g.num_candidates.cpu(), w.num_candidates)


# (plane shape, sigma): a ragged plane; one pixel row; a radius (36) that
# passes the whole 10x14 plane; leading batch dimensions; planes of several
# tiles each way at a small radius and at the main path's largest (47);
# radii of 116 and 188 on the small planes of a deep pyramid (clamped mode);
# that mode on one pixel row, and on a plane of several tiles.
BLUR_CASES = [
    ((3, 33, 47), 1.3), ((2, 1, 50), 2.0), ((2, 10, 14), 12.0), ((2, 3, 17, 19), 0.9),
    ((2, 100, 150), 2.05), ((1, 120, 160), 15.63), ((2, 60, 80), 38.7), ((1, 30, 40), 62.7),
    ((2, 1, 50), 40.0), ((1, 270, 480), 38.7),
]


@pytest.mark.parametrize("shape, sigma", BLUR_CASES)
def test_blur_kernel_matches_plain_version_bit_for_bit(device, shape, sigma):
    rng = np.random.default_rng(2)
    image = torch.from_numpy(rng.random(shape).astype(np.float32)).to(device)
    before = blur_fused.launches, blur_fused.clamped_launches
    got = blur_fused(image, sigma)
    torch.cuda.synchronize()
    assert blur_fused.launches == before[0] + 1
    clamped = blur_tile_plan(*shape[-2:], kernel_radius(sigma)).clamped
    assert clamped == (sigma > 30) and blur_fused.clamped_launches == before[1] + clamped
    # Both round every product and sum separately in float32, in tap order.
    assert torch.equal(got, blur_separable(image, sigma))
    # The tap loop on the CPU does the same float32 operations in the same order.
    assert torch.equal(got.cpu(), blur_fused(image.cpu(), sigma))


def _sample_case(device, m, n, seed):
    """Stacks of three ragged octaves, and ``m`` slots of ``n`` samples whose
    coordinates run past every border; slot 0 sits on a plane's corner."""
    rng = np.random.default_rng(seed)
    shapes = [(2, 4, 37, 53), (2, 4, 19, 27), (2, 4, 3, 2)]
    stacks = [torch.from_numpy(rng.random(s).astype(np.float32)).to(device) for s in shapes]
    octave = rng.integers(0, 3, m)
    table = np.stack(
        [rng.integers(0, 2, m), octave, rng.integers(-1, 6, m), rng.random(m) > 0.2], axis=1
    ).astype(np.int32)
    table[0] = [1, 0, 3, 1]
    octave[0] = 0
    table[-1] = [0, 5, 1, 1]  # an octave the table does not hold
    hs = np.array([s[2] for s in shapes])[octave][:, None]
    ws = np.array([s[3] for s in shapes])[octave][:, None]
    ys = rng.uniform(-4, hs + 3, (m, n)).astype(np.float32)
    xs = rng.uniform(-4, ws + 3, (m, n)).astype(np.float32)
    k = min(n, 4)
    ys[0, :k] = [0.0, 0.0, 36.0, 36.0][:k]
    xs[0, :k] = [0.0, 52.0, 0.0, 52.0][:k]
    to = lambda a: torch.from_numpy(a).to(device)
    return stacks, to(table), to(ys), to(xs)


@pytest.mark.parametrize("m, n", [(77, 256), (5, 3), (301, 37)])
def test_window_sample_kernel_matches_plain_version_bit_for_bit(device, m, n):
    stacks, table, ys, xs = _sample_case(device, m, n, seed=3)
    before = window_sample_pair.launches
    got = window_sample_pair(stacks, table, ys, xs)
    torch.cuda.synchronize()
    assert window_sample_pair.launches == before + 1
    want = window_sample_pair_reference(stacks, table, ys, xs)
    # Differences, products and sums are rounded one by one on both sides.
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    skipped = (table[:, 3] == 0) | (table[:, 1] > 2)
    assert not got[0][skipped].any() and not got[1][skipped].any()
    assert got[0][~skipped].any()


def test_window_sample_kernel_takes_no_slots(device):
    stacks, table, ys, xs = _sample_case(device, 4, 8, seed=4)
    gy, gx = window_sample_pair(stacks, table[:0], ys[:0], xs[:0])
    assert gy.shape == gx.shape == (0, 8)


def _blob_images(seed, b, h, w):
    """``(b, h, w)`` float32 frames of random Gaussian blobs on a smooth
    pattern (made here: this file imports no other test module, so that it
    runs from any working directory on a machine without the CPU tests'
    dependencies)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = np.tile(0.5 + 0.1 * np.sin(xx / 6.0) * np.cos(yy / 8.0), (b, 1, 1))
    for img in imgs:
        for _ in range(60):
            cy, cx, r = rng.uniform(8, h - 8), rng.uniform(8, w - 8), rng.uniform(1.5, 5.0)
            img += rng.uniform(-0.35, 0.35) * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r)
            )
    return np.clip(imgs, 0.0, 1.0).astype(np.float32)


def test_detect_and_describe_on_card_matches_cpu(device):
    images = torch.from_numpy(_blob_images(9, 2, 96, 128))
    cfg = port.SiftConfig(num_octaves=3, max_keypoints_per_trio=128)
    before = window_sample_pair.launches
    got = port.detect_and_describe_batched(images.to(device), cfg)
    torch.cuda.synchronize()
    assert window_sample_pair.launches == before + 2  # orientation, descriptor
    want = port.detect_and_describe_batched(images, cfg, device="cpu")
    assert want.valid.sum() > 30
    # The card's atan2, exp, sin and cos differ from the CPU's in the last
    # ulp, and its sums run in another order: a sample on a histogram bin's
    # edge may change bins, so validity and θ are held at a rate.
    assert (got.valid.cpu() == want.valid).float().mean() >= 0.999
    v = got.valid.cpu() & want.valid
    dtheta = (got.theta.cpu()[v] - want.theta[v]).abs()
    dtheta = torch.minimum(dtheta, 2 * torch.pi - dtheta)
    assert (dtheta <= 1e-4).float().mean() >= 0.99
    same = dtheta <= 1e-4
    cosine = (got.descriptor.cpu()[v][same] * want.descriptor[v][same]).sum(-1)
    assert cosine.min() >= 0.9999


def test_per_octave_describe_on_card_matches_cpu(device):
    images = torch.from_numpy(_blob_images(11, 2, 96, 128))
    cfg = port.SiftConfig(num_octaves=3, max_keypoints_per_trio=128, compact_describe=False)
    before = window_sample_pair.launches
    got = port.detect_and_describe_batched(images.to(device), cfg)
    torch.cuda.synchronize()
    assert window_sample_pair.launches == before + 2 * cfg.num_octaves
    want = port.detect_and_describe_batched(images, cfg, device="cpu")
    assert want.valid.sum() > 30 and got.valid.shape == want.valid.shape
    # Held at a rate for the reasons given in the test above.
    assert (got.valid.cpu() == want.valid).float().mean() >= 0.999
    v = got.valid.cpu() & want.valid
    dtheta = (got.theta.cpu()[v] - want.theta[v]).abs()
    dtheta = torch.minimum(dtheta, 2 * torch.pi - dtheta)
    same = dtheta <= 1e-4
    assert same.float().mean() >= 0.99
    cosine = (got.descriptor.cpu()[v][same] * want.descriptor[v][same]).sum(-1)
    assert cosine.min() >= 0.9999
