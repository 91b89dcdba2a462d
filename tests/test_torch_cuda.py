"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device (decided in
a fixture, never at import). On a GPU machine, without jax installed:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX, so it runs where jax is absent.
"""

import collections
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.core.types import Extrema
from sift_scale_space_extrema_detection_tpu_torch.models.frontend import (
    _as_unit_float,
    _pyramid,
    _select_candidates,
    build_pyramid_fused,
)
from sift_scale_space_extrema_detection_tpu_torch.ops import refine
from sift_scale_space_extrema_detection_tpu_torch.ops.extrema import (
    select_refine_candidates,
    select_refine_candidates_reference,
)
from sift_scale_space_extrema_detection_tpu_torch.ops.gaussian import (
    blur_separable,
    kernel_radius,
)
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import launch_counts, launches_since
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import refine as refine_kernel
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import select as select_kernel
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
from sift_scale_space_extrema_detection_tpu_torch.utils.profile import tracing

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
    before = launch_counts()
    got = fused_octave(base, sigmas, spo, thr, upsample2x=up2)
    torch.cuda.synchronize()
    since = launches_since(before)
    assert since["fused_octave"] == 1
    # The clamped mode is a second kernel: octaves 4 and 5 take it here.
    assert since["fused_octave.clamped"] == (octave >= 4)
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
    before = launch_counts()
    got, got_extrema = port.detect_batched(images, cfg)
    torch.cuda.synchronize()
    assert launches_since(before)["fused_octave"] == cfg.num_octaves
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
    before = launch_counts()
    got = blur_fused(image, sigma)
    torch.cuda.synchronize()
    since = launches_since(before)
    assert since["blur_fused"] == 1
    clamped = blur_tile_plan(*shape[-2:], kernel_radius(sigma)).clamped
    assert clamped == (sigma > 30) and since["blur_fused.clamped"] == clamped
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
    before = launch_counts()
    got = window_sample_pair(stacks, table, ys, xs)
    torch.cuda.synchronize()
    assert launches_since(before)["window_sample_pair"] == 1
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
    before = launch_counts()
    got = port.detect_and_describe_batched(images.to(device), cfg)
    torch.cuda.synchronize()
    since = launches_since(before)  # R3 for orientation, R4 for the descriptors; K2 no more
    assert since["orient_slots"] == since["describe_pairs"] == 1
    assert since["window_sample_pair"] == 0
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


def test_budgeted_describe_on_card_matches_the_plain_reference(device):
    """``max_features`` on the card against ``port_bench/reference/budget.py``
    (plain PyTorch, the same frames on the card) at a mid size with odd
    plane sides, held by the benchmark's comparison within the photo
    configuration's limits; the budget binds on every image and no
    capacity drops a keypoint or a pair."""
    import json
    from pathlib import Path

    from port_bench import compare, frames
    from port_bench.reference import budget as ref_budget
    from port_bench.reference import config as ref_config

    limits = json.loads((Path(__file__).resolve().parent.parent / "port_bench" / "configs"
                         / "colmap-3200.json").read_text())["checks"]
    # Four views of a blob field dense enough that every image ranks
    # 3,000-5,000 pairs.
    size = {"width": 1600, "height": 1066,
            "intrinsics": {"fx": 1440.0, "fy": 1440.0, "cx": 799.5, "cy": 533.0}}
    scene = {"trajectory": "zigzag", "scene": {
        "seed": 7, "landmarks_per_unit": 150, "satellites": 3, "satellite_spread": 0.35,
        "blob_sigma": 20.0, "background": 0.35, "noise": 0.01}}
    images = frames.make_frames(5, size, scene, 4, device)
    fields = dict(num_octaves=4, scales_per_octave=3, contrast_threshold=0.02 / 3,
                  max_keypoints_per_trio=8192, refine_compaction=1.0)
    n = 1024
    with tracing(spans=False, counters=True) as session:
        got = port.detect_and_describe_batched(images, port.SiftConfig(**fields), max_features=n)
    counters = session.counters
    assert counters["budget.images_bound"] == 4
    assert counters["describe.keypoints_over_capacity"] == 0
    assert counters["describe.pairs_over_capacity"] == 0
    kept = got.valid.sum(-1)
    assert bool((kept >= n).all()) and int(kept.sum()) == counters["budget.pairs_kept"]
    cfg = ref_config.SiftConfig(**fields)
    want = ref_budget.detect_and_describe_batched(images, cfg, "fused", n)
    correct, checks = compare.verdict(
        compare.gaps(compare.fields(got), compare.fields(want), cfg), limits)
    assert correct, checks


def test_per_octave_describe_on_card_matches_cpu(device):
    images = torch.from_numpy(_blob_images(11, 2, 96, 128))
    cfg = port.SiftConfig(num_octaves=3, max_keypoints_per_trio=128, compact_describe=False)
    before = launch_counts()
    got = port.detect_and_describe_batched(images.to(device), cfg)
    torch.cuda.synchronize()
    since = launches_since(before)
    assert since["orient_slots"] == since["describe_pairs"] == cfg.num_octaves
    assert since["window_sample_pair"] == 0
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


# --- R3 and R4, the describe stages' kernels, against the tensor code --------------

# A few frames of the benchmark's describe cells: configuration, traffic and
# frames (the photo cell's two, and its whole 16-photo batch below).
DESCRIBE_CELLS = {
    "tum": ("tum-vga", "describe-b64-zigzag", 4),
    "kitti": ("kitti-odom", "describe-b64-dolly", 4),
    "photo": ("colmap-3200", "extract-b16-zigzag", 2),
}
_CELL_CACHE = {}


def _cell_keypoints(cell, frames=None):
    """``(cfg, stacks, keypoints, max_features)`` of ``frames`` frames of a
    benchmark cell (its scene and ``SiftConfig``, made on the card by
    ``port_bench/frames.py``; the traffic's budget or None); the last one
    asked for is kept for the next test."""
    from pathlib import Path

    from port_bench import frames as bench_frames
    from port_bench.reference import frontend as ref_frontend
    from sift_scale_space_extrema_detection_tpu_torch.models.frontend import _refine_per_octave

    config_name, traffic_name, n = DESCRIBE_CELLS[cell]
    key = (cell, frames or n)
    if key not in _CELL_CACHE:
        _CELL_CACHE.clear()
        torch.cuda.empty_cache()
        root = Path(__file__).resolve().parent.parent / "port_bench"
        config = json.loads((root / "configs" / f"{config_name}.json").read_text())
        traffic = json.loads((root / "traffic" / f"{traffic_name}.json").read_text())
        images = bench_frames.make_frames(7, config, traffic, key[1], torch.device("cuda"))
        images = ref_frontend.pad_edges(images, config.get("pad_to"))
        cfg = port.SiftConfig(**config["sift"])
        dogs, masks, stacks = _pyramid(images, cfg, "fused", emit_scales=True)
        _, selected = _select_candidates(dogs, cfg, masks)
        keypoints = _refine_per_octave(dogs, selected, cfg)
        _CELL_CACHE[key] = (cfg, stacks, keypoints, traffic.get("max_features"))
    return _CELL_CACHE[key]


def _assert_stage_gaps(gaps):
    """R3 and R4 on the slots of each stage call against the tensor code
    (R4 on the same θ): the histograms' sums differ only in order, so
    validity differs only at near ties, θ by about an ulp and a descriptor
    by a few ulps; invalid slots empty, reruns bit-equal (no atomics)."""
    assert gaps["pairs"] > 100, gaps
    assert gaps["orient_valid_differ"] <= 1e-3 * gaps["orient_valid"], gaps
    assert gaps["theta_median"] <= 1e-6, gaps
    assert gaps["desc_l2_max"] <= 1e-5, gaps
    assert gaps["invalid_zero"] and gaps["rerun_equal"], gaps


@pytest.mark.parametrize("mode", ["compact", "budget", "upright", "per_octave"])
@pytest.mark.parametrize("cell", list(DESCRIBE_CELLS))
def test_describe_kernels_match_the_tensor_code(device, cell, mode):
    """R3 and R4 on tum-, kitti- and photo-shaped batches, through
    ``describe_compact`` (with and without ``max_features``, with
    ``upright``) and per octave (``describe_octave``): one launch each a
    pass (R3 none upright), K2 none; each stage against the tensor code on
    the same slots; the whole pass against the tensor route."""
    from sift_scale_space_extrema_detection_tpu_torch.benchmarks import (
        describe_stage_calls,
        describe_stage_gaps,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.descriptor import (
        concat_described,
        describe_compact,
        describe_octave,
    )

    cfg, stacks, keypoints, budget = _cell_keypoints(cell)
    cfg = dataclasses.replace(cfg, upright=mode == "upright")
    max_features = (budget or 100) if mode == "budget" else None

    def run(sample_fn=None):
        if mode == "per_octave":
            return concat_described([describe_octave(s, k, o, cfg, sample_fn)
                                     for o, (s, k) in enumerate(zip(stacks, keypoints))])
        return describe_compact(stacks, keypoints, cfg, sample_fn, max_features)

    before = launch_counts()
    with describe_stage_calls() as calls:
        got = run()
    torch.cuda.synchronize()
    since = launches_since(before)
    passes = cfg.num_octaves if mode == "per_octave" else 1
    assert since["orient_slots"] == (0 if cfg.upright else passes)
    assert since["describe_pairs"] == passes and since["window_sample_pair"] == 0
    _assert_stage_gaps(describe_stage_gaps(calls))
    del calls
    want = run(window_sample_pair)
    assert chip_smoke._slot_agreement(got, want) >= 0.999
    both = got.valid & want.valid
    dtheta = (got.theta - want.theta)[both].abs()
    dtheta = torch.minimum(dtheta, 2 * torch.pi - dtheta)
    assert dtheta.median() <= 1e-6
    assert (got.descriptor - want.descriptor)[both].norm(dim=-1).median() <= 1e-5
    assert not got.descriptor[~got.valid].any()


def test_describe_kernels_address_a_stack_past_int32(device):
    """The photo cell's whole 16-photo batch, whose octave-0 Gaussian stack
    holds more than 2^31 floats: R3 and R4 hold their bars on the slots of
    its budgeted pass, the last photo's among them (64-bit offsets)."""
    from sift_scale_space_extrema_detection_tpu_torch.benchmarks import (
        describe_stage_calls,
        describe_stage_gaps,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.descriptor import describe_compact

    cfg, stacks, keypoints, budget = _cell_keypoints("photo", 16)
    assert stacks[0].numel() > 2**31
    with describe_stage_calls() as calls:
        describe_compact(stacks, keypoints, cfg, max_features=budget)
    table = calls[-1][1][0].table
    assert bool(((table[:, 0] == 15) & (table[:, 1] == 0) & (table[:, 3] != 0)).any())
    _assert_stage_gaps(describe_stage_gaps(calls))
    del calls
    _CELL_CACHE.clear()


# --- the oracle leg and the solvers on the card ------------------------------------


def test_oracle_leg_on_card_is_bit_equal_to_cpu(device):
    frame = torch.from_numpy(_blob_images(5, 1, 24, 32)).double()
    cfg = port.SiftConfig(num_octaves=3)
    got = port.build_scale_space(frame, cfg, blur="exact")
    want = port.build_scale_space(frame, cfg, blur="exact", device="cpu")
    assert all(g.is_cuda and g.dtype == torch.float64 for g in got)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    got_kp, _ = port.detect_from_dog(port.build_dog(got), cfg)
    want_kp, _ = port.detect_from_dog(port.build_dog(want), cfg)
    assert want_kp.valid.any()
    assert torch.equal(got_kp.valid.cpu(), want_kp.valid)
    assert torch.equal(got_kp.reject_reason.cpu(), want_kp.reject_reason)
    err = (got_kp.abs_x.cpu() - want_kp.abs_x)[want_kp.valid].abs().max()
    assert err <= 1e-10


def _small_sfm_problem(seed=0, cams=4, pts=60, baseline=0.25):
    """A ring of cameras looking at a point cloud: float32 CPU tensors of
    the solvers' inputs, every camera seeing every point, 0.3 px of noise."""
    rng = np.random.default_rng(seed)
    geo = port.sfm.geometry
    k = torch.tensor([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    points = torch.from_numpy(rng.uniform([-2, -2, 4], [2, 2, 7], size=(pts, 3))).float()
    rots = geo.so3_exp(torch.tensor([[0.0, 0.04 * i, 0.0] for i in range(cams)]))
    ts = torch.tensor([[-baseline * i, 0.0, 0.02 * i] for i in range(cams)])
    uv = geo.project(geo.transform(rots, ts, points), k)  # (C, P, 2)
    uv = uv + 0.3 * torch.from_numpy(rng.normal(size=tuple(uv.shape))).float()
    state = port.sfm.ba.BAState(
        rots, ts, points + 0.02 * torch.from_numpy(rng.normal(size=(pts, 3))).float(), k
    )
    obs = port.sfm.ba.Observations(
        torch.arange(cams, dtype=torch.int32).repeat_interleave(pts),
        torch.arange(pts, dtype=torch.int32).repeat(cams),
        uv.reshape(-1, 2),
        torch.ones(cams * pts, dtype=torch.bool),
    )
    return dict(k=k, points=points, rots=rots, ts=ts, uv=uv, state=state, obs=obs)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_bundle_adjust_on_card_from_cpu_tensors_is_deterministic(device, solver):
    p = _small_sfm_problem()
    runs = [
        port.sfm.ba.bundle_adjust(p["state"], p["obs"], num_iterations=5, solver=solver)
        for _ in range(2)
    ]
    (out, cost), (again, cost_again) = runs
    assert out.points.is_cuda and cost.is_cuda
    for field in ("rotations", "translations", "points"):
        assert torch.equal(getattr(out, field), getattr(again, field))
    assert torch.equal(cost, cost_again)
    _, want = port.sfm.ba.bundle_adjust(
        p["state"], p["obs"], num_iterations=5, solver=solver, device="cpu"
    )
    # float32 on both devices, sums in another order: held at a rate.
    assert abs(cost.item() - want.item()) <= 1e-3 * want.item()
    rms = (2.0 * cost.item() / p["obs"].capacity) ** 0.5
    assert rms < 1.0


@pytest.mark.parametrize("kwargs", [dict(), dict(assembly="scatter"), dict(solver="cg")])
def test_bundle_adjust_on_card_with_skewed_visibility(device, kwargs):
    """One landmark seen by every camera and one camera seeing every
    landmark, the rest seen three times: the reductions by segment take any
    spread of segment sizes, in the same bits run after run."""
    cams, pts = 12, 600
    p = _small_sfm_problem(seed=4, cams=cams, pts=pts, baseline=0.1)
    obs = p["obs"]
    cam, lm = obs.camera.long(), obs.landmark.long()
    valid = (lm == 0) | (cam == 0) | ((lm + cam) % 6 == 0)
    obs = dataclasses.replace(obs, valid=valid)
    counts = torch.bincount(lm[valid], minlength=pts)
    assert counts[0] == cams and counts.median() <= 3
    runs = [port.sfm.ba.bundle_adjust(p["state"], obs, num_iterations=5, **kwargs) for _ in range(2)]
    (out, cost), (again, cost_again) = runs
    assert out.points.is_cuda
    for field in ("rotations", "translations", "points"):
        assert torch.equal(getattr(out, field), getattr(again, field))
    assert torch.equal(cost, cost_again)
    _, cost0 = port.sfm.ba.bundle_adjust(p["state"], obs, num_iterations=0, **kwargs)
    _, want = port.sfm.ba.bundle_adjust(p["state"], obs, num_iterations=5, device="cpu", **kwargs)
    assert cost.item() < cost0.item()
    assert abs(cost.item() - want.item()) <= 1e-3 * want.item()

    seg = torch.where(valid, lm, pts).cuda()
    data = torch.from_numpy(np.random.default_rng(0).normal(size=(cams * pts, 3, 3))).float().cuda()
    got = port.sfm.ba.segment_sum(data, port.sfm.ba.segment_tables(seg, pts))
    want = torch.zeros((pts + 1, 3, 3)).index_add_(0, seg.cpu(), data.cpu())[:pts]
    assert (got.cpu() - want).abs().max() <= 1e-4


def test_two_view_solvers_on_card_from_cpu_tensors(device):
    p = _small_sfm_problem(seed=1, cams=2, pts=120, baseline=0.8)
    geo = port.sfm.geometry
    rays1, rays2 = geo.backproject(p["uv"][0], p["k"]), geo.backproject(p["uv"][1], p["k"])
    ok = torch.ones(120, dtype=torch.bool)
    res = port.estimate_essential_ransac(
        rays1, rays2, ok, torch.Generator().manual_seed(0), num_hypotheses=64,
        inlier_threshold=2.0 / 300.0,
    )
    assert res.rotation.is_cuda and int(res.num_inliers) >= 100
    rr = res.rotation.cpu().double() @ p["rots"][1].double().T
    angle = torch.rad2deg(torch.acos(((rr.diagonal().sum() - 1) / 2).clamp(-1, 1)))
    assert angle < 1.0
    rot, t, rms = port.sfm.pnp.solve_pnp(
        p["points"], p["uv"][1], ok, p["k"], p["rots"][0], p["ts"][0]
    )
    assert rot.is_cuda and rms.item() < 1.0
    assert (t.cpu() - p["ts"][1]).abs().max() < 0.05

    rng = np.random.default_rng(2)
    desc = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(64, 128))).float(), dim=1)
    perm = torch.from_numpy(rng.permutation(64))
    ok = torch.ones(64, dtype=torch.bool)
    matches = port.match_descriptors(desc, ok, desc[perm] + 0.01, ok)
    assert matches.index.is_cuda and bool(matches.valid.all())
    assert torch.equal(perm[matches.index.cpu().long()], torch.arange(64))


def test_pose_graph_on_card_in_float32(device):
    # Float32 through vmap(jacfwd): the dtype of every tangent must hold.
    p = _small_sfm_problem(cams=6)
    geo = port.sfm.geometry
    src, dst = torch.arange(5), torch.arange(1, 6)
    rel_r, rel_t = geo.compose(
        p["rots"][dst], p["ts"][dst], *geo.invert(p["rots"][src], p["ts"][src])
    )
    edges = port.sfm.pose_graph.PoseGraphEdges(src.int(), dst.int(), rel_r, rel_t, torch.ones(5))
    rng = np.random.default_rng(3)
    drifted = p["ts"] + 0.05 * torch.from_numpy(rng.normal(size=(6, 3))).float()
    drifted[0] = p["ts"][0]
    rots, ts, cost = port.sfm.pose_graph.optimize_pose_graph(p["rots"], drifted, edges)
    assert rots.is_cuda and rots.dtype == torch.float32
    assert cost.item() < 1e-8
    assert (ts.cpu() - p["ts"]).abs().max() < 1e-3


def _orbit(seed=3, frames=8, landmarks=150):
    from sift_scale_space_extrema_detection_tpu_torch.utils.synthetic import orbit_sequence

    return orbit_sequence(np.random.default_rng(seed), num_frames=frames,
                          num_landmarks=landmarks, noise_px=0.3)


def test_run_slam_on_card_agrees_with_cpu(device):
    seq = _orbit()
    cfg = port.SlamConfig(ba_interval=3)
    got = port.run_slam(seq.pixels, seq.visible, seq.k_mat, cfg)
    want = port.run_slam(seq.pixels, seq.visible, seq.k_mat, cfg, device="cpu")
    ate = port.evaluate_ate(got, seq.rotations, seq.translations)
    ate_cpu = port.evaluate_ate(want, seq.rotations, seq.translations, device="cpu")
    assert ate < 0.1 and abs(ate - ate_cpu) < 0.02
    assert (got.landmark_valid == want.landmark_valid).mean() >= 0.99
    assert got.num_observations > 100
    again = port.run_slam(seq.pixels, seq.visible, seq.k_mat, cfg)
    assert np.array_equal(again.rotations, got.rotations)
    assert np.array_equal(again.translations, got.translations)


def test_run_slam_on_card_resumes_bit_equal_after_every_window(device):
    seq = _orbit(seed=5, frames=14, landmarks=200)
    cfg = port.SlamConfig(ba_interval=3)
    full = port.run_slam(seq.pixels, seq.visible, seq.k_mat, cfg)
    for stop in range(4, 13, 3):  # the last frame of each window but the final one
        port.run_slam(seq.pixels, seq.visible, seq.k_mat, cfg, checkpoint_dir="mem://cuda_resume",
                      _stop_after=stop)
        resumed = port.run_slam(seq.pixels, seq.visible, seq.k_mat, cfg,
                                checkpoint_dir="mem://cuda_resume", resume=True)
        assert np.array_equal(resumed.rotations, full.rotations), stop
        assert np.array_equal(resumed.translations, full.translations), stop


def test_pair_verification_on_card_does_not_depend_on_its_group(device):
    # The streaming session verifies a few pairs a step, the batch run all
    # of them: a pair's inliers must not depend on the pairs beside it.
    from sift_scale_space_extrema_detection_tpu_torch.models import slam as pslam

    seq = _orbit(seed=4, frames=12, landmarks=120)
    rng = np.random.default_rng(0)
    uv_a = np.zeros((11, 128, 2), np.float32)
    uv_b = np.zeros((11, 128, 2), np.float32)
    mask = np.zeros((11, 128), bool)
    for p in range(11):
        ids = np.flatnonzero(seq.visible[p] & seq.visible[p + 1])
        uv2 = seq.pixels[p + 1, ids].copy()
        wrong = rng.permutation(len(ids))[: len(ids) // 3]
        uv2[wrong] = uv2[np.roll(wrong, 1)]
        uv_a[p, : len(ids)], uv_b[p, : len(ids)], mask[p, : len(ids)] = seq.pixels[p, ids], uv2, True
    thr = 2.0 / seq.k_mat[0, 0]
    dev = torch.device("cuda")
    together = pslam._verify_pairs(uv_a, uv_b, mask, seq.k_mat, range(1, 12), thr, 64, 256, dev)
    assert together.sum() > 100
    for p in range(11):
        alone = pslam._verify_pairs(uv_a[p : p + 1], uv_b[p : p + 1], mask[p : p + 1], seq.k_mat,
                                    [p + 1], thr, 64, 256, dev)
        assert np.array_equal(alone[0], together[p]), p


def test_slam_session_on_card_leaves_the_mem_store_empty(device):
    from sift_scale_space_extrema_detection_tpu_torch.utils import checkpoint
    from sift_scale_space_extrema_detection_tpu_torch.utils.synthetic import (
        render_blob_image,
        textured_blob_field,
    )

    rng = np.random.default_rng(12)
    k_mat = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
    rpts, amps, ss = textured_blob_field(rng, rng.uniform([-3.5, -1.8, 4.0], [3.5, 1.8, 9.0],
                                                          size=(110, 3)))
    frames = [
        render_blob_image(rpts, np.eye(3), -np.array([0.28 * f, 0.02 * f, 0.0]), k_mat, (320, 240),
                          amplitudes=amps, sigma_scales=ss, rng=np.random.default_rng(100 + f))
        for f in range(10)
    ]
    stored = set(checkpoint._MEM_STORE)
    sift_cfg = port.SiftConfig(num_octaves=3, max_keypoints_per_trio=256)
    slam_cfg = port.SlamConfig(ba_interval=3, ba_window=6, bootstrap_baseline=2)
    sess = port.SlamSession(k_mat, sift_cfg, slam_cfg)
    assert sess.device.type == "cuda"
    updates = [sess.add_frame(f) for f in frames]
    assert sum(u is not None for u in updates) == 3
    assert set(checkpoint._MEM_STORE) != stored
    result = sess.finalize()
    assert set(checkpoint._MEM_STORE) == stored
    assert np.isfinite(result.translations).all() and result.landmark_valid.sum() > 20
    batch = port.run_slam_from_images(np.stack(frames), k_mat, sift_cfg, slam_cfg, reassoc_window=2)
    assert np.array_equal(result.rotations, batch.rotations)
    assert np.array_equal(result.translations, batch.translations)


def test_slam_entry_points_raise_without_a_card(device, monkeypatch):
    seq = _orbit(frames=4, landmarks=40)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port.run_slam(seq.pixels, seq.visible, seq.k_mat)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port.SlamSession(seq.k_mat)


# --- the user surfaces: cli.py and evaluate.py on the card ---------------------------


@pytest.mark.parametrize("blur, k1, k3", [("fused", 3, 0), ("cuda", 0, 3 * 6 - 2)])
def test_cli_on_card_matches_cpu(device, tmp_path, blur, k1, k3):
    from sift_scale_space_extrema_detection_tpu_torch import cli
    from sift_scale_space_extrema_detection_tpu_torch.core.image import write_png

    path = str(tmp_path / "in.png")
    write_png(path, np.round(_blob_images(21, 1, 96, 128)[0] * 255.0).astype(np.uint8))
    argv = [path, "--octaves", "3", "--descriptors", "--blur", blur]
    before = launch_counts()
    assert cli.main(argv + ["-o", str(tmp_path / "card")]) == 0
    assert _launched(before) == dict(fused_octave=k1, orient_slots=3, describe_pairs=3,
                                     window_sample_pair=0, blur_fused=k3)
    assert cli.main(argv + ["-o", str(tmp_path / "cpu"), "--device", "cpu", "--no-galleries"]) == 0
    got, got_desc = chip_smoke.cli_records(str(tmp_path / "card"))
    want, want_desc = chip_smoke.cli_records(str(tmp_path / "cpu"))
    matched, p99 = chip_smoke.record_agreement(got, want)
    assert len(want) > 10 and matched >= 0.999 and p99 <= 0.1, (matched, p99)
    share, min_cos = chip_smoke.descriptor_cosines(got_desc, want_desc)
    assert share >= 0.999 and min_cos >= 0.999, (share, min_cos)


def test_blur_matmul_on_card_refuses_tf32_and_matches_the_tap_loop(device, monkeypatch):
    from sift_scale_space_extrema_detection_tpu_torch.ops.gaussian import blur_matmul

    image = torch.from_numpy(_blob_images(22, 2, 48, 64)).to(device)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        blur_matmul(image, 1.6)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for sigma in (0.9, 2.5, 7.0):
        got = blur_matmul(image, sigma)
        torch.testing.assert_close(got, blur_separable(image, sigma), rtol=0, atol=1e-6)


def test_evaluate_on_card_agrees_with_cpu(device, tmp_path, capsys):
    import json

    from sift_scale_space_extrema_detection_tpu_torch import evaluate
    from sift_scale_space_extrema_detection_tpu_torch.data import (
        read_tum_trajectory,
        write_tum_sequence,
    )
    from sift_scale_space_extrema_detection_tpu_torch.utils.synthetic import (
        render_blob_image,
        textured_blob_field,
    )

    # The scene of tests/test_datasets.py::test_evaluate_cli_end_to_end.
    rng = np.random.default_rng(4)
    k_mat = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
    rpts, amps, ss = textured_blob_field(rng, rng.uniform([-3.5, -1.8, 4.0], [3.5, 1.8, 9.0],
                                                          size=(110, 3)))
    rots = port.sfm.geometry.so3_exp(
        torch.tensor([[0.004 * f, -0.01 * f, 0.0] for f in range(6)], dtype=torch.float64)
    ).numpy()
    ts = -np.einsum("fij,fj->fi", rots, [[0.3 * f, 0.02 * f, 0.0] for f in range(6)])
    frames = np.stack([
        render_blob_image(rpts, r, t, k_mat, (320, 240), amplitudes=amps,
                          sigma_scales=ss, rng=np.random.default_rng(200 + f))
        for f, (r, t) in enumerate(zip(rots, ts))
    ])
    root = str(tmp_path / "rgbd_dataset_freiburg_synth")
    write_tum_sequence(root, frames, np.arange(6) / 30.0, rots, ts)
    argv = [root, "--octaves", "3", "--capacity", "256"]
    before = launch_counts()
    metrics = []
    for device_flag in ("cuda", "cpu"):
        traj = str(tmp_path / f"{device_flag}.txt")
        assert evaluate.main(argv + ["--device", device_flag, "--out-traj", traj]) == 0
        metrics.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
        assert read_tum_trajectory(traj)[0].shape == (6,)
        if device_flag == "cuda":
            assert _launched(before) == dict(fused_octave=3, orient_slots=1, describe_pairs=1,
                                             window_sample_pair=0, blur_fused=0)
    card, cpu = metrics
    assert card["frames"] == cpu["frames"] == 6
    assert card["ate_rmse"] < 0.25 and abs(card["ate_rmse"] - cpu["ate_rmse"]) < 0.02, metrics


# --- sharding: parallel/ at world 1 on NCCL, and two gloo ranks on the card -----------


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A world-1 NCCL group in this process over a file store, and its mesh;
    the group is destroyed after the module."""
    import datetime

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    store = tmp_path_factory.mktemp("nccl") / "store"
    port.parallel.initialize_multihost(f"file://{store}", 1, 0, backend="nccl",
                                       timeout=datetime.timedelta(seconds=60))
    try:
        yield port.parallel.make_mesh(1)
    finally:
        torch.distributed.destroy_process_group()


SHARD_CFG = dict(num_octaves=3, max_keypoints_per_trio=128)


def test_data_parallel_frontend_on_card_equals_the_batched_one(device, nccl_mesh):
    images = torch.from_numpy(chip_smoke._make_batch(4, 96, 128))
    cfg = port.SiftConfig(**SHARD_CFG)
    before = launch_counts()
    got = port.parallel.detect_and_describe_data_parallel(images, cfg, nccl_mesh)
    assert _launched(before) == dict(fused_octave=3, orient_slots=1, describe_pairs=1,
                                     window_sample_pair=0, blur_fused=0)
    want = port.detect_and_describe_batched(images, cfg)
    assert got.valid.is_cuda and int(got.valid.sum()) > 0
    for f in dataclasses.fields(got):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
    idx, _, ok = port.parallel.match_against_keyframes_sharded(
        got.descriptor[0], got.valid[0], got.descriptor[1:], got.valid[1:], nccl_mesh
    )
    for k in range(3):
        ref = port.match_descriptors(got.descriptor[0], got.valid[0], got.descriptor[k + 1],
                                     got.valid[k + 1])
        assert torch.equal(ok[k], ref.valid)
        assert torch.equal(idx[k][ref.valid], ref.index[ref.valid])


def test_distributed_bundle_adjust_on_card_at_world_1(device, nccl_mesh):
    from sift_scale_space_extrema_detection_tpu_torch.benchmarks.ba_bench import make_problem
    from sift_scale_space_extrema_detection_tpu_torch.sfm.ba import bundle_adjust

    state, obs = make_problem(np.random.default_rng(0), 6, 128, 64)
    _, want = bundle_adjust(state, obs, num_iterations=10)
    out, cost = port.parallel.distributed_bundle_adjust(state, obs, nccl_mesh, num_iterations=10)
    again, cost_again = port.parallel.distributed_bundle_adjust(state, obs, nccl_mesh,
                                                                num_iterations=10)
    assert out.points.is_cuda and cost.is_cuda
    assert abs(cost.item() - want.item()) <= 1e-3 * want.item()
    assert torch.equal(out.points, again.points) and torch.equal(cost, cost_again)


def test_sharded_slam_and_session_on_card_at_world_1(device, nccl_mesh):
    """Every BA sharded (threshold 0): the orbit's ATE within 0.02 of the
    run without a mesh, and ``SlamSession(mesh=…)`` bit-equal to the batch
    run with the same mesh."""
    from sift_scale_space_extrema_detection_tpu_torch.models import slam as slam_module
    from sift_scale_space_extrema_detection_tpu_torch.utils import synthetic

    seq = _orbit(seed=6, frames=12, landmarks=100)
    cfg = port.SlamConfig(ba_interval=4)
    single = port.run_slam(seq.pixels, seq.visible, seq.k_mat, cfg)
    read, restore = chip_smoke._count_bas(slam_module)
    try:
        sharded = port.run_slam(seq.pixels, seq.visible, seq.k_mat,
                                dataclasses.replace(cfg, dist_ba_min_landmarks=0), mesh=nccl_mesh)
    finally:
        calls = read()
        restore()
    assert calls[0] == 0 and calls[1] > 0
    ate = port.evaluate_ate(sharded, seq.rotations, seq.translations)
    assert ate < 0.1
    assert abs(ate - port.evaluate_ate(single, seq.rotations, seq.translations)) < 0.02

    images, _, _, k_mat = chip_smoke._test_sequence(synthetic)
    sift_cfg = port.SiftConfig(num_octaves=3, max_keypoints_per_trio=256)
    slam_cfg = port.SlamConfig(ba_interval=3, ba_window=6, dist_ba_min_landmarks=0)
    batch = port.run_slam_from_images(images, k_mat, sift_cfg, slam_cfg, mesh=nccl_mesh,
                                      reassoc_window=2)
    sess = port.SlamSession(k_mat, sift_cfg, slam_cfg, mesh=nccl_mesh)
    for image in images:
        sess.add_frame(image)
    streamed = sess.finalize()
    assert np.array_equal(streamed.rotations, batch.rotations)
    assert np.array_equal(streamed.translations, batch.translations)


def test_data_parallel_frontend_over_two_gloo_ranks_on_the_card(device, tmp_path):
    """Two gloo ranks on the one card, 2 frames each (``chip_smoke.py`` phase
    17 (b)'s rank and bars): each launches K1 per octave and R3 and R4 once,
    K1 and K2 equal their plain versions on its share, R3 and R4 hold
    their bars against the tensor code, the ranks sit on the
    parent's card with their outputs there, and the gathered result equals
    each share's batched frontend bit for bit."""
    import torch.multiprocessing as mp

    card = torch.cuda.current_device()
    spec = dict(world=2, device="cuda", cards=[card, card],
                share=2, height=96, width=128, blurs=["fused"], repeats=1, keyframes=0, ba=[],
                slam_frames=0, orbit_frames=0)
    chip_smoke._write_spec(str(tmp_path), spec)
    mp.spawn(chip_smoke._shard_rank, args=(str(tmp_path),), nprocs=2)
    ref = chip_smoke._share_references(torch, port, torch.device("cuda", card),
                                       chip_smoke._make_batch(4, 96, 128), 2, ("fused",))
    launches, octave_err, sample_err, _ = chip_smoke._shard_bars(
        torch, chip_smoke._read_ranks(str(tmp_path), 2), spec, ref, "", "two gloo ranks")
    assert launches == collections.Counter(fused_octave=8, orient_slots=2, describe_pairs=2,
                                           newton_ladder=8, select_candidates=8)
    assert octave_err == sample_err == 0.0


# --- one process on a card other than 0 ---------------------------------------------


@pytest.mark.parametrize("blur", ["fused", "cuda"])
def test_a_card_other_than_0_in_one_process(device, blur):
    """``device="cuda:<last card>"`` after a run on card 0, whose constants
    the per-device caches (taps, grids, cell lists, offsets) already hold:
    the kernels launch on that card (K1, R3, R4 and K3 counted, outputs there), the result equals
    card 0's bit for bit, and nothing is allocated on card 0, not even for
    a moment (``chip_smoke.py`` phase 20 (g) at 64 × 480×640)."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f"needs two CUDA devices or more, {cards} visible")
    other = torch.device("cuda", cards - 1)
    images = torch.from_numpy(chip_smoke._make_batch(2, 96, 128))
    cfg = port.SiftConfig(num_octaves=3, max_keypoints_per_trio=128)
    want = port.detect_and_describe_batched(images, cfg, blur, device="cuda:0")
    torch.cuda.synchronize(0)
    held = torch.cuda.memory_allocated(0)
    torch.cuda.reset_peak_memory_stats(0)
    before = launch_counts()
    got = port.detect_and_describe_batched(images, cfg, blur, device=str(other))
    torch.cuda.synchronize(other)
    described = dict(orient_slots=1, describe_pairs=1, window_sample_pair=0)
    assert _launched(before) == (
        dict(fused_octave=3, blur_fused=0, **described) if blur == "fused"
        else dict(fused_octave=0, blur_fused=chip_smoke._blur_count(cfg), **described))
    assert torch.cuda.max_memory_allocated(0) == held
    assert int(got.valid.sum()) > 0
    for f in dataclasses.fields(got):
        value = getattr(got, f.name)
        assert value.device == other, f.name
        assert torch.equal(value.cpu(), getattr(want, f.name).cpu()), f.name


# --- the blur-by-blur frontend and the pooled refinement on the card ----------


def _launched(before, names=("fused_octave", "orient_slots", "describe_pairs",
                              "window_sample_pair", "blur_fused")):
    """The launches of ``names`` since ``before = launch_counts()``, by name."""
    since = launches_since(before)
    return {name: since[name] for name in names}


def test_per_trio_detect_and_describe_on_card_equal_the_tap_loop(device):
    """``blur="cuda"`` launches K3 once per blurred scale (and R3 and R4 once
    each a describe, K1 and K2 never) and gives every field of
    ``blur="separable"`` on the card: K3 is bit-equal to the tap loop."""
    images = torch.from_numpy(_blob_images(13, 2, 96, 128)).to(device)
    cfg = port.SiftConfig(num_octaves=3, scales_per_octave=5, max_keypoints_per_trio=32)
    for call, passes in ((port.detect_batched, 0), (port.detect_and_describe_batched, 1)):
        before = launch_counts()
        got = call(images, cfg, "cuda")
        torch.cuda.synchronize()
        assert _launched(before) == dict(fused_octave=0, orient_slots=passes,
                                         describe_pairs=passes, window_sample_pair=0,
                                         blur_fused=chip_smoke._blur_count(cfg))
        want = call(images, cfg, "separable")
        got, want = (r[0] if isinstance(r, tuple) else r for r in (got, want))
        assert int(want.valid.sum()) > 10
        for field in dataclasses.fields(want):
            assert torch.equal(getattr(got, field.name), getattr(want, field.name)), field.name
    with pytest.raises(ValueError, match="float64"):
        port.detect_batched(images.double(), cfg, "pallas")


def test_per_trio_slam_on_card_equals_the_tap_loop(device):
    """``run_slam_from_images(blur="cuda")``: 16 K3 launches per frontend
    chunk at 3 octaves × 3 scales, and the trajectory of ``"separable"``."""
    from sift_scale_space_extrema_detection_tpu_torch.utils.synthetic import (
        render_blob_image,
        textured_blob_field,
    )

    rng = np.random.default_rng(12)
    k_mat = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
    rpts, amps, ss = textured_blob_field(rng, rng.uniform([-3.5, -1.8, 4.0], [3.5, 1.8, 9.0],
                                                          size=(110, 3)))
    frames = np.stack([
        render_blob_image(rpts, np.eye(3), -np.array([0.28 * f, 0.02 * f, 0.0]), k_mat, (320, 240),
                          amplitudes=amps, sigma_scales=ss, rng=np.random.default_rng(100 + f))
        for f in range(8)
    ])
    sift_cfg = port.SiftConfig(num_octaves=3, max_keypoints_per_trio=256)
    slam_cfg = port.SlamConfig(ba_interval=3, ba_window=6, bootstrap_baseline=2)
    before = launch_counts()
    got = port.run_slam_from_images(frames, k_mat, sift_cfg, slam_cfg, blur="cuda",
                                    frontend_chunk=4)
    per_chunk = chip_smoke._blur_count(sift_cfg)
    assert _launched(before) == dict(fused_octave=0, orient_slots=2, describe_pairs=2,
                                     window_sample_pair=0, blur_fused=2 * per_chunk)
    want = port.run_slam_from_images(frames, k_mat, sift_cfg, slam_cfg, blur="separable",
                                     frontend_chunk=4)
    assert np.isfinite(got.translations).all()
    np.testing.assert_array_equal(got.rotations, want.rotations)
    np.testing.assert_array_equal(got.translations, want.translations)


@pytest.mark.parametrize("flag", ["unified_refine", "refine_tail_pool"])
def test_pooled_refinement_on_card_matches_cpu(device, flag):
    """The pooled refinement on white-noise DoGs, where its pool and ladder
    overflow: the card's result is the CPU's, and a rerun's bits."""
    rng = np.random.default_rng(3)
    dogs = [torch.from_numpy((0.03 * rng.standard_normal((2, 5, h, w))).astype(np.float32))
            for h, w in ((64, 96), (32, 48), (16, 24))]
    cfg = port.SiftConfig(num_octaves=3, max_keypoints_per_trio=256, **{flag: True})
    want, _ = port.detect_from_dog(dogs, cfg)
    per_octave, _ = port.detect_from_dog(dogs, dataclasses.replace(cfg, **{flag: False}))
    assert not torch.equal(want.reject_reason, per_octave.reject_reason)
    card = [d.to(device) for d in dogs]
    got, _ = port.detect_from_dog(card, cfg)
    again, _ = port.detect_from_dog(card, cfg)
    for field in ("valid", "reject_reason", "octave", "scale_level", "local_y", "local_x"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field
        assert torch.equal(getattr(got, field), getattr(again, field)), field
    v = want.valid
    torch.testing.assert_close(got.abs_x.cpu()[v], want.abs_x[v], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.abs_y.cpu()[v], want.abs_y[v], rtol=1e-5, atol=1e-5)
    for field in ("abs_x", "abs_y", "abs_sigma", "value"):
        assert torch.equal(getattr(got, field), getattr(again, field)), field


# --- the refinement kernel against its plain version --------------------------


def _card_frames(seed, b, h, w, device):
    """``(b, h, w)`` float32 frames of :func:`_blob_images`' kind, made on
    the card (a batch of 64 VGA frames takes minutes in numpy)."""
    rng = np.random.default_rng(seed)
    cy, cx, r, a = (
        torch.tensor(v, dtype=torch.float32, device=device)[:, :, None, None]
        for v in (rng.uniform(8, h - 8, (b, 60)), rng.uniform(8, w - 8, (b, 60)),
                  rng.uniform(1.5, 5.0, (b, 60)), rng.uniform(-0.35, 0.35, (b, 60)))
    )
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    img = (0.5 + 0.1 * torch.sin(xx / 6.0) * torch.cos(yy / 8.0)).expand(b, h, w).clone()
    for k in range(60):
        img += a[:, k] * torch.exp(-((yy - cy[:, k]) ** 2 + (xx - cx[:, k]) ** 2)
                                   / (2 * r[:, k] * r[:, k]))
    return img.clamp(0.0, 1.0)


def _ladder_case(kind, seed, b, depth, planes, invalid_rows=()):
    """DoGs ``(b, depth, h, w)`` and ``n`` candidates an image for each
    ``(h, w, n)`` of ``planes``, 90 % valid but ``invalid_rows``, as numpy.
    ``noise``: white noise. ``overflow``: ``1e3 e^(-0.7 x)`` times a bowl
    in scale and row, so every Newton step moves one column and no slot
    converges or leaves: every cap of the ladder fills. ``wild``: noise
    scaled by 10^U(-12, 0) point by point, a third of the rows flat:
    singular and near-singular Hessians, steps past the int32 range."""
    rng = np.random.default_rng(seed)
    dogs, fields = [], []
    for h, w, n in planes:
        s = rng.integers(1, depth - 1, (b, n))
        y = rng.integers(1, h - 1, (b, n))
        x = rng.integers(1, w - 1, (b, n))
        if kind == "overflow":
            ss = np.arange(depth)[:, None, None]
            yy, xx = np.mgrid[0:h, 0:w]
            bowl = 1 + 0.3 * (ss - depth // 2) ** 2 + 0.3 * (yy - h // 2) ** 2
            noise = 1 + 1e-3 * rng.standard_normal((b, depth, h, w))
            dog = 1e3 * np.exp(-0.7 * xx) * bowl * noise
            s = rng.integers(2, depth - 2, (b, n))
            y = rng.integers(h // 2 - 3, h // 2 + 4, (b, n))
            x = rng.integers(1, 13, (b, n))
        else:
            dog = 0.1 * rng.standard_normal((b, depth, h, w))
        if kind == "wild":
            dog *= 10.0 ** rng.uniform(-12, 0, dog.shape)
            dog[:, :, rng.random(h) < 1 / 3] = 0.0
            # The first slots on a grid of cubes with g = (0, 0, ±1) and H =
            # [[2, 0, δ], [0, 2, 0], [δ, 0, 0]], δ = 2^-20: det = -2δ², so
            # the step is ±2^41 columns, past the int32 range both ways.
            gy, gx = np.mgrid[2:h - 2:3, 2:w - 2:3]
            k = min(n // 4, gy.size)
            s[:, :k], y[:, :k], x[:, :k] = 2, gy.ravel()[:k], gx.ravel()[:k]
            for r in range(b):
                for i in range(k):
                    cube = dog[r, 1:4, y[r, i] - 1:y[r, i] + 2, x[r, i] - 1:x[r, i] + 2]
                    cube[...] = 0.0
                    cube[0, 1, 1] = cube[2, 1, 1] = cube[1, 0, 1] = cube[1, 2, 1] = 1.0
                    cube[1, 1, 2], cube[1, 1, 0] = (-1.0) ** i, -((-1.0) ** i)
                    cube[2, 1, 2] = 4 * 2.0**-20
        dog = dog.astype(np.float32)
        valid = rng.random((b, n)) < 0.9
        valid[list(invalid_rows)] = False
        counts = np.zeros((b, 5), np.int32)
        dogs.append(dog)
        fields.append(dict(y=y.astype(np.int32), x=x.astype(np.int32),
                           scale_level=s.astype(np.int32),
                           value=dog[np.arange(b)[:, None], s, y, x], valid=valid,
                           num_candidates=counts, num_low_contrast=counts))
    return dogs, fields


def _largest_first_step(dog, f):
    """The largest ``|α|`` of Newton step 1 over the valid slots whose
    Hessian is not singular, in float64 from the candidates' cubes."""
    b = np.arange(dog.shape[0])[:, None]
    s, y, x = f["scale_level"], f["y"], f["x"]

    def v(ds, dy, dx):
        return dog[b, s + ds, y + dy, x + dx].astype(np.float64)

    c = v(0, 0, 0)
    g = np.stack([v(1, 0, 0) - v(-1, 0, 0), v(0, 1, 0) - v(0, -1, 0),
                  v(0, 0, 1) - v(0, 0, -1)], -1) / 2
    d = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
    hess = np.empty(c.shape + (3, 3))
    for i in range(3):
        for j in range(3):
            if i == j:
                hess[..., i, i] = v(*d[i]) + v(*(-k for k in d[i])) - 2 * c
            else:
                p = np.add(d[i], d[j])
                q = np.subtract(d[i], d[j])
                hess[..., i, j] = (v(*p) - v(*q) - v(*(-q)) + v(*(-p))) / 4
    ok = f["valid"] & (np.abs(np.linalg.det(hess)) >= 2.0**-52)
    alpha = -np.linalg.solve(hess[ok], g[ok][..., None])[..., 0]
    return np.abs(alpha).max()


# (kind, batch, scales per octave, planes (h, w, n) or the frame size,
# pool, rows left without a valid candidate): the benchmark's TUM and KITTI
# batches at their configurations, every octave (octave 0 960x1280 with
# 1,280 slots, 768x2560 with 768), at 64 and at one image; a ragged plane
# with a row of 300 slots, no multiple of the block; a ladder that fills
# every cap; singular, near-singular and huge steps; rows with no valid
# candidate; a pool of three octaves whose pool cap lies below its 1,050
# slots.
REFINE_CASES = {
    "tum-b64": ("frames", 64, 5, (480, 640), False, ()),
    "tum-b1": ("frames", 1, 5, (480, 640), False, ()),
    "kitti-b64": ("frames", 64, 3, (384, 1280), False, ()),
    "kitti-b1": ("frames", 1, 3, (384, 1280), False, ()),
    "ragged": ("noise", 3, 5, [(33, 47, 300)], False, ()),
    "overflow": ("overflow", 2, 5, [(24, 32, 1000)], False, ()),
    "wild": ("wild", 4, 3, [(40, 56, 700)], False, ()),
    "invalid-rows": ("noise", 6, 3, [(30, 40, 200)], False, (0, 2, 5)),
    "pool": ("noise", 3, 5, [(64, 96, 600), (32, 48, 300), (16, 24, 150)], True, (1,)),
}


@pytest.mark.parametrize("case", list(REFINE_CASES))
def test_refinement_kernel_matches_plain_version_bit_for_bit(device, case):
    """Every output field and each row's live count a step: the kernel's
    and the tensor code's on the card, equal to the bit."""
    kind, b, spo, shape, pooled, invalid_rows = REFINE_CASES[case]
    cfg = port.SiftConfig(num_octaves=4, scales_per_octave=spo, max_keypoints_per_trio=512)
    if kind == "frames":
        images = _card_frames(7, b, *shape, device)
        dogs, masks, _ = _pyramid(images, cfg, "fused", emit_scales=False)
        _, selected = _select_candidates(dogs, cfg, masks)
        runs = [([d], [e], o, None) for o, (d, e) in enumerate(zip(dogs, selected))]
    else:
        planes, fields = _ladder_case(kind, 11, b, cfg.dog_per_octave, shape, invalid_rows)
        dogs = [torch.from_numpy(d).to(device) for d in planes]
        selected = [Extrema(**{k: torch.from_numpy(v).to(device) for k, v in f.items()})
                    for f in fields]
        n = sum(e.y.shape[-1] for e in selected)
        runs = [(dogs, selected, 1, refine._pool_cap(cfg, n) if pooled else None)]
    reasons = torch.zeros(7, dtype=torch.int64, device=device)
    for run_dogs, run_sel, first, pool_cap in runs:
        n = sum(e.y.shape[-1] for e in run_sel)
        caps = refine._kernel_caps(cfg, n, pool_cap)
        geometry = [refine._octave_geometry(first + i, cfg) for i in range(len(run_dogs))]
        before = launch_counts()
        got, live = refine_kernel.newton_ladder(run_dogs, run_sel, first, cfg, caps, geometry)
        torch.cuda.synchronize()
        assert launches_since(before)["newton_ladder"] == 1
        with tracing(spans=False, counters=True) as session:
            want = refine.newton_ladder_reference(run_dogs, run_sel, first, cfg, pool_cap)
        for field in dataclasses.fields(want):
            g, w = getattr(got, field.name), getattr(want, field.name)
            assert g.dtype == w.dtype and g.shape == w.shape, field.name
            assert torch.equal(g, w), field.name
        last = first + len(run_dogs) - 1
        tag = f"o{first}" if first == last else f"o{first}-{last}"
        want_live = [int(session.counters[f"refine.slots_live.{tag}.s{i + 1}"])
                     for i in range(len(caps))]
        assert live.sum(0).tolist() == want_live
        if len(run_dogs) == 1 and pool_cap is None:  # the public route: the kernel
            routed = refine.refine_keypoints(run_dogs[0], run_sel[0], first, cfg)
            assert launches_since(before)["newton_ladder"] == 2
            assert torch.equal(routed.reject_reason, want.reject_reason)
        reasons += torch.bincount(want.reject_reason.flatten() + 1, minlength=7)
        caps = torch.tensor(caps, device=device)
        assert (live <= caps).all()
    reasons = reasons.tolist()  # counts of -1 (no candidate), 0 (accepted), ..., 5
    if kind == "frames":
        assert reasons[1] > 0  # accepted
    if kind == "overflow":
        assert (live[:, 1:] == caps[1:]).all(dim=1).any()
    if kind == "wild":
        assert reasons[4] > 0 and reasons[6] > 0  # left the interior, singular
        assert _largest_first_step(planes[0], fields[0]) > 2.0**31
    if invalid_rows:
        rows = list(invalid_rows)
        assert (got.reject_reason[rows] == -1).all() and (live[rows] == 0).all()
    if pooled:
        assert (live[:, 0] == caps[0]).any() and caps[0] < got.valid.shape[1]


def test_the_kernel_route_casts_the_candidates_as_the_tensor_code_does(device):
    """Candidates whose positions are int64, whose values are float64 and
    whose valid flags are uint8 refine on the card through the kernel to
    what the tensor code gives them (which casts them itself)."""
    planes, fields = _ladder_case("noise", 5, 3, 8, [(40, 56, 300)])
    dog = torch.from_numpy(planes[0]).to(device)
    extrema = Extrema(**{k: torch.from_numpy(v).to(device) for k, v in fields[0].items()})
    wide = dataclasses.replace(
        extrema, y=extrema.y.long(), x=extrema.x.long(), scale_level=extrema.scale_level.long(),
        value=extrema.value.double(), valid=extrema.valid.to(torch.uint8),
    )
    cfg = port.SiftConfig(num_octaves=4, scales_per_octave=5, max_keypoints_per_trio=512)
    before = launch_counts()
    got = refine.refine_keypoints(dog, wide, 1, cfg)
    torch.cuda.synchronize()
    assert launches_since(before)["newton_ladder"] == 1
    want = refine.newton_ladder_reference([dog], [wide], 1, cfg)
    narrow = refine.refine_keypoints(dog, extrema, 1, cfg)
    assert torch.equal(want.reject_reason, narrow.reject_reason)
    assert (want.reject_reason >= 0).any()
    for field in dataclasses.fields(want):
        assert torch.equal(getattr(got, field.name), getattr(want, field.name)), field.name


# --- the selection kernels against their plain version ------------------------


def _code_plane(seed, b, n_trios, h, w, device, density=0.01, fill=None, top_twos=False):
    """A packed plane ``(b, h, w)`` of random 2-bit codes (1 and 2, a few
    3s, which count as neither) and a float32 DoG ``(b, T + 2, h, w)`` of
    noise, on the card. ``fill=1`` sets code 1 in every trio of every
    interior pixel, ``fill=0`` leaves the plane empty; ``top_twos`` sets
    code 2 on a tenth of the top trio's pixels, which makes the words
    negative."""
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((b, n_trios, h, w), generator=gen, device=device)
    codes = ((u < density).long() + (u < 0.4 * density).long()
             + (u < 0.05 * density).long())  # 1, then 2, then 3
    if fill is not None:
        codes.zero_()
        if fill == 1 and h > 2 and w > 2:
            codes[..., 1:-1, 1:-1] = 1
    if top_twos:
        codes[:, -1] = torch.where(u[:, -1] > 0.9, 2, codes[:, -1])
    shifts = 2 * torch.arange(n_trios, device=device)[:, None, None]
    word = (codes << shifts).sum(1)
    bits = 16 if n_trios <= 8 else 32
    word = torch.where(word >= 2 ** (bits - 1), word - 2**bits, word)
    dtype = torch.int16 if bits == 16 else torch.int32
    dog = torch.randn((b, n_trios + 2, h, w), generator=gen, device=device)
    return word.to(dtype), dog


def _photo_cfg():
    path = pathlib.Path(__file__).resolve().parents[1] / "port_bench/configs/colmap-3200.json"
    return port.SiftConfig(**json.loads(path.read_text())["sift"])


# (kind, batch, trios or scales, frame or plane size, extra): the benchmark
# cells' batches through the real pyramid, every octave, at 64 frames and at
# one (tum 480x640 at 5 scales, kitti 384x1280 at 3, the photo cell at
# COLMAP's settings, whose 16-photo octave-0 DoG holds 2.18 G elements);
# odd planes; an empty plane and one whose every interior pixel is a
# candidate; int16 at 8 trios and int32 at 9 and 16 with code 2 in the top
# trio (negative words).
SELECT_CASES = {
    "tum-b64": ("frames", 64, 5, (480, 640), None),
    "tum-b1": ("frames", 1, 5, (480, 640), None),
    "kitti-b64": ("frames", 64, 3, (384, 1280), None),
    "kitti-b1": ("frames", 1, 3, (384, 1280), None),
    "photo-b1": ("photo", 1, 3, (2133, 3200), None),
    "photo-b16": ("photo", 16, 3, (2133, 3200), None),
    "odd-3x3": ("codes", 2, 3, (3, 3), dict(density=0.5)),
    "odd-5x7": ("codes", 3, 5, (5, 7), dict(density=0.3)),
    "odd-2133x3200": ("codes", 2, 3, (2133, 3200), dict(density=1e-3)),
    "empty": ("codes", 4, 5, (480, 640), dict(fill=0)),
    "all-interior": ("codes", 2, 5, (96, 128), dict(fill=1)),
    "int16-8-trios": ("codes", 3, 8, (100, 150), dict(top_twos=True)),
    "int32-9-trios": ("codes", 3, 9, (100, 150), dict(top_twos=True)),
    "int32-16-trios": ("codes", 2, 16, (64, 96), dict(top_twos=True)),
}


@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_selection_kernel_matches_plain_version_bit_for_bit(device, case):
    """Every Extrema field and both uncapped counters of the kernels and
    of the tensor code on the card, equal to the bit, at the refinement
    capacity (frames), at capacity 1, below each image's total, at the
    largest total and far above it (parking); then the public route."""
    kind, b, trios, (h, w), extra = SELECT_CASES[case]
    if kind == "codes":
        cfg = port.SiftConfig(scales_per_octave=trios)
        packed, dog = _code_plane(13, b, trios, h, w, device, **extra)
        planes = [(packed, dog, None)]
    else:
        cfg = _photo_cfg() if kind == "photo" else port.SiftConfig(
            num_octaves=4, scales_per_octave=trios, max_keypoints_per_trio=512)
        dogs, masks, _ = _pyramid(_card_frames(7, b, h, w, device), cfg, "fused",
                                  emit_scales=False)
        planes = [(m, d, cfg.refine_capacity(o)) for o, (d, m) in enumerate(zip(dogs, masks))]
        if b == 16:
            assert dogs[0].numel() > 2**31
    seen_total = 0
    for packed, dog, refine_cap in planes:
        totals = select_refine_candidates_reference(packed, dog, cfg, 1).num_candidates.sum(-1)
        most = int(totals.max())
        seen_total += most
        capacities = {1, max(1, int(totals.min()) // 2), max(most, 1), 4 * most + 64}
        if refine_cap is not None:
            capacities.add(refine_cap)
        for capacity in sorted(capacities):
            before = launch_counts()
            got = select_kernel.select_candidates(packed, dog, capacity)
            torch.cuda.synchronize()
            assert launches_since(before)["select_candidates"] == 1
            want = select_refine_candidates_reference(packed, dog, cfg, capacity)
            for field in dataclasses.fields(want):
                g, wv = getattr(got, field.name), getattr(want, field.name)
                assert g.dtype == wv.dtype and g.shape == wv.shape, (field.name, capacity)
                assert torch.equal(g, wv), (field.name, capacity)
            del got, want
        with tracing(spans=False, counters=True) as session:
            routed = select_refine_candidates(packed, dog, cfg, 4 * most + 64)
        assert session.counters == {"select.route.kernel": 1}
        assert torch.equal(routed.num_candidates.sum(-1), totals)
    if case == "empty":
        assert seen_total == 0
    elif case == "all-interior":
        assert seen_total == trios * (h - 2) * (w - 2)
    else:
        assert seen_total > 0


def test_the_references_orbax_ba_state_restores_onto_the_card(device):
    """The JAX package's orbax ``BAState`` fixture, read by the port's own
    zstd/OCDBT/zarr readers into a template on the card: leaves on
    ``cuda:0``, equal to its npz twin."""
    from pathlib import Path

    from sift_scale_space_extrema_detection_tpu_torch.sfm.ba import BAState
    from sift_scale_space_extrema_detection_tpu_torch.utils import checkpoint

    fixture = Path(__file__).resolve().parent / "fixtures" / "jax_orbax"
    shapes = {k: v.shape for k, v in
              checkpoint.restore_checkpoint_flat(str(fixture / "ba" / "state")).items()}
    like = BAState(**{k: torch.zeros(s, device=device) for k, s in shapes.items()})
    got = checkpoint.restore_checkpoint(str(fixture / "ba" / "state"), like)
    want = checkpoint.restore_checkpoint(str(fixture / "ba_npz" / "state"), like)
    for name in shapes:
        leaf = getattr(got, name)
        assert leaf.device == device and leaf.dtype == torch.float32, name
        assert torch.equal(leaf, getattr(want, name)), name


# --- the card's probes (K4-K7, csrc/probes.cu) ----------------------------


# The write's and the copy's edges: a block of 256 float4s a stretch, so 4
# elements, one stretch and 16 bytes, a count of stretches that does not
# divide among 132 multiprocessors × 8 resident blocks, and a view 16 bytes
# into its buffer (taken, and read too).
STRETCH = 256 * 4


@pytest.mark.parametrize(
    "rows, cols, offset",
    [(128, 128, 0), (384, 4096, 0), (256, 640, 0), (1, 4, 0), (1, STRETCH + 4, 0),
     (1, (132 * 8 * 3 + 5) * STRETCH + 4, 0), (128, 128, 4)],
)
def test_memory_probes_match_their_plain_versions_bit_for_bit(device, rows, cols, offset):
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import probes

    base = torch.from_numpy(
        np.random.default_rng(rows + cols).standard_normal(offset + rows * cols).astype(np.float32)
    ).to(device)
    x = base[offset:].view(rows, cols)
    readable = rows % 128 == 0 and cols % 128 == 0
    before = launch_counts()
    # Each output where a buffer of NaN was just freed, so an element the
    # kernel missed cannot hold a value left there by an earlier output.
    wrote = chip_smoke._on_poison(torch, rows * cols, device, lambda: probes.probe_write(rows, cols, device))
    copied = chip_smoke._on_poison(torch, rows * cols, device, lambda: probes.probe_copy(x))
    read = probes.probe_read(x) if readable else None
    torch.cuda.synchronize()
    assert _launched(before, ("probe_write", "probe_copy", "probe_read")) == dict(
        probe_write=1, probe_copy=1, probe_read=int(readable))
    assert wrote.device == device
    assert torch.equal(wrote, probes.probe_write_reference(rows, cols, device))
    assert torch.equal(copied, x)
    if readable:
        assert read.shape == (8, 128)
        assert torch.equal(read, probes.probe_read_reference(x))


def test_probes_refuse_a_view_off_their_access_boundary_on_the_card(device):
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import probes

    base = torch.ones(1 + 128 * 128, device=device)
    before = launch_counts()
    with pytest.raises(ValueError):
        probes.probe_copy(base[1:9])
    with pytest.raises(ValueError):
        probes.probe_read(base[1:].view(128, 128))
    with pytest.raises(ValueError):
        probes.tap_chain(base[1 : 1 + 14 * 4].view(14, 4), probes.probe_taps().to(device), "bf16_full")
    torch.cuda.synchronize()
    assert not launches_since(before)


@pytest.mark.parametrize("rows, width", [(16, 128), (5, 6), (256, 1024), (3, 1000)])
@pytest.mark.parametrize("mode", ["f32", "bf16_carry", "bf16_full", "bf16_pair"])
def test_tap_chain_kernel_matches_its_plain_version(device, mode, rows, width):
    from sift_scale_space_extrema_detection_tpu_torch.benchmarks.tap_probe import probe_input
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import probes

    x = probe_input(rows, width, seed=rows).to(device)
    taps = probes.probe_taps().to(device)
    before = launch_counts()
    got = probes.tap_chain(x, taps, mode)
    torch.cuda.synchronize()
    assert launches_since(before)["tap_chain"] == 1
    want = probes.tap_chain_reference(x, taps, mode)
    err = (got.double() - want.double()).abs()
    assert bool((err <= chip_smoke.tap_tolerance(torch, x, taps, mode)).all()), err.max().item()
    if mode == "f32":
        assert torch.equal(got, want)


def test_probes_refuse_a_mixed_device_or_odd_shape_on_the_card(device):
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import probes

    x = torch.ones((14, 4), device=device)
    with pytest.raises(ValueError):
        probes.tap_chain(x, probes.probe_taps(), "f32")  # taps on the CPU
    with pytest.raises(ValueError):
        probes.probe_read(torch.ones((100, 128), device=device))


def test_probe_entry_points_run_on_the_card(device, capsys):
    import json

    from sift_scale_space_extrema_detection_tpu_torch.benchmarks import bw_probe, tap_probe

    assert bw_probe.main(["--gb", "0.01", "--iters", "2"]) == 0
    assert tap_probe.main(["--rows", "32", "--width", "256", "--iters", "2"]) == 0
    bw, tap = (json.loads(line) for line in capsys.readouterr().out.strip().splitlines())
    assert bw["platform"] == "gpu" and bw["pl_copy_gb_s"] > 0 and bw["smi"]
    assert tap["platform"] == "gpu" and tap["f32"]["ms"] > 0 and "max_rel_err" in tap["bf16_pair"]
