"""The ranked per-image feature budget (``ops/budget.py``,
``describe_compact(max_features=...)``) against plain full sorts and the
benchmark's plain reference (``port_bench/reference/budget.py``), the
describe pass's capacity counters, and the CLI's ``--max-features``."""

import copy
import time

import numpy as np
import pytest
import torch

import sift_scale_space_extrema_detection_tpu_torch as port
from port_bench import compare, spec
from port_bench.reference import budget as ref_budget
from port_bench.reference import config as ref_config
from port_bench.reference import descriptor as ref_descriptor
from port_bench.reference import kp_types as ref_types
from port_bench.run import measure
from sift_scale_space_extrema_detection_tpu_torch.cli import main as cli_main
from sift_scale_space_extrema_detection_tpu_torch.core.image import write_png
from sift_scale_space_extrema_detection_tpu_torch.models import frontend as fe
from sift_scale_space_extrema_detection_tpu_torch.ops.budget import budget_capacity, keep_strongest
from sift_scale_space_extrema_detection_tpu_torch.ops.descriptor import describe_compact
from sift_scale_space_extrema_detection_tpu_torch.utils.profile import tracing

torch.set_num_threads(2)

FIELDS = ("octave", "scale_level", "abs_y", "abs_x", "abs_sigma", "theta", "descriptor")


def _strengths(case: str):
    """``(strength, valid, n)`` ``(B, 12)`` of a named case."""
    g = torch.Generator().manual_seed(3)
    strength = torch.rand(3, 12, generator=g)
    valid = torch.ones(3, 12, dtype=torch.bool)
    n = 5
    if case == "ties_at_boundary":
        # Image 0: the 5th largest appears three times; image 1: two pairs of
        # one keypoint share its response; image 2: every response equal.
        strength[0] = torch.tensor([9, 8, 7, 6, 5, 5, 5, 1, 2, 3, 0.5, 0.25])
        strength[1, 4] = strength[1, 5] = strength[1].sort(descending=True).values[4]
        strength[2] = 0.5
    elif case == "budget_above_count":
        n = 40
    elif case == "uneven_images":
        valid[0, 7:] = False
        valid[1, ::2] = False
        valid[2, 3:] = False
    elif case == "empty_image":
        valid[1] = False
    return strength, valid, n


@pytest.mark.parametrize("case", ["ties_at_boundary", "budget_above_count", "uneven_images",
                                  "empty_image"])
def test_keep_strongest_against_a_plain_sort(case):
    strength, valid, n = _strengths(case)
    with tracing(spans=False, counters=True) as session:
        keep = keep_strongest(strength, valid, n)
    want = torch.zeros_like(valid)
    for b in range(valid.shape[0]):
        own = torch.nonzero(valid[b]).squeeze(1)
        want[b, own] = ref_budget.strongest(strength[b, own], n)
    assert torch.equal(keep, want)
    ranked, kept = valid.sum(-1), keep.sum(-1)
    assert bool((kept >= ranked.clamp(max=n)).all())
    c = session.counters
    assert c["budget.pairs_ranked"] == int(ranked.sum())
    assert c["budget.pairs_kept"] == int(kept.sum())
    assert c["budget.ties_kept"] == int((kept - ranked.clamp(max=n)).sum())
    assert c["budget.images_bound"] == int((ranked > n).sum())
    if case == "ties_at_boundary":
        assert kept.tolist() == [7, 6, 12] and c["budget.ties_kept"] == 10


def test_keep_strongest_refuses_an_empty_budget():
    strength, valid, _ = _strengths("uneven_images")
    with pytest.raises(ValueError, match="at least 1"):
        keep_strongest(strength, valid, 0)


def test_budget_capacity_leaves_room_for_ties():
    assert budget_capacity(8192, 10**6) == 8192 + 128
    assert budget_capacity(100, 10**6) == 164
    assert budget_capacity(100, 120) == 120


def _frames(seed=0, b=2, h=96, w=128):
    g = torch.Generator().manual_seed(seed)
    imgs = torch.rand(b, h, w, generator=g)
    return torch.nn.functional.avg_pool2d(imgs[:, None], 3, 1, 1)[:, 0]


@pytest.mark.parametrize("n,upright", [(100, False), (150, False), (100, True)],
                         ids=["binds", "binds_with_ties", "upright"])
def test_budgeted_frontend_matches_the_plain_reference(n, upright):
    fields = dict(num_octaves=3, upright=upright)
    images = _frames()
    with tracing(spans=False, counters=True) as session:
        got = port.detect_and_describe_batched(images, port.SiftConfig(**fields), device="cpu",
                                               max_features=n)
    cfg = ref_config.SiftConfig(**fields)
    want = ref_budget.detect_and_describe_batched(images, cfg, "fused", n)
    assert session.counters["budget.images_bound"] == 2
    assert bool((got.valid.sum(-1) >= n).all())
    gaps = compare.gaps(compare.fields(got), compare.fields(want), cfg)
    assert gaps["unmatched_share"] == 0.0 and gaps["reference_slots"] > 0
    assert all(v <= 1e-4 for k, v in gaps.items() if k not in ("unmatched_share",
                                                                "reference_slots"))
    # Both sides keep their pairs in (octave, slot, orientation) order: slot
    # by slot, the same keypoints (the reference's blur is another order of
    # the same sums).
    assert torch.equal(got.valid.sum(-1), want.valid.sum(-1))
    for k in FIELDS:
        a, b = getattr(got, k)[got.valid], getattr(want, k)[want.valid]
        if k in ("octave", "scale_level"):
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, atol=1e-2 if k == "descriptor" else 1e-3, rtol=0)


def _described_inputs(fields, images):
    cfg = port.SiftConfig(**fields)
    dogs, masks, stacks = fe._pyramid(images, cfg, "fused", emit_scales=True)
    _, selected = fe._select_candidates(dogs, cfg, masks)
    return cfg, stacks, fe._refine_per_octave(dogs, selected, cfg)


@pytest.mark.parametrize("upright", [False, True], ids=["oriented", "upright"])
def test_no_budget_is_the_frozen_describe_pass_bit_for_bit(upright):
    """``max_features=None`` computes what the frozen copy of the describe
    pass (``port_bench/reference/descriptor.py``, taken before the budget
    existed) computes from the same stacks and keypoints."""
    fields = dict(num_octaves=3, upright=upright)
    cfg, stacks, keypoints = _described_inputs(fields, _frames(1))
    got = describe_compact(stacks, keypoints, cfg, max_features=None)
    want = ref_descriptor.describe_compact(
        stacks, [ref_types.Keypoints(**vars(k)) for k in keypoints],
        ref_config.SiftConfig(**fields))
    for k in FIELDS + ("valid",):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def test_a_budget_above_every_count_keeps_every_pair_bit_for_bit():
    cfg, stacks, keypoints = _described_inputs(dict(num_octaves=3), _frames(2))
    every = describe_compact(stacks, keypoints, cfg)
    with tracing(spans=False, counters=True) as session:
        budgeted = describe_compact(stacks, keypoints, cfg, max_features=10**4)
    assert session.counters["budget.images_bound"] == 0
    assert torch.equal(every.valid.sum(-1), budgeted.valid.sum(-1))
    for k in FIELDS:
        assert torch.equal(getattr(every, k)[every.valid], getattr(budgeted, k)[budgeted.valid])


@pytest.mark.parametrize("capacities,name", [
    (dict(describe_compaction=0.01), "describe.keypoints_over_capacity"),
    (dict(descriptor_pair_compaction=0.01), "describe.pairs_over_capacity"),
], ids=["keypoints", "pairs"])
def test_describe_counts_what_its_capacities_drop(capacities, name):
    fields = dict(num_octaves=3, max_keypoints_per_trio=256, **capacities)
    cfg, stacks, keypoints = _described_inputs(fields, _frames(3))
    with tracing(spans=False, counters=True) as session:
        out = describe_compact(stacks, keypoints, cfg)
    counters = session.counters
    valid = torch.cat([k.valid for k in keypoints], -1).sum(-1)
    if name == "describe.keypoints_over_capacity":
        want = (valid - cfg.describe_capacity()).clamp(min=0).sum()
        assert int(want) > 0 and counters[name] == int(want)
        assert counters["describe.pairs_over_capacity"] == 0
    else:
        assert counters["describe.keypoints_over_capacity"] == 0
        assert counters[name] > 0 and bool((out.valid.sum(-1) == cfg.descriptor_pair_capacity()).all())
    with tracing(spans=False, counters=False) as session:
        describe_compact(stacks, keypoints, cfg)
    assert session.counters == {}


def test_the_budget_needs_the_compacting_pass():
    cfg = port.SiftConfig(num_octaves=2, compact_describe=False)
    with pytest.raises(ValueError, match="compact_describe"):
        port.detect_and_describe_batched(_frames(), cfg, device="cpu", max_features=10)


def test_cli_max_features_keeps_the_strongest_pairs(tmp_path):
    rng = np.random.default_rng(4)
    image = np.clip(0.5 + 0.2 * rng.standard_normal((96, 128)), 0, 1)
    image = (255 * torch.nn.functional.avg_pool2d(torch.from_numpy(image)[None, None], 3, 1, 1)
             [0, 0].numpy()).round().astype(np.uint8)
    path = str(tmp_path / "in.png")
    write_png(path, image)
    runs = {}
    for flags in ((), ("--max-features", "40")):
        out = tmp_path / ("budget" if flags else "every")
        argv = [path, "-o", str(out), "--octaves", "3", "--descriptors", "--no-galleries",
                "--device", "cpu", *flags]
        assert cli_main(argv) == 0
        runs[bool(flags)] = np.load(out / "descriptors.npz")
    every, budgeted = runs[False], runs[True]
    assert 40 <= len(budgeted["theta"]) < len(every["theta"])
    rows = {tuple(r) for r in np.column_stack([every[k] for k in ("abs_x", "abs_y", "theta")])}
    assert {tuple(r) for r in np.column_stack(
        [budgeted[k] for k in ("abs_x", "abs_y", "theta")])} <= rows


def _tiny_photo_cell(width=128, height=97):
    cell = copy.deepcopy(spec.cell(spec.load_benchmark(), "colmap-3200.extract-b16"))
    config, traffic = cell["config"], cell["traffic"]
    config.update(width=width, height=height, intrinsics={
        "fx": 0.9 * width, "fy": 0.9 * width, "cx": width / 2, "cy": height / 2})
    config["sift"].update(num_octaves=3, max_keypoints_per_trio=256)
    traffic.update(batch=2, ring_batches=2, warmup_batches=1, trace_batches=2, max_features=60,
                   check_frames=1)
    traffic["scene"].update(landmarks_per_unit=22.857142857142858, blob_sigma=12.0)
    return cell


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
def test_the_photo_cell_runs_correct_on_the_cpu(trace):
    line = measure(_tiny_photo_cell(), 2**31 + 101, 0.2, trace, torch.device("cpu"),
                   time.perf_counter())
    assert line["correct"] is True and line["failed"] == 0
    r = line["readings"]
    assert r["budget.images_bound"] == r["images_per_batch"] == 2
    assert r["describe.keypoints_over_capacity"] == r["describe.pairs_over_capacity"] == 0
    assert r["budget.pairs_kept"] >= 2 * 60
    if trace:
        assert {"pyramid_ms", "select_ms", "refine_ms"} <= set(line["metrics"])
        assert "budget_ms" not in line["metrics"]  # no card: no device time


def test_the_budget_runs_in_its_span_inside_describe():
    from torch.profiler import ProfilerActivity, profile

    cfg, stacks, keypoints = _described_inputs(dict(num_octaves=2), _frames(5))
    with tracing(spans=True), profile(activities=[ProfilerActivity.CPU]) as prof:
        describe_compact(stacks, keypoints, cfg, max_features=20)
    spans = {e.name: e for e in prof.events() if e.name.startswith("sift.")}
    assert {"sift.describe", "sift.describe.orientation", "sift.describe.budget",
            "sift.describe.descriptor"} <= set(spans)
    outer, budget = spans["sift.describe"].time_range, spans["sift.describe.budget"].time_range
    assert outer.start <= budget.start and budget.end <= outer.end
