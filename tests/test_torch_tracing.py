"""The port's spans and counters (``utils/profile.py``) and where the
frontend puts them: off outside ``tracing()`` (one flag check, no op, no
launch, no host read), the same work with spans on as off, the ranges
nested as the layers call each other, and refinement's slot counters
against the candidates selection kept."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.models import frontend as fe
from sift_scale_space_extrema_detection_tpu_torch.ops import refine
from sift_scale_space_extrema_detection_tpu_torch.utils import profile as tracing_mod
from sift_scale_space_extrema_detection_tpu_torch.utils.profile import (
    NO_SPAN,
    count,
    counting,
    span,
    tracing,
)

torch.set_num_threads(2)

CFG = port.SiftConfig(num_octaves=2, max_keypoints_per_trio=64)
LAYERS = ("pyramid", "select", "refine", "describe")


def _frames(b=2, h=64, w=96, seed=3):
    """``(b, h, w)`` float32 frames in [0, 1]: a smooth pattern and blobs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for k in range(b):
        img = 0.5 + 0.1 * np.sin(xx / 6.0 + k) * np.cos(yy / 8.0)
        for _ in range(30):
            cy, cx, r = rng.uniform(6, h - 6), rng.uniform(6, w - 6), rng.uniform(1.5, 4.0)
            blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
            img += rng.uniform(-0.35, 0.35) * blob
        out.append(np.clip(img, 0.0, 1.0))
    return torch.from_numpy(np.stack(out).astype(np.float32))


def _events(fn):
    """``fn()`` under the CPU profiler: its result and the events, as
    ``(name, kind, start_ns, end_ns)`` in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted(
        (e.name(), e.activity_type(), e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
    )
    return out, sorted(events, key=lambda e: e[2])


def _ops(events):
    return [name for name, kind, _, _ in events if kind == "cpu_op"]


def _ranges(events, name):
    return [(a, b) for n, kind, a, b in events if n == f"sift.{name}" and kind == "user_annotation"]


def _inside(inner, outer):
    return all(any(a <= x and y <= b for a, b in outer) for x, y in inner)


def test_spans_are_off_outside_a_session():
    assert span("pyramid") is NO_SPAN and not counting()
    with tracing(spans=False, counters=True):
        assert span("pyramid") is NO_SPAN and counting()
    with tracing(spans=True) as session:
        assert span("pyramid") is not NO_SPAN and not counting()
    assert span("pyramid") is NO_SPAN and session.counters == {}


def test_a_counter_off_records_no_op():
    x = torch.arange(6)
    _, events = _events(lambda: [count("n", x.sum() if counting() else 0), count("n", x[0])])
    _, indexing = _events(lambda: x[0])
    assert _ops(events) == _ops(indexing) != []  # the caller's indexing, nothing of count()


def test_a_span_off_records_nothing():
    _, events = _events(lambda: [span("pyramid").__enter__(), NO_SPAN.__exit__(None, None, None)])
    assert events == []


def test_counters_total_host_numbers_and_device_tensors_at_the_end():
    x = torch.arange(5)
    with tracing(spans=False, counters=True) as session:
        count("a", 3)
        count("a", 4)
        count("b", x.sum())
        count("b", (x > 2).sum())
        count("c", torch.tensor(0.5))
        assert session.counters == {}  # filled when the block closes
    assert session.counters == {"a": 7, "b": 12, "c": 0.5}
    assert [type(v) for v in session.counters.values()] == [int, int, float]


def test_sessions_nest():
    with tracing(spans=False, counters=True) as outer:
        count("n", 1)
        with tracing(spans=True) as inner:
            count("n", 10)
            assert span("x") is not NO_SPAN
        assert span("x") is NO_SPAN and counting()
        count("n", 2)
    assert outer.counters == {"n": 3} and inner.counters == {}


@pytest.mark.parametrize("entry", ["detect_and_describe_batched", "detect_batched"])
def test_spans_on_record_the_same_ops_as_off(entry):
    images = _frames()
    call = getattr(port, entry)
    call(images, CFG, device="cpu")  # the first call makes the cached constants
    off_out, off = _events(lambda: call(images, CFG, device="cpu"))
    with tracing():
        on_out, on = _events(lambda: call(images, CFG, device="cpu"))
    assert _ops(on) == _ops(off)
    assert not any(n.startswith("sift.") for n, *_ in off)
    assert {k for n, k, *_ in on if n.startswith("sift.")} == {"user_annotation"}
    for a, b in zip(vars(off_out[0] if isinstance(off_out, tuple) else off_out).values(),
                    vars(on_out[0] if isinstance(on_out, tuple) else on_out).values()):
        assert torch.equal(a, b)


HOST_READS = ("aten::_local_scalar_dense", "aten::item", "aten::nonzero", "aten::tolist")


def test_counters_on_change_no_result_and_read_no_tensor_before_the_end():
    images = _frames()
    port.detect_and_describe_batched(images, CFG, device="cpu")
    want, off = _events(lambda: port.detect_and_describe_batched(images, CFG, device="cpu"))
    with tracing(spans=False, counters=True) as session:
        got, on = _events(lambda: port.detect_and_describe_batched(images, CFG, device="cpu"))
    for a, b in zip(vars(want).values(), vars(got).values()):
        assert torch.equal(a, b)
    reads = [[n for n in _ops(ev) if n in HOST_READS] for ev in (off, on)]
    assert reads[0] == reads[1]
    assert len(_ops(on)) > len(_ops(off))  # the counters' own sums, on the device
    assert session.counters


def test_frontend_ranges_nest_as_the_layers_call_each_other():
    images = _frames()
    with tracing():
        _, events = _events(lambda: port.detect_and_describe_batched(images, CFG, device="cpu"))
    frontend = _ranges(events, "frontend")
    assert len(frontend) == 1
    layers = [_ranges(events, name) for name in LAYERS]
    assert [len(r) for r in layers] == [1, 1, 1, 1]
    assert all(_inside(r, frontend) for r in layers)
    starts = [r[0][0] for r in layers]
    assert starts == sorted(starts)  # pyramid, select, refine, describe in turn
    for before, after in zip(layers, layers[1:]):
        assert before[0][1] <= after[0][0]  # one after the other, no overlap
    steps = _ranges(events, "refine.step")
    assert len(steps) == CFG.num_octaves * CFG.max_refine_iterations
    assert _inside(steps, _ranges(events, "refine"))
    for sub in ("describe.orientation", "describe.descriptor"):
        assert len(_ranges(events, sub)) == 1
        assert _inside(_ranges(events, sub), _ranges(events, "describe"))
    # every op of the batch's work lies in a layer, but the entry's own
    # conversion of the images
    ops = [(a, b) for n, k, a, b in events if k == "cpu_op"]
    outside = [o for o in ops
               if _inside([o], frontend) and not any(_inside([o], r) for r in layers)]
    assert len(outside) < 0.05 * len(ops)


def test_the_per_octave_describe_route_has_its_spans():
    images = _frames()
    cfg = port.SiftConfig(num_octaves=2, max_keypoints_per_trio=64, compact_describe=False)
    with tracing():
        _, events = _events(lambda: port.detect_and_describe_batched(images, cfg, device="cpu"))
    describe = _ranges(events, "describe")
    assert len(describe) == cfg.num_octaves
    for sub in ("describe.orientation", "describe.descriptor"):
        assert len(_ranges(events, sub)) == cfg.num_octaves
        assert _inside(_ranges(events, sub), describe)


@pytest.mark.parametrize("flags", [dict(unified_refine=True), dict(refine_tail_pool=True)])
def test_the_pooled_routes_refine_in_the_refine_span(flags):
    images = _frames()
    cfg = port.SiftConfig(num_octaves=3, max_keypoints_per_trio=64, **flags)
    with tracing(counters=True) as session:
        _, events = _events(lambda: port.detect_batched(images, cfg, device="cpu"))
    refine = _ranges(events, "refine")
    assert len(refine) == (1 if flags.get("unified_refine") else 2)
    assert _inside(_ranges(events, "refine.step"), refine)
    assert _inside(refine, _ranges(events, "frontend"))
    tags = {k.split(".")[2] for k in session.counters if k.startswith("refine.slots_")}
    assert tags == ({"o0-2"} if flags.get("unified_refine") else {"o0", "o1-2"})
    assert session.counters["refine.route.plain"] == len(refine)
    assert "refine.route.kernel" not in session.counters


def test_refine_counters_match_the_candidates_kept():
    images = _frames(b=3)
    dogs, masks, _ = fe._pyramid(images, CFG, "fused", emit_scales=False)
    _, selected = fe._select_candidates(dogs, CFG, masks)
    want = fe._refine_per_octave(dogs, selected, CFG)
    with tracing(spans=False, counters=True) as session:
        got = fe._refine_per_octave(dogs, selected, CFG)
    for a, b in zip(want, got):
        for x, y in zip(vars(a).values(), vars(b).values()):
            assert torch.equal(x, y)
    c = session.counters
    steps = range(1, CFG.max_refine_iterations + 1)
    assert c.pop("refine.route.plain") == CFG.num_octaves
    assert len(c) == 2 * CFG.num_octaves * len(steps)
    assert sum(c[f"refine.slots_live.o{o}.s1"] for o in range(CFG.num_octaves)) > 0
    for o, sel in enumerate(selected):
        assert c[f"refine.slots_live.o{o}.s1"] == int(sel.valid.sum())
        live = [c[f"refine.slots_live.o{o}.s{i}"] for i in steps]
        assert live == sorted(live, reverse=True)
        for i in steps:
            assert c[f"refine.slots_stepped.o{o}.s{i}"] == 3 * CFG.refine_capacity(o)


@pytest.mark.cuda
def test_the_kernel_route_counts_what_the_plain_route_counts():
    """On the card, float32 refinement takes the kernel once an octave and
    counts the stepped and live slots the tensor code counts there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    images = _frames(b=3).to("cuda")
    dogs, masks, _ = fe._pyramid(images, CFG, "fused", emit_scales=False)
    _, selected = fe._select_candidates(dogs, CFG, masks)
    with tracing(spans=False, counters=True) as plain:
        want = [refine.newton_ladder_reference([d], [e], o, CFG)
                for o, (d, e) in enumerate(zip(dogs, selected))]
    with tracing(spans=False, counters=True) as kernel:
        got = fe._refine_per_octave(dogs, selected, CFG)
    c = dict(kernel.counters)
    assert c.pop("refine.route.kernel") == CFG.num_octaves
    assert "refine.route.plain" not in c
    assert c == plain.counters
    assert sum(c[f"refine.slots_live.o{o}.s1"] for o in range(CFG.num_octaves)) > 0
    for a, b in zip(want, got):
        for x, y in zip(vars(a).values(), vars(b).values()):
            assert torch.equal(x, y)


def _select_routes(images) -> dict:
    """The selection route counters of one fused 4-octave detect batch."""
    cfg = port.SiftConfig(num_octaves=4, max_keypoints_per_trio=64)
    with tracing(spans=False, counters=True) as session:
        port.detect_batched(images, cfg, device=images.device)
    return {k: v for k, v in session.counters.items() if k.startswith("select.route.")}


def test_a_fused_batch_on_the_cpu_selects_on_the_plain_route():
    assert _select_routes(_frames(b=2)) == {"select.route.plain": 4}


@pytest.mark.cuda
def test_a_fused_batch_on_the_card_selects_on_the_kernel_route():
    """On the card each octave's packed plane goes to the selection
    kernels, once an octave, and none to the tensor code."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert _select_routes(_frames(b=2).to("cuda")) == {"select.route.kernel": 4}


def _describe_routes(images, entry) -> dict:
    """The describe route counters of one batch through ``entry``."""
    with tracing(spans=False, counters=True) as session:
        entry(images, CFG, device=images.device)
    return {k: v for k, v in session.counters.items() if k.startswith("describe.route.")}


@pytest.mark.parametrize("entry, want", [
    (port.detect_and_describe_batched, {"describe.route.plain": 2}),
    (port.detect_batched, {}),
])
def test_a_batch_on_the_cpu_describes_on_the_plain_route(entry, want):
    assert _describe_routes(_frames(b=2), entry) == want


@pytest.mark.cuda
@pytest.mark.parametrize("entry, want", [
    (port.detect_and_describe_batched, {"describe.route.kernel": 2}),
    (port.detect_batched, {}),
])
def test_a_batch_on_the_card_describes_on_the_kernel_route(entry, want):
    """On the card each describe stage goes to its kernel (R3, R4), once a
    batch, and none to the tensor code; detection alone describes nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert _describe_routes(_frames(b=2).to("cuda"), entry) == want


def test_the_session_state_is_back_off_after_an_error():
    with pytest.raises(RuntimeError):
        with tracing(counters=True):
            raise RuntimeError("inside")
    assert tracing_mod.span("x") is NO_SPAN and not counting()
