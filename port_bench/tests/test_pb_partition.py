"""The loop's partition by the program's spans (``partition.py``): on
synthetic traces, on a tiny cell on the CPU, and on the card."""

import time
from types import SimpleNamespace

import pytest
import torch

from port_bench import partition as pa
from port_bench.runners import frontend as runner

from .cells import CELLS, tiny_cell


class Event:
    """A stand-in for the profiler's ``_KinetoEvent`` (torch 2.13's, which
    says its activity type)."""

    def __init__(self, name, kind, start, end, corr=0, linked=0, thread=1):
        self._v = (name, kind, round(start * 1e9), round((end - start) * 1e9), corr, linked, thread)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]

    def device_type(self):
        on_card = self._v[1] in ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")
        return SimpleNamespace(name="CUDA" if on_card else "CPU")


class OldEvent(Event):
    """torch 2.11's ``_KinetoEvent``: no ``activity_type``."""

    def __getattribute__(self, name):
        if name == "activity_type":
            raise AttributeError(name)
        return super().__getattribute__(name)


FORMS = pytest.mark.parametrize("form", [Event, OldEvent], ids=["torch2.13", "torch2.11"])


def _events(form=Event, card_shift=0.0):
    """One batch: the window 0-10 s; pyramid 0-2, select 2-4, refine 4-8
    with two Newton steps, describe 8-9.5, all in ``sift.frontend``.
    The card runs refine's first kernel late, during no span of its own
    (5.0-6.5, launched at 4.2), and one select kernel overlaps it."""
    return [
        form("port_bench.loop", "user_annotation", 0.0, 10.0),
        form("sift.frontend", "user_annotation", 0.0, 9.5),
        form("sift.pyramid", "user_annotation", 0.0, 2.0),
        form("sift.select", "user_annotation", 2.0, 4.0),
        form("sift.refine", "user_annotation", 4.0, 8.0),
        form("sift.refine.step", "user_annotation", 4.1, 5.0),
        form("sift.refine.step", "user_annotation", 5.0, 7.0),
        form("sift.describe", "user_annotation", 8.0, 9.5),
        form("sift.refine", "gpu_user_annotation", 4.0, 8.0),  # the card's copy of the range
        form("aten::conv", "cpu_op", 0.1, 0.3, corr=101),
        form("cudaLaunchKernel", "cuda_runtime", 0.15, 0.2, corr=1),
        form("aten::cumsum", "cpu_op", 3.0, 3.5, corr=102),
        form("cudaLaunchKernel", "cuda_runtime", 3.1, 3.2, corr=2),
        form("aten::mul", "cpu_op", 4.2, 4.4, corr=103),
        form("cudaLaunchKernel", "cuda_runtime", 4.25, 4.3, corr=3),
        form("aten::add", "cpu_op", 8.1, 8.2, corr=104),
        form("cudaLaunchKernel", "cuda_runtime", 8.12, 8.15, corr=4),
        form("aten::where", "cpu_op", 8.3, 8.4, corr=105),  # its kernel: no runtime call recorded
        form("cudaStreamSynchronize", "cuda_runtime", 9.6, 10.0, corr=5),
        form("fused_octave_kernel", "kernel", 0.2 + card_shift, 1.8 + card_shift, corr=1, linked=101),
        form("tensor_kernel_scan", "kernel", 3.2 + card_shift, 5.5 + card_shift, corr=2, linked=102),
        form("elementwise_kernel", "kernel", 5.0 + card_shift, 6.5 + card_shift, corr=3, linked=103),
        form("window_sample", "kernel", 8.2 + card_shift, 8.6 + card_shift, corr=4, linked=104),
        form("where_kernel", "kernel", 8.6 + card_shift, 8.8 + card_shift, corr=99, linked=105),
    ]


@FORMS
def test_busy_time_goes_to_the_span_of_the_launch_and_gaps_to_the_hosts_span(form):
    pt = pa.ProgramTrace.from_events(_events(form))
    assert [d[3] for d in pt.device] == pytest.approx([0.15, 3.1, 4.25, 8.12, 8.3])
    got = pa.partition(pt, *pt.mark("loop"))
    parts = got["parts"]
    # busy: pyramid's kernel; select's scan 3.2-5.5, which started first,
    # holds the overlap; refine's kernel the rest, 5.5-6.5
    assert parts["pyramid"]["busy_s"] == pytest.approx(1.6)
    assert parts["select"]["busy_s"] == pytest.approx(2.3)
    assert parts["refine"]["busy_s"] == pytest.approx(1.0)
    assert parts["describe"]["busy_s"] == pytest.approx(0.6)
    # idle, whole gaps by where the host was as each began: 0-0.2 and
    # 1.8-3.2 in pyramid, 6.5-8.2 in refine's second step, 8.8-10 in describe
    assert parts["pyramid"]["idle_s"] == pytest.approx(0.2 + 1.4)
    assert parts["select"]["idle_s"] == 0.0
    assert parts["refine"]["idle_s"] == pytest.approx(1.7)
    assert parts["describe"]["idle_s"] == pytest.approx(1.2)
    assert parts["other"]["loop_s"] == pytest.approx(0.0)
    assert sum(p["loop_s"] for p in parts.values()) == pytest.approx(got["window_s"], rel=1e-12)
    assert [parts[n]["launches"] for n in (*pa.LAYERS, "other")] == [1, 1, 1, 2, 0]
    steps = got["steps"]
    assert steps["count"] == 2 and steps["launches"] == 1
    assert steps["busy_s"] == pytest.approx(1.0) and steps["idle_s"] == pytest.approx(1.7)
    assert got["idle_causes"] == {"pyramid/python": pytest.approx(1.6),
                                  "refine.step/python": pytest.approx(1.7),
                                  "describe/python": pytest.approx(1.2)}
    assert pa.clock_check(pt) == {"before_launch": 0, "before_span": 0, "launch_outside_op": 0,
                                  "lead_min_us": pytest.approx(5e4),
                                  "lead_median_us": pytest.approx(1e5)}


def test_a_card_timeline_off_the_hosts_moves_no_gap_past_its_launches():
    """The card's events a second early against the host's: the last gap
    (7.8-10 on the card) begins before the host launched the operation
    that ended just before it (8.3, in describe), so it is describe's."""
    pt = pa.ProgramTrace.from_events(_events(card_shift=-1.0))
    got = pa.partition(pt, *pt.mark("loop"))
    parts = got["parts"]
    assert parts["describe"]["idle_s"] == pytest.approx(2.2)
    assert parts["refine"]["idle_s"] == pytest.approx(1.7)  # 5.5-7.2, in step 2
    assert sum(p["loop_s"] for p in parts.values()) == pytest.approx(10.0, rel=1e-12)
    assert pa.clock_check(pt)["before_launch"] == 5


def test_time_outside_the_layers_is_other_and_the_parts_still_sum():
    pt = pa.ProgramTrace.from_events(_events())
    got = pa.partition(pt, 0.0, 12.0)  # a window that ends past the last span
    parts = got["parts"]
    assert parts["other"]["idle_s"] == pytest.approx(0.0)  # the gap 8.8-12 begins in describe
    got = pa.partition(pt, 0.0, 10.0, layers=("pyramid", "select"))
    assert got["parts"]["other"]["busy_s"] == pytest.approx(1.0 + 0.6)
    assert sum(p["loop_s"] for p in got["parts"].values()) == pytest.approx(10.0, rel=1e-12)


def test_a_card_operation_before_its_launch_or_its_span_is_a_clock_fault():
    events = _events() + [Event("cudaLaunchKernel", "cuda_runtime", 4.6, 4.7, corr=7),
                          Event("early_kernel", "kernel", 3.95, 4.1, corr=7, linked=103)]
    got = pa.clock_check(pa.ProgramTrace.from_events(events))
    assert got["before_launch"] == 1 and got["before_span"] == 1
    assert got["launch_outside_op"] == 1  # launched at 4.6, its op ran 4.2-4.4
    assert got["lead_min_us"] == pytest.approx(-6.5e5)


@FORMS
def test_a_program_annotation_never_lands_among_the_cards_operations(form):
    tr = pa.ProgramTrace.from_events(_events(form))
    assert not any(d[2].startswith("sift.") for d in tr.device)
    assert [d[2] for d in tr.device] == ["fused_octave_kernel", "tensor_kernel_scan",
                                         "elementwise_kernel", "window_sample", "where_kernel"]
    assert [n for *_, n in tr.spans].count("refine") == 1
    assert tr.marks == [(0.0, 10.0, "loop")] and tr.asked() == 4


def test_the_summary_reads_the_metrics_from_the_stretches():
    pt = pa.ProgramTrace.from_events(_events())
    got = pa.partition(pt, *pt.mark("loop"))
    loop = {"batches": 1, "attempts": 1, "clock": {}, "unlinked": 0, "window_s": got["window_s"],
            "parts": got["parts"], "idle_causes": got["idle_causes"], "steps": got["steps"]}
    counters = {"refine.slots_stepped.o0.s1": 200, "refine.slots_live.o0.s1": 30,
                "refine.slots_stepped.o0.s2": 200, "refine.slots_live.o0.s2": 10}
    out = pa.summarize(loop, counters)
    m = out["metrics"]
    assert m["refine_loop_ms"] == pytest.approx(2700.0)
    assert m["refine_launches"] == 1
    assert m["refine_live_slot_pct"] == pytest.approx(10.0)
    assert out["readings"]["loop.partition_share"] == pytest.approx(1.0)
    assert out["readings"]["idle_causes_ms"][0][1] >= out["readings"]["idle_causes_ms"][-1][1]
    assert pa.live_slot_pct({}) is None


@pytest.mark.parametrize("workload", CELLS)
def test_stretches_on_a_tiny_cell(workload):
    cell = tiny_cell(workload)
    fr = runner.Frontend(cell["config"], cell["traffic"], 2**31 + 11, torch.device("cpu"))
    fr.call(fr.next_frames()[1])
    loop = pa.loop_stretch(fr, 2)
    counters = pa.counter_stretch(fr, 2)
    out = pa.summarize(loop, counters)
    assert set(out["metrics"]) == {"pyramid_loop_ms", "select_loop_ms", "refine_loop_ms",
                                   "describe_loop_ms", "refine_launches", "refine_live_slot_pct"}
    assert out["readings"]["loop.partition_share"] == pytest.approx(1.0, rel=1e-9)
    # no card: no operation, one idle gap over the whole window
    assert out["metrics"]["refine_launches"] == 0
    assert sum(out["metrics"][f"{n}_loop_ms"] for n in pa.LAYERS) + \
        out["readings"]["loop.other_ms"] == pytest.approx(out["readings"]["loop.window_ms"])
    assert 0 < out["metrics"]["refine_live_slot_pct"] <= 100
    steps = cell["config"]["sift"]["num_octaves"] * 5
    assert out["readings"]["refine.steps_per_batch"] == steps
    assert len(out["readings"]["refine.slots_live_per_batch"]) == steps


def test_the_cost_windows_alternate():
    cell = tiny_cell("tum-vga.describe-b64")
    fr = runner.Frontend(cell["config"], cell["traffic"], 5, torch.device("cpu"))
    t0 = time.perf_counter()
    got = pa.cost(fr, 0.05, 2)
    assert got["order"] == ["off", "on", "on", "off"]
    assert len(got["runs"]["on"]) == len(got["runs"]["off"]) == 2
    assert got["batch_ms_untraced"] > 0 and time.perf_counter() - t0 < 60


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_partition_on_the_card(workload):
    """On the card: the loop metrics reported, the parts summing to the
    window, every card operation matched to its launch and that launch
    inside the host op it is linked to, and none starting before its
    launch or the span it was launched in (host and card on one clock:
    traces where the profiler placed them apart are taken again)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = tiny_cell(workload, width=320, height=240, batch=4)
    fr = runner.Frontend(cell["config"], cell["traffic"], 2**31 + 3, device)
    fr.call(fr.next_frames()[1])
    loop = pa.loop_stretch(fr, 2)
    out = pa.summarize(loop, pa.counter_stretch(fr, 2))
    assert all(v is not None for v in out["metrics"].values()) and len(out["metrics"]) == 6
    readings = out["readings"]
    assert readings["loop.partition_share"] == pytest.approx(1.0, rel=1e-9)
    assert readings["loop.unlinked_ops"] == 0 and readings["clock.launch_outside_op"] == 0
    assert readings["clock.before_launch"] == readings["clock.before_span"] == 0
    assert out["metrics"]["refine_launches"] > 0
    assert sum(readings[f"{n}.busy_ms"] for n in (*pa.LAYERS, "other")) > 0
