"""The frontend loop partitioned by the program's own spans on the card's
clock, and refinement's slot counters.

    python3 port_bench/partition.py --workload <name> --seed <n> [--batches 12]
        [--cost-seconds 51 --cost-runs 3]

For one cell, after the set-up a run makes (the frames, the entry warmed
up), three stretches of ``--batches`` batches, each batch as the untraced
window runs it (the entry called, one synchronise):

1. under the profiler of host and card, inside the program's
   ``tracing(spans=True)`` (``utils/profile.py``), each batch in the range
   ``port_bench.loop``: each layer's loop time (:func:`partition`), the
   card operations launched in each layer, the card's idle gaps by the
   innermost span and what the host was doing, the Newton steps';
2. inside ``tracing(spans=False, counters=True)``, no profiler: the share
   of refinement's stepped slots that were still running
   (``refine.slots_live`` over ``refine.slots_stepped``), per octave and
   step;
3. with ``--cost-seconds``: ``--cost-runs`` untraced windows of that many
   seconds with the spans on (``tracing(spans=True)``, no profiler)
   against as many with the session off, in the order off, on, on, off,
   ...: what the spans cost when on.

Prints one JSON line: ``metrics`` (the loop metrics), ``readings`` and the
kernels' build and load seconds. The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import heapq  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

from port_bench.trace import _ASKS, DEVICE_ACTIVITIES, Trace  # noqa: E402

PROGRAM_PREFIX = "sift."
BENCH_PREFIX = "port_bench."
LAYERS = ("pyramid", "select", "refine", "describe")
STEP = "refine.step"
OTHER = "other"


class ProgramTrace:
    """The events of one profiler run, in seconds on one clock:
    ``device`` (start, end, name, launch, op) of the card's operations,
    where ``launch`` is the start of the runtime call that launched it
    (matched by correlation id; else the start of the host op it is linked
    to; ``None`` where neither was recorded) and ``op`` the (start, end) of
    that host op (or ``None``), ``host`` (start, end, name,
    kind) of the main thread's ops and runtime calls, ``spans`` (start,
    end, name) of the program's ranges (names after ``sift.``) and
    ``marks`` of the benchmark's (after ``port_bench.``)."""

    def __init__(self, device, host, spans, marks):
        self.device = sorted(device, key=lambda d: (d[0], d[1]))
        self.host = sorted(host)
        self.spans = sorted(spans)
        self.marks = sorted(marks)
        self.trace = Trace([d[:3] for d in self.device], self.host, [])

    @classmethod
    def from_profiler(cls, prof) -> "ProgramTrace":
        return cls.from_events(prof.profiler.kineto_results.events())

    @classmethod
    def from_events(cls, events) -> "ProgramTrace":
        device, host, spans, marks = [], [], [], []
        launched, linked = {}, {}
        main = None
        for e in events:
            kind = _kind(e)
            start = e.start_ns() * 1e-9
            end = start + e.duration_ns() * 1e-9
            name = e.name()
            if kind in DEVICE_ACTIVITIES:
                device.append((start, end, name, e.correlation_id(), e.linked_correlation_id()))
            elif kind == "user_annotation" and name.startswith(PROGRAM_PREFIX):
                spans.append((start, end, name[len(PROGRAM_PREFIX):], e.start_thread_id()))
            elif kind == "user_annotation" and name.startswith(BENCH_PREFIX):
                marks.append((start, end, name[len(BENCH_PREFIX):]))
                main = e.start_thread_id()
            elif kind in ("cpu_op", "cuda_runtime", "cuda_driver"):
                host.append((start, end, name, kind, e.start_thread_id()))
                if kind == "cpu_op":
                    linked.setdefault(e.correlation_id(), (start, end))
                else:
                    launched.setdefault(e.correlation_id(), start)
        ops = []
        for a, b, n, c, lc in device:
            op = linked.get(lc)
            ops.append((a, b, n, launched.get(c, op[0] if op else None), op))
        host = [h[:4] for h in host if main is None or h[4] == main]
        spans = [s[:3] for s in spans if main is None or s[3] == main]
        return cls(ops, host, spans, marks)

    def asked(self) -> int:
        """The launches, copies and fills the host asked of the card."""
        return sum(kind in ("cuda_runtime", "cuda_driver") and bool(_ASKS.search(name))
                   for _, _, name, kind in self.host)

    def mark(self, name: str) -> tuple[float, float]:
        (lo, hi), = [(a, b) for a, b, n in self.marks if n == name]
        return lo, hi


def _kind(event) -> str:
    """The event's activity type (``kernel``, ``cpu_op``, ...); where the
    profiler's events do not say it (torch 2.11), from the device and the
    name: on the card a range of the program's or the benchmark's is the
    card's copy of that range, not an operation."""
    if hasattr(event, "activity_type"):
        return event.activity_type()
    name = event.name()
    marked = name.startswith((PROGRAM_PREFIX, BENCH_PREFIX))
    if event.device_type().name == "CUDA":
        return "gpu_user_annotation" if marked else "kernel"
    if marked:
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


class _Spans:
    """Which of ``names`` holds a time, and the innermost span of all."""

    def __init__(self, spans, names):
        self.of = [(a, b, n) for a, b, n in spans if n in names]
        self.all = spans

    def layer_at(self, t) -> str:
        for a, b, n in self.of:
            if a <= t < b:
                return n
        return OTHER

    def innermost_at(self, t) -> str:
        held = [(b - a, n) for a, b, n in self.all if a <= t < b]
        return min(held)[1] if held else OTHER


def partition(pt: ProgramTrace, lo: float, hi: float, layers=LAYERS) -> dict:
    """The window ``[lo, hi]`` split among ``layers`` and ``other``.

    A layer's loop time is the card-busy time of the operations launched
    inside its spans, plus the idle gaps that began while the host was
    inside them. Busy time is the union of the operations' intervals: where
    operations overlap, the one that started first holds the time. The
    rest, busy or idle, is ``other``. So the parts sum to ``hi - lo``.

    Where a gap began is read on the host's clock, the card's time of its
    start held between the launches of the operations on either side of
    it (the host launched the one before it earlier and the one after it,
    on an idle card, just before it ends): so a card timeline that the
    profiler placed off the host's moves a gap no further than those
    launches (:func:`clock_check` measures how far off it is).

    Returns ``{"window_s", "parts": {name: {"loop_s", "busy_s", "idle_s",
    "launches"}}, "idle_causes": {"<innermost span>/<host>": s},
    "steps": {"count", "span_s", "busy_s", "idle_s", "launches"},
    "unlinked": operations whose launch was not recorded}``.
    """
    spans = [s for s in pt.spans if s[1] > lo and s[0] < hi]
    at = _Spans(spans, set(layers))
    steps = _Spans(spans, {STEP})
    parts = {name: {"loop_s": 0.0, "busy_s": 0.0, "idle_s": 0.0, "launches": 0}
             for name in (*layers, OTHER)}
    step = {"count": sum(n == STEP for *_, n in spans),
            "span_s": sum(min(b, hi) - max(a, lo) for a, b, n in spans if n == STEP),
            "busy_s": 0.0, "idle_s": 0.0, "launches": 0}
    ops, unlinked = [], 0
    for a, b, _, launch, _ in pt.device:
        if b <= lo or a >= hi:
            continue
        unlinked += launch is None
        owner = at.layer_at(launch) if launch is not None else OTHER
        in_step = launch is not None and steps.layer_at(launch) == STEP
        ops.append((max(a, lo), min(b, hi), owner, in_step, launch))
        if lo <= (launch if launch is not None else a) < hi:
            parts[owner]["launches"] += 1
            step["launches"] += in_step
    # Sweep the operations' ends: each stretch covered by any operation
    # goes to the covering operation that started first.
    edges = sorted([(op[0], 1, i) for i, op in enumerate(ops)]
                   + [(op[1], 0, i) for i, op in enumerate(ops)])
    live, done, t_prev = [], set(), None
    for t, opens, i in edges:
        while live and live[0][1] in done:
            heapq.heappop(live)
        if live and t > t_prev:
            _, j = live[0]
            parts[ops[j][2]]["busy_s"] += t - t_prev
            if ops[j][3]:
                step["busy_s"] += t - t_prev
        if opens:
            heapq.heappush(live, (ops[i][0], i))
        else:
            done.add(i)
        t_prev = t
    causes: dict[str, float] = defaultdict(float)
    for a, b, before, after in _gaps(ops, lo, hi):
        t = a if before is None else max(a, before)
        t = t if after is None else min(t, after)
        parts[at.layer_at(t)]["idle_s"] += b - a
        if steps.layer_at(t) == STEP:
            step["idle_s"] += b - a
        causes[f"{at.innermost_at(t)}/{pt.trace.host_at(t)}"] += b - a
    for p in parts.values():
        p["loop_s"] = p["busy_s"] + p["idle_s"]
    return {"window_s": hi - lo, "parts": parts, "idle_causes": dict(causes), "steps": step,
            "unlinked": unlinked}


def _gaps(ops, lo, hi):
    """The card's idle intervals in ``[lo, hi]`` between ``ops`` (start,
    end, ..., launch), each with the launch of the operation that ended
    just before it and of the one that starts it (``None`` at the
    window's ends)."""
    busy = []  # [start, end, launch of its first operation, of its last to end]
    for a, b, *_, launch in sorted(ops, key=lambda op: op[0]):
        if busy and a <= busy[-1][1]:
            if b > busy[-1][1]:
                busy[-1][1], busy[-1][3] = b, launch
        else:
            busy.append([a, b, launch, launch])
    out, t, before = [], lo, None
    for a, b, first, last in busy:
        if a > t:
            out.append((t, a, before, first))
        t, before = max(t, b), last
    if t < hi:
        out.append((t, hi, before, None))
    return out


def loop_stretch(fr, n_batches: int) -> dict:
    """Stretch 1 (see the module): the partition of each of ``n_batches``
    batches, summed, and ``batches``. A batch's trace is taken again, on a
    fresh batch, at most ``TRACE_ATTEMPTS`` times, until it is whole: as
    many operations on the card as the host asked for (the benchmark's own
    rule), and none that starts before its launch. The profiler has been
    seen to place a quarter of its card timelines early of the host's, by
    an offset and a drift that reached 5 ms within a batch; a whole trace
    has none. Of attempts that all fall short, the fullest, then the one
    with the fewest operations before their launch, is kept."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from port_bench.runners.frontend import TRACE_ATTEMPTS, _sync
    from sift_scale_space_extrema_detection_tpu_torch.utils.profile import tracing

    on_card = fr.device.type == "cuda"
    both = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])

    def one():
        with profile(activities=both) as prof:
            with tracing(spans=True), record_function(BENCH_PREFIX + "loop"):
                fr.call(fr.next_frames()[1])
                _sync(fr.device)
        return ProgramTrace.from_profiler(prof)

    one()  # the profiler's own start-up, not measured
    out = {"batches": 0, "attempts": 0, "window_s": 0.0, "idle_causes": defaultdict(float),
           "parts": {}, "steps": defaultdict(float), "clock": defaultdict(float), "unlinked": 0}
    for _ in range(n_batches):
        best = None
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            pt = one()
            check = clock_check(pt)
            rank = (len(pt.device), -check["before_launch"])
            if best is None or rank > best[0]:
                best = (rank, pt, check)
            if not on_card or (pt.device and len(pt.device) >= pt.asked()
                               and check["before_launch"] == 0):
                break
        _, best, check = best
        out["attempts"] += attempt
        lo, hi = best.mark("loop")
        got = partition(best, lo, hi)
        out["batches"] += 1
        out["window_s"] += got["window_s"]
        clock = out["clock"]
        clock["lead_min_us"] = min(clock.get("lead_min_us", math.inf), check["lead_min_us"])
        for k, v in check.items():
            if k != "lead_min_us":
                clock[k] += v
        out["unlinked"] += got["unlinked"]
        for name, p in got["parts"].items():
            into = out["parts"].setdefault(name, defaultdict(float))
            for k, v in p.items():
                into[k] += v
        for k, v in got["idle_causes"].items():
            out["idle_causes"][k] += v
        for k, v in got["steps"].items():
            out["steps"][k] += v
    return out


def clock_check(pt: ProgramTrace) -> dict:
    """Whether host and card share one clock in ``pt``: the card
    operations that start before the runtime call that launched them
    began (``before_launch``) or before the start of the program span
    their launch lies in (``before_span``), the least and the median lead
    from launch to start (µs), and the launches matched by correlation id
    that lie outside the host op the operation is linked to
    (``launch_outside_op``: a correlation matched wrongly)."""
    leads, before_span, outside = [], 0, 0
    for a, _, _, launch, op in pt.device:
        if launch is None:
            continue
        leads.append(a - launch)
        held = [s for s, e, _ in pt.spans if s <= launch < e]
        before_span += any(a < s for s in held)
        if op is not None and not op[0] <= launch <= op[1]:
            outside += 1
    leads.sort()
    return {"before_launch": sum(x < 0 for x in leads), "before_span": before_span,
            "launch_outside_op": outside,
            "lead_min_us": 1e6 * leads[0] if leads else 0.0,
            "lead_median_us": 1e6 * leads[len(leads) // 2] if leads else 0.0}


def counter_stretch(fr, n_batches: int) -> dict:
    """Stretch 2 (see the module): every counter's total over
    ``n_batches`` batches, divided by the batches."""
    from port_bench.runners.frontend import _sync
    from sift_scale_space_extrema_detection_tpu_torch.utils.profile import tracing

    with tracing(spans=False, counters=True) as session:
        for _ in range(n_batches):
            fr.call(fr.next_frames()[1])
            _sync(fr.device)
    return {k: v / n_batches for k, v in session.counters.items()}


def live_slot_pct(counters: dict) -> float | None:
    """100 × Σ ``refine.slots_live`` ÷ Σ ``refine.slots_stepped``."""
    live = sum(v for k, v in counters.items() if k.startswith("refine.slots_live."))
    stepped = sum(v for k, v in counters.items() if k.startswith("refine.slots_stepped."))
    return 100.0 * live / stepped if stepped else None


def summarize(loop: dict, counters: dict) -> dict:
    """The loop metrics and the readings of both stretches (ms a batch)."""
    n = loop["batches"]
    parts = loop["parts"]

    def ms(s):
        return 1e3 * s / n

    metrics = {f"{name}_loop_ms": ms(parts[name]["loop_s"]) for name in LAYERS}
    metrics["refine_launches"] = parts["refine"]["launches"] / n
    metrics["refine_live_slot_pct"] = live_slot_pct(counters)
    total = sum(p["loop_s"] for p in parts.values())
    readings = {"loop.window_ms": ms(loop["window_s"]), "loop.other_ms": ms(parts[OTHER]["loop_s"]),
                "loop.partition_share": total / loop["window_s"],
                "loop.idle_pct": 100.0 * sum(p["idle_s"] for p in parts.values())
                / loop["window_s"],
                "loop.trace_attempts": loop["attempts"], "loop.unlinked_ops": loop["unlinked"] / n}
    clock = dict(loop["clock"])
    if "lead_median_us" in clock:
        clock["lead_median_us"] /= n  # the mean of the batches' medians
    readings |= {f"clock.{k}": v for k, v in clock.items()}
    for name in (*LAYERS, OTHER):
        readings[f"{name}.busy_ms"] = ms(parts[name]["busy_s"])
        readings[f"{name}.idle_ms"] = ms(parts[name]["idle_s"])
        readings[f"{name}.launches"] = parts[name]["launches"] / n
    steps = loop["steps"]
    if steps["count"]:
        per = steps["count"]
        readings |= {"refine.steps_per_batch": per / n,
                     "refine.step.span_ms": 1e3 * steps["span_s"] / per,
                     "refine.step.busy_ms": 1e3 * steps["busy_s"] / per,
                     "refine.step.idle_ms": 1e3 * steps["idle_s"] / per,
                     "refine.step.launches": steps["launches"] / per}
    causes = sorted(loop["idle_causes"].items(), key=lambda kv: -kv[1])[:10]
    readings["idle_causes_ms"] = [[k, ms(v)] for k, v in causes]
    readings["refine.slots_live_per_batch"] = {
        k[len("refine.slots_live."):]: v for k, v in counters.items()
        if k.startswith("refine.slots_live.")}
    readings["refine.slots_stepped_per_batch"] = {
        k[len("refine.slots_stepped."):]: v for k, v in counters.items()
        if k.startswith("refine.slots_stepped.")}
    return {"metrics": metrics, "readings": readings}


def cost(fr, seconds: float, runs: int) -> dict:
    """Stretch 3 (see the module): frames/s and the p95 of each untraced
    window, spans off and on, in the order off, on, on, off, ..."""
    from port_bench import trace
    from port_bench.runners import frontend as runner
    from sift_scale_space_extrema_detection_tpu_torch.utils.profile import tracing

    out = {"off": [], "on": []}
    order = [("off", "on")[(i + 1) // 2 % 2] for i in range(2 * runs)]
    for side in order:
        summary: dict = {}
        sample = runner.Sample(0, 0)
        if side == "on":
            with tracing(spans=True):
                runner._window(fr, sample, seconds, summary, time.perf_counter())
        else:
            runner._window(fr, sample, seconds, summary, time.perf_counter())
        out[side].append({"frames_per_s": trace.rate(summary["frames"], summary["window_s"]),
                          "batch_p95_ms": 1e3 * trace.percentile(summary["latencies_s"], 95)})
    med = {side: {k: statistics.median(r[k] for r in rows) for k in rows[0]}
           for side, rows in out.items()}
    return {"order": order, "runs": out, "median": med,
            "frames_per_s_change": med["on"]["frames_per_s"] / med["off"]["frames_per_s"] - 1.0,
            "batch_ms_untraced": 1e3 * fr.batch / med["off"]["frames_per_s"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--cost-seconds", type=float, default=0.0)
    ap.add_argument("--cost-runs", type=int, default=3)
    args = ap.parse_args(argv)

    from port_bench import run as bench_run

    bench_run._environment()
    import torch

    from port_bench import spec
    from port_bench.runners import frontend as runner
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        print("port_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = spec.cell(spec.load_benchmark(), args.workload)
    t_run = time.perf_counter()
    fr = runner.Frontend(cell["config"], cell["traffic"], args.seed, device)
    for _ in range(cell["traffic"]["warmup_batches"]):
        fr.call(fr.next_frames()[1])
    runner._sync(device)
    setup = {"setup.start_s": t_run - T_START, "setup.to_warm_s": time.perf_counter() - T_START}
    setup |= {f"setup.kernel_{k}": v for k, v in _build.LOAD_TIMES.items()}
    loop = loop_stretch(fr, args.batches)
    counters = counter_stretch(fr, args.batches)
    line = {"workload": args.workload, "seed": args.seed, **summarize(loop, counters),
            "setup": setup, "device": torch.cuda.get_device_name(device)}
    if args.cost_seconds > 0:
        line["cost"] = cost(fr, args.cost_seconds, args.cost_runs)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
