"""The frontend runner: batches of consecutive frames through one of the
port's frontend entry points, closed loop, one batch in flight.

The traffic file names the entry (``detect_and_describe_batched`` or
``detect_batched``), ``blur``, ``batch``, the ring of frames
(``ring_batches`` batches made in set-up, taken in turn from one that the
seed picks), the trajectory and the scene (``frames.py``), and how many
batches the output check and the traced run take. The configuration file
gives the frame size, the intrinsics, the padding and the ``SiftConfig``
fields.

``trace=0``: after set-up (the frames made, the entry called on the cell's
one batch shape until every kernel is built and warm), batches run back
to back for ``seconds``, each timed from the call to a synchronise.
``trace=1``: the layers in spans, and the loop under the profiler
(:func:`_traced`).

Either way a sample of the run's batches, drawn from the seed, is kept
and held to the plain reference once the window has closed
(:func:`check`, ``compare.py``).
"""

from __future__ import annotations

import random
import time

import torch

from .. import compare, frames, work
from ..reference import config as ref_config
from ..reference import frontend as ref_frontend
from ..trace import Trace

PORT = "sift_scale_space_extrema_detection_tpu_torch"
# The traced loop's bounds on the card's clock: ``torch.cuda._sleep``'s
# kernel, which nothing else launches, for about half a microsecond.
MARK_KERNEL = "spin_kernel"
MARK_CYCLES = 1000
TRACE_ATTEMPTS = 5


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Sample:
    """A reservoir of ``k`` batches drawn uniformly from all batches seen,
    by a generator seeded with the run's seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.kept = k, random.Random(seed), 0, []

    def offer(self, offset: int, result) -> None:
        if self.seen < self.k:
            self.kept.append((offset, result))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = (offset, result)
        self.seen += 1


class Frontend:
    """One cell's program side: the port's entry, its ``SiftConfig``, and
    the rings of frames (as made, and as the program is given them)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from importlib import import_module

        self.fe = import_module(f"{PORT}.models.frontend")
        self.descriptor = import_module(f"{PORT}.ops.descriptor")
        self.cfg = import_module(f"{PORT}.config").SiftConfig(**config["sift"])
        self.config, self.traffic, self.device = config, traffic, device
        self.batch = traffic["batch"]
        self.entry = getattr(self.fe, traffic["entry"])
        self.blur = traffic["blur"]
        self.describes = traffic["entry"] == "detect_and_describe_batched"
        n = self.batch * traffic["ring_batches"]
        self.ring = frames.make_frames(seed, config, traffic, n, device)
        self.program_ring = ref_frontend.pad_edges(self.ring, config.get("pad_to"))
        # The run's seed picks the batch of the ring that comes first.
        self.offset = self.batch * random.Random(seed).randrange(traffic["ring_batches"])

    def next_frames(self):
        off = self.offset
        self.offset = (off + self.batch) % len(self.ring)
        return off, self.program_ring[off:off + self.batch]

    def call(self, images):
        return self.entry(images, self.cfg, blur=self.blur, device=self.device)

    def staged(self, images, span):
        """The entry's layers one by one, each in ``span(name)``; returns the
        selection's candidates (one ``Extrema`` per octave), the describe
        layer's input (one ``Keypoints`` per octave) and its output
        (``None`` when the entry does not describe)."""
        fe, cfg = self.fe, self.cfg
        if cfg.unified_refine or cfg.refine_tail_pool or not cfg.compact_describe:
            raise ValueError("the staged run refines octave by octave and describes compacted")
        with span("pyramid"):
            dogs, masks, stacks = fe._pyramid(images, cfg, self.blur, emit_scales=self.describes)
        with span("select"):
            _, selected = fe._select_candidates(dogs, cfg, masks)
        with span("refine"):
            keypoints = fe._refine_per_octave(dogs, selected, cfg)
        del dogs, masks
        if not self.describes:
            return selected, keypoints, None
        with span("describe"):
            described = self.descriptor.describe_compact(stacks, keypoints, cfg)
        return selected, keypoints, described

    def shape(self):
        return tuple(self.program_ring.shape[-2:])


class Spans:
    """``spans(name)``: a context that runs its block in the profiler range
    ``port_bench.<name>`` and ends it with a synchronise; each block's
    host-clock seconds are kept in ``seconds[name]``."""

    def __init__(self, device):
        self.device, self.seconds = device, {}

    def __call__(self, name):
        from torch.profiler import record_function

        spans = self

        class Span:
            def __enter__(self):
                self.rf = record_function(f"port_bench.{name}")
                self.rf.__enter__()
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                _sync(spans.device)
                spans.seconds.setdefault(name, []).append(time.perf_counter() - self.t0)
                self.rf.__exit__(*exc)

        return Span()


def check(fr: Frontend, sample: Sample, control: bool = False) -> list[dict]:
    """The gaps of each kept batch against the reference run on the same
    frames, as made (it pads them itself), with its float32 matrix
    products in full precision. ``control=True``: the control takes the
    program's place, the reference run again with those products in TF32,
    one precision below what the configuration states."""
    cfg = ref_config.SiftConfig(**fr.config["sift"])
    entry = ref_frontend.ENTRIES[fr.traffic["entry"]]
    out = []
    for offset, result in sample.kept:
        frames_in = ref_frontend.pad_edges(fr.ring[offset:offset + fr.batch],
                                           fr.config.get("pad_to"))
        with ref_frontend.precision(False):
            want = entry(frames_in, cfg, fr.blur)
        if control:
            with ref_frontend.precision(True):
                result = entry(frames_in, cfg, fr.blur)
        out.append(compare.gaps(compare.fields(result), compare.fields(want), cfg))
        del want, result
        if fr.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of the cell (see the module): the result's fields, and the
    summary the metric readers read."""
    t_run = time.perf_counter()
    fr = Frontend(cell["config"], cell["traffic"], seed, device)
    _sync(device)
    t_frames = time.perf_counter()
    traffic = cell["traffic"]
    for _ in range(traffic["warmup_batches"]):
        fr.call(fr.next_frames()[1])
    _sync(device)
    setup = {"setup.start_s": t_run - t_start, "setup.frames_s": t_frames - t_run,
             "setup.warmup_s": time.perf_counter() - t_frames}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sample = Sample(traffic["check_batches"], seed)
    summary: dict = {}
    if trace:
        breakdown = _traced(fr, sample, traffic["trace_batches"], summary)
    else:
        breakdown = None
        _window(fr, sample, seconds, summary, t_start)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    summary["readings"] = setup | summary.get("readings", {})
    return {"summary": summary, "sample": sample, "frontend": fr, "breakdown": breakdown,
            "memory_peak_bytes": peak}


def _host(device) -> dict:
    """What may pace the host-bound loop, read at a point of the window:
    this process's CPU seconds and involuntary context switches, the
    caching allocator's device allocations and the garbage collector's
    collections."""
    import gc
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "cpu_s": ru.ru_utime + ru.ru_stime,
            "preempted": ru.ru_nivcsw, "gc": sum(g["collections"] for g in gc.get_stats()),
            "allocs": torch.cuda.memory_stats(device).get("num_device_alloc", 0)
            if device.type == "cuda" else 0}


def _thirds(marks: list[dict], done: list[int], batch: int) -> dict:
    """Readings of each third of the window from the host's state at its
    ends (:func:`_host`) and the batches done by each."""
    out = {}
    for k, (a, b) in enumerate(zip(marks, marks[1:]), 1):
        dt = max(b["t"] - a["t"], 1e-9)
        out[f"frames_per_s.third{k}"] = (done[k] - done[k - 1]) * batch / dt
        out[f"host_cores_busy.third{k}"] = (b["cpu_s"] - a["cpu_s"]) / dt
        out[f"preempted_per_s.third{k}"] = (b["preempted"] - a["preempted"]) / dt
        out[f"device_allocs.third{k}"] = b["allocs"] - a["allocs"]
        out[f"gc_collections.third{k}"] = b["gc"] - a["gc"]
    return out


def _window(fr: Frontend, sample: Sample, seconds: float, summary: dict, t_start: float):
    latencies = []
    marks, done = [_host(fr.device)], [0]
    t0 = marks[0]["t"]
    while True:
        tb = time.perf_counter()
        offset, images = fr.next_frames()
        result = fr.call(images)
        _sync(fr.device)
        te = time.perf_counter()
        latencies.append(te - tb)
        sample.offer(offset, result)
        del result
        while len(marks) <= 3 and te - t0 >= len(marks) * seconds / 3:
            marks.append(_host(fr.device))
            done.append(len(latencies))
        if te - t0 >= seconds:
            break
    window = te - t0
    # The rate in each third of the window, beside what may pace the host.
    readings = {"host_cores_busy": (marks[-1]["cpu_s"] - marks[0]["cpu_s"]) / window}
    readings |= _thirds(marks, done, fr.batch)
    summary.update(setup_s=t0 - t_start, window_s=window, latencies_s=latencies,
                   frames=len(latencies) * fr.batch, batches=len(latencies), readings=readings)


def _whole(body, activities, on_card: bool, floor: float = 0.0):
    """``(trace, body's result, attempts)`` of ``body()`` run under the
    profiler, taken again (on a fresh batch) until the trace is whole, at
    most :data:`TRACE_ATTEMPTS` times: the profiler has been seen to drop
    the card's operations, from some of them to all but the markers,
    which would undercount the card's time. Whole means as many
    operations on the card as the host asked for (launches, copies and
    fills the runtime recorded), and at least ``floor`` of them. Of
    attempts that all fall short, the fullest is kept."""
    from torch.profiler import profile

    best = None
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with profile(activities=activities) as prof:
            out = body()
        tr = Trace.from_profiler(prof)
        ops = len(tr.device)
        if not on_card or (ops > 0 and ops >= max(tr.asked(), floor)):
            return tr, out, attempt
        if best is None or ops > len(best[0].device):
            best = (tr, out)
    return (*best, TRACE_ATTEMPTS)


def _traced(fr: Frontend, sample: Sample, n_batches: int, summary: dict) -> dict:
    """The traced run, four stretches of ``n_batches`` batches each, each
    batch traced on its own so that a trace stays small (see :func:`_whole`):

    1. the layers one by one in spans ending in a synchronise, no profiler:
       each layer's host-clock milliseconds;
    2. the same under the profiler (host and card): the card's time inside
       each span, which the roofline shares divide by, and the readings;
    3. the loop as the untraced window runs it, under the profiler of the
       card alone (no host op is recorded, so the host runs at its own
       pace), each batch between two marker kernels: the busy and idle
       share, the device operations that took most time;
    4. the same loop under the profiler of host and card: what the host
       was doing in each of the card's idle gaps.
    """
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = fr.device.type == "cuda"
    both = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=both):  # the profiler's own start-up, not measured
        fr.call(fr.next_frames()[1])
        _sync(fr.device)
    cfg = ref_config.SiftConfig(**fr.config["sift"])
    h, w = fr.shape()
    planes = work.octave_planes(cfg, h, w)

    timed = Spans(fr.device)
    for _ in range(n_batches):
        fr.staged(fr.next_frames()[1], timed)

    device_in = {name: [] for name in timed.seconds}
    describe_least, counts, ops, attempts = [], [], [], {"staged": 0, "card": 0, "host": 0}
    for _ in range(n_batches):
        tr, (selected, keypoints, described), n = _whole(
            lambda: fr.staged(fr.next_frames()[1], Spans(fr.device)), both, on_card)
        attempts["staged"] += n
        ops.append(len(tr.device))
        for name in device_in:
            device_in[name] += [tr.device_in(a, b) for a, b in tr.span_list(name)]
        if described is not None:
            describe_least.append(work.describe_least_s(cfg, planes, keypoints, described))
        counts.append(_counts(cfg, selected, keypoints, described))
        del selected, keypoints, described

    def one_batch():
        offset, images = fr.next_frames()
        result = fr.call(images)
        _sync(fr.device)
        sample.offer(offset, result)

    def marked():
        _sync(fr.device)
        torch.cuda._sleep(MARK_CYCLES)
        one_batch()
        torch.cuda._sleep(MARK_CYCLES)
        _sync(fr.device)

    def labelled():
        with record_function("port_bench.loop"):
            one_batch()

    busy = window = 0.0
    top: dict[str, float] = {}
    idle: dict[str, float] = {}
    for _ in range(n_batches):
        if on_card:
            tr, _, n = _whole(marked, [ProfilerActivity.CUDA], on_card, 0.99 * min(ops) + 2)
            attempts["card"] += n
            marks = [(a, b) for a, b, name in tr.device if MARK_KERNEL in name]
            tr = Trace([d for d in tr.device if MARK_KERNEL not in d[2]], tr.host, tr.spans)
            (lo, _), (_, hi) = marks[0], marks[-1]
            busy, window = busy + tr.device_in(lo, hi), window + hi - lo
            for name, s in tr.top_ops(lo, hi, k=None):
                top[name] = top.get(name, 0.0) + s
        tr, _, n = _whole(labelled, both, on_card)
        attempts["host"] += n
        (lo, hi), = tr.span_list("loop")
        for name, s in tr.idle_by_host(lo, hi, k=None):
            idle[name] = idle.get(name, 0.0) + s
        if not on_card:
            busy, window = busy + tr.device_in(lo, hi), window + hi - lo
    least_pyramid = work.pyramid_least_s(cfg, fr.batch, h, w, fr.blur, fr.describes)
    summary.update(
        spans={name: list(zip(timed.seconds[name], device_in[name])) for name in device_in},
        least={"pyramid": [least_pyramid] * n_batches, "describe": describe_least},
        loop={"busy_s": busy, "window_s": window},
        batches=2 * n_batches,
        readings={k: sum(c[k] for c in counts) / len(counts) for k in counts[0]}
        | {"device_ops_per_batch": sum(ops) / len(ops)}
        | {f"trace_attempts.{k}": v for k, v in attempts.items()},
    )
    return {"device_ops": _largest(top), "idle_gaps": _largest(idle)}


def _largest(seconds: dict, k: int = 10) -> list[list]:
    return [[n, s] for n, s in sorted(seconds.items(), key=lambda kv: -kv[1])[:k]]


def _counts(cfg, selected, keypoints, described) -> dict:
    """Readings of one traced batch, per frame: the candidates that
    selection counted (uncapped), the share of trios whose count reached
    the per-trio capacity and of octaves whose count passed the refinement
    capacity (the work a frame can bring is bounded there), the candidates
    kept, the keypoints refinement accepted, and the described pairs."""
    frames = selected[0].valid.shape[0]
    out = {}
    for o, sel in enumerate(selected):
        n = sel.num_candidates
        out[f"candidates_per_frame.o{o}"] = float(n.sum()) / frames
        out[f"trio_at_capacity_share.o{o}"] = float((n >= cfg.keypoints_per_trio(o)).float().mean())
        out[f"octave_over_refine_capacity_share.o{o}"] = float(
            (n.sum(-1) > cfg.refine_capacity(o)).float().mean())
    kept = sum(float(s.valid.sum()) for s in selected)
    accepted = sum(float(k.valid.sum()) for k in keypoints)
    out["selected_per_frame"] = kept / frames
    out["keypoints_per_frame"] = accepted / frames
    out["refine_accepted_share"] = accepted / kept if kept else 0.0
    if described is not None:
        out["described_per_frame"] = float(described.valid.sum()) / frames
    return out
