"""The photo-collection runner: batches of photos through the port's
``detect_and_describe_batched`` with a ranked per-image feature budget
(``max_features``), closed loop, one batch in flight.

The frontend runner (``runners/frontend.py``) with three changes:

- the entry is called with the traffic's ``max_features``, in the timed
  loop and in the staged layers (:class:`Photos`);
- the output check holds it to ``reference/budget.py``, a few frames of
  a sampled batch at a time (the traffic's ``check_frames``), since the
  plain reference of a whole batch of large photos would not fit beside
  the frames (:func:`check`);
- after the window or the traced stretches, ``trace_batches`` more batches
  (one after an untraced window) run staged inside the program's
  ``tracing(counters=True)``, under the profiler of host and card in a
  traced run (:func:`_counted`): the capacity readings, the budget's and
  describe's counters, and the card's busy time of the operations
  launched in the program's ``sift.describe.budget`` range.

Every other field of the summary is the frontend runner's, so its metric
readers read this cell too.
"""

from __future__ import annotations

import time
from importlib import import_module

import torch

from .. import compare
from ..partition import ProgramTrace
from ..reference import budget as ref_budget
from ..reference import config as ref_config
from ..reference import frontend as ref_frontend
from ..trace import union
from . import frontend as base

BUDGET_SPAN = "describe.budget"


class Photos(base.Frontend):
    """The frontend runner's program side, with the traffic's budget."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        self.max_features = traffic["max_features"]
        self.profile = import_module(f"{base.PORT}.utils.profile")

    def call(self, images):
        return self.entry(images, self.cfg, blur=self.blur, device=self.device,
                          max_features=self.max_features)

    def staged(self, images, span):
        """The layers of :meth:`call` one by one, as the frontend runner's
        ``staged`` runs them, the describe layer with the budget."""
        fe, cfg = self.fe, self.cfg
        with span("pyramid"):
            dogs, masks, stacks = fe._pyramid(images, cfg, self.blur, emit_scales=True)
        with span("select"):
            _, selected = fe._select_candidates(dogs, cfg, masks)
        with span("refine"):
            keypoints = fe._refine_per_octave(dogs, selected, cfg)
        del dogs, masks
        with span("describe"):
            described = self.descriptor.describe_compact(stacks, keypoints, cfg,
                                                         max_features=self.max_features)
        return selected, keypoints, described


def check(fr: Photos, sample: base.Sample, control: bool = False) -> list[dict]:
    """The gaps of each kept batch against ``reference/budget.py`` on the
    same frames, ``check_frames`` frames at a time; a batch's numbers are
    its worst frame's, its ``reference_slots`` the sum. ``control=True``:
    the reference again with its float32 matrix products in TF32 takes the
    program's place (``frontend.check``)."""
    cfg = ref_config.SiftConfig(**fr.config["sift"])
    step = fr.traffic["check_frames"]
    out = []
    for offset, result in sample.kept:
        got_all = compare.fields(result)
        parts = []
        for lo in range(0, fr.batch, step):
            hi = min(lo + step, fr.batch)
            frames_in = ref_frontend.pad_edges(fr.ring[offset + lo:offset + hi],
                                               fr.config.get("pad_to"))
            with ref_frontend.precision(False):
                want = ref_budget.detect_and_describe_batched(frames_in, cfg, fr.blur,
                                                              fr.max_features)
            if control:
                with ref_frontend.precision(True):
                    got = compare.fields(ref_budget.detect_and_describe_batched(
                        frames_in, cfg, fr.blur, fr.max_features))
            else:
                got = {k: v[lo:hi] for k, v in got_all.items()}
            parts.append(compare.gaps(got, compare.fields(want), cfg))
            del want, got
            if fr.device.type == "cuda":
                torch.cuda.empty_cache()
        merged = compare.worst(parts)
        merged["reference_slots"] = sum(p["reference_slots"] for p in parts)
        out.append(merged)
    return out


def _budget_busy_s(pt: ProgramTrace) -> float | None:
    """Seconds the card was busy with the operations launched inside the
    program's ``sift.describe.budget`` ranges; ``None`` where the trace
    has no such range."""
    ranges = [(a, b) for a, b, name in pt.spans if name == BUDGET_SPAN]
    if not ranges:
        return None
    ops = [(a, b) for a, b, _, launch, _ in pt.device
           if launch is not None and any(lo <= launch < hi for lo, hi in ranges)]
    return sum(b - a for a, b in union(ops))


def _profiled(fr: Photos, images):
    """``(trace, counters, staged result, attempts)`` of one staged batch
    under the profiler of host and card, inside the program's spans and
    counters; taken again on the same frames, at most
    ``base.TRACE_ATTEMPTS`` times, until the card ran every operation the
    host asked for (``base._whole``)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if fr.device.type == "cuda" else [])
    for attempt in range(1, base.TRACE_ATTEMPTS + 1):
        with fr.profile.tracing(spans=True, counters=True) as session:
            with profile(activities=acts) as prof:
                out = fr.staged(images, base.Spans(fr.device))
        pt = ProgramTrace.from_profiler(prof)
        if fr.device.type != "cuda" or (pt.device and len(pt.device) >= pt.asked()):
            break
    return pt, session.counters, out, attempt


def _per_octave(keypoints, described) -> dict:
    """Each octave's accepted keypoints and described pairs a frame."""
    frames = keypoints[0].valid.shape[0]
    out = {f"keypoints_per_frame.o{o}": float(k.valid.sum()) / frames
           for o, k in enumerate(keypoints)}
    octave = described.octave[described.valid].long()
    pairs = torch.bincount(octave, minlength=len(keypoints)).tolist()
    out |= {f"described_per_frame.o{o}": n / frames for o, n in enumerate(pairs)}
    return out


def _counted(fr: Photos, n_batches: int, traced: bool, summary: dict) -> dict:
    """The readings of ``n_batches`` staged batches inside the program's
    counters, each ``{name: mean a batch}``: the frontend runner's
    capacity readings, each octave's keypoints and pairs, and the
    ``budget.*`` and ``describe.*`` counters. With ``traced``, under the
    profiler (:func:`_profiled`): ``summary["budget_s"]``, the card's busy
    seconds in the budget a batch, where the trace has the range."""
    readings, budget_s, attempts = [], [], 0
    for _ in range(n_batches):
        images = fr.next_frames()[1]
        if traced:
            pt, counters, (selected, keypoints, described), n = _profiled(fr, images)
            attempts += n
            busy = _budget_busy_s(pt) if fr.device.type == "cuda" else None
            if busy is not None:
                budget_s.append(busy)
        else:
            with fr.profile.tracing(spans=False, counters=True) as session:
                selected, keypoints, described = fr.staged(images, base.Spans(fr.device))
            counters = session.counters
        r = base._counts(fr.cfg, selected, keypoints, described)
        r |= _per_octave(keypoints, described)
        r |= {k: float(v) for k, v in counters.items() if k.startswith(("budget.", "describe."))}
        readings.append(r)
        del selected, keypoints, described
    if budget_s:
        summary["budget_s"] = budget_s
    out = {k: sum(r.get(k, 0.0) for r in readings) / len(readings) for k in readings[0]}
    out["images_per_batch"] = fr.batch
    if traced:
        out["trace_attempts.counted"] = attempts
    return out


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of the cell, as ``frontend.run`` runs one, then
    :func:`_counted`."""
    t_run = time.perf_counter()
    fr = Photos(cell["config"], cell["traffic"], seed, device)
    base._sync(device)
    t_frames = time.perf_counter()
    traffic = cell["traffic"]
    for _ in range(traffic["warmup_batches"]):
        fr.call(fr.next_frames()[1])
    base._sync(device)
    setup = {"setup.start_s": t_run - t_start, "setup.frames_s": t_frames - t_run,
             "setup.warmup_s": time.perf_counter() - t_frames}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sample = base.Sample(traffic["check_batches"], seed)
    summary: dict = {}
    if trace:
        breakdown = base._traced(fr, sample, traffic["trace_batches"], summary)
    else:
        breakdown = None
        base._window(fr, sample, seconds, summary, t_start)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    counted = _counted(fr, traffic["trace_batches"] if trace else 1, trace, summary)
    summary["readings"] = setup | summary.get("readings", {}) | counted
    return {"summary": summary, "sample": sample, "frontend": fr, "breakdown": breakdown,
            "memory_peak_bytes": peak}
