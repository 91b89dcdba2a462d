"""What the benchmark reads from a ``torch.profiler`` trace: the device's
busy intervals, spans, idle gaps and what the host did in them, and the
statistics of the end-to-end metrics.

Device time is the union of the intervals of the operations that ran on
the card (kernels, copies, fills): overlapping operations count once.
Spans are the benchmark's own ``record_function`` ranges, read from the
same trace, so host and device times share one clock.
"""

from __future__ import annotations

import bisect
import math
import re
from collections import defaultdict

SPAN_PREFIX = "port_bench."
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
_ASKS = re.compile(r"LaunchKernel|Memcpy|Memset")


def union(intervals) -> list[tuple[float, float]]:
    """``[(start, end)]`` merged into disjoint intervals, sorted."""
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def covered(merged, lo: float, hi: float) -> float:
    """Length of the disjoint sorted intervals ``merged`` inside ``[lo, hi]``."""
    starts = [a for a, _ in merged]
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    total = 0.0
    for a, b in merged[i:]:
        if a >= hi:
            break
        total += max(0.0, min(b, hi) - max(a, lo))
    return total


def gaps(merged, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle intervals inside ``[lo, hi]`` between the disjoint sorted
    busy intervals ``merged``."""
    out, t = [], lo
    for a, b in merged:
        if b <= lo:
            continue
        if a >= hi:
            break
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def idle_pct(merged, lo: float, hi: float) -> float:
    """100 − the busy share of ``[lo, hi]``, in per cent."""
    return 100.0 * (1.0 - covered(merged, lo, hi) / (hi - lo))


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values`` by nearest rank: the
    smallest value with at least ``q`` per cent of the values at or below
    it."""
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def rate(count: float, seconds: float) -> float:
    """Work completed over the whole window's seconds."""
    return count / seconds


class Trace:
    """The events of one profiler run, in seconds on one clock:
    ``device`` (start, end, name) of the card's operations, ``host``
    (start, end, name, kind) of the host's ops, runtime calls and
    annotations on the main thread, and ``spans`` (start, end, name) of the
    benchmark's own ranges (names after :data:`SPAN_PREFIX`)."""

    def __init__(self, device, host, spans):
        self.device = sorted(device)
        self.host = sorted(host)
        self.spans = sorted(spans)
        self.busy = union((a, b) for a, b, _ in self.device)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        device, host, spans = [], [], []
        main = None
        for e in prof.profiler.kineto_results.events():
            kind = _kind(e)
            start, end = _interval(e)
            name = e.name()
            if kind in DEVICE_ACTIVITIES:
                device.append((start, end, name))
            elif kind == "user_annotation" and name.startswith(SPAN_PREFIX):
                spans.append((start, end, name[len(SPAN_PREFIX):]))
                main = e.start_thread_id()
            elif kind in ("cpu_op", "cuda_runtime", "cuda_driver"):
                host.append((start, end, name, kind, e.start_thread_id()))
        host = [h[:4] for h in host if main is None or h[4] == main]
        return cls(device, host, spans)

    def span_list(self, name: str) -> list[tuple[float, float]]:
        return [(a, b) for a, b, n in self.spans if n == name]

    def device_in(self, lo: float, hi: float) -> float:
        """Seconds the card was busy inside ``[lo, hi]``."""
        return covered(self.busy, lo, hi)

    def asked(self) -> int:
        """The operations the host asked of the card: the launches, copies
        and fills among the runtime and driver calls recorded."""
        return sum(kind in ("cuda_runtime", "cuda_driver") and bool(_ASKS.search(name))
                   for _, _, name, kind in self.host)

    def top_ops(self, lo: float, hi: float, k: int | None = 10) -> list[list]:
        """The ``k`` device operations that took the most time in
        ``[lo, hi]`` (all with ``None``), summed by :func:`short_name`:
        ``[[name, seconds]]``."""
        total: dict[str, float] = defaultdict(float)
        for a, b, name in self.device:
            if b > lo and a < hi:
                total[short_name(name)] += min(b, hi) - max(a, lo)
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:k]]

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost op that holds it,
        with the runtime call inside it where there is one
        (``aten::nonzero/cudaStreamSynchronize``), or ``python`` between ops."""
        i = bisect.bisect_right(self.host, (t, math.inf))
        op = call = None
        for a, b, name, kind in reversed(self.host[max(0, i - 256):i]):
            if b <= t:
                continue
            if kind in ("cuda_runtime", "cuda_driver"):
                call = call or name
            elif kind == "cpu_op" and op is None:
                op = name
            if op and call:
                break
        if op is None and call is None:
            return "python"
        return "/".join(n for n in (op, call) if n)

    def idle_by_host(self, lo: float, hi: float, k: int | None = 10) -> list[list]:
        """The card's idle time in ``[lo, hi]``, summed by what the host was
        doing when each gap began, the ``k`` largest: ``[[what, seconds]]``."""
        total: dict[str, float] = defaultdict(float)
        for a, b in gaps(self.busy, lo, hi):
            total[self.host_at(a)] += b - a
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:k]]


def _kind(event) -> str:
    """The event's activity type (``kernel``, ``cpu_op``, ...); where the
    profiler's events do not say it, from the device and the name."""
    if hasattr(event, "activity_type"):
        return event.activity_type()
    name = event.name()
    if event.device_type().name == "CUDA":
        return "gpu_user_annotation" if name.startswith(SPAN_PREFIX) else "kernel"
    if name.startswith(SPAN_PREFIX):
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def _interval(event) -> tuple[float, float]:
    """``(start, end)`` of the event in seconds."""
    start = event.start_ns() * 1e-9
    return start, start + event.duration_ns() * 1e-9


_FUNCTOR = re.compile(r"(\w+(?:Functor|_functor|_kernel_cuda))\b")


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and namespaces, with
    the innermost functor its template names: ``elementwise_kernel[MulFunctor]``
    for PyTorch's generic kernels, ``fused_octave_kernel`` for the port's."""
    body = name[5:] if name.startswith("void ") else name
    body = body.replace("(anonymous namespace)::", "")
    cut = min((i for i in (body.find("<"), body.find("(")) if i >= 0), default=len(body))
    base = body[:cut].split("::")[-1].strip() or body[:64]
    if cut < len(body) and body[cut] == "<":
        end = body.find("(", cut)
        functors = _FUNCTOR.findall(body[cut:end if end >= 0 else len(body)])
        if functors:
            return f"{base}[{functors[-1]}]"
    return base
