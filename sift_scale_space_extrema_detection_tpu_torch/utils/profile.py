"""The port's spans and counters, and the SLAM pipeline's stage profiler.

Spans and counters (:func:`tracing`, :func:`span`, :func:`count`): the
program marks where its work happens, and a measurement turns the marks on
for one block. A span is a ``torch.profiler.record_function`` range named
``sift.<name>``: under the profiler it is a ``user_annotation`` event of
the same trace as the card's kernels, on their clock, so a card operation
belongs to the span its launch lies in. A counter adds numbers, host ints
or 0-d device tensors, to a total of the session, read once when the
session closes. Outside a :func:`tracing` block both are off and cost one
flag check a call: no object, no dispatcher op, no launch. A profiler that
happens to run does not turn them on.

Wall-clock stage profiler (:class:`StageProfile`), the port of the JAX
package's ``utils/profile.py``: per-stage wall-clock accumulators plus a
counter of host↔device round trips, so "where do the ms/frame go" is
answered by measurement. Each stage is also the span ``sift.slam.<name>``.
Profiling SYNCS at stage boundaries (``torch.cuda.synchronize`` on the
device of the stage's outputs) so each stage's time includes its own
device work instead of leaking into whichever later stage first reads a
value. That makes profiled runs slower than production runs: use it for
attribution, never for headline throughput.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext

import torch

from .checkpoint import flatten_with_paths


SPAN_PREFIX = "sift."
NO_SPAN = nullcontext()  # what span() returns with spans off: shared, reentrant


class Tracing:
    """One :func:`tracing` block: what it turned on and, once the block has
    closed, ``counters``: every counter's total as a plain number. One
    block at a time is the process's: the flags are read by the program
    wherever it runs."""

    def __init__(self, spans: bool, counters: bool):
        self.spans, self.counting = spans, counters
        self.counters: dict[str, int | float] = {}
        self._host: dict[str, int | float] = {}
        self._device: dict[str, torch.Tensor] = {}

    def _close(self) -> None:
        """The totals as plain numbers, with one synchronise a device."""
        totals = dict(self._host)
        by_device: dict[torch.device, list[str]] = {}
        for name, held in self._device.items():
            by_device.setdefault(held.device, []).append(name)
        for names in by_device.values():
            held = [self._device[n] for n in names]
            values = torch.stack([t.to(torch.float64) for t in held]).tolist()
            for name, t, value in zip(names, held, values):
                value = value if t.is_floating_point() else int(value)
                totals[name] = totals.get(name, 0) + value
        self.counters = dict(sorted(totals.items()))


_session = Tracing(False, False)


@contextmanager
def tracing(spans: bool = True, counters: bool = False):
    """Turn the program's spans and/or counters on for the block; yields
    its :class:`Tracing`, whose ``counters`` are filled when the block
    closes. Blocks may nest: the outer block's settings and totals come
    back after an inner one."""
    global _session
    outer = _session
    _session = session = Tracing(spans, counters)
    try:
        yield session
    finally:
        _session = outer
        session._close()


def span(name: str):
    """A context for the range ``sift.<name>`` while spans are on; else the
    shared no-op :data:`NO_SPAN`."""
    if not _session.spans:
        return NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)


def counting() -> bool:
    """Whether counters are on: a caller whose value costs work (a device
    reduction, a formatted name) checks this first."""
    return _session.counting


def count(name: str, value) -> None:
    """Add ``value`` (a Python number or a 0-d tensor) to the counter
    ``name`` while counters are on; a tensor stays on its device until the
    session closes."""
    session = _session
    if not session.counting:
        return
    if isinstance(value, torch.Tensor):
        held = session._device.get(name)
        value = value.detach().to(torch.float64 if value.is_floating_point() else torch.int64)
        session._device[name] = value if held is None else held + value
    else:
        session._host[name] = session._host.get(name, 0) + value


def tensor_leaves(tree) -> list[torch.Tensor]:
    """Every tensor in a tree of dataclasses, dicts, lists and tuples."""
    return [leaf for leaf in flatten_with_paths(tree)[1] if isinstance(leaf, torch.Tensor)]


class StageProfile:
    """Accumulates wall-clock per named stage + device round-trip counts.

    Each stage is also the span ``sift.slam.<name>`` (:func:`span`).

    Usage::

        prof = StageProfile()
        with prof.stage("pnp"):
            out = solve_pnp(...)
            prof.sync(out)        # count a device round trip + block
        print(prof.report())
    """

    def __init__(self) -> None:
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.dispatches: int = 0

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span("slam." + name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1

    def sync(self, value) -> None:
        """Wait for the card that holds ``value``'s tensors (nothing to wait
        for on the CPU) and count one host↔device round trip."""
        for device in {t.device for t in tensor_leaves(value) if t.is_cuda}:
            torch.cuda.synchronize(device)
        self.dispatches += 1

    def count(self, n: int = 1) -> None:
        """Count device round trips that were synced elsewhere."""
        self.dispatches += n

    def report(self, total_frames: int | None = None) -> dict:
        """Structured summary: per-stage seconds/calls, sorted by cost."""
        order = sorted(self.seconds, key=self.seconds.get, reverse=True)
        out = {
            "stages": {
                k: {
                    "s": round(self.seconds[k], 3),
                    "calls": self.calls[k],
                    "ms_per_call": round(1e3 * self.seconds[k] / self.calls[k], 2),
                }
                for k in order
            },
            "device_round_trips": self.dispatches,
            "total_s": round(sum(self.seconds.values()), 3),
        }
        if total_frames:
            out["ms_per_frame"] = {
                k: round(1e3 * self.seconds[k] / total_frames, 1) for k in order
            }
        return out
