"""Wall-clock stage profiler for the host-orchestrated SLAM pipeline.

Port of the JAX package's ``utils/profile.py``: per-stage wall-clock
accumulators plus a counter of host↔device round trips, so "where do the
ms/frame go" is answered by measurement.

Profiling SYNCS at stage boundaries (``torch.cuda.synchronize`` on the
device of the stage's outputs) so each stage's time includes its own
device work instead of leaking into whichever later stage first reads a
value. That makes profiled runs slower than production runs: use it for
attribution, never for headline throughput.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch

from .checkpoint import flatten_with_paths


def tensor_leaves(tree) -> list[torch.Tensor]:
    """Every tensor in a tree of dataclasses, dicts, lists and tuples."""
    return [leaf for leaf in flatten_with_paths(tree)[1] if isinstance(leaf, torch.Tensor)]


class StageProfile:
    """Accumulates wall-clock per named stage + device round-trip counts.

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
