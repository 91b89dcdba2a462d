"""Observability: per-stage timing, keypoint counters and profiler capture.

Port of the JAX package's ``utils/metrics.py``:

- :class:`StageTimer` — wall-clock per pipeline stage, ended by a forced
  device sync (:func:`device_sync`).
- :func:`keypoint_stats` — counters of the rejection taxonomy plus the
  occupancy and overflow of the fixed-capacity buffers (overflow is the one
  failure mode the fixed-shape design can hide; this keeps it observable).
- :func:`trace` — a ``torch.profiler`` capture written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

from ..core.types import NUM_REJECT_REASONS, REJECT_REASON_NAMES
from .profile import tensor_leaves


def device_sync(tree) -> float:
    """Force execution to finish: every tensor leaf reduced to a scalar and
    read on the host. Reducing only the first leaf would leave work that
    others wait on outside a measured window. Returns the sum."""
    return sum(float(leaf.to(torch.float32).sum()) for leaf in tensor_leaves(tree))


@dataclass
class StageTimer:
    """Accumulates per-stage wall-clock across repeated pipeline runs."""

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, sync_tree=None):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            if "result" in holder:
                device_sync(holder["result"])
            elif sync_tree is not None:
                device_sync(sync_tree)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in self.totals.items():
            n = self.counts[name]
            lines.append(f"{name}: {1e3 * total / n:.1f} ms/call ({n} calls)")
        return "\n".join(lines)


def keypoint_stats(keypoints, extrema=None) -> dict:
    """Counters of a :class:`~..core.types.Keypoints` buffer (and optionally
    its :class:`~..core.types.Extrema`): the rejection taxonomy, the buffer's
    occupancy and the candidates that overflowed it, each summed over a
    batch."""
    counts = keypoints.reject_counts().reshape(-1, NUM_REJECT_REASONS).sum(dim=0)
    stats = {name: int(c) for name, c in zip(REJECT_REASON_NAMES, counts.tolist())}
    stats["capacity"] = int(keypoints.valid.numel())
    stats["occupied"] = int((keypoints.reject_reason >= 0).sum())
    if extrema is not None:
        total_candidates = 0
        stored = 0
        for e in extrema if isinstance(extrema, (list, tuple)) else [extrema]:
            total_candidates += int(e.num_candidates.sum())
            stored += int(e.valid.sum())
        stats["candidates_found"] = total_candidates
        stats["candidates_stored"] = stored
        stats["candidates_overflowed"] = max(0, total_candidates - stored)
    return stats


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (the CPU, and the card where there
    is one); writes ``log_dir/trace.json``, a Chrome trace (Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

