"""Keypoint counters: :func:`keypoint_stats`.

Port of the JAX package's ``utils/metrics.py``: counters of the rejection
taxonomy plus the occupancy and overflow of the fixed-capacity buffers
(overflow is the one failure mode the fixed-shape design can hide; this
keeps it observable). Spans and counters of the program's own work are in
``utils/profile.py``.
"""

from __future__ import annotations

from ..core.types import NUM_REJECT_REASONS, REJECT_REASON_NAMES


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
