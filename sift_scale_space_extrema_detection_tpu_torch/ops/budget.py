"""A ranked per-image feature budget: keep each image's N strongest
(keypoint, orientation) pairs.

The rule of OpenCV's ``SIFT::create(nfeatures)`` (``KeyPointsFilter::retainBest``):
rank an image's valid pairs by their response, the refined DoG value's
magnitude ``|value|``, and keep every pair whose response is at or above
the N-th largest. Pairs tied with the N-th are kept too, so an image may
keep more than N; two orientations of one keypoint share its response
and are kept or dropped together. An image with at most N valid pairs
keeps them all.

The N-th response of each image is found on the device (``torch.topk``)
and compared there: no host synchronise.
"""

from __future__ import annotations

import torch

from ..utils.profile import count, counting


def budget_capacity(max_features: int, full: int) -> int:
    """Pair slots that a budget of ``max_features`` fills: the budget and
    room for ties at its boundary (a sixty-fourth of it, at least 64),
    at most ``full``, the slots ranked."""
    return min(full, max_features + max(64, max_features // 64))


def keep_strongest(strength: torch.Tensor, valid: torch.Tensor, max_features: int) -> torch.Tensor:
    """``(B, n)`` bool: each image's valid entries whose ``strength``
    (``(B, n)``, at least 0) is at or above its ``max_features``-th largest
    valid strength; every valid entry where an image has no more than
    ``max_features``. While counters are on, counts ``budget.pairs_ranked``
    (valid entries), ``budget.pairs_kept``, ``budget.ties_kept`` (kept
    beyond ``max_features``) and ``budget.images_bound`` (images with more
    than ``max_features`` valid entries)."""
    if max_features < 1:
        raise ValueError(f"max_features must be at least 1, got {max_features}")
    k = min(max_features, valid.shape[-1])
    # Invalid entries rank below every valid one; an image with fewer than k
    # valid entries then has a k-th largest score of -1 and keeps them all.
    score = torch.where(valid, strength, -1.0)
    kth = torch.topk(score, k, dim=-1, sorted=False).values.amin(dim=-1, keepdim=True)
    keep = valid & (strength >= kth)
    if counting():
        ranked = valid.sum(dim=-1)
        kept = keep.sum(dim=-1)
        count("budget.pairs_ranked", ranked.sum())
        count("budget.pairs_kept", kept.sum())
        count("budget.ties_kept", (kept - ranked.clamp(max=max_features)).sum())
        count("budget.images_bound", (ranked > max_features).sum())
    return keep
