"""The comparison that decides ``correct``: the program's keypoints and
descriptors of a batch against the reference's, keypoint by keypoint.

The two sides need not fill their slots in the same order, nor agree on
the keypoints that sit on a threshold: a float32 sum in another order can
move a DoG value across one. So the keypoints of each frame are paired
first. Two keypoints are the same when they lie in the same octave and
scale level, within half a pixel of that octave (``position_opx``, below)
and, where they are oriented, within half a bin of the orientation
histogram; each pairs with the other's nearest, and only mutually. Each
number is a gap, 0 where the two agree, taken frame by frame, and the
batch's is its worst frame's; it is compared with its limit from the
configuration file (``checks``):

- ``unmatched_share``: the share of the frame's keypoints (both sides
  counted) that found no partner;
- ``position_opx``: the median over the frame's pairs of the largest gap
  of ``abs_y``, ``abs_x`` and ``abs_sigma``, in pixels of the octave
  (``min_interpixel_distance · 2^octave`` input pixels);
- ``theta_rad``: the median circular gap of the pairs' orientations;
- ``descriptor_dist``: the median Euclidean distance between the pairs'
  unit descriptors.

The gaps of a pair are medians, not maxima: a keypoint whose orientation
histogram has two near peaks, or whose refinement stops near a step,
turns a float32 rounding into a gap as wide as the pairing allows, so
the widest pair of a batch reads alike for the program and for the
control; the median pair does not.

A batch whose reference has no valid keypoint cannot be judged: it counts
as not correct.
"""

from __future__ import annotations

import math

import torch

NAMES = ("unmatched_share", "position_opx", "theta_rad", "descriptor_dist")
RADIUS = 0.5  # half a pixel of the octave, half an orientation bin


def fields(result) -> dict:
    """The compared fields of a result (``Keypoints``, ``DescribedKeypoints``,
    or ``detect_batched``'s ``(keypoints, extrema)``), as a dict of tensors."""
    if isinstance(result, tuple):
        result = result[0]
    out = {k: getattr(result, k) for k in ("octave", "scale_level", "abs_y", "abs_x",
                                           "abs_sigma", "valid")}
    for k in ("theta", "descriptor"):
        if hasattr(result, k):
            out[k] = getattr(result, k)
    return out


def _circular(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = (a - b).abs() % (2 * math.pi)
    return torch.minimum(d, 2 * math.pi - d)


def pairs(got: dict, want: dict, cfg) -> tuple[torch.Tensor, torch.Tensor, int, int]:
    """``(i, j, n_got, n_want)`` of one frame's fields (``(N,)`` each):
    the slots of ``got`` and of ``want`` that pair (see the module), and
    the valid keypoints on each side."""
    gi = torch.nonzero(got["valid"]).squeeze(1)
    wj = torch.nonzero(want["valid"]).squeeze(1)
    if not len(gi) or not len(wj):
        return gi[:0], wj[:0], len(gi), len(wj)
    g = {k: v[gi] for k, v in got.items()}
    w = {k: v[wj] for k, v in want.items()}
    pixel = cfg.min_interpixel_distance * torch.exp2(w["octave"].double())
    cost = torch.zeros((len(gi), len(wj)), dtype=torch.float64, device=gi.device)
    for k in ("abs_y", "abs_x", "abs_sigma"):
        cost = torch.maximum(cost, (g[k].double()[:, None] - w[k].double()[None, :]).abs())
    cost = cost / pixel[None, :]
    if "theta" in w:
        bin_rad = 2 * math.pi / cfg.n_orientation_bins
        cost = torch.maximum(cost, _circular(g["theta"].double()[:, None],
                                             w["theta"].double()[None, :]) / bin_rad)
    same = ((g["octave"][:, None] == w["octave"][None, :])
            & (g["scale_level"][:, None] == w["scale_level"][None, :]))
    cost = torch.where(same, cost, math.inf)
    to_w, to_g = cost.argmin(1), cost.argmin(0)
    rows = torch.arange(len(gi), device=cost.device)
    keep = (to_g[to_w] == rows) & (cost[rows, to_w] <= RADIUS)
    return gi[keep], wj[to_w[keep]], len(gi), len(wj)


def gaps(got: dict, want: dict, cfg) -> dict:
    """The numbers above for one batch (see the module)."""
    if got["valid"].shape[0] != want["valid"].shape[0]:
        return {n: math.inf for n in NAMES} | {"reference_slots": int(want["valid"].sum())}
    out = dict.fromkeys(NAMES[:3], 0.0) | {"reference_slots": int(want["valid"].sum())}
    if "theta" in want:
        out["descriptor_dist"] = 0.0
    else:
        del out["theta_rad"]
    for b in range(want["valid"].shape[0]):
        g = {k: v[b] for k, v in got.items()}
        w = {k: v[b] for k, v in want.items()}
        i, j, n_got, n_want = pairs(g, w, cfg)
        if n_got + n_want:
            out["unmatched_share"] = max(out["unmatched_share"],
                                         1.0 - 2 * len(i) / (n_got + n_want))
        if not len(i):
            continue
        pixel = cfg.min_interpixel_distance * torch.exp2(w["octave"][j].double())
        pos = torch.stack([(g[k][i].double() - w[k][j].double()).abs()
                           for k in ("abs_y", "abs_x", "abs_sigma")]).amax(0) / pixel
        out["position_opx"] = max(out["position_opx"], float(pos.median()))
        if "theta" in w:
            out["theta_rad"] = max(out["theta_rad"], float(
                _circular(g["theta"][i].double(), w["theta"][j].double()).median()))
            out["descriptor_dist"] = max(out["descriptor_dist"], float(
                (g["descriptor"][i].double() - w["descriptor"][j].double())
                .norm(dim=-1).median()))
    return out


def worst(per_batch: list[dict]) -> dict:
    """The largest of each number over the compared batches."""
    out = {}
    for g in per_batch:
        for k, v in g.items():
            if k == "reference_slots":
                out[k] = min(out.get(k, v), v)
            else:
                out[k] = max(out.get(k, v), v)
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number with a limit
    at or under it, and a reference with valid slots."""
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in NAMES
              if n in limits and n in numbers}
    ok = numbers.get("reference_slots", 0) > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
