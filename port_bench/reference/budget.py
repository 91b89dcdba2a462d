"""The ranked per-image feature budget in plain PyTorch: the frontend's
keypoints and descriptors of a photo collection, each image keeping its
``max_features`` strongest (keypoint, orientation) pairs.

It composes the frozen reference (``frontend.py``'s pyramid and
selection with refinement, ``descriptor.py``'s orientation and descriptor
stages) without editing it, and writes the budget out plainly:

1. every valid keypoint of each image, octaves in order, with no capacity;
2. orientation on all of them;
3. per image, its valid pairs sorted by response ``|value|`` (the refined
   DoG value), largest first; where it has more than ``max_features``,
   every pair at or above the ``max_features``-th response is kept, ties
   included (OpenCV's ``KeyPointsFilter::retainBest``);
4. descriptors of the kept pairs, in (octave, slot, orientation) order.

Fields come out ``(B, P)``, ``P`` the most pairs an image kept, with
``valid`` marking each image's own.
"""

from __future__ import annotations

import torch

from .config import SiftConfig
from .descriptor import (
    DescribedKeypoints,
    _descriptor_stage,
    _orientation_stage,
    _Slots,
)
from .frontend import pyramid, select_and_refine
from .sampling import window_sample_pair

FIELDS = ("octave", "scale_level", "abs_y", "abs_x", "abs_sigma", "value")


def strongest(strength: torch.Tensor, max_features: int) -> torch.Tensor:
    """``(n,)`` bool of one image's pairs: all of them where there are at
    most ``max_features``, else those whose ``strength`` is at or above
    the ``max_features``-th largest, by a full sort."""
    if len(strength) <= max_features:
        return torch.ones_like(strength, dtype=torch.bool)
    nth = torch.sort(strength, descending=True).values[max_features - 1]
    return strength >= nth


def describe_budgeted(stacks, keypoints, cfg: SiftConfig, max_features: int | None,
                      sample_fn=window_sample_pair) -> DescribedKeypoints:
    """Steps 1-4 of the module on per-octave keypoints (fields ``(B, n_o)``)
    and the Gaussian stacks; ``max_features=None`` keeps every pair."""
    n_ori = 1 if cfg.upright else cfg.max_orientations_per_keypoint
    cat = {k: torch.cat([getattr(kp, k) for kp in keypoints], dim=-1) for k in FIELDS + ("valid",)}
    images = cat["valid"].shape[0]
    device = cat["valid"].device
    # Every valid keypoint, image by image, each image's in slot order.
    image, column = torch.nonzero(cat["valid"], as_tuple=True)
    f = {k: cat[k][image, column] for k in FIELDS}
    delta = torch.exp2((f["octave"] - 1).to(torch.float32))
    f.update(y_loc=f["abs_y"] / delta, x_loc=f["abs_x"] / delta, sigma_loc=f["abs_sigma"] / delta,
             batch=image.to(torch.int32))

    def slots_of(g):
        return _Slots(stacks, *(g[k] for k in ("batch", "octave", "scale_level", "y_loc",
                                                "x_loc", "sigma_loc")),
                      torch.ones_like(g["octave"], dtype=torch.bool))

    if cfg.upright:
        theta = torch.zeros((len(image), 1), device=device)
        ori_valid = torch.ones((len(image), 1), dtype=torch.bool, device=device)
    else:
        theta, ori_valid = _orientation_stage(slots_of(f), cfg, sample_fn)
    pair = torch.nonzero(ori_valid.reshape(-1)).squeeze(1)  # (image, slot, orientation) order
    slot = pair // n_ori
    if max_features is not None:
        keep = torch.zeros_like(pair, dtype=torch.bool)
        for b in range(images):
            mine = torch.nonzero(image[slot] == b).squeeze(1)
            keep[mine] = strongest(f["value"][slot[mine]].abs(), max_features)
        pair, slot = pair[keep], slot[keep]
    g = {k: v[slot] for k, v in f.items()}
    g["theta"] = theta.reshape(-1)[pair]
    g["descriptor"] = _descriptor_stage(slots_of(g), g["theta"], cfg, sample_fn)
    # Each image's pairs into its own row, padded to the longest row.
    owner = image[slot]
    counts = torch.bincount(owner, minlength=images)
    width = int(counts.max()) if images else 0
    column = torch.arange(len(owner), device=device) - (torch.cumsum(counts, 0) - counts)[owner]
    out = {}
    for k in FIELDS[:5] + ("theta", "descriptor"):
        rows = torch.zeros((images, width, *g[k].shape[1:]), dtype=g[k].dtype, device=device)
        rows[owner, column] = g[k]
        out[k] = rows
    out["valid"] = torch.arange(width, device=device)[None, :] < counts[:, None]
    return DescribedKeypoints(**out)


def detect_and_describe_batched(images: torch.Tensor, cfg: SiftConfig, blur: str = "fused",
                                max_features: int | None = None) -> DescribedKeypoints:
    """Oriented keypoints with 128-D descriptors, fields ``(B, P)``, of
    ``(B, H, W)`` float32 frames in [0, 1], each image keeping its
    ``max_features`` strongest pairs (the module); refined octave by
    octave, as the port's describe path does."""
    dogs, masks, stacks = pyramid(images, cfg, blur, emit_scales=True)
    keypoints = select_and_refine(dogs, masks, cfg)
    del dogs, masks
    return describe_budgeted(stacks, keypoints, cfg, max_features)
