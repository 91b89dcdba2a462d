"""The port's descriptors and matching against OpenCV's SIFT: the mirror of
``tests/test_descriptor_opencv.py``'s four tests at their bars.

A synthetic textured image and a known similarity warp of it (rotation 20°,
scale 1.15, a translation): each pipeline detects, describes and matches
(ratio 0.8, the port's matches mutual as well), and a match is correct when
it lies within 3 px of the warped source point. The port runs with
``device="cpu"``; the scene, the warp and the scoring are the reference
test's own, and the recall grid's helpers are those of
``benchmarks/descriptor_bench.py``, as in that test.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import sift_scale_space_extrema_detection_tpu_torch as port

from tests.test_descriptor_opencv import _score, _warp_pair
from tests.torch_dist_ranks import REPO

torch.set_num_threads(2)

CFG = port.SiftConfig(num_octaves=3, max_keypoints_per_trio=256)


def _describe(image):
    """``(positions (N, 2), descriptors (N, 128))`` of the valid slots."""
    d = port.detect_and_describe(torch.from_numpy(np.asarray(image, np.float32)), CFG,
                                 device="cpu")
    v = d.valid.numpy()
    return np.stack([d.abs_x.numpy(), d.abs_y.numpy()], -1)[v], d.descriptor.numpy()[v]


def _match(desc_a, desc_b):
    """``(a slots, b slots)`` of the ratio + mutual matches."""
    m = port.match_descriptors(
        torch.from_numpy(desc_a), torch.ones(len(desc_a), dtype=torch.bool),
        torch.from_numpy(desc_b), torch.ones(len(desc_b), dtype=torch.bool),
        ratio=0.8, device="cpu",
    )
    sel = np.flatnonzero(m.valid.numpy())
    return sel, m.index.numpy()[sel]


@pytest.fixture(scope="module")
def pair_scores():
    img, img2, a_mat = _warp_pair()
    pa, da = _describe(img)
    pb, db = _describe(img2)
    sel, idx = _match(da, db)
    ours = _score(pa[sel], pb[idx], a_mat)

    sift = cv2.SIFT_create()
    ka, desc_a = sift.detectAndCompute((img * 255).astype(np.uint8), None)
    kb, desc_b = sift.detectAndCompute((img2 * 255).astype(np.uint8), None)
    knn = cv2.BFMatcher().knnMatch(desc_a, desc_b, k=2)
    good = [mm for mm, nn in knn if mm.distance < 0.8 * nn.distance]
    cpa = np.array([ka[mm.queryIdx].pt for mm in good])
    cpb = np.array([kb[mm.trainIdx].pt for mm in good])
    theirs = _score(cpa, cpb, a_mat)
    return ours, theirs


def test_our_matches_are_geometrically_correct(pair_scores):
    (n, correct), _ = pair_scores
    assert n >= 12, f"too few matches to assess quality: {n}"
    assert correct / n >= 0.9, f"precision {correct}/{n}"


def test_metric_sanity_opencv_precision(pair_scores):
    # The protocol must rate standard SIFT highly, or the bar above tests
    # the protocol and not the descriptors.
    _, (n, correct) = pair_scores
    assert n >= 30 and correct / n >= 0.9, f"cv2 {correct}/{n}"


def test_match_yield_within_family_of_standard_sift(pair_scores):
    # The reference's thresholds detect fewer keypoints than OpenCV's
    # defaults: fewer correct matches, but of the same order.
    (_, ours_correct), (_, cv_correct) = pair_scores
    assert ours_correct >= 0.25 * cv_correct, (ours_correct, cv_correct)


def test_recall_floor_over_warp_grid():
    """Descriptor recall and precision over three warps of the grid of
    ``benchmarks/descriptor_bench.py``, at the reference test's floors."""
    sys.path.insert(0, str(REPO / "benchmarks"))
    import descriptor_bench as dbench

    img = dbench.textured_image(np.random.default_rng(7))
    pa, da = _describe(img)
    recalls, precisions = [], []
    for rdeg, s in [(20.0, 1.0), (90.0, 1.0), (45.0, 1.25)]:
        a_mat = dbench.warp_matrix(rdeg, s)
        img2 = cv2.warpAffine(img, a_mat, (dbench.W, dbench.H), flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_REFLECT)
        pb, db = _describe(img2)
        sel, idx = _match(da, db)
        row = dbench.score_warp(pa, pb, np.stack([sel, idx], -1), a_mat)
        recalls.append(row["recall"])
        precisions.append(row["precision"])
    assert float(np.mean(recalls)) >= 0.6, recalls
    assert float(np.mean(precisions)) >= 0.9, precisions
