"""The comparison pairs keypoints whatever their slots, and counts what
finds no partner."""

import math

import torch

from port_bench import compare
from port_bench.reference.config import SiftConfig

CFG = SiftConfig(num_octaves=4, scales_per_octave=3)


def _frame(rows):
    """Fields ``(1, N)`` of keypoints ``(octave, level, y, x, sigma, theta)``,
    one invalid slot after them."""
    n = len(rows) + 1
    t = torch.tensor(rows + [(0, 1, 0.0, 0.0, 0.0, 0.0)], dtype=torch.float64)
    out = {"octave": t[:, 0].int(), "scale_level": t[:, 1].int(), "abs_y": t[:, 2].float(),
           "abs_x": t[:, 3].float(), "abs_sigma": t[:, 4].float(), "theta": t[:, 5].float(),
           "descriptor": torch.nn.functional.normalize(torch.rand(n, 128), dim=-1),
           "valid": torch.arange(n) < len(rows)}
    return {k: v[None] for k, v in out.items()}


ROWS = [(0, 1, 10.0, 20.0, 1.0, 0.5), (0, 1, 10.0, 20.0, 1.0, 2.0),
        (1, 2, 40.0, 33.0, 3.0, 6.2), (3, 1, 80.0, 90.0, 9.0, 1.0)]


def test_slots_in_another_order_pair_exactly():
    want = _frame(ROWS)
    order = [3, 1, 0, 2, 4]
    got = {k: v[:, order] for k, v in want.items()}
    g = compare.gaps(got, want, CFG)
    assert g == {"unmatched_share": 0.0, "position_opx": 0.0, "theta_rad": 0.0,
                 "descriptor_dist": 0.0, "reference_slots": 4}


def test_small_gaps_are_the_median_pairs_in_the_octaves_pixels():
    want = _frame(ROWS)
    got = {k: v.clone() for k, v in want.items()}
    got["abs_x"][0, 3] += 0.8  # octave 3: a pixel is 4 input pixels
    got["abs_x"][0, 2] += 0.2  # octave 1: a pixel is 1 input pixel
    got["abs_x"][0, :2] += 0.05  # octave 0: a pixel is half an input pixel
    got["theta"][0, 2] = 0.0  # 6.2 → 0 across 2π: under half a bin
    got["theta"][0, 3] += 0.01
    g = compare.gaps(got, want, CFG)
    assert g["unmatched_share"] == 0.0
    # gaps 0.1, 0.1, 0.2, 0.2 opx: torch's median is the lower middle one
    assert math.isclose(g["position_opx"], 0.1, rel_tol=1e-4)
    assert math.isclose(g["theta_rad"], 0.0, abs_tol=1e-6)
    got["theta"][0, 0] += 0.02
    assert math.isclose(compare.gaps(got, want, CFG)["theta_rad"], 0.01, rel_tol=1e-4)


def test_a_keypoint_beyond_half_a_pixel_or_in_another_level_is_unmatched():
    want = _frame(ROWS)
    moved = {k: v.clone() for k, v in want.items()}
    moved["abs_y"][0, 0] += 0.3  # octave 0: 0.6 of its pixel
    assert compare.gaps(moved, want, CFG)["unmatched_share"] == 1 - 2 * 3 / 8
    level = {k: v.clone() for k, v in want.items()}
    level["scale_level"][0, 2] = 3
    assert compare.gaps(level, want, CFG)["unmatched_share"] == 1 - 2 * 3 / 8


def test_the_worst_frame_counts():
    one = _frame(ROWS)
    want = {k: torch.cat([v, v]) for k, v in one.items()}
    got = {k: v.clone() for k, v in want.items()}
    got["valid"][1, 1:] = False
    g = compare.gaps(got, want, CFG)
    assert g["unmatched_share"] == 1 - 2 * 1 / 5 and g["reference_slots"] == 8
