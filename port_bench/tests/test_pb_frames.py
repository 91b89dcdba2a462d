"""The frames made from the seed: deterministic, seed-dependent, and the
host renderer's image."""

import numpy as np
import pytest
import torch

from port_bench import frames

from .cells import tiny_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("workload", ["tum-vga.describe-b64", "kitti-odom.describe-b64"])
def test_same_seed_same_frames_other_seed_other_frames(workload):
    cell = tiny_cell(workload, 120, 80)
    make = lambda seed: frames.make_frames(seed, cell["config"], cell["traffic"], 4, CPU)  # noqa: E731
    a, b, c = make(2**31 + 17), make(2**31 + 17), make(2**31 + 18)
    assert a.shape == (4, 80, 120) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert 0.0 <= float(a.min()) and float(a.max()) <= 1.0
    assert (a.double() * 255 - torch.round(a.double() * 255)).abs().max() < 1e-4  # 8-bit levels
    # One scene for every seed: another seed draws other sensor noise only.
    assert float((a - c).abs().mean()) < 0.02
    other = dict(cell["traffic"], scene=dict(cell["traffic"]["scene"], seed=1))
    d = frames.make_frames(2**31 + 17, cell["config"], other, 4, CPU)
    assert float((a - d).abs().mean()) > 2 * float((a - c).abs().mean())
    # Consecutive frames of one ring differ: the camera moves.
    assert not torch.equal(a[0], a[1])


def test_negative_and_large_seeds():
    cell = tiny_cell("tum-vga.describe-b64", 64, 48)
    for seed in (-5, 0, 2**40 + 3):
        f = frames.make_frames(seed, cell["config"], cell["traffic"], 2, CPU)
        assert torch.isfinite(f).all()


def test_matches_the_host_renderer():
    """Without noise, one frame equals the port's numpy renderer's on the
    same blob field and pose, up to rare quantisation flips."""
    from sift_scale_space_extrema_detection_tpu_torch.utils.synthetic import render_blob_image

    g = torch.Generator().manual_seed(3)
    pts, amps, scales = frames.blob_field(g, "zigzag", 8, 22.857142857142858, 3, 0.35, CPU)
    rots, ts = frames.poses("zigzag", 8)
    w, h = 160, 120
    k = (130.0, 130.0, 80.0, 60.0)
    ours = frames.render(g, pts, amps, scales, rots[5:6], ts[5:6], k, (w, h), noise=0.0)[0]
    k_mat = np.array([[k[0], 0, k[2]], [0, k[1], k[3]], [0, 0, 1.0]])
    host = render_blob_image(pts.numpy(), rots[5], ts[5], k_mat, (w, h), amplitudes=amps.numpy(),
                             sigma_scales=scales.numpy(), noise=0.0)
    diff = np.abs(ours.double().numpy() - host)
    assert diff.max() <= 1.0 / 255 + 1e-9
    assert (diff > 1e-6).mean() < 0.001  # a level apart, from float rounding at a half level
    assert host.std() > 0.02  # the frame has texture
