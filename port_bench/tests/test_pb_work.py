"""The frozen work model against the port's ``frontend_bench`` at the
cells' shapes, and the counts it adds."""

import pytest
import torch

from port_bench import work
from port_bench.reference.config import SiftConfig
from port_bench.reference.frontend import pad_edges
from sift_scale_space_extrema_detection_tpu_torch.benchmarks import frontend_bench
from sift_scale_space_extrema_detection_tpu_torch.config import SiftConfig as PortConfig

SHAPES = [  # (spo, batch, height, width): the two cells, and bench.py's
    (5, 64, 480, 640),
    (3, 64, 384, 1280),
    (5, 8, 240, 320),
]


@pytest.mark.parametrize("spo,batch,height,width", SHAPES)
def test_k1_work_equals_frontend_bench(spo, batch, height, width):
    kw = dict(num_octaves=4, scales_per_octave=spo, max_keypoints_per_trio=512)
    ours = work.k1_work(SiftConfig(**kw), batch, height, width)
    theirs = frontend_bench.k1_work(PortConfig(**kw), batch, height, width)
    assert ours == theirs
    for (b, f, s) in ours:
        assert work.bound(b, f) == frontend_bench.bound(b, f)
        assert work.bound(b, f + s) == frontend_bench.bound(b, f + s)
    assert (work.PEAK_BYTES_PER_S, work.PEAK_FLOP_PER_S) == (
        frontend_bench.PEAK_BYTES_PER_S, frontend_bench.PEAK_FLOP_PER_S)


@pytest.mark.parametrize("spo,batch,height,width", SHAPES)
def test_pyramid_least_adds_the_stacks(spo, batch, height, width):
    cfg = SiftConfig(num_octaves=4, scales_per_octave=spo)
    detect = work.pyramid_least_s(cfg, batch, height, width, "fused", False)
    k1 = sum(work.bound(b, f + s)[0] for b, f, s in work.k1_work(cfg, batch, height, width))
    assert detect == pytest.approx(k1 / 1e3, rel=1e-12)
    describe = work.pyramid_least_s(cfg, batch, height, width, "fused", True)
    planes = work.octave_planes(cfg, height, width)
    with_stacks = sum(
        work.bound(b + 4 * (cfg.scales_per_octave_total - 1) * batch * h * w, f + s)[0]
        for (b, f, s), (h, w) in zip(work.k1_work(cfg, batch, height, width), planes))
    assert describe == pytest.approx(with_stacks / 1e3, rel=1e-12)
    assert describe > detect
    assert work.pyramid_least_s(cfg, batch, height, width, "cuda", True) > 0


def test_octave_planes_of_the_padded_kitti_frame():
    frame = torch.zeros(1, 376, 1241)
    padded = pad_edges(frame, (32, 64))
    assert tuple(padded.shape[-2:]) == (384, 1280)
    cfg = SiftConfig(num_octaves=4, scales_per_octave=3)
    assert work.octave_planes(cfg, 384, 1280) == [(768, 2560), (384, 1280), (192, 640), (96, 320)]


def test_window_bytes_counts_table_samples_and_windows():
    planes = [(100, 100)]
    table = torch.tensor([[0, 0, 1, 1], [0, 0, 1, 0]], dtype=torch.int32)
    ys = torch.tensor([[10.0, 12.5], [0.0, 0.0]])
    xs = torch.tensor([[20.0, 20.0], [0.0, 0.0]])
    # valid slot: rows 9..14 (6), columns 19..22 (4): 24 pixels
    assert work.window_bytes(planes, table, ys, xs) == 16 * 2 + 8 * 2 * 2 + 1 * 8 * 2 + 4 * 24
