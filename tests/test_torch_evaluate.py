"""The port's dataset evaluator (``evaluate.py``) against the JAX package's.

A TUM and a KITTI fixture, the scenes of ``tests/test_datasets.py``'s two
end-to-end tests cut from 6 frames to 4, go through both evaluators: the
frame counts are equal, both ATEs are under the JAX tests' bars (0.25 and
0.15), and each package reads the other's trajectory file. The TUM fixture
is written by the port's writer, the KITTI fixture by the JAX package's.
The full-size mirrors of the two JAX tests run the port alone (``-m slow``).

The JAX package's SLAM compiles here with JAX's persistent compilation cache
switched off: loading a cached SLAM executable can crash XLA:CPU
(``ROADMAP.md`` §3)."""

import json

import numpy as np
import jax
import pytest
import torch

from sift_scale_space_extrema_detection_tpu import data as jdata
from sift_scale_space_extrema_detection_tpu import evaluate as jev
from sift_scale_space_extrema_detection_tpu_torch import data as pdata
from sift_scale_space_extrema_detection_tpu_torch import evaluate as pev
from sift_scale_space_extrema_detection_tpu_torch.sfm import geometry as pgeo
from sift_scale_space_extrema_detection_tpu_torch.utils.synthetic import (
    render_blob_image,
    textured_blob_field,
)

torch.set_num_threads(2)

FLAGS = ["--octaves", "3", "--capacity", "256"]


@pytest.fixture(scope="module", autouse=True)
def _no_persistent_jax_cache():
    before = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", before)


def _render(seed, n, w, h, focal, lo, hi, num_pts, turn, step, noise_seed):
    """``tests/test_datasets.py``'s fixture scenes: a dolly past a textured
    blob field. Returns ``(images, rotations, translations, k_mat)``."""
    rng = np.random.default_rng(seed)
    k_mat = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]])
    pts = rng.uniform(lo, hi, size=(num_pts, 3))
    rpts, amps, ss = textured_blob_field(rng, pts)
    rots, ts, imgs = [], [], []
    for f in range(n):
        r = pgeo.so3_exp(torch.tensor([turn[0] * f, turn[1] * f, 0.0], dtype=torch.float64)).numpy()
        center = np.array([step[0] * f, step[1] * f, 0.0])
        rots.append(r)
        ts.append(-r @ center)
        imgs.append(render_blob_image(rpts, r, ts[-1], k_mat, (w, h), amplitudes=amps,
                                      sigma_scales=ss, rng=np.random.default_rng(noise_seed + f)))
    return np.stack(imgs), np.stack(rots), np.stack(ts), k_mat


def tum_fixture(root, n, writer=pdata):
    """``test_evaluate_cli_end_to_end``'s 320×240 sequence, ``n`` frames."""
    images, rots, ts, _ = _render(4, n, 320, 240, 260.0, [-3.5, -1.8, 4.0], [3.5, 1.8, 9.0], 110,
                                  (0.004, -0.01), (0.3, 0.02), 200)
    writer.write_tum_sequence(root, images, np.arange(n) / 30.0, rots, ts)


def kitti_fixture(root, n, writer=pdata):
    """``test_evaluate_cli_kitti_end_to_end``'s 310×110 sequence (padded to
    320×128 by the evaluators), ``n`` frames, sequence 07."""
    images, rots, ts, k_mat = _render(5, n, 310, 110, 200.0, [-2.5, -0.9, 3.0], [2.5, 0.9, 8.0],
                                      130, (0.003, -0.008), (0.25, 0.015), 300)
    writer.write_kitti_sequence(root, "07", images, np.arange(n) * 0.1, rots, ts, k_mat)


def _evaluate(main, capsys, argv):
    assert main(argv) == 0
    out = capsys.readouterr().out
    return json.loads(out.strip().splitlines()[-1]), out


def _both(tmp_path, capsys, root, extra):
    jtraj, ptraj = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    jm, jout = _evaluate(jev.main, capsys, [root, *extra, *FLAGS, "--out-traj", jtraj])
    pm, pout = _evaluate(pev.main, capsys, [root, *extra, *FLAGS, "--out-traj", ptraj,
                                            "--device", "cpu"])
    # Each package reads the other's trajectory.
    for read, path, other in ((pdata.read_tum_trajectory, jtraj, jdata.read_tum_trajectory),
                              (jdata.read_tum_trajectory, ptraj, pdata.read_tum_trajectory)):
        got = read(path)
        assert got[0].shape == (pm["frames"],)
        for g, w in zip(got, other(path)):
            np.testing.assert_array_equal(g, w)
        assert np.isfinite(got[1]).all() and np.isfinite(got[2]).all()
    return jm, pm, jout, pout


def test_tum_fixture_through_both_evaluators(tmp_path, capsys):
    root = str(tmp_path / "rgbd_dataset_freiburg_synth")
    tum_fixture(root, 4)
    jm, pm, _, _ = _both(tmp_path, capsys, root, [])
    assert jm["frames"] == pm["frames"] == 4
    assert jm["format"] == pm["format"] == "tum"
    assert jm["ate_rmse"] < 0.25 and pm["ate_rmse"] < 0.25, (jm, pm)
    # The JAX run above is its default ``--blur separable``; the port's
    # ``--blur separable`` runs the same frontend.
    sm, _ = _evaluate(pev.main, capsys, [root, *FLAGS, "--blur", "separable", "--device", "cpu"])
    assert sm["frames"] == 4 and sm["ate_rmse"] < 0.25, sm


def test_kitti_fixture_through_both_evaluators(tmp_path, capsys):
    root = str(tmp_path / "kitti_root")
    kitti_fixture(root, 4, writer=jdata)
    jm, pm, jout, pout = _both(tmp_path, capsys, root, ["--sequence", "07"])
    assert "padded to 320x128" in jout and "padded to 320x128" in pout
    assert jm["frames"] == pm["frames"] == 4
    assert jm["format"] == pm["format"] == "kitti"
    assert jm["ate_rmse"] < 0.15 and pm["ate_rmse"] < 0.15, (jm, pm)


def test_no_pad_keeps_the_frames_as_they_are(tmp_path, capsys):
    root = str(tmp_path / "kitti_root")
    kitti_fixture(root, 3)
    _, out = _evaluate(pev.main, capsys, [root, "--sequence", "07", "--no-pad", "--device", "cpu",
                                          *FLAGS, "--max-frames", "3"])
    assert "kitti: 3 frames 310x110, loaded in" in out


def test_detect_format_names_what_it_found(tmp_path):
    with pytest.raises(SystemExit, match="neither a TUM"):
        pev.detect_format(str(tmp_path))


# --- full-size mirrors of tests/test_datasets.py's end-to-end tests ---------------


@pytest.mark.slow
def test_evaluate_cli_end_to_end(tmp_path, capsys):
    root = str(tmp_path / "rgbd_dataset_freiburg_synth")
    tum_fixture(root, 6)
    traj = str(tmp_path / "est.txt")
    metrics, _ = _evaluate(pev.main, capsys, [root, *FLAGS, "--out-traj", traj, "--device", "cpu"])
    assert metrics["frames"] == 6
    assert metrics["ate_rmse"] < 0.25  # ~2-unit trajectory; wrong-K slack
    ts_read, _, _ = pdata.read_tum_trajectory(traj)
    assert len(ts_read) == 6


@pytest.mark.slow
def test_evaluate_cli_kitti_end_to_end(tmp_path, capsys):
    root = str(tmp_path / "kitti_root")
    kitti_fixture(root, 6)
    metrics, out = _evaluate(pev.main, capsys, [root, "--sequence", "07", *FLAGS,
                                                "--device", "cpu"])
    assert "padded to 320x128" in out
    assert metrics["frames"] == 6
    assert metrics["ate_rmse"] < 0.15  # true K; ~1.3-unit trajectory
