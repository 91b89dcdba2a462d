"""The port's SLAM back end (``models/slam.py``) on synthetic sequences: the
mirrors of ``tests/test_slam.py`` at the same sizes and bars, run with
``device="cpu"``; and ``run_slam`` from both packages in float64 on one
orbit sequence, with the JAX package's RANSAC draws substituted in the
port, giving the same map and the same trajectory.

The reference's runs in this file (one ``run_slam``) compile with JAX's
persistent compilation cache switched off: loading a cached SLAM executable
can crash XLA:CPU (``ROADMAP.md`` §3)."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from sift_scale_space_extrema_detection_tpu.models import slam as jslam
from sift_scale_space_extrema_detection_tpu.utils.synthetic import orbit_sequence
import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.models import slam as pslam
from sift_scale_space_extrema_detection_tpu_torch.models.slam import (
    SlamConfig,
    build_tracks_from_images,
    evaluate_ate,
    measure_loop_edge,
    run_slam,
)
from sift_scale_space_extrema_detection_tpu_torch.ops import ransac as pransac
from sift_scale_space_extrema_detection_tpu_torch.sfm import geometry as pgeo
from sift_scale_space_extrema_detection_tpu_torch.utils import checkpoint as pckpt
from sift_scale_space_extrema_detection_tpu_torch.utils.profile import StageProfile

from tests.torch_port_helpers import (
    K_LOOP,
    jax_ransac_draws,
    loop_distractor_images,
    loop_gap_images,
)

torch.set_num_threads(2)

CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _no_persistent_jax_cache():
    before = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", before)


def _ate(result, seq):
    return evaluate_ate(result, seq.rotations, seq.translations, **CPU)


def test_slam_config_is_the_references():
    want = {f.name: f.default for f in dataclasses.fields(jslam.SlamConfig)}
    assert {f.name: f.default for f in dataclasses.fields(SlamConfig)} == want


def test_run_slam_matches_the_reference_in_float64(monkeypatch):
    # Same sequence and config as the short-sequence test; the port draws
    # JAX's hypotheses (PRNGKey(0) at bootstrap over the unpadded slots).
    seq = orbit_sequence(np.random.default_rng(3), num_frames=8, num_landmarks=150, noise_px=0.3)
    want = jslam.run_slam(seq.pixels, seq.visible, seq.k_mat, jslam.SlamConfig(ba_interval=3))
    monkeypatch.setattr(pransac, "sample_minimal_sets", jax_ransac_draws)
    got = run_slam(seq.pixels, seq.visible, seq.k_mat, SlamConfig(ba_interval=3),
                   dtype=torch.float64, **CPU)
    np.testing.assert_array_equal(got.landmark_valid, want.landmark_valid)
    assert got.num_observations == want.num_observations > 100
    np.testing.assert_allclose(got.rotations, want.rotations, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.translations, want.translations, rtol=0, atol=1e-6)
    valid = want.landmark_valid
    np.testing.assert_allclose(got.points[valid], want.points[valid], rtol=0, atol=1e-6)
    assert np.isnan(got.points[~valid]).all() == np.isnan(want.points[~valid]).all()


def _config3_sequence():
    """BASELINE config[3]: 50 keyframes orbiting 400 landmarks, 0.4 px of
    noise, 2 % outliers (tests/test_slam.py:46-60)."""
    return orbit_sequence(np.random.default_rng(2), num_frames=50, num_landmarks=400,
                          noise_px=0.4, outlier_frac=0.02)


def test_slam_50_keyframes_ate():
    """BASELINE config[3] through the port: more than 200 valid landmarks
    and ATE < 0.08 (1 % of the orbit's radius), the reference's bars."""
    seq = _config3_sequence()
    result = run_slam(seq.pixels, seq.visible, seq.k_mat, SlamConfig(), **CPU)
    assert result.landmark_valid.sum() > 200
    ate = _ate(result, seq)
    assert ate < 0.08, f"ATE {ate:.4f} exceeds bound"


@pytest.mark.slow
def test_slam_50_keyframes_ate_in_both_packages():
    """BASELINE config[3] through both packages, each at the reference's
    bars (the JAX package's run takes minutes to compile)."""
    seq = _config3_sequence()
    want = jslam.run_slam(seq.pixels, seq.visible, seq.k_mat, jslam.SlamConfig())
    got = run_slam(seq.pixels, seq.visible, seq.k_mat, SlamConfig(), **CPU)
    for result in (want, got):
        assert result.landmark_valid.sum() > 200
        ate = _ate(result, seq)
        assert ate < 0.08, f"ATE {ate:.4f} exceeds bound"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_slam_short_sequence_runs(dtype):
    seq = orbit_sequence(np.random.default_rng(3), num_frames=8, num_landmarks=150, noise_px=0.3)
    result = run_slam(seq.pixels, seq.visible, seq.k_mat, SlamConfig(ba_interval=3),
                      dtype=dtype, **CPU)
    ate = _ate(result, seq)
    assert ate < 0.1, f"ATE {ate:.4f}"
    assert result.num_observations > 100


def test_slam_records_its_stages():
    seq = orbit_sequence(np.random.default_rng(3), num_frames=8, num_landmarks=150, noise_px=0.3)
    prof = StageProfile()
    run_slam(seq.pixels, seq.visible, seq.k_mat, SlamConfig(ba_interval=3), profile=prof, **CPU)
    report = prof.report(total_frames=8)
    assert set(report["stages"]) == {"pnp_tri", "obs_record", "ba_windowed", "ba_final"}
    assert report["stages"]["pnp_tri"]["calls"] == 2  # windows [2, 5) and [5, 8)
    assert report["stages"]["ba_final"]["calls"] == 2
    assert report["device_round_trips"] == 4


def test_slam_with_pose_graph_step():
    """The pose-graph back-end layer runs and does not degrade accuracy."""
    seq = orbit_sequence(np.random.default_rng(4), num_frames=12, num_landmarks=200, noise_px=0.3)
    result = run_slam(seq.pixels, seq.visible, seq.k_mat,
                      SlamConfig(ba_interval=4, use_pose_graph=True), **CPU)
    ate = _ate(result, seq)
    assert ate < 0.1, f"ATE {ate:.4f}"


def test_loop_edge_measurement_matches_ground_truth():
    """A loop edge is measured from the pair's pixels: its rotation and
    translation direction match the ground-truth relative pose."""
    seq = orbit_sequence(np.random.default_rng(7), num_frames=12, num_landmarks=200, noise_px=0.1)
    a, b = 2, 9
    edge = measure_loop_edge(seq.pixels, seq.visible, seq.k_mat, seq.rotations,
                             seq.translations, a, b, SlamConfig(), **CPU)
    assert edge is not None, "loop pair with full covisibility must measure"
    rel_r, rel_t = edge
    gt_r = seq.rotations[b] @ seq.rotations[a].T
    gt_t = seq.translations[b] - gt_r @ seq.translations[a]
    ang_deg = np.degrees(np.arccos(np.clip((np.trace(rel_r @ gt_r.T) - 1.0) / 2.0, -1.0, 1.0)))
    assert ang_deg < 1.0, f"loop rotation off by {ang_deg:.2f} deg"
    cos_dir = np.dot(rel_t, gt_t) / (np.linalg.norm(rel_t) * np.linalg.norm(gt_t))
    assert cos_dir > 0.999, f"loop translation direction cos {cos_dir:.4f}"
    np.testing.assert_allclose(np.linalg.norm(rel_t), np.linalg.norm(gt_t), rtol=1e-6)


@pytest.mark.parametrize("store", ["disk", "mem"])
def test_slam_checkpoint_resume_matches_uninterrupted(tmp_path, store):
    """Kill the SLAM loop mid-sequence, resume, match the full run bit for
    bit (same inputs, same numerics, state fully restored)."""
    seq = orbit_sequence(np.random.default_rng(5), num_frames=16, num_landmarks=120, noise_px=0.3)
    cfg = SlamConfig(ba_interval=4)
    full = run_slam(seq.pixels, seq.visible, seq.k_mat, cfg, **CPU)

    ckpt = str(tmp_path / "slam_ckpt") if store == "disk" else "mem://test_torch_slam_resume"
    partial = run_slam(seq.pixels, seq.visible, seq.k_mat, cfg, checkpoint_dir=ckpt,
                       checkpoint_interval=3, _stop_after=8, **CPU)
    assert np.all(partial.rotations[12] == 0)  # later frames untouched
    resumed = run_slam(seq.pixels, seq.visible, seq.k_mat, cfg, checkpoint_dir=ckpt,
                       resume=True, **CPU)
    np.testing.assert_array_equal(resumed.rotations, full.rotations)
    np.testing.assert_array_equal(resumed.translations, full.translations)
    assert resumed.num_observations == full.num_observations
    pckpt.remove_checkpoint(ckpt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_tracks_no_frame_sees_change_no_bit(dtype):
    """The back end solves only what a window or a BA sees: appending tracks
    no frame sees (as a streaming session's later steps do) changes no
    bit of the trajectory or the map."""
    seq = orbit_sequence(np.random.default_rng(3), num_frames=8, num_landmarks=150, noise_px=0.3)
    cfg = SlamConfig(ba_interval=3)
    base = run_slam(seq.pixels, seq.visible, seq.k_mat, cfg, dtype=dtype, **CPU)
    pixels = np.concatenate([seq.pixels, np.ones((8, 900, 2))], axis=1)
    visible = np.concatenate([seq.visible, np.zeros((8, 900), bool)], axis=1)
    wide = run_slam(pixels, visible, seq.k_mat, cfg, dtype=dtype, **CPU)
    np.testing.assert_array_equal(wide.rotations, base.rotations)
    np.testing.assert_array_equal(wide.translations, base.translations)
    np.testing.assert_array_equal(wide.points[:150], base.points)
    assert not wide.landmark_valid[150:].any()
    assert wide.num_observations == base.num_observations


def test_pair_verification_does_not_depend_on_the_batch_pad():
    """A pair's inliers are the same whether its batch pads it to 64 or to
    512 slots, and whatever other pairs are verified with it: the draw is
    slot by slot, and every solve runs at the configuration's capacity in a
    group of ``PAIR_GROUP`` pairs (a streaming step verifies fewer pairs
    than the batch run)."""
    seq = orbit_sequence(np.random.default_rng(4), num_frames=4, num_landmarks=60, noise_px=0.3)
    ids = np.flatnonzero(seq.visible[1] & seq.visible[2])
    n = len(ids)
    rng = np.random.default_rng(0)
    wrong = rng.permutation(n)[: n // 3]  # a third of the matches swapped
    uv2 = seq.pixels[2, ids].copy()
    uv2[wrong] = uv2[np.roll(wrong, 1)]

    def verify(cap):
        uv_a = np.zeros((1, cap, 2), np.float32)
        uv_b = np.zeros((1, cap, 2), np.float32)
        mask = np.zeros((1, cap), bool)
        uv_a[0, :n], uv_b[0, :n], mask[0, :n] = seq.pixels[1, ids], uv2, True
        # Few hypotheses, so that other draws would find other inliers.
        return pslam._verify_pairs(uv_a, uv_b, mask, seq.k_mat, [2], 2.0 / seq.k_mat[0, 0], 4,
                                   512, torch.device("cpu"))[0]

    small, large = verify(64), verify(512)
    np.testing.assert_array_equal(small[:n], large[:n])
    assert not large[n:].any()
    assert 8 <= small.sum() < n

    # The same pair among others: first of a full group, and the tenth
    # pair, alone in the second group.
    others = np.random.default_rng(1).permutation(n)
    uv_a = np.zeros((10, 64, 2), np.float32)
    uv_b = np.zeros((10, 64, 2), np.float32)
    mask = np.zeros((10, 64), bool)
    for p in range(10):
        take = np.arange(n) if p in (0, 9) else others[: n - p]
        uv_a[p, : len(take)] = seq.pixels[1, ids[take]]
        uv_b[p, : len(take)] = uv2[take]
        mask[p, : len(take)] = True
    seeds = [2] + list(range(3, 11)) + [2]
    many = pslam._verify_pairs(uv_a, uv_b, mask, seq.k_mat, seeds, 2.0 / seq.k_mat[0, 0], 4,
                               512, torch.device("cpu"))
    np.testing.assert_array_equal(many[0, :n], small[:n])
    np.testing.assert_array_equal(many[9, :n], small[:n])


def test_pose_jump_gate_rejects_catastrophic_frame():
    """A frame whose observations are consistent with a far-away camera is
    rejected by ``pose_jump_gate`` (pose held, observations kept out of BA);
    ``pose_jump_gate=0`` reproduces the unguarded behaviour."""
    seq = orbit_sequence(np.random.default_rng(5), num_frames=16, num_landmarks=250, noise_px=0.2)
    pix = np.array(seq.pixels)
    k = 9
    # Re-project frame k's visible landmarks from a camera displaced by 60
    # units: a self-consistent but catastrophically wrong view.
    t_bad = seq.translations[k] - seq.rotations[k] @ np.array([60.0, 0.0, 0.0])
    cam = seq.points @ seq.rotations[k].T + t_bad
    uv_bad = pgeo.project(torch.from_numpy(cam), torch.from_numpy(seq.k_mat)).numpy()
    pix[k, seq.visible[k]] = uv_bad[seq.visible[k]]

    gated = run_slam(pix, seq.visible, seq.k_mat, SlamConfig(ba_interval=4), **CPU)
    ungated = run_slam(pix, seq.visible, seq.k_mat,
                       SlamConfig(ba_interval=4, pose_jump_gate=0.0), **CPU)

    def center(res, f):
        return -res.rotations[f].T @ res.translations[f]

    jump_ungated = np.linalg.norm(center(ungated, k) - center(ungated, k - 1))
    jump_gated = np.linalg.norm(center(gated, k) - center(gated, k - 1))
    assert jump_ungated > 10.0, f"corruption did not bite ({jump_ungated:.2f})"
    assert jump_gated < 2.0, f"gate failed to hold the pose ({jump_gated:.2f})"
    ate, ate_ungated = _ate(gated, seq), _ate(ungated, seq)
    assert ate < 0.8, f"gated ATE {ate:.4f}"
    assert ate < ate_ungated / 3, f"gated {ate:.3f} vs ungated {ate_ungated:.3f}"


SIFT_LOOP = port.SiftConfig(num_octaves=2, max_keypoints_per_trio=256)


def test_loop_closure_association_merges_tracks():
    """``loop_stride`` merges the reappeared keypoints into the original
    tracks across a featureless gap (essential-RANSAC verified);
    consecutive + window matching structurally cannot."""
    images = loop_gap_images()
    kw = dict(k_mat=K_LOOP, reassoc_window=0, loop_min_gap=3, loop_min_matches=8, **CPU)
    _, vis_off, _ = build_tracks_from_images(images, SIFT_LOOP, loop_stride=0, **kw)
    _, vis_on, _ = build_tracks_from_images(images, SIFT_LOOP, loop_stride=1, **kw)
    assert (vis_off[0] & vis_off[4]).sum() == 0
    merged = (vis_on[0] & vis_on[4]).sum()
    assert merged >= 8, f"only {merged} merged tracks"
    assert vis_on.shape[1] < vis_off.shape[1]  # union-find compacted


def test_loop_closure_sketch_prune_still_merges():
    """With ``loop_topk=2`` only 2 of the 8 eligible candidates per query
    get full descriptor matching; the pooled-sketch similarity must rank
    frame 0 into query 10's top 2, or the merge is lost."""
    _, vis, _ = build_tracks_from_images(
        loop_distractor_images(), SIFT_LOOP, k_mat=K_LOOP, reassoc_window=0, loop_min_gap=3,
        loop_min_matches=8, loop_stride=1, loop_topk=2, **CPU,
    )
    merged = (vis[0] & vis[10]).sum()
    assert merged >= 8, f"only {merged} merged tracks with topk=2"
