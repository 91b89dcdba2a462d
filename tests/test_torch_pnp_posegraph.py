"""The port's PnP and pose-graph optimization against the JAX package's,
on the same numpy inputs from a seed, both in float64 on the CPU (after
their iterations: poses within 1e-6, cost within a relative 1e-6), and the
behavioural tests of ``tests/test_pnp_posegraph.py`` on the port alone."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sift_scale_space_extrema_detection_tpu.sfm import pnp as jpnp
from sift_scale_space_extrema_detection_tpu.sfm import pose_graph as jpg
from sift_scale_space_extrema_detection_tpu_torch.sfm import geometry as pgeo
from sift_scale_space_extrema_detection_tpu_torch.sfm import pnp as ppnp
from sift_scale_space_extrema_detection_tpu_torch.sfm import pose_graph as ppg
from sift_scale_space_extrema_detection_tpu_torch.sfm.pnp import pnp_dlt, solve_pnp
from sift_scale_space_extrema_detection_tpu_torch.sfm.pose_graph import (
    PoseGraphEdges,
    optimize_pose_graph,
    pose_graph_residuals,
)

from tests.test_pnp_posegraph import _circle_graph, _pnp_problem
from tests.torch_port_helpers import edges_to_port, rotation_angle_deg

torch.set_num_threads(2)

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out.to(dtype) if dtype else out


def _problem(seed, **kw):
    """A PnP problem of ``tests/test_pnp_posegraph.py`` as numpy arrays."""
    pts, uv, r_true, t_true = _pnp_problem(np.random.default_rng(seed), **kw)
    return np.array(pts), np.array(uv), r_true, t_true


def _graph(seed, **kw):
    rots, ts, est_r, est_t, edges = _circle_graph(np.random.default_rng(seed), **kw)
    return rots, ts, est_r, est_t, edges, edges_to_port(edges)


# --- against JAX ----------------------------------------------------------------


@pytest.mark.parametrize("n_invalid", [0, 16])
def test_pnp_dlt_matches_jax(n_invalid):
    pts, uv, _, _ = _problem(0, noise_px=0.3)
    valid = np.arange(len(pts)) < len(pts) - n_invalid
    uv[~valid] += 300.0
    want = jpnp.pnp_dlt(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(K))
    got = pnp_dlt(_t(pts), _t(uv), _t(valid), _t(K))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-9)


@pytest.mark.parametrize(
    "huber_delta, outlier_frac", [(2.0, 0.0), (2.0, 0.2), (None, 0.0)],
    ids=["huber", "huber_outliers", "least_squares"],
)
def test_solve_pnp_matches_jax(huber_delta, outlier_frac):
    pts, uv, r_true, t_true = _problem(1, noise_px=0.5, outlier_frac=outlier_frac)
    valid = np.arange(len(pts)) % 9 != 0
    r0 = pgeo.so3_exp(torch.tensor([0.03, -0.02, 0.01], dtype=torch.float64)).numpy() @ r_true
    t0 = t_true + np.array([0.1, -0.05, 0.1])
    want = jpnp.solve_pnp(
        jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(K),
        jnp.asarray(r0), jnp.asarray(t0), huber_delta=huber_delta,
    )
    got = solve_pnp(
        _t(pts), _t(uv), _t(valid), _t(K), _t(r0), _t(t0), huber_delta=huber_delta, device="cpu"
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_reprojection_jacobian_matches_forward_mode_autodiff():
    pts, uv, r_true, t_true = _problem(2, noise_px=0.5)
    w = _t(np.random.default_rng(2).random(len(pts)))
    args = (_t(r_true), _t(t_true), _t(pts), _t(uv), _t(K), w)
    zero6 = torch.zeros(6, dtype=torch.float64)
    res, jac = ppnp._reprojection_terms(*args)
    np.testing.assert_allclose(res.numpy(), ppnp._pnp_residuals(zero6, *args).numpy(), atol=1e-12)
    want = torch.func.jacfwd(ppnp._pnp_residuals)(zero6, *args)
    np.testing.assert_allclose(jac.numpy(), want.numpy(), rtol=1e-9, atol=1e-9)


def test_pose_graph_residuals_match_jax():
    _, _, est_r, est_t, jedges, pedges = _graph(4)
    want = jpg.pose_graph_residuals(jnp.asarray(est_r), jnp.asarray(est_t), jedges)
    got = pose_graph_residuals(_t(est_r), _t(est_t), pedges)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-9)


@pytest.mark.parametrize("n, iterations", [(12, 20), (12, 1), (24, 8)])
def test_optimize_pose_graph_matches_jax(n, iterations):
    _, _, est_r, est_t, jedges, pedges = _graph(5, n=n)
    want = jpg.optimize_pose_graph(
        jnp.asarray(est_r), jnp.asarray(est_t), jedges, num_iterations=iterations
    )
    got = optimize_pose_graph(
        _t(est_r), _t(est_t), pedges, num_iterations=iterations, device="cpu"
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6, atol=1e-12)


def test_pose_graph_accumulates_repeated_edges_like_jax():
    # The same (src, dst) pair twice: an indexed ``+=`` would keep one.
    _, _, est_r, est_t, jedges, pedges = _graph(8)
    twice = {f.name: np.concatenate([np.asarray(getattr(jedges, f.name))] * 2)
             for f in dataclasses.fields(PoseGraphEdges)}
    jtwice = jpg.PoseGraphEdges(**{k: jnp.asarray(v) for k, v in twice.items()})
    want = jpg.optimize_pose_graph(jnp.asarray(est_r), jnp.asarray(est_t), jtwice, num_iterations=3)
    got = optimize_pose_graph(_t(est_r), _t(est_t), edges_to_port(jtwice), num_iterations=3, device="cpu")
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6, atol=1e-12)
    n, ptwice = len(est_r), edges_to_port(jtwice)
    h, _ = ppg._build_system(_t(est_r), _t(est_t), ptwice, ppg._system_tables(ptwice, n))
    h1, _ = ppg._build_system(_t(est_r), _t(est_t), pedges, ppg._system_tables(pedges, n))
    np.testing.assert_allclose(h.numpy(), 2.0 * h1.numpy(), rtol=1e-12, atol=1e-12)


# --- behaviour, on the port alone -------------------------------------------------


def test_pnp_dlt_clean():
    pts, uv, r_true, t_true = _problem(0, noise_px=0.0)
    r, t = pnp_dlt(_t(pts), _t(uv), torch.ones(len(pts), dtype=torch.bool), _t(K))
    assert rotation_angle_deg(r, r_true) < 0.1
    np.testing.assert_allclose(t.numpy(), t_true, atol=1e-3)


def test_pnp_refine_from_dlt_with_noise():
    pts, uv, r_true, t_true = _problem(1, noise_px=0.5)
    valid = torch.ones(len(pts), dtype=torch.bool)
    r0, t0 = pnp_dlt(_t(pts), _t(uv), valid, _t(K))
    r, t, rms = solve_pnp(_t(pts), _t(uv), valid, _t(K), r0, t0, device="cpu")
    assert rotation_angle_deg(r, r_true) < 0.2
    np.testing.assert_allclose(t.numpy(), t_true, atol=0.01)
    assert float(rms) < 1.5


def test_pnp_robust_to_outliers():
    pts, uv, r_true, t_true = _problem(2, noise_px=0.5, outlier_frac=0.2)
    valid = torch.ones(len(pts), dtype=torch.bool)
    # Init from a perturbed truth (the sequential-SLAM motion-model setting).
    r0 = pgeo.so3_exp(torch.tensor([0.03, -0.02, 0.01], dtype=torch.float64)) @ _t(r_true)
    t0 = _t(t_true + np.array([0.1, -0.05, 0.1]))
    r, t, _ = solve_pnp(_t(pts), _t(uv), valid, _t(K), r0, t0, huber_delta=2.0, device="cpu")
    assert rotation_angle_deg(r, r_true) < 0.5
    np.testing.assert_allclose(t.numpy(), t_true, atol=0.03)


def test_pnp_respects_validity():
    pts, uv, r_true, _ = _problem(3, noise_px=0.0)
    uv[-16:] += 500.0  # garbage in the masked-out tail must not matter
    valid = torch.arange(len(pts)) < len(pts) - 16
    r0, t0 = pnp_dlt(_t(pts), _t(uv), valid, _t(K))
    r, _, rms = solve_pnp(_t(pts), _t(uv), valid, _t(K), r0, t0, device="cpu")
    assert rotation_angle_deg(r, r_true) < 0.1
    assert float(rms) < 1e-2


def test_pnp_dlt_offset_scene_float32():
    """DLT must survive a scene far from the origin in float32: the
    Hartley-style point normalization keeps the nullspace solve
    conditioned at world coordinates of ~1e2."""
    pts, uv, r_true, t_true = _problem(7, noise_px=0.0)
    offset = np.array([120.0, -80.0, 250.0])
    # Same pixels, so the camera compensates: X' = X + o ⇒ t' = t − R·o.
    t_adj = t_true - r_true @ offset
    r, t = pnp_dlt(
        _t(pts + offset, torch.float32), _t(uv, torch.float32),
        torch.ones(len(pts), dtype=torch.bool), _t(K, torch.float32),
    )
    assert r.dtype == torch.float32
    assert rotation_angle_deg(r, r_true) < 0.5
    np.testing.assert_allclose(t.numpy(), t_adj, rtol=2e-3, atol=5e-3)


def test_pose_graph_zero_residual_at_truth():
    rots, ts, _, _, _, edges = _graph(4)
    r = pose_graph_residuals(_t(rots), _t(ts), edges)
    assert float(r.abs().max()) < 1e-8


def test_pose_graph_corrects_drift():
    rots, ts, est_r, est_t, _, edges = _graph(5)
    r0 = pose_graph_residuals(_t(est_r), _t(est_t), edges)
    cost0 = float((r0 * r0).sum())
    opt_r, opt_t, cost = optimize_pose_graph(_t(est_r), _t(est_t), edges, device="cpu")
    assert float(cost) < 1e-10 * max(cost0, 1.0) + 1e-10
    # Poses match ground truth (gauge = node 0 = truth here).
    for i in range(len(rots)):
        assert rotation_angle_deg(opt_r[i], rots[i]) < 0.01
    np.testing.assert_allclose(opt_t.numpy(), ts, atol=1e-4)


def test_pose_graph_zero_weight_edges_ignored():
    _, ts, est_r, est_t, _, edges = _graph(6)
    bad = PoseGraphEdges(  # a garbage edge with weight 0
        src=torch.cat([edges.src, torch.tensor([0], dtype=torch.int32)]),
        dst=torch.cat([edges.dst, torch.tensor([5], dtype=torch.int32)]),
        rel_rotation=torch.cat([edges.rel_rotation, torch.eye(3, dtype=torch.float64)[None]]),
        rel_translation=torch.cat(
            [edges.rel_translation, torch.tensor([[99.0, 99.0, 99.0]], dtype=torch.float64)]
        ),
        weight=torch.cat([edges.weight, torch.zeros(1, dtype=torch.float64)]),
    )
    _, opt_t, _ = optimize_pose_graph(_t(est_r), _t(est_t), bad, device="cpu")
    np.testing.assert_allclose(opt_t.numpy(), ts, atol=1e-4)
