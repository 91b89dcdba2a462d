"""The port's projective geometry and trajectory metrics against the JAX
package's, on the same numpy inputs from a seed, both in float64 on the
CPU (tolerance 1e-9: the same closed forms, summed in another order), and
the behavioural tests of ``tests/test_matching_ransac.py``'s geometry
section on the port alone."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sift_scale_space_extrema_detection_tpu.sfm import evaluate as jev
from sift_scale_space_extrema_detection_tpu.sfm import geometry as jgeo
from sift_scale_space_extrema_detection_tpu_torch.sfm import evaluate as pev
from sift_scale_space_extrema_detection_tpu_torch.sfm import geometry as pgeo

torch.set_num_threads(2)

ATOL = 1e-9


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rotations(rng, n, scale=1.0):
    return np.array(jgeo.so3_exp(jnp.asarray(scale * rng.normal(size=(n, 3)))))


def _inputs(name, rng):
    """Seeded float64 inputs of one geometry function, as numpy arrays."""
    w = rng.normal(size=(16, 3))
    w[0] = 0.0  # the Taylor branch
    w[1] = 1e-6 * rng.normal(size=3)
    rot, rot2 = _rotations(rng, 16), _rotations(rng, 16)
    rot[0] = np.eye(3)  # so3_log's Taylor branch
    t, t2 = rng.normal(size=(16, 3)), rng.normal(size=(16, 3))
    pts = rng.uniform([-2, -2, 2], [2, 2, 8], size=(16, 20, 3))
    k_mat = np.array([[500.0, 0, 320], [0, 480.0, 240], [0, 0, 1]])
    return {
        "hat": (w,),
        "so3_exp": (w,),
        "so3_log": (rot,),
        "se3_exp": (np.concatenate([w, t], axis=-1),),
        "se3_log": (rot, t),
        "compose": (rot, t, rot2, t2),
        "invert": (rot, t),
        "transform": (rot, t, pts),
        "project": (pts, k_mat),
        "backproject": (pts[..., :2] * 100.0, k_mat),
        "triangulate_midpoint": (
            np.eye(3), np.zeros(3), rot2[3], t2[3], pts[0] / pts[0][:, 2:3],
            (pts[0] @ rot2[3].T + t2[3]) / (pts[0] @ rot2[3].T + t2[3])[:, 2:3],
        ),
    }[name]


def _flat(result):
    return result if isinstance(result, tuple) else (result,)


@pytest.mark.parametrize(
    "name",
    ["hat", "so3_exp", "so3_log", "se3_exp", "se3_log", "compose", "invert",
     "transform", "project", "backproject", "triangulate_midpoint"],
)
def test_geometry_matches_jax(name):
    args = _inputs(name, np.random.default_rng(len(name)))
    want = _flat(getattr(jgeo, name)(*(jnp.asarray(a) for a in args)))
    got = _flat(getattr(pgeo, name)(*(_t(a) for a in args)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_project_clamps_depth_like_jax():
    pts = np.array([[[0.3, -0.2, 0.0], [0.3, -0.2, -1e-9], [0.1, 0.1, -2.0]]])
    k_mat = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    want = np.asarray(jgeo.project(jnp.asarray(pts), jnp.asarray(k_mat)))
    got = pgeo.project(_t(pts), _t(k_mat)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def _trajectories(rng, n=12):
    gt_r, gt_t = _rotations(rng, n, 0.4), rng.normal(size=(n, 3)) * 3
    est_r = np.einsum("nij,njk->nik", _rotations(rng, n, 0.02), gt_r)
    est_t = 0.5 * gt_t + 0.05 * rng.normal(size=(n, 3))
    return est_r, est_t, gt_r, gt_t


@pytest.mark.parametrize("with_scale", [True, False])
def test_trajectory_metrics_match_jax(with_scale):
    est_r, est_t, gt_r, gt_t = _trajectories(np.random.default_rng(3))
    j = [jnp.asarray(a) for a in (est_r, est_t, gt_r, gt_t)]
    p = [_t(a) for a in (est_r, est_t, gt_r, gt_t)]
    np.testing.assert_allclose(
        pev.camera_centers(p[0], p[1]).numpy(), np.asarray(jev.camera_centers(j[0], j[1])),
        rtol=0, atol=ATOL,
    )
    want = jev.umeyama_alignment(jev.camera_centers(j[0], j[1]), jev.camera_centers(j[2], j[3]), with_scale)
    got = pev.umeyama_alignment(pev.camera_centers(p[0], p[1]), pev.camera_centers(p[2], p[3]), with_scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    for name in ("absolute_trajectory_error", "relative_pose_error"):
        np.testing.assert_allclose(
            float(getattr(pev, name)(*p, with_scale=with_scale)),
            float(getattr(jev, name)(*j, with_scale=with_scale)),
            rtol=0, atol=ATOL,
        )
    for delta in (1, 3):
        np.testing.assert_allclose(
            float(pev.relative_rotation_error(p[0], p[2], delta)),
            float(jev.relative_rotation_error(j[0], j[2], delta)),
            rtol=0, atol=ATOL,
        )


def test_ate_is_zero_for_a_similarity_of_the_truth():
    rng = np.random.default_rng(4)
    gt_r, gt_t = _rotations(rng, 10, 0.5), rng.normal(size=(10, 3))
    # The same trajectory in a frame rotated, shifted and scaled by 2.
    g = _rotations(rng, 1, 0.7)[0]
    centers = -np.einsum("nji,nj->ni", gt_r, gt_t)
    est_c = 2.0 * centers @ g.T + np.array([1.0, -2.0, 0.5])
    est_r = gt_r @ g.T
    est_t = -np.einsum("nij,nj->ni", est_r, est_c)
    ate = pev.absolute_trajectory_error(_t(est_r), _t(est_t), _t(gt_r), _t(gt_t))
    assert float(ate) < 1e-9


# --- behaviour, on the port alone ------------------------------------------


def test_so3_exp_log_roundtrip():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(32, 3))
    # θ < π: beyond that the log returns the equivalent shorter rotation.
    norms = np.linalg.norm(w, axis=1, keepdims=True)
    w = _t(w / norms * rng.uniform(0.01, 3.0, size=norms.shape))
    r = pgeo.so3_exp(w)
    np.testing.assert_allclose(
        (r @ r.transpose(-1, -2)).numpy(), np.broadcast_to(np.eye(3), (32, 3, 3)), atol=1e-6
    )
    np.testing.assert_allclose(torch.linalg.det(r).numpy(), 1.0, atol=1e-6)
    w2 = pgeo.so3_log(r)
    np.testing.assert_allclose(w2.numpy(), w.numpy(), atol=1e-4)
    np.testing.assert_allclose(pgeo.so3_exp(w2).numpy(), r.numpy(), atol=1e-5)


def test_so3_exp_zero():
    r = pgeo.so3_exp(torch.zeros(3))
    np.testing.assert_allclose(r.numpy(), np.eye(3), atol=1e-7)
    # The tangent is finite at zero (the double ``where``).
    g = torch.func.jacfwd(lambda w: pgeo.so3_exp(w).sum())(torch.zeros(3))
    assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("fn", ["se3_exp", "se3_log", "so3_log"])
def test_tangents_are_finite_at_the_identity(fn):
    zero6 = torch.zeros(6, dtype=torch.float64)
    if fn == "se3_exp":
        jac = torch.func.jacfwd(lambda xi: torch.cat([a.reshape(-1) for a in pgeo.se3_exp(xi)]))(zero6)
    elif fn == "se3_log":
        jac = torch.func.jacfwd(lambda xi: pgeo.se3_log(*pgeo.se3_exp(xi)))(zero6)
        np.testing.assert_allclose(jac.numpy(), np.eye(6), atol=1e-6)
    else:
        jac = torch.func.jacfwd(lambda w: pgeo.so3_log(pgeo.so3_exp(w)))(zero6[:3])
    assert bool(torch.isfinite(jac).all())


def test_se3_exp_pure_translation():
    r, t = pgeo.se3_exp(torch.tensor([0.0, 0.0, 0.0, 1.0, 2.0, 3.0]))
    np.testing.assert_allclose(r.numpy(), np.eye(3), atol=1e-7)
    np.testing.assert_allclose(t.numpy(), [1.0, 2.0, 3.0], atol=1e-6)


def test_se3_exp_log_roundtrip():
    rng = np.random.default_rng(5)
    xi = _t(rng.normal(size=(20, 6)) * 0.8)
    np.testing.assert_allclose(pgeo.se3_log(*pgeo.se3_exp(xi)).numpy(), xi.numpy(), atol=1e-9)


def test_project_backproject_roundtrip():
    rng = np.random.default_rng(1)
    k_mat = torch.tensor([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], dtype=torch.float64)
    pts = _t(rng.uniform([-2, -2, 2], [2, 2, 8], size=(64, 3)))
    rays = pgeo.backproject(pgeo.project(pts, k_mat), k_mat)
    ratio = (pts / rays).numpy()  # the rays are proportional to the points
    np.testing.assert_allclose(ratio, np.broadcast_to(ratio[..., 2:3], ratio.shape), rtol=1e-5)


def test_triangulate_midpoint_exact():
    rng = np.random.default_rng(2)
    pts = _t(rng.uniform([-2, -2, 4], [2, 2, 10], size=(50, 3)))
    r1, t1 = torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)
    r2 = pgeo.so3_exp(torch.tensor([0.02, -0.3, 0.01], dtype=torch.float64))
    t2 = torch.tensor([-0.8, 0.05, 0.1], dtype=torch.float64)
    rec, depths = pgeo.triangulate_midpoint(
        r1, t1, r2, t2, pgeo.transform(r1, t1, pts), pgeo.transform(r2, t2, pts)
    )
    np.testing.assert_allclose(rec.numpy(), pts.numpy(), atol=1e-4)
    assert bool((depths > 0).all())


def test_triangulate_midpoint_takes_a_batch_of_second_poses():
    # recover_pose triangulates four candidate poses against shared rays.
    rng = np.random.default_rng(7)
    pts = _t(rng.uniform([-2, -2, 4], [2, 2, 10], size=(30, 3)))
    eye, zero = torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)
    r2 = pgeo.so3_exp(_t(0.1 * rng.normal(size=(4, 3))))
    t2 = _t(rng.normal(size=(4, 3)))
    rays1 = pts / pts[:, 2:3]
    rays2 = pgeo.transform(r2, t2, pts)
    points, depths = pgeo.triangulate_midpoint(eye, zero, r2, t2, rays1, rays2)
    assert points.shape == (4, 30, 3) and depths.shape == (4, 30, 2)
    for k in range(4):
        one, d_one = pgeo.triangulate_midpoint(eye, zero, r2[k], t2[k], rays1, rays2[k])
        np.testing.assert_allclose(points[k].numpy(), one.numpy(), atol=1e-12)
        np.testing.assert_allclose(depths[k].numpy(), d_one.numpy(), atol=1e-12)
