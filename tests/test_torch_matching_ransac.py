"""The port's descriptor matching and RANSAC two-view estimation against
the JAX package's, on the same numpy inputs from a seed, both in float64 on
the CPU, and the behavioural tests of ``tests/test_matching_ransac.py`` on
the port alone.

RANSAC draws its samples from ``jax.random`` there and from a
``torch.Generator`` here; the two cannot give the same numbers. The parity
test computes JAX's sample indices itself (the two lines of its
``estimate_essential_ransac``) and feeds them to the port's
``essential_from_samples``, the function of everything after the draw."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sift_scale_space_extrema_detection_tpu.ops import matching as jmatch
from sift_scale_space_extrema_detection_tpu.ops import ransac as jransac
from sift_scale_space_extrema_detection_tpu.sfm import geometry as jgeo
import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.ops import matching as pmatch
from sift_scale_space_extrema_detection_tpu_torch.ops import ransac as pransac
from sift_scale_space_extrema_detection_tpu_torch.sfm import geometry as pgeo

from tests.torch_port_helpers import matches_to_port, rotation_angle_deg

torch.set_num_threads(2)


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out.to(dtype) if dtype else out


def _unit(rng, n, d=128, dtype=np.float32):
    v = rng.normal(size=(n, d)).astype(dtype)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _two_view(rng, n=256, outlier_frac=0.3, noise=1e-3):
    """Two views of a point cloud as normalized rays (float64), the true
    relative pose and the inlier mask."""
    pts = rng.uniform([-2, -2, 4], [2, 2, 12], size=(n, 3))
    r = np.asarray(jgeo.so3_exp(jnp.asarray([0.05, -0.2, 0.03])))
    t = np.array([-1.0, 0.1, 0.15])
    t /= np.linalg.norm(t)
    cam2 = pts @ r.T + t
    rays1 = pts / pts[:, 2:3]
    rays2 = cam2 / cam2[:, 2:3]
    rays1[:, :2] += noise * rng.normal(size=(n, 2))
    rays2[:, :2] += noise * rng.normal(size=(n, 2))
    n_out = int(n * outlier_frac)
    out_idx = rng.choice(n, n_out, replace=False)
    rays2[out_idx, :2] = rng.uniform(-0.5, 0.5, size=(n_out, 2))
    is_inlier = np.ones(n, bool)
    is_inlier[out_idx] = False
    return rays1, rays2, r, t, is_inlier


# --- matching against JAX ---------------------------------------------------


def _noisy_permutation(rng, n, dtype):
    a = _unit(rng, n, dtype=dtype)
    perm = rng.permutation(n)
    b = a[perm] + 0.05 * rng.normal(size=a.shape).astype(dtype)
    return a, b / np.linalg.norm(b, axis=1, keepdims=True), perm


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_descriptor_distances_match_jax(dtype):
    rng = np.random.default_rng(3)
    a, b = _unit(rng, 40, dtype=dtype), _unit(rng, 30, dtype=dtype)
    want = np.asarray(jmatch.descriptor_distances(jnp.asarray(a), jnp.asarray(b)))
    got = pmatch.descriptor_distances(_t(a), _t(b))
    assert got.dtype == _t(a).dtype
    # d = |a|² + |b|² − 2ab cancels: the two products sum in another order.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 if dtype == np.float32 else 1e-12)


@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_match_descriptors_matches_jax(dtype, mutual):
    # A separated fixture: every true match clears the ratio test by far,
    # so the last bits of a distance decide nothing.
    rng = np.random.default_rng(4)
    a, b, _ = _noisy_permutation(rng, 96, dtype)
    valid_a = rng.random(96) < 0.85
    valid_b = rng.random(96) < 0.85
    want = matches_to_port(
        jmatch.match_descriptors(
            jnp.asarray(a), jnp.asarray(valid_a), jnp.asarray(b), jnp.asarray(valid_b),
            mutual=mutual,
        )
    )
    got = port.match_descriptors(
        _t(a), _t(valid_a), _t(b), _t(valid_b), mutual=mutual, device="cpu"
    )
    assert got.index.dtype == torch.int32 and got.distance.dtype == torch.float32
    assert torch.equal(got.valid, want.valid)
    assert int(got.valid.sum()) > 50
    assert torch.equal(got.index[got.valid], want.index[want.valid])
    np.testing.assert_allclose(
        got.distance[got.valid].numpy(), want.distance[want.valid].numpy(), rtol=1e-5, atol=1e-6
    )


def test_match_ties_take_the_lower_index_like_jax():
    # Every B row equal: each A slot's two nearest tie, and so do the
    # columns' nearest A slots. jax.lax.top_k and argmin take the lowest.
    rng = np.random.default_rng(9)
    a = _unit(rng, 6, dtype=np.float64)
    b = np.repeat(_unit(rng, 1, dtype=np.float64), 5, axis=0)
    ok_a, ok_b = np.ones(6, bool), np.array([False, True, True, True, True])
    want = matches_to_port(
        jmatch.match_descriptors(jnp.asarray(a), jnp.asarray(ok_a), jnp.asarray(b), jnp.asarray(ok_b))
    )
    got = port.match_descriptors(_t(a), _t(ok_a), _t(b), _t(ok_b), device="cpu")
    assert torch.equal(got.index, want.index)
    assert got.index.tolist() == [1] * 6
    assert torch.equal(got.valid, want.valid) and not bool(got.valid.any())


# --- RANSAC against JAX -------------------------------------------------------


def _jax_sample_indices(key, valid, num_hypotheses):
    """The draw of the JAX package's ``estimate_essential_ransac``."""
    u = jax.random.uniform(key, (num_hypotheses, valid.shape[0]))
    u = jnp.where(valid[None, :], u, -1.0)
    return jax.lax.top_k(u, 8)[1]


@pytest.mark.parametrize("seed, outlier_frac", [(6, 0.3), (7, 0.0), (8, 0.5)])
def test_essential_from_samples_matches_jax(seed, outlier_frac):
    rng = np.random.default_rng(seed)
    rays1, rays2, _, _, _ = _two_view(rng, n=160, outlier_frac=outlier_frac)
    valid = rng.random(160) < 0.9
    key = jax.random.PRNGKey(seed)
    want = jransac.estimate_essential_ransac(
        jnp.asarray(rays1), jnp.asarray(rays2), jnp.asarray(valid), key,
        num_hypotheses=64, inlier_threshold=3e-3,
    )
    idx = np.asarray(_jax_sample_indices(key, jnp.asarray(valid), 64))
    got = pransac.essential_from_samples(
        _t(rays1), _t(rays2), _t(valid), _t(idx).long(), inlier_threshold=3e-3
    )
    # Equal inlier sets and the pose within 1e-6: the same algorithm from
    # the same samples; E itself is compared up to sign (SVD vectors).
    assert torch.equal(got.inliers, _t(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers) > 15
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-6)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=1e-6)
    e_got, e_want = got.e_mat.numpy(), np.asarray(want.e_mat)
    assert min(np.abs(e_got - e_want).max(), np.abs(e_got + e_want).max()) < 1e-6


@pytest.mark.parametrize("name", ["sampson_error", "decompose_essential", "recover_pose", "refine_relative_pose"])
def test_ransac_pieces_match_jax(name):
    rng = np.random.default_rng(11)
    rays1, rays2, r, t, is_inlier = _two_view(rng, n=96, outlier_frac=0.2)
    e_true = np.asarray(jgeo.hat(jnp.asarray(t))) @ r
    w = is_inlier.astype(np.float64)
    j1, j2, p1, p2 = jnp.asarray(rays1), jnp.asarray(rays2), _t(rays1), _t(rays2)
    if name == "sampson_error":
        e_batch = np.stack([e_true, 2.0 * e_true.T, rng.normal(size=(3, 3))])
        want = [jransac.sampson_error(jnp.asarray(e_batch), j1, j2)]
        got = [pransac.sampson_error(_t(e_batch), p1, p2)]
    elif name == "decompose_essential":
        (a, b), c = jransac.decompose_essential(jnp.asarray(e_true))
        (x, y), z = pransac.decompose_essential(_t(e_true))
        # The translation is a singular vector: equal up to sign.
        z = z * torch.sign((z * _t(c)).sum())
        want, got = [a, b, c], [x, y, z]
    elif name == "recover_pose":
        want = jransac.recover_pose(jnp.asarray(e_true), j1, j2, jnp.asarray(w))
        got = pransac.recover_pose(_t(e_true), p1, p2, _t(w))
    else:
        r0 = np.asarray(jgeo.so3_exp(jnp.asarray([0.01, -0.02, 0.015]))) @ r
        t0 = t + np.array([0.03, -0.02, 0.04])
        t0 /= np.linalg.norm(t0)
        want = jransac.refine_relative_pose(jnp.asarray(r0), jnp.asarray(t0), j1, j2, jnp.asarray(w))
        got = pransac.refine_relative_pose(_t(r0), _t(t0), p1, p2, _t(w))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0, atol=1e-9)


def test_sampson_jacobian_matches_forward_mode_autodiff():
    rng = np.random.default_rng(12)
    rays1, rays2, r, t, _ = _two_view(rng, n=48, outlier_frac=0.2)
    w = _t(rng.random(48))
    zero6 = torch.zeros(6, dtype=torch.float64)
    args = (_t(r), _t(t), _t(rays1), _t(rays2), w)
    res, jac = pransac._sampson_terms(*args)
    np.testing.assert_allclose(
        res.numpy(), pransac._sampson_residuals(zero6, *args).numpy(), atol=1e-12
    )
    want = torch.func.jacfwd(pransac._sampson_residuals)(zero6, *args)
    np.testing.assert_allclose(jac.numpy(), want.numpy(), atol=1e-9)


def test_refine_relative_pose_batch_equals_one_by_one():
    rng = np.random.default_rng(13)
    rays1, rays2, r, t, is_inlier = _two_view(rng, n=80, outlier_frac=0.1)
    rots = pgeo.so3_exp(_t(0.02 * rng.normal(size=(5, 3)))) @ _t(r)
    ts = _t(t + 0.03 * rng.normal(size=(5, 3)))
    ts = ts / ts.norm(dim=-1, keepdim=True)
    ws = _t(is_inlier.astype(np.float64) * rng.uniform(0.5, 1.0, size=(5, 80)))
    got_r, got_t = pransac.refine_relative_pose(rots, ts, _t(rays1), _t(rays2), ws, iterations=4)
    for k in range(5):
        one_r, one_t = pransac.refine_relative_pose(
            rots[k], ts[k], _t(rays1), _t(rays2), ws[k], iterations=4
        )
        np.testing.assert_allclose(got_r[k].numpy(), one_r.numpy(), atol=1e-12)
        np.testing.assert_allclose(got_t[k].numpy(), one_t.numpy(), atol=1e-12)


def test_sample_minimal_sets_are_distinct_valid_and_seeded():
    valid = torch.arange(40) % 3 != 0
    idx = pransac.sample_minimal_sets(valid, 32, torch.Generator().manual_seed(5))
    assert idx.shape == (32, 8)
    assert bool(valid[idx].all())
    assert all(len(set(row)) == 8 for row in idx.tolist())
    again = pransac.sample_minimal_sets(valid, 32, torch.Generator().manual_seed(5))
    assert torch.equal(idx, again)
    # Fewer than 8 valid slots: the row ends in the lowest invalid slots.
    few = torch.arange(12) >= 7
    idx = pransac.sample_minimal_sets(few, 4, torch.Generator().manual_seed(1))
    assert all(sorted(row[:5]) == [7, 8, 9, 10, 11] and row[5:] == [0, 1, 2] for row in idx.tolist())


# --- behaviour, on the port alone -------------------------------------------


def test_distances_match_numpy():
    rng = np.random.default_rng(3)
    a, b = _unit(rng, 40), _unit(rng, 30)
    d = pmatch.descriptor_distances(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(d, ((a[:, None] - b[None]) ** 2).sum(-1), atol=1e-4)


def test_match_descriptors_permutation():
    """B is a noisy permutation of A: matches must recover the permutation."""
    rng = np.random.default_rng(4)
    a, b, perm = _noisy_permutation(rng, 64, np.float32)
    ok = torch.ones(64, dtype=torch.bool)
    m = port.match_descriptors(_t(a), ok, _t(b), ok, device="cpu")
    valid = m.valid.numpy()
    assert valid.sum() > 55  # near-all matched despite noise
    np.testing.assert_array_equal(m.index.numpy()[valid], np.argsort(perm)[valid])


def test_match_respects_validity_and_ratio():
    rng = np.random.default_rng(5)
    a = _unit(rng, 16)
    # B holds each A descriptor twice: d1 == d2 == 0, so the strict ratio
    # test d1 < r²·d2 must kill everything.
    b = np.concatenate([a, a])
    ok_a = torch.ones(16, dtype=torch.bool)
    m = port.match_descriptors(_t(a), ok_a, _t(b), torch.ones(32, dtype=torch.bool), device="cpu")
    assert int(m.valid.sum()) == 0
    # Masking the duplicates out restores the matches.
    m2 = port.match_descriptors(_t(a), ok_a, _t(b), torch.arange(32) < 16, device="cpu")
    assert int(m2.valid.sum()) == 16


def _ransac(rays1, rays2, valid, seed, **kw):
    return port.estimate_essential_ransac(
        _t(rays1, torch.float32), _t(rays2, torch.float32), valid,
        torch.Generator().manual_seed(seed), device="cpu", **kw,
    )


def test_ransac_recovers_pose_with_outliers():
    rng = np.random.default_rng(6)
    rays1, rays2, r_true, t_true, is_inlier = _two_view(rng)
    res = _ransac(rays1, rays2, torch.ones(256, dtype=torch.bool), 0,
                  num_hypotheses=256, inlier_threshold=3e-3)
    inl = res.inliers.numpy()
    assert (inl & is_inlier).sum() > 0.85 * is_inlier.sum()
    assert (inl & ~is_inlier).sum() < 0.1 * (~is_inlier).sum() + 3
    assert int(res.num_inliers) == inl.sum() and res.num_inliers.dtype == torch.int32
    assert rotation_angle_deg(res.rotation, r_true) < np.degrees(0.02)
    assert abs(float(res.translation.numpy() @ t_true)) > 0.995


def test_ransac_respects_validity_mask():
    """Invalid slots carry garbage; they must not poison the estimate."""
    rng = np.random.default_rng(7)
    rays1, rays2, r_true, _, _ = _two_view(rng, outlier_frac=0.0)
    n = rays1.shape[0]
    rays1 = np.concatenate([rays1, rng.uniform(-1, 1, size=(64, 3))])
    rays2 = np.concatenate([rays2, rng.uniform(-1, 1, size=(64, 3))])
    res = _ransac(rays1, rays2, torch.arange(n + 64) < n, 1, num_hypotheses=128)
    assert not bool(res.inliers[n:].any())
    assert rotation_angle_deg(res.rotation, r_true) < np.degrees(0.02)


def test_sampson_zero_for_exact_correspondences():
    rng = np.random.default_rng(8)
    rays1, rays2, r, t, _ = _two_view(rng, outlier_frac=0.0, noise=0.0)
    e_true = pgeo.hat(_t(t)) @ _t(r)
    err = port.sampson_error(e_true.float(), _t(rays1, torch.float32), _t(rays2, torch.float32))
    assert float(err.max()) < 1e-8


def test_ransac_too_few_valid_reports_zero_inliers():
    """Fewer than 8 valid correspondences: the 8-point system is
    underdetermined; the result must say so (zero inliers) instead of
    returning a noise pose with a plausible-looking inlier set."""
    rng = np.random.default_rng(11)
    res = _ransac(rng.normal(size=(16, 3)), rng.normal(size=(16, 3)),
                  torch.arange(16) < 5, 0, num_hypotheses=32)
    assert int(res.num_inliers) == 0
    assert not bool(res.inliers.any())


def test_decompose_essential_batched_proper_rotations():
    rng = np.random.default_rng(12)
    r = pgeo.so3_exp(_t(rng.normal(size=(5, 3)) * 0.4))
    t = _t(rng.normal(size=(5, 3)))
    e_batch = pgeo.hat(t / t.norm(dim=-1, keepdim=True)) @ r
    (r1, r2), tt = port.ops.ransac.decompose_essential(e_batch)
    assert r1.shape == (5, 3, 3) and tt.shape == (5, 3)
    for rs in (r1, r2):
        np.testing.assert_allclose(torch.linalg.det(rs).numpy(), 1.0, atol=1e-5)
        np.testing.assert_allclose(
            (rs @ rs.transpose(-1, -2)).numpy(), np.broadcast_to(np.eye(3), (5, 3, 3)), atol=1e-5
        )
