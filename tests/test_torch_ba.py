"""The port's bundle adjustment against the JAX package's, on the same
scenes from a seed, both in float64 on the CPU, and the behavioural tests
of ``tests/test_ba.py`` on the port alone.

Tolerances: the residual terms, the Huber functions, the Schur pieces and
one LM step agree to 1e-9 (the same closed forms, summed in another
order; the pieces relative to their size); after its iterations a solve
agrees to 1e-6 on the poses and to a relative 1e-6 on the cost."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sift_scale_space_extrema_detection_tpu.sfm import ba as jba
from sift_scale_space_extrema_detection_tpu_torch.sfm import ba as pba
from sift_scale_space_extrema_detection_tpu_torch.sfm.ba import (
    BAState,
    Observations,
    bundle_adjust,
    reprojection_residuals,
)

from tests.test_ba import make_scene, perturb
from tests.torch_port_helpers import (
    ba_state_to_port,
    observations_to_port,
    rotation_angle_deg,
)

torch.set_num_threads(2)


def _scene(seed, corrupt=0.0, invalid=0.0, **kw):
    """A scene of ``tests/test_ba.py`` from a seed: the JAX structs
    ``(truth, init, obs)`` and the same three as the port's dataclasses.
    ``corrupt`` of the observations are moved by tens of pixels and stay
    valid; ``invalid`` of them are marked invalid."""
    rng = np.random.default_rng(seed)
    truth, obs = make_scene(rng, **kw)
    n = obs.capacity
    if corrupt:
        bad = rng.choice(n, int(n * corrupt), replace=False)
        uv = np.array(obs.uv)
        uv[bad] += rng.uniform(20, 80, size=(len(bad), 2)) * rng.choice([-1, 1], size=(len(bad), 2))
        obs = obs.replace(uv=jnp.asarray(uv))
    if invalid:
        obs = obs.replace(valid=jnp.asarray(rng.random(n) >= invalid))
    init = perturb(rng, truth)
    jax_side = (truth, init, obs)
    return jax_side, (ba_state_to_port(truth), ba_state_to_port(init), observations_to_port(obs))


def _close(got, want, atol=1e-9, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _rms(state, obs):
    r = reprojection_residuals(state, obs)
    return float(torch.sqrt((r**2).sum(-1).mean()))


# --- against JAX ---------------------------------------------------------------


def test_obs_terms_and_residuals_match_jax():
    (jt, ji, jo), (pt, pi, po) = _scene(5, invalid=0.2, n_cams=4, n_pts=30, noise_px=0.4)
    _close(reprojection_residuals(pi, po), jba.reprojection_residuals(ji, jo))
    want = jba._obs_terms(
        ji.rotations, ji.translations, ji.k_mat, ji.points[jo.landmark], jo.camera, jo.uv, jo.valid
    )
    got = pba._obs_terms(
        pi.rotations, pi.translations, pi.k_mat, pi.points[po.landmark.long()],
        po.camera.long(), po.uv, po.valid,
    )
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-12)


@pytest.mark.parametrize("delta", [None, 2.0])
def test_huber_functions_match_jax(delta):
    (_, ji, jo), (_, pi, po) = _scene(3, corrupt=0.1, n_cams=4, n_pts=40, noise_px=0.3)
    jres, pres = jba.reprojection_residuals(ji, jo), reprojection_residuals(pi, po)
    np.testing.assert_allclose(
        float(pba.huber_cost(pres, delta)), float(jba.huber_cost(jres, delta)), rtol=1e-12
    )
    if delta is None:
        assert pba.huber_weights(pres, delta) is None
    else:
        _close(pba.huber_weights(pres, delta), jba.huber_weights(jres, delta, jnp.float64))


def test_closed_form_jacobians_match_autodiff():
    """_obs_terms' hand-derived Jacobians == forward-mode autodiff of the
    residual of one observation."""
    _, (truth, _, obs) = _scene(5, n_cams=3, n_pts=20, noise_px=0.4)
    cam, lm = obs.camera.long(), obs.landmark.long()
    res, jc, jl = pba._obs_terms(
        truth.rotations, truth.translations, truth.k_mat, truth.points[lm], cam, obs.uv, obs.valid
    )
    z6, z3 = torch.zeros(6, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)
    for o in range(0, obs.capacity, 7):
        args = (truth.rotations[cam[o]], truth.translations[cam[o]], truth.points[lm[o]],
                obs.uv[o], truth.k_mat, z6, z3)
        _close(res[o], pba._per_obs_residual(*args))
        jc_ref, jl_ref = torch.func.jacfwd(pba._per_obs_residual, argnums=(5, 6))(*args)
        _close(jc[o], jc_ref, atol=1e-8, rtol=1e-8)
        _close(jl[o], jl_ref, atol=1e-8, rtol=1e-8)


def _pieces_close(got, want):
    for name, g, w in zip(jba.SchurPieces._fields, got, want):
        w = np.asarray(w)
        # Relative to the piece's size: h_cc holds entries of 1e7.
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=1e-9 * max(1.0, np.abs(w).max()), err_msg=name
        )


@pytest.mark.parametrize("huber", [False, True])
def test_schur_pieces_match_jax(huber):
    (_, ji, jo), (_, pi, po) = _scene(7, corrupt=0.1, invalid=0.2, n_cams=5, n_pts=40, noise_px=0.4)
    lam = 1e-3
    jw = jba.huber_weights(jba.reprojection_residuals(ji, jo), 2.0, jnp.float64) if huber else None
    pw = pba.huber_weights(reprojection_residuals(pi, po), 2.0) if huber else None
    want = jba.shard_schur_pieces(
        ji.rotations, ji.translations, ji.k_mat, ji.points, jo.camera, jo.landmark,
        jo.uv, jo.valid, jnp.asarray(lam), 5, jw,
    )
    got = pba.shard_schur_pieces(
        pi.rotations, pi.translations, pi.k_mat, pi.points, po.camera, po.landmark,
        po.uv, po.valid, torch.tensor(lam, dtype=torch.float64), 5, pw,
    )
    _pieces_close(got, want)

    # The sorted assembly: equal index tables, then equal pieces.
    jtables = jba._build_sorted_tables(jo.camera, jo.landmark, jo.valid, 40, 5)
    ptables = pba._build_sorted_tables(po.camera.long(), po.landmark.long(), po.valid, 40, 5)
    for g, w in zip(ptables, jtables):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    order = ptables[0]
    jorder = jtables[0]
    want = jba._schur_pieces_sorted(
        ji.rotations, ji.translations, ji.k_mat, ji.points, jo.camera[jorder],
        jo.landmark[jorder], jo.uv[jorder], jo.valid[jorder], jnp.asarray(lam), 5, jtables,
        None if jw is None else jw[jorder],
    )
    cam = po.camera.long()[order]
    got = pba._schur_pieces_sorted(
        pi.rotations, pi.translations, pi.k_mat, pi.points, cam, po.landmark.long()[order],
        po.uv[order], po.valid[order], torch.tensor(lam, dtype=torch.float64), 5, ptables,
        pba.segment_tables(cam, 5), None if pw is None else pw[order],
    )
    _pieces_close(got, want)

    # And the reduced solve with the back-substitution.
    jdc = jba.solve_reduced(want.h_cc, want.b_c, want.s_off, want.rhs_off, jnp.asarray(lam), 1)
    pdc = pba.solve_reduced(got.h_cc, got.b_c, got.s_off, got.rhs_off, torch.tensor(lam, dtype=torch.float64), 1)
    _close(pdc, jdc)
    _close(pba.backsub_landmarks(got, pdc), jba.backsub_landmarks(want, jdc))


SOLVES = {
    "dense_sorted": dict(),
    "dense_sorted_pad": dict(sorted_pad=6),
    "dense_scatter": dict(assembly="scatter"),
    "cg": dict(solver="cg", cg_iterations=40),
    "dense_sorted_huber": dict(huber_delta=2.0),
    "dense_scatter_huber": dict(huber_delta=2.0, assembly="scatter"),
    "cg_huber": dict(solver="cg", cg_iterations=40, huber_delta=2.0),
    "two_fixed_cameras": dict(num_fixed_cameras=2),
}


def _solve_both(kwargs, iterations, seed=6):
    (_, ji, jo), (_, pi, po) = _scene(
        seed, corrupt=0.1 if "huber_delta" in kwargs else 0.0, invalid=0.15, noise_px=0.3
    )
    want, want_cost = jba.bundle_adjust(ji, jo, num_iterations=iterations, **kwargs)
    got, got_cost = bundle_adjust(pi, po, num_iterations=iterations, device="cpu", **kwargs)
    return got, got_cost, want, want_cost


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_one_lm_step_matches_jax(name):
    got, got_cost, want, want_cost = _solve_both(SOLVES[name], 1)
    for field in ("rotations", "translations", "points"):
        _close(getattr(got, field), getattr(want, field), atol=1e-9)
    np.testing.assert_allclose(float(got_cost), float(want_cost), rtol=1e-9)


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_bundle_adjust_matches_jax(name):
    got, got_cost, want, want_cost = _solve_both(SOLVES[name], 10)
    for field in ("rotations", "translations", "points"):
        _close(getattr(got, field), getattr(want, field), atol=1e-6)
    np.testing.assert_allclose(float(got_cost), float(want_cost), rtol=1e-6)
    assert got.points.dtype == torch.float64 and got.k_mat is not None


# --- the port's own rules -----------------------------------------------------


def test_undersized_sorted_pad_raises():
    _, (_, init, obs) = _scene(2, n_cams=6, n_pts=30)
    with pytest.raises(ValueError, match="sorted_pad"):
        bundle_adjust(init, obs, num_iterations=1, sorted_pad=5, device="cpu")
    bundle_adjust(init, obs, num_iterations=1, sorted_pad=6, device="cpu")


@pytest.mark.parametrize("bad", [dict(solver="sparse"), dict(assembly="sort")])
def test_unknown_solver_or_assembly_raises(bad):
    _, (_, init, obs) = _scene(2, n_cams=3, n_pts=10)
    with pytest.raises(ValueError):
        bundle_adjust(init, obs, num_iterations=1, device="cpu", **bad)


def test_segment_sum_equals_index_add_and_skips_the_sentinel():
    rng = np.random.default_rng(0)
    seg = torch.from_numpy(rng.integers(-1, 9, size=200))  # outside [0, 7): no segment
    data = torch.from_numpy(rng.normal(size=(200, 2, 3)))
    got = pba.segment_sum(data, pba.segment_tables(seg, 7))
    want = torch.zeros((10, 2, 3), dtype=torch.float64).index_add_(0, seg + 1, data)[1:8]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12)
    empty = pba.segment_sum(data, pba.segment_tables(torch.full((200,), 3), 3))
    assert empty.shape == (3, 2, 3) and not bool(empty.any())


@pytest.mark.parametrize("kwargs", [dict(), dict(assembly="scatter"), dict(solver="cg", cg_iterations=40)])
def test_skewed_visibility_matches_jax(kwargs):
    """One landmark seen by every camera while most are seen by two or
    three: the reductions by segment take any spread of segment sizes."""
    (_, ji, jo), (_, pi, po) = _scene(9, n_cams=6, n_pts=60, noise_px=0.3)
    rng = np.random.default_rng(9)
    cam, lm = np.asarray(jo.camera), np.asarray(jo.landmark)
    valid = (lm == 0) | (cam < 2) | (rng.random(len(lm)) < 0.15)
    jo = jo.replace(valid=jnp.asarray(valid))
    po = dataclasses.replace(po, valid=torch.from_numpy(valid))
    counts = np.bincount(lm[valid], minlength=60)
    assert counts[0] == 6 and np.median(counts) <= 3
    want, want_cost = jba.bundle_adjust(ji, jo, num_iterations=6, **kwargs)
    got, got_cost = bundle_adjust(pi, po, num_iterations=6, device="cpu", **kwargs)
    for field in ("rotations", "translations", "points"):
        _close(getattr(got, field), getattr(want, field), atol=1e-6)
    np.testing.assert_allclose(float(got_cost), float(want_cost), rtol=1e-6)


@pytest.mark.parametrize("kwargs", [dict(), dict(assembly="scatter"), dict(solver="cg")])
def test_an_invalid_slot_may_hold_any_index(kwargs):
    _, (_, init, obs) = _scene(12, invalid=0.2, n_cams=4, n_pts=30, noise_px=0.3)
    junk = torch.where(torch.arange(obs.capacity) % 2 == 0, 30 + 7, -3).int()
    wild = dataclasses.replace(
        obs,
        landmark=torch.where(obs.valid, obs.landmark, junk),
        camera=torch.where(obs.valid, obs.camera, junk),
    )
    assert torch.equal(reprojection_residuals(init, wild), reprojection_residuals(init, obs))
    want, want_cost = bundle_adjust(init, obs, num_iterations=3, device="cpu", **kwargs)
    got, got_cost = bundle_adjust(init, wild, num_iterations=3, device="cpu", **kwargs)
    assert torch.equal(got.points, want.points) and torch.equal(got.rotations, want.rotations)
    assert torch.equal(got_cost, want_cost)


def test_two_runs_give_the_same_bits():
    _, (_, init, obs) = _scene(4, noise_px=0.3)
    for kwargs in (dict(), dict(solver="cg")):
        a, cost_a = bundle_adjust(init, obs, num_iterations=4, device="cpu", **kwargs)
        b, cost_b = bundle_adjust(init, obs, num_iterations=4, device="cpu", **kwargs)
        assert torch.equal(a.rotations, b.rotations) and torch.equal(a.points, b.points)
        assert torch.equal(cost_a, cost_b)


# --- behaviour, on the port alone ----------------------------------------------


def test_ba_converges_to_truth():
    _, (truth, init, obs) = _scene(0, noise_px=0.0)
    assert _rms(init, obs) > 5.0
    refined, _ = bundle_adjust(init, obs, num_iterations=15, device="cpu")
    assert _rms(refined, obs) < 1e-3
    # Poses recover the truth (gauge anchored at camera 0).
    for c in range(truth.rotations.shape[0]):
        assert rotation_angle_deg(refined.rotations[c], truth.rotations[c]) < 0.05
    np.testing.assert_allclose(refined.translations.numpy(), truth.translations.numpy(), atol=5e-3)


def test_ba_noisy_observations():
    _, (truth, init, obs) = _scene(1, noise_px=0.5)
    refined, _ = bundle_adjust(init, obs, num_iterations=15, device="cpu")
    # The residual comes down to the noise floor (~0.5 px RMS over 2 dims),
    # without overfitting wildly: poses near truth.
    assert _rms(refined, obs) < 1.0
    assert float((refined.translations - truth.translations).abs().max()) < 0.05


def test_ba_respects_validity_mask():
    rng = np.random.default_rng(2)
    _, (truth, init, obs) = _scene(2, noise_px=0.0)
    # Corrupt 25% of the observations but mark them invalid.
    n = obs.capacity
    bad = rng.choice(n, n // 4, replace=False)
    uv = obs.uv.clone()
    uv[bad] += torch.from_numpy(rng.uniform(50, 200, size=(len(bad), 2)))
    valid = torch.ones(n, dtype=torch.bool)
    valid[bad] = False
    obs2 = dataclasses.replace(obs, uv=uv, valid=valid)
    refined, _ = bundle_adjust(init, obs2, num_iterations=15, device="cpu")
    r = reprojection_residuals(refined, obs2)
    assert float(torch.sqrt((r[valid] ** 2).sum(-1).mean())) < 1e-3


def test_ba_huber_downweights_outliers():
    _, (truth, init, obs) = _scene(3, corrupt=0.1, noise_px=0.3)
    plain, _ = bundle_adjust(init, obs, num_iterations=15, device="cpu")
    robust, _ = bundle_adjust(init, obs, num_iterations=15, huber_delta=2.0, device="cpu")

    def pose_err(s):
        return float((s.translations - truth.translations).abs().max())

    assert pose_err(robust) < pose_err(plain)
    assert pose_err(robust) < 0.05


def test_ba_fixed_cameras_stay_fixed():
    _, (_, init, obs) = _scene(4, noise_px=0.2)
    refined, _ = bundle_adjust(init, obs, num_iterations=8, num_fixed_cameras=2, device="cpu")
    assert torch.equal(refined.rotations[:2], init.rotations[:2])
    assert torch.equal(refined.translations[:2], init.translations[:2])


def test_ba_cg_solver_matches_dense():
    """The matrix-free CG path converges to the dense Schur solution."""
    _, (_, init, obs) = _scene(6, noise_px=0.2)
    dense, _ = bundle_adjust(init, obs, num_iterations=12, device="cpu")
    cg, _ = bundle_adjust(init, obs, num_iterations=12, solver="cg", cg_iterations=40, device="cpu")
    assert _rms(cg, obs) < 1.0
    np.testing.assert_allclose(cg.translations.numpy(), dense.translations.numpy(), atol=1e-3)
    np.testing.assert_allclose(cg.points.numpy(), dense.points.numpy(), atol=5e-3)


def test_ba_cg_huber():
    """The CG path supports IRLS Huber weighting like the dense path."""
    _, (truth, init, obs) = _scene(7, corrupt=0.1, noise_px=0.3)
    robust, _ = bundle_adjust(
        init, obs, num_iterations=15, huber_delta=2.0, solver="cg", cg_iterations=40, device="cpu"
    )
    dense, _ = bundle_adjust(init, obs, num_iterations=15, huber_delta=2.0, device="cpu")
    cg_err = float((robust.translations - truth.translations).abs().max())
    dense_err = float((dense.translations - truth.translations).abs().max())
    assert abs(cg_err - dense_err) < 0.02
    assert cg_err < 0.1


def test_sorted_assembly_matches_scatter():
    """Gather-side assembly == scatter assembly, with mixed validity and a
    ``sorted_pad`` at the largest run length (float64 makes the reorder
    drift ~1e-12)."""
    _, (_, init, obs) = _scene(7, invalid=0.2, n_cams=7, n_pts=90, noise_px=0.4)
    ref, cost_ref = bundle_adjust(init, obs, num_iterations=6, assembly="scatter", device="cpu")
    for pad in (0, 8):  # 0 -> the largest count; 8 >= the largest count, 7
        got, cost_got = bundle_adjust(
            init, obs, num_iterations=6, assembly="sorted", sorted_pad=pad, device="cpu"
        )
        np.testing.assert_allclose(got.translations.numpy(), ref.translations.numpy(), atol=1e-8)
        np.testing.assert_allclose(got.points.numpy(), ref.points.numpy(), atol=1e-7)
        assert abs(float(cost_got) - float(cost_ref)) < 1e-7 * max(1.0, float(cost_ref))


def test_sorted_assembly_huber_matches_scatter():
    _, (_, init, obs) = _scene(11, n_cams=5, n_pts=70, noise_px=0.3)
    ref, _ = bundle_adjust(init, obs, num_iterations=5, huber_delta=2.0, assembly="scatter", device="cpu")
    got, _ = bundle_adjust(init, obs, num_iterations=5, huber_delta=2.0, assembly="sorted", device="cpu")
    np.testing.assert_allclose(got.translations.numpy(), ref.translations.numpy(), atol=1e-8)


def test_state_and_observations_are_dataclasses_of_tensors():
    _, (truth, _, obs) = _scene(0, n_cams=2, n_pts=5)
    assert isinstance(truth, BAState) and isinstance(obs, Observations)
    assert obs.capacity == 10
    assert [f.name for f in dataclasses.fields(BAState)] == ["rotations", "translations", "points", "k_mat"]
