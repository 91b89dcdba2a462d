"""The port's ``parallel/distributed.py`` at world size 2 on gloo, on the CPU.

- The mirrors of ``tests/test_distributed.py`` at its bars: the sharded BA
  against the single-device BA (plain, Huber, convergence, a landmark
  count that needs padding), the data-parallel frontend against
  ``detect_and_describe_batched``, and keyframe-sharded matching against
  ``match_descriptors`` per keyframe.
- The port's sharded BA in float64 against the JAX package's on its
  8-virtual-device mesh, on one problem.
- Composed SLAM over a mesh: the mirrors of ``tests/test_slam.py:167`` and
  ``tests/test_visual_slam.py:100``, and ``run_slam_from_images`` and
  ``SlamSession`` with a mesh, each run at the reference's
  ``dist_ba_min_landmarks`` and at 0, where the count of sharded BAs must
  equal the count of BAs; the session bit-equal to the batch run.
- Every rank's outputs bit-equal to rank 0's.

One run of two ranks serves the whole module
(``tests/torch_dist_ranks.py``); each test reads its part of it.
"""

import dataclasses
import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sift_scale_space_extrema_detection_tpu.parallel import (
    distributed_bundle_adjust as jax_distributed_bundle_adjust,
    make_mesh as jax_make_mesh,
)
import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.ops.matching import match_descriptors
from sift_scale_space_extrema_detection_tpu_torch.sfm.ba import (
    bundle_adjust,
    reprojection_residuals,
)
from sift_scale_space_extrema_detection_tpu_torch.utils.synthetic import orbit_sequence

from tests.test_ba import make_scene, perturb
from tests.test_torch_visual_slam import render_sequence
from tests.torch_dist_ranks import (
    FRONTEND_CFG,
    ORBIT_SLAM_CFG,
    REFERENCE_THRESHOLD,
    THRESHOLDS,
    TRACKS_CFG,
    VISUAL_CFG,
    VISUAL_SLAM_CFG,
    WORLD,
    shared_run,
)
from tests.torch_port_helpers import ba_state_to_port, observations_to_port

torch.set_num_threads(2)

CPU = dict(device="cpu")
SCENARIOS = ["bundle_adjust", "frontend", "keyframe_matching", "slam_orbit", "tracks",
             "visual_slam"]
# (seed, cameras, points, noise px, LM iterations, Huber delta, outliers):
# the problems of tests/test_distributed.py.
BA_PROBLEMS = {
    "match": (0, 5, 100, 0.3, 10, None, 0),
    "huber": (4, 5, 96, 0.3, 10, 2.0, 40),
    "converge": (1, 6, 120, 0.0, 15, None, 0),
    "pad": (2, 4, 93, 0.2, 10, None, 0),
}


@pytest.fixture(scope="module", autouse=True)
def _no_persistent_jax_cache():
    before = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", before)


@functools.cache
def ba_problem(name):
    """``(init state, observations, iterations, huber)`` in float64, the
    JAX package's structs (made by tests/test_ba.py's helpers)."""
    seed, cams, pts, noise, iterations, huber, outliers = BA_PROBLEMS[name]
    rng = np.random.default_rng(seed)
    truth, obs = make_scene(rng, n_cams=cams, n_pts=pts, noise_px=noise)
    if outliers:
        uv = np.array(obs.uv)
        sel = rng.choice(np.flatnonzero(np.asarray(obs.valid)), outliers, False)
        uv[sel] += rng.normal(0, 40.0, size=(outliers, 2))
        obs = obs.replace(uv=jnp.asarray(uv))
    return perturb(rng, truth), obs, iterations, huber


def frontend_images():
    rng = np.random.default_rng(3)
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 0.4 + 0.2 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    imgs = base[None] + 0.05 * rng.standard_normal((8, h, w))
    return (np.round(np.clip(imgs, 0, 1) * 255) / 255).astype(np.float32)


def matching_inputs():
    rng = np.random.default_rng(4)

    def unit(n):
        v = rng.normal(size=(n, 128)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    q = unit(64)
    kf = np.stack([unit(96) for _ in range(8)])
    return dict(q=q, qv=np.arange(64) < 48, kf=kf, kfv=np.tile(np.arange(96) < 80, (8, 1)))


@functools.cache
def orbit():
    return orbit_sequence(np.random.default_rng(6), num_frames=12, num_landmarks=100,
                          noise_px=0.3)


@functools.cache
def tracks_sequence():
    images, _, _, k_mat = render_sequence(np.random.default_rng(4), num_frames=6, w=96, h=64)
    return images, k_mat


@functools.cache
def visual_sequence():
    return render_sequence(np.random.default_rng(12), num_frames=10)


def _inputs():
    inputs = {}
    for name in BA_PROBLEMS:
        init, obs, iterations, huber = ba_problem(name)
        for key in ("rotations", "translations", "points", "k_mat"):
            inputs[f"bundle_adjust/{name}.{key}"] = np.asarray(getattr(init, key))
        for key in ("camera", "landmark", "uv", "valid"):
            inputs[f"bundle_adjust/{name}.{key}"] = np.asarray(getattr(obs, key))
        inputs[f"bundle_adjust/{name}.iterations"] = np.asarray(iterations)
        inputs[f"bundle_adjust/{name}.huber"] = np.asarray(np.nan if huber is None else huber)
    inputs["frontend/images"] = frontend_images()
    inputs.update({f"keyframe_matching/{k}": v for k, v in matching_inputs().items()})
    seq = orbit()
    inputs.update({
        "slam_orbit/orbit.pixels": seq.pixels,
        "slam_orbit/orbit.visible": seq.visible,
        "slam_orbit/orbit.k_mat": seq.k_mat,
        "slam_orbit/orbit.cfg": np.asarray(json.dumps(ORBIT_SLAM_CFG)),
    })
    inputs["tracks/images"], inputs["tracks/k_mat"] = tracks_sequence()
    images, _, _, k_mat = visual_sequence()
    inputs["visual_slam/images"], inputs["visual_slam/k_mat"] = images, k_mat
    return inputs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return shared_run(tmp_path_factory, "distributed", SCENARIOS, _inputs)


def _out(ranks, prefix):
    outputs, _ = ranks
    return {k[len(prefix):]: v for k, v in outputs.items() if k.startswith(prefix)}


def _single(name):
    init, obs, iterations, huber = ba_problem(name)
    state, cost = bundle_adjust(ba_state_to_port(init), observations_to_port(obs),
                                num_iterations=iterations, huber_delta=huber, **CPU)
    return state, float(cost)


def _rms(points, name):
    init, obs, _, _ = ba_problem(name)
    state = ba_state_to_port(init)
    got = _out_state(points, state)
    r = reprojection_residuals(got, observations_to_port(obs)).numpy()
    return float(np.sqrt((r**2).sum(-1).mean()))


def _out_state(out, like):
    return type(like)(
        rotations=torch.from_numpy(out["rotations"]),
        translations=torch.from_numpy(out["translations"]),
        points=torch.from_numpy(out["points"]),
        k_mat=like.k_mat,
    )


def _ba_out(ranks, name):
    return _out(ranks, f"bundle_adjust/{name}.")


# The bars below hold a run of any world size (here 2; 4 in
# tests/test_torch_multicard.py).


def check_ba(ranks, name):
    """The sharded BA against the single-device BA on ``BA_PROBLEMS[name]``:
    the same algorithm and damping schedule, whose sums over the ranks
    reassociate, which allows a small drift. ``match``: poses within 1e-6,
    points within 1e-5, cost within 1e-6 relative; ``huber`` (the same IRLS
    weights and accept-test cost): poses and cost within 1e-5; ``converge``:
    RMS below 1e-3; ``pad`` (93 landmarks, padded to the world): RMS below
    1 px. Every problem keeps its landmark count and reruns bit-equal."""
    got = _ba_out(ranks, name)
    assert got["rerun_equal"], "two runs of the sharded BA differ"
    assert got["points"].shape[0] == BA_PROBLEMS[name][2]
    if name in ("match", "huber"):
        single, cost_s = _single(name)
        tol = 1e-6 if name == "match" else 1e-5
        np.testing.assert_allclose(got["translations"], single.translations.numpy(), atol=tol)
        if name == "match":
            np.testing.assert_allclose(got["points"], single.points.numpy(), atol=1e-5)
        assert abs(float(got["cost"]) - cost_s) < tol * max(1.0, cost_s)
    else:
        assert _rms(got, name) < (1e-3 if name == "converge" else 1.0)


def check_ba_against_the_reference(ranks, devices):
    """The port's sharded BA against the JAX package's on ``devices`` of
    conftest's 8 virtual devices, float64, at tests/test_distributed.py's
    tolerances."""
    assert len(jax.devices()) >= devices, "conftest must provide 8 virtual devices"
    init, obs, iterations, _ = ba_problem("match")
    want, cost_w = jax_distributed_bundle_adjust(init, obs, jax_make_mesh(devices),
                                                 num_iterations=iterations)
    got = _ba_out(ranks, "match")
    assert got["points"].dtype == np.float64
    np.testing.assert_allclose(got["translations"], np.asarray(want.translations), atol=1e-6)
    np.testing.assert_allclose(got["points"], np.asarray(want.points), atol=1e-5)
    assert abs(float(got["cost"]) - float(cost_w)) < 1e-6 * max(1.0, float(cost_w))


def check_frontend(ranks, blur):
    """The data-parallel frontend (``blur``: ``"fused"`` or ``"separable"``,
    which goes through to each rank's share) gathers the unsharded call's
    result, field for field."""
    got = _out(ranks, "frontend/" + ("" if blur == "fused" else f"{blur}."))
    ref = port.detect_and_describe_batched(torch.from_numpy(frontend_images()),
                                           port.SiftConfig(**FRONTEND_CFG), blur, **CPU)
    assert ref.valid.sum() > 20, "degenerate test"
    for field in dataclasses.fields(ref):
        np.testing.assert_array_equal(got[field.name], getattr(ref, field.name).numpy(),
                                      err_msg=field.name)


def check_keyframe_matching(ranks):
    """Valid flags and indices of every keyframe equal ``match_descriptors``'."""
    got = _out(ranks, "keyframe_matching/")
    inp = {k: torch.from_numpy(v) for k, v in matching_inputs().items()}
    assert got["index"].shape == (8, 64)
    for k in range(8):
        ref = match_descriptors(inp["q"], inp["qv"], inp["kf"][k], inp["kfv"][k], **CPU)
        np.testing.assert_array_equal(got["valid"][k], ref.valid.numpy())
        v = ref.valid.numpy()
        np.testing.assert_array_equal(got["index"][k][v], ref.index.numpy()[v])


def check_slam_orbit(ranks, threshold):
    """Composed SLAM with a mesh reproduces the single-device trajectory
    (tests/test_slam.py:167's bars); at threshold 0 every BA is sharded, at
    the reference's none (100 landmarks at most, far below it)."""
    seq = orbit()
    single = port.run_slam(seq.pixels, seq.visible, seq.k_mat,
                           port.SlamConfig(**ORBIT_SLAM_CFG), **CPU)
    got = _out(ranks, f"slam_orbit/orbit_{threshold}.")
    np.testing.assert_allclose(got["translations"], single.translations, atol=5e-3)
    ate_s = port.evaluate_ate(single, seq.rotations, seq.translations, **CPU)
    assert abs(_ate(got, seq.rotations, seq.translations) - ate_s) < 1e-3
    n_ba = sum(_ba_count(ranks, f"slam_orbit/orbit_{REFERENCE_THRESHOLD}."))
    assert n_ba > 0
    want = (n_ba, 0) if threshold == REFERENCE_THRESHOLD else (0, n_ba)
    assert _ba_count(ranks, f"slam_orbit/orbit_{threshold}.") == want


def check_same_bits(ranks, world, scenarios):
    """Every rank's outputs of every scenario are rank 0's, bit for bit."""
    _, digests = ranks
    assert len(digests) == world
    assert sorted(digests[0]) == sorted(scenarios)
    for rank, got in enumerate(digests[1:], start=1):
        assert got == digests[0], f"rank {rank} differs from rank 0"


def test_distributed_ba_matches_single_device(ranks):
    check_ba(ranks, "match")


def test_distributed_ba_huber_matches_single_device(ranks):
    check_ba(ranks, "huber")


def test_distributed_ba_converges(ranks):
    check_ba(ranks, "converge")


def test_distributed_ba_landmarks_not_multiple_of_mesh(ranks):
    check_ba(ranks, "pad")


def test_distributed_ba_matches_the_reference_on_its_mesh(ranks):
    check_ba_against_the_reference(ranks, 8)


def test_data_parallel_frontend_matches_single(ranks):
    check_frontend(ranks, "fused")


def test_data_parallel_blurred_frontend_matches_single(ranks):
    check_frontend(ranks, "separable")


def test_sharded_keyframe_matching_matches_vmap(ranks):
    check_keyframe_matching(ranks)


def _ate(out, gt_r, gt_t):
    result = port.SlamResult(out["rotations"], out["translations"], out["points"],
                             out["landmark_valid"], int(out["num_observations"]))
    return port.evaluate_ate(result, gt_r, gt_t, **CPU)


def _ba_count(ranks, prefix):
    """``(single-device, sharded)`` BAs of the run under ``prefix``."""
    return tuple(int(v) for v in _out(ranks, prefix)["ba_calls"])


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_slam_on_a_mesh_matches_single_device(ranks, threshold):
    check_slam_orbit(ranks, threshold)


def test_build_tracks_on_a_mesh_matches_single_device(ranks):
    """A sequence shorter than one chunk of the mesh (6 frames, 16 a rank)
    runs and reproduces the single-device tracks."""
    images, k_mat = tracks_sequence()
    single = port.build_tracks_from_images(images, port.SiftConfig(**TRACKS_CFG), k_mat=k_mat,
                                           **CPU)
    got = _out(ranks, "tracks/")
    assert got["pixels"].shape == single[0].shape
    np.testing.assert_array_equal(got["visible"], single[1])
    np.testing.assert_allclose(got["pixels"], single[0], atol=1e-5)


@pytest.fixture(scope="module")
def visual_single():
    images, gt_r, gt_t, k_mat = visual_sequence()
    result = port.run_slam_from_images(images, k_mat, port.SiftConfig(**VISUAL_CFG),
                                       port.SlamConfig(**VISUAL_SLAM_CFG), reassoc_window=2,
                                       dtype=torch.float64, **CPU)
    return result, port.evaluate_ate(result, gt_r, gt_t, **CPU)


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_visual_slam_on_a_mesh_matches_single_device(ranks, visual_single, threshold):
    """``run_slam_from_images(mesh=…)``: the data-parallel frontend, the
    query-sharded window matching and, at threshold 0, every BA sharded;
    the back end in float64 (see the scenario)."""
    _, gt_r, gt_t, _ = visual_sequence()
    single, ate_s = visual_single
    got = _out(ranks, f"visual_slam/batch_{threshold}.")
    np.testing.assert_allclose(got["translations"], single.translations, atol=5e-3)
    assert abs(_ate(got, gt_r, gt_t) - ate_s) < 1e-3
    n_ba = sum(_ba_count(ranks, f"visual_slam/batch_{REFERENCE_THRESHOLD}."))
    assert n_ba == 5  # windows [1, 4), [4, 7), [7, 10) and two final rounds
    want = (n_ba, 0) if threshold == REFERENCE_THRESHOLD else (0, n_ba)
    assert _ba_count(ranks, f"visual_slam/batch_{threshold}.") == want


def test_streaming_session_on_a_mesh_matches_the_batch_run(ranks):
    """``SlamSession(mesh=…)`` gives the batch run with the same mesh bit for
    bit, every BA sharded (threshold 0)."""
    stream = _out(ranks, "visual_slam/stream.")
    batch = _out(ranks, "visual_slam/batch_0.")
    assert int(stream["updates"]) == 3  # frames 4, 7, 10
    for key in ("rotations", "translations", "points", "landmark_valid"):
        np.testing.assert_array_equal(stream[key], batch[key])
    single, sharded = _ba_count(ranks, "visual_slam/stream.")
    assert single == 0 and sharded == 5


def test_every_rank_returns_the_same_bits(ranks):
    check_same_bits(ranks, WORLD, SCENARIOS)
