"""The port's describe stages against the JAX package's gather path.

The same Gaussian stacks and the same refined keypoints (JAX outputs,
carried over as numpy arrays) go through ``jax.vmap`` of the JAX
``describe_compact`` / ``describe_octave`` and through the port's batched
``describe_compact`` / ``describe_octave``; on the CPU the port samples
through the plain version of its window-sampling kernel.

Why the two are not bit-equal, and what bounds the difference:

- the JAX sampler folds the scale level into the row coordinate
  (``y + s·H``), which rounds ``y`` to a coarser float32 grid (6e-5 px on a
  192-row octave at level 5); the port keeps ``y``;
- XLA:CPU fuses products and sums and orders the histogram sums its own way;
- the orientation histogram bins hard (``floor``), so an ulp of ``atan2``
  moves a sample on a bin edge to the next bin, which after smoothing and
  the parabolic fit moves θ a little and can flip a peak across the 0.8
  ratio. Hence agreement rates and quantiles instead of equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_scale_space_extrema_detection_tpu.config import SiftConfig as JaxConfig
from sift_scale_space_extrema_detection_tpu.models import frontend as jfront
from sift_scale_space_extrema_detection_tpu.ops import descriptor as jdesc
from sift_scale_space_extrema_detection_tpu.ops import extrema as jextrema
from sift_scale_space_extrema_detection_tpu.ops import refine as jrefine
from sift_scale_space_extrema_detection_tpu_torch.config import from_reference_config
from sift_scale_space_extrema_detection_tpu_torch.ops import descriptor as pdesc
from tests.torch_port_helpers import keypoints_to_port, textured_images

torch.set_num_threads(2)

N_OCTAVES = 3
# Measured on these inputs (47 valid pairs, 37 upright): every slot agrees in
# validity, θ differs by at most 1.2e-6 rad, descriptors by at most 1.3e-6
# (p99 6e-7, cosine ≥ 0.9999999). The bars leave a factor of a few.
VALID_AGREEMENT = 0.999
THETA_ATOL, THETA_SHARE = 1e-5, 0.999
MIN_COSINE = 0.999999
DESC_P99 = 2e-6


@pytest.fixture(scope="module")
def detected():
    """JAX Gaussian stacks and refined keypoints of 2 textured 96×128 frames."""
    cfg = JaxConfig(num_octaves=N_OCTAVES, max_keypoints_per_trio=128)
    images = jnp.asarray(textured_images(7, 2, 96, 128))
    stacks = jfront.build_scale_space(images, cfg, "separable")
    dogs = jfront.build_dog(stacks)

    def detect_one(*dogs):
        return [
            jrefine.refine_keypoints(
                d,
                jextrema.compact_extrema(
                    jextrema.find_extrema(d, cfg, cfg.keypoints_per_trio(o)),
                    cfg.refine_capacity(o),
                ),
                o,
                cfg,
            )
            for o, d in enumerate(dogs)
        ]

    keypoints = jax.jit(jax.vmap(detect_one))(*dogs)
    return stacks, keypoints


def _port_inputs(stacks, keypoints):
    return (
        [torch.from_numpy(np.array(s)) for s in stacks],
        [keypoints_to_port(k) for k in keypoints],
    )


def _assert_described_match(got, want, min_valid):
    want_valid = np.asarray(want.valid)
    got_valid = got.valid.numpy()
    assert got_valid.shape == want_valid.shape
    assert want_valid.sum() > min_valid, "degenerate test: too few keypoints"
    assert (got_valid == want_valid).mean() >= VALID_AGREEMENT
    v = got_valid & want_valid
    for field in ("octave", "scale_level"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy()[v], np.asarray(getattr(want, field))[v]
        )
    for field in ("abs_y", "abs_x", "abs_sigma"):  # copied through, not computed
        np.testing.assert_array_equal(
            getattr(got, field).numpy()[v], np.asarray(getattr(want, field))[v]
        )
    dtheta = np.abs(got.theta.numpy()[v] - np.asarray(want.theta)[v])
    dtheta = np.minimum(dtheta, 2 * np.pi - dtheta)
    assert (dtheta <= THETA_ATOL).mean() >= THETA_SHARE, dtheta.max()
    # Descriptors are compared where θ agrees: a pair whose θ moved is a
    # different (rotated) descriptor, which the θ share above accounts for.
    same = dtheta <= THETA_ATOL
    d_got = got.descriptor.numpy()[v][same]
    d_want = np.asarray(want.descriptor)[v][same]
    assert got.descriptor.dtype == torch.float32 and d_got.shape[-1] == 128
    np.testing.assert_allclose(np.linalg.norm(d_got, axis=-1), 1.0, atol=1e-5)
    cosine = (d_got * d_want).sum(-1) / (
        np.linalg.norm(d_got, axis=-1) * np.linalg.norm(d_want, axis=-1)
    )
    assert cosine.min() >= MIN_COSINE, cosine.min()
    assert np.quantile(np.abs(d_got - d_want), 0.99) <= DESC_P99


@pytest.mark.parametrize("upright", [False, True])
def test_describe_compact_matches_jax_gather_path(detected, upright):
    stacks, keypoints = detected
    cfg = JaxConfig(num_octaves=N_OCTAVES, max_keypoints_per_trio=128, upright=upright)
    n = N_OCTAVES
    want = jax.jit(
        jax.vmap(lambda *a: jdesc.describe_compact(list(a[:n]), list(a[n:]), cfg))
    )(*stacks, *keypoints)
    got = pdesc.describe_compact(
        *_port_inputs(stacks, keypoints), from_reference_config(cfg)
    )
    _assert_described_match(got, want, min_valid=30)
    if upright:
        assert not got.theta.any()


def test_describe_octave_matches_jax(detected):
    stacks, keypoints = detected
    octave = 1
    cfg = JaxConfig(num_octaves=N_OCTAVES, max_keypoints_per_trio=128)
    want = jax.jit(
        jax.vmap(lambda s, k: jdesc.describe_octave(s, k, octave, cfg))
    )(stacks[octave], keypoints[octave])
    port_stacks, port_keypoints = _port_inputs(stacks, keypoints)
    got = pdesc.describe_octave(
        port_stacks[octave], port_keypoints[octave], octave, from_reference_config(cfg)
    )
    _assert_described_match(got, want, min_valid=10)
    # An invalid pair is not sampled: its descriptor is zero.
    assert not got.descriptor[~got.valid].any()


def test_describe_compact_agrees_with_describe_octave(detected):
    """Per kept keypoint the compacting pass is the per-octave math."""
    stacks, keypoints = _port_inputs(*detected)
    cfg = from_reference_config(JaxConfig(num_octaves=N_OCTAVES, max_keypoints_per_trio=128))
    compact = pdesc.describe_compact(stacks, keypoints, cfg)
    per_octave = pdesc.concat_described(
        [pdesc.describe_octave(s, k, o, cfg) for o, (s, k) in enumerate(zip(stacks, keypoints))]
    )
    assert compact.valid.sum() == per_octave.valid.sum() > 30
    for b in range(compact.valid.shape[0]):
        v, w = compact.valid[b], per_octave.valid[b]
        assert torch.equal(compact.theta[b][v], per_octave.theta[b][w])
        assert torch.equal(compact.descriptor[b][v], per_octave.descriptor[b][w])


@pytest.mark.parametrize("half_width, n", [(1.0, 16), (7.5, 16), (6.0 * 3 / 2, 9)])
def test_grid_rulers_within_one_ulp_of_jnp_linspace(half_width, n):
    # Measured: up to 7 of 16 points differ, by at most one float32 ulp of
    # the half-width, which is up to 5 ulps of a point near zero (XLA:CPU
    # fuses and reorders jnp.linspace's lo·(1−t) + hi·t); that moves a
    # sample by 1.2e-7 of the grid's half-width.
    want = np.asarray(jnp.linspace(-half_width, half_width, n, dtype=jnp.float32))
    got = pdesc._ruler(half_width, n)
    assert got.dtype == np.float32 and got[0] == -got[-1] == -np.float32(half_width)
    assert (np.abs(got - want) <= np.spacing(np.float32(half_width))).all()


def _hist(**bins):
    h = np.full(36, 0.1, np.float32)
    for k, v in bins.items():
        h[int(k[1:])] = v
    return h


PEAK_CASES = {
    # Two equal peaks: the lower bin takes the first slot.
    "two_equal_peaks": _hist(b30=2.0, b5=2.0),
    "two_equal_peaks_across_the_wrap": _hist(b35=1.5, b0=0.2, b17=1.5),
    "no_peak": np.full(36, 0.7, np.float32),
    "all_zero": np.zeros(36, np.float32),
    "one_peak": _hist(b11=1.0, b12=0.6, b20=0.5),
    "second_peak_below_ratio": _hist(b3=1.0, b9=0.79),
    "three_peaks_keep_the_two_largest": _hist(b2=0.9, b14=1.0, b25=0.95),
}


@pytest.mark.parametrize("name", PEAK_CASES)
def test_extract_peaks_matches_jax(name):
    hist = PEAK_CASES[name]
    cfg = JaxConfig()
    want_theta, want_valid = jdesc._extract_peaks(jnp.asarray(hist), cfg)
    got_theta, got_valid = pdesc._extract_peaks(
        torch.from_numpy(hist)[None], from_reference_config(cfg)
    )
    np.testing.assert_array_equal(got_valid[0].numpy(), np.asarray(want_valid))
    v = np.asarray(want_valid)
    np.testing.assert_allclose(
        got_theta[0].numpy()[v], np.asarray(want_theta)[v], rtol=0, atol=1e-6
    )
    if name.startswith("two_equal"):
        assert v.all() and got_theta[0, 0] < got_theta[0, 1]


def test_normalize_clamp_renormalize():
    rng = np.random.default_rng(8)
    raw = rng.random((5, 128)).astype(np.float32) ** 6  # a few dominant bins
    raw[4] = 0.0
    got = pdesc._normalize_descriptor(torch.from_numpy(raw), 0.2).numpy()
    norm = np.sqrt((raw * raw).sum(-1, keepdims=True) + 1e-12)
    clamped = np.minimum(raw, 0.2 * norm)
    want = clamped / np.sqrt((clamped * clamped).sum(-1, keepdims=True) + 1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (raw[:4] > 0.2 * norm[:4]).any()  # the clamp did bite
    np.testing.assert_allclose(np.linalg.norm(got[:4], axis=-1), 1.0, atol=1e-6)
    assert not got[4].any()  # an empty histogram stays zero, not NaN


def test_concat_described_joins_slots(detected):
    stacks, keypoints = _port_inputs(*detected)
    cfg = from_reference_config(JaxConfig(num_octaves=N_OCTAVES, max_keypoints_per_trio=128))
    parts = [pdesc.describe_octave(stacks[o], keypoints[o], o, cfg) for o in (1, 2)]
    both = pdesc.concat_described(parts)
    assert both.capacity == parts[0].capacity + parts[1].capacity
    assert both.descriptor.shape == (2, both.capacity, 128)
    assert torch.equal(both.descriptor[:, : parts[0].capacity], parts[0].descriptor)
