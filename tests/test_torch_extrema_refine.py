"""Candidate selection and Newton refinement of the port against the JAX package.

Both sides are fed the JAX Pallas kernel's own DoG and packed masks
(interpret mode, plane-major layout), so these tests see only the
selection and refinement arithmetic. Inputs are made with numpy from a
seed and handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_scale_space_extrema_detection_tpu.core.types as jtypes
from sift_scale_space_extrema_detection_tpu.config import SiftConfig as JaxConfig
from sift_scale_space_extrema_detection_tpu.models.frontend import (
    build_pyramid_fused as jax_build_pyramid_fused,
)
from sift_scale_space_extrema_detection_tpu.ops import extrema as jextrema
from sift_scale_space_extrema_detection_tpu.ops import refine as jrefine
import sift_scale_space_extrema_detection_tpu_torch.core.types as ptypes
from sift_scale_space_extrema_detection_tpu_torch.config import from_reference_config
from sift_scale_space_extrema_detection_tpu_torch.ops.extrema import (
    select_refine_candidates,
    unpack_mask_codes,
)
from sift_scale_space_extrema_detection_tpu_torch.ops.refine import refine_keypoints

torch.set_num_threads(2)

# Refinement runs in float32 on both sides; XLA:CPU may contract some of
# the Newton step's products and sums into FMAs and its exp2 may differ
# in the last ulp, so the float outputs agree to a few float32 ulps.
RTOL = 1e-5
N_OCTAVES = 3


def _images():
    """2 × 48×64 uint8 frames: smooth blobs + gradient + noise."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:48, 0:64].astype(np.float64)
    out = []
    for _ in range(2):
        img = 0.4 + 0.2 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
        for _ in range(5):
            cy, cx = rng.uniform(4, 44), rng.uniform(4, 60)
            r, a = rng.uniform(2, 5), rng.uniform(-0.4, 0.5)
            img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        img += 0.05 * rng.standard_normal((48, 64))
        out.append(np.round(np.clip(img, 0, 1) * 255))
    return np.stack(out).astype(np.uint8)


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX kernel's DoG/masks and the JAX selection + refinement."""
    cfg = JaxConfig(num_octaves=N_OCTAVES, scales_per_octave=5)
    images = jnp.asarray(_images()).astype(jnp.float32) / 255.0
    _, dogs, masks = jax_build_pyramid_fused(
        images, cfg, emit_scales=False, emit_masks=True, interpret=True
    )

    def per_image(dog, mask, octave):
        sel = jextrema.select_refine_candidates(
            mask, dog, cfg, cfg.refine_capacity(octave)
        )
        return sel, jrefine.refine_keypoints(dog, sel, octave, cfg)

    results = [
        jax.jit(jax.vmap(lambda d, m, o=o: per_image(d, m, o)))(d, m)
        for o, (d, m) in enumerate(zip(dogs, masks))
    ]
    return cfg, [np.array(d) for d in dogs], [np.array(m) for m in masks], results


@pytest.mark.parametrize("octave", range(N_OCTAVES))
def test_select_refine_candidates_matches_jax(jax_run, octave):
    cfg, dogs, masks, results = jax_run
    want, _ = results[octave]
    got = select_refine_candidates(
        torch.from_numpy(masks[octave]),
        torch.from_numpy(dogs[octave]),
        from_reference_config(cfg),
        cfg.refine_capacity(octave),
    )
    for field in ("y", "x", "scale_level", "valid"):
        g, w = getattr(got, field).numpy(), _np(getattr(want, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    # The counters are int32 in the port; the JAX package's sums widen to
    # int64 under the suite's jax_enable_x64, so only values are compared.
    for field in ("num_candidates", "num_low_contrast"):
        assert getattr(got, field).dtype == torch.int32
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), _np(getattr(want, field)), err_msg=field
        )
    np.testing.assert_allclose(got.value.numpy(), _np(want.value), rtol=RTOL)
    if octave == 0:
        assert got.valid.sum() > 0


@pytest.mark.parametrize("octave", range(N_OCTAVES))
def test_refine_keypoints_matches_jax(jax_run, octave):
    cfg, dogs, masks, results = jax_run
    sel, want = results[octave]
    extrema = ptypes.Extrema(
        **{
            f.name: torch.tensor(_np(getattr(sel, f.name)))
            for f in dataclasses.fields(ptypes.Extrema)
        }
    )
    got = refine_keypoints(
        torch.from_numpy(dogs[octave]), extrema, octave, from_reference_config(cfg)
    )
    _assert_keypoints_match(got, want)
    if octave == 0:
        assert got.valid.sum() > 0


def _assert_keypoints_match(got, want):
    for field in ("octave", "scale_level", "local_y", "local_x", "valid", "reject_reason"):
        g, w = getattr(got, field).numpy(), _np(getattr(want, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    for field in ("abs_y", "abs_x", "abs_sigma", "value"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), _np(getattr(want, field)),
            rtol=RTOL, atol=1e-7, err_msg=field,
        )


def test_selection_capacity_overflow_keeps_counters(jax_run):
    """A capacity below the candidate count keeps the first candidates in
    order and leaves the per-trio counters uncapped."""
    cfg, dogs, masks, _ = jax_run
    cap = 8
    want = jax.vmap(
        lambda m, d: jextrema.select_refine_candidates(m, d, cfg, cap)
    )(jnp.asarray(masks[0]), jnp.asarray(dogs[0]))
    got = select_refine_candidates(
        torch.from_numpy(masks[0]), torch.from_numpy(dogs[0]),
        from_reference_config(cfg), cap,
    )
    assert (got.num_candidates.sum(dim=1) > cap).all()
    for field in ("y", "x", "scale_level", "valid", "num_candidates"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), _np(getattr(want, field)), err_msg=field
        )


def test_unpack_mask_codes_matches_jax(jax_run):
    _, _, masks, _ = jax_run
    for m in masks:
        np.testing.assert_array_equal(
            unpack_mask_codes(torch.from_numpy(m), 5).numpy(),
            np.stack([_np(jextrema.unpack_mask_codes(jnp.asarray(mi), 5)) for mi in m]),
        )


def test_refine_ladder_truncation_matches_jax():
    """More still-active slots than the ladder admits: the slots beyond
    each cap keep REJECT_MAX_ITERATIONS, as in the JAX compaction ladder."""
    cfg = JaxConfig(num_octaves=1, scales_per_octave=5)
    rng = np.random.default_rng(12)
    b, n = 2, 300
    dog = (0.1 * rng.standard_normal((b, 7, 24, 32))).astype(np.float32)
    s = rng.integers(1, 6, (b, n)).astype(np.int32)
    y = rng.integers(1, 23, (b, n)).astype(np.int32)
    x = rng.integers(1, 31, (b, n)).astype(np.int32)
    value = dog[np.arange(b)[:, None], s, y, x]
    valid = rng.random((b, n)) < 0.9
    counts = np.zeros((b, 5), np.int32)
    fields = dict(y=y, x=x, scale_level=s, value=value, valid=valid,
                  num_candidates=counts, num_low_contrast=counts)
    want = jax.jit(jax.vmap(lambda d, e: jrefine.refine_keypoints(d, e, 1, cfg)))(
        jnp.asarray(dog), jtypes.Extrema(**{k: jnp.asarray(v) for k, v in fields.items()})
    )
    extrema = ptypes.Extrema(**{k: torch.from_numpy(v) for k, v in fields.items()})
    pcfg = from_reference_config(cfg)
    got = refine_keypoints(torch.from_numpy(dog), extrema, 1, pcfg)
    _assert_keypoints_match(got, want)
    # The ladder did cut: without it more slots finish.
    uncut = refine_keypoints(
        torch.from_numpy(dog), extrema, 1,
        dataclasses.replace(pcfg, refine_compaction_schedule=(1.0,)),
    )
    assert (uncut.reject_reason != got.reject_reason).any()
