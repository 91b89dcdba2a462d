"""The port's detect and describe paths end to end against the JAX package's
kernel path.

The JAX reference is its fused-kernel path: ``build_pyramid_fused`` with
the Pallas kernel in interpret mode, then ``detect_from_dog`` per image.
(``detect_batched(blur="fused")`` on the CPU would silently take the
separable fallback, so it is not the reference for the kernel path.)
The same numpy arrays go into both packages.
"""

import dataclasses

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
import sift_scale_space_extrema_detection_tpu_torch as port
from tests.torch_port_helpers import textured_images

torch.set_num_threads(2)

# Positions: both pyramids and refinements run in float32, but XLA:CPU may
# contract the JAX side's products and sums into FMAs, so DoG values differ
# by a few ulps and refined coordinates below 130 px by ~1e-5 px.
POS_ATOL = 1e-4


def _images(kind):
    """2 × 48×64 frames of blobs + gradient + noise, as uint8 or float32.

    The DoG values of the two packages differ by a few ulps (see
    ``POS_ATOL``), so where two neighbours tie to within that, a strict
    extremum can move by one trio (about one mask pixel in 25k per image
    on such frames); the values stay inside (0, 1), since clipped flat
    regions make such ties common, and the seed gives frames without one,
    so the comparison below can demand equal sets.
    """
    rng = np.random.default_rng(22)
    yy, xx = np.mgrid[0:48, 0:64].astype(np.float64)
    out = []
    for _ in range(2):
        img = 0.45 + 0.2 * np.sin(xx / 6.0) * np.cos(yy / 5.0)
        for _ in range(6):
            cy, cx = rng.uniform(4, 44), rng.uniform(4, 60)
            r, a = rng.uniform(1.5, 5), rng.uniform(-0.25, 0.25)
            img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        img += 0.04 * rng.standard_normal((48, 64))
        out.append(np.clip(img, 0, 1))
    imgs = np.stack(out)
    if kind == "uint8":
        return np.round(imgs * 255).astype(np.uint8)
    return imgs.astype(np.float32)


@pytest.fixture(scope="module", params=["uint8", "float32"])
def run(request):
    images = _images(request.param)
    cfg = JaxConfig(num_octaves=3, scales_per_octave=5)
    _, dogs, masks = jfront.build_pyramid_fused(
        jfront._as_unit_float(jnp.asarray(images)), cfg,
        emit_scales=False, emit_masks=True, interpret=True,
    )
    n = len(dogs)
    want_kp, want_ex = jax.jit(
        jax.vmap(lambda *a: jfront.detect_from_dog(list(a[:n]), cfg, list(a[n:])))
    )(*dogs, *masks)
    got_kp, got_ex = port.detect_batched(
        torch.from_numpy(images), port.from_reference_config(cfg), device="cpu"
    )
    return images, cfg, (want_kp, want_ex), (got_kp, got_ex)


def test_detect_batched_keypoints_match_jax(run):
    _, _, (want, _), (got, _) = run
    valid = np.asarray(want.valid)
    assert got.valid.shape == valid.shape and valid.sum() > 0
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(
        got.reject_reason.numpy(), np.asarray(want.reject_reason)
    )
    for field in ("octave", "scale_level", "local_y", "local_x"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy()[valid],
            np.asarray(getattr(want, field))[valid], err_msg=field,
        )
    for field in ("abs_y", "abs_x"):
        np.testing.assert_allclose(
            getattr(got, field).numpy()[valid],
            np.asarray(getattr(want, field))[valid],
            rtol=0, atol=POS_ATOL, err_msg=field,
        )
    # The pyramids differ by a few float32 ulps (POS_ATOL), which moves the
    # Newton scale offset, and with it sigma = c * 2^(s/spo), by ~1e-5.
    np.testing.assert_allclose(
        got.abs_sigma.numpy()[valid], np.asarray(want.abs_sigma)[valid], rtol=1e-4
    )


def test_detect_batched_counters_match_jax(run):
    _, _, (want_kp, want_ex), (got_kp, got_ex) = run
    reasons = np.asarray(want_kp.reject_reason)
    want_counts = np.stack(
        [(reasons == r).sum(-1) for r in range(port.NUM_REJECT_REASONS)], -1
    )
    np.testing.assert_array_equal(got_kp.reject_counts().numpy(), want_counts)
    assert len(got_ex) == len(want_ex)
    for g, w in zip(got_ex, want_ex):
        for field in ("num_candidates", "num_low_contrast", "y", "x", "valid"):
            np.testing.assert_array_equal(
                getattr(g, field).numpy(), np.asarray(getattr(w, field)),
                err_msg=field,
            )


def test_detect_single_image_equals_batch_row(run):
    images, cfg, _, (got, got_ex) = run
    one, one_ex = port.detect(
        torch.from_numpy(images[1]), port.from_reference_config(cfg), device="cpu"
    )
    for field in ("valid", "reject_reason", "abs_x", "abs_y", "abs_sigma", "value"):
        assert torch.equal(getattr(one, field), getattr(got, field)[1]), field
    for e1, eb in zip(one_ex, got_ex):
        assert torch.equal(e1.num_candidates, eb.num_candidates[1])


def test_output_types(run):
    _, _, _, (got, got_ex) = run
    for field in ("octave", "scale_level", "local_y", "local_x", "reject_reason"):
        assert getattr(got, field).dtype == torch.int32, field
    for field in ("abs_y", "abs_x", "abs_sigma", "value"):
        assert getattr(got, field).dtype == torch.float32, field
    assert got.valid.dtype == torch.bool
    assert all(e.value.dtype == torch.float32 for e in got_ex)


# --- detect + describe end to end -------------------------------------------

# The JAX package's own parity bars for a second implementation of its
# frontend (slot agreement, p99 position delta in px, descriptor cosine).
SLOT_AGREEMENT = 0.999
P99_PX = 0.1
MIN_COSINE = 0.999


@pytest.fixture(scope="module")
def described():
    """2 textured 96×128 frames through both packages. JAX: the Pallas octave
    kernel in interpret mode with its Gaussian stacks, selection and
    refinement per image, then the gather-path ``describe_compact``."""
    images = textured_images(13, 2, 96, 128)
    cfg = JaxConfig(num_octaves=3, max_keypoints_per_trio=128)
    stacks, dogs, masks = jfront.build_pyramid_fused(
        jnp.asarray(images), cfg, emit_scales=True, emit_masks=True, interpret=True
    )
    n = cfg.num_octaves

    def one(*arrays):
        stacks, dogs, masks = arrays[:n], arrays[n : 2 * n], arrays[2 * n :]
        keypoints = [
            jrefine.refine_keypoints(
                d, jextrema.select_refine_candidates(m, d, cfg, cfg.refine_capacity(o)), o, cfg
            )
            for o, (d, m) in enumerate(zip(dogs, masks))
        ]
        return jdesc.describe_compact(list(stacks), keypoints, cfg)

    want = jax.jit(jax.vmap(one))(*stacks, *dogs, *masks)
    pcfg = port.from_reference_config(cfg)
    got = port.detect_and_describe_batched(torch.from_numpy(images), pcfg, device="cpu")
    return images, pcfg, want, got


def test_detect_and_describe_batched_matches_jax(described):
    _, _, want, got = described
    want_valid, got_valid = np.asarray(want.valid), got.valid.numpy()
    assert got_valid.shape == want_valid.shape and want_valid.sum() > 30
    both = got_valid & want_valid
    same_slot = (got_valid == want_valid) & (
        ~both
        | (
            (got.octave.numpy() == np.asarray(want.octave))
            & (got.scale_level.numpy() == np.asarray(want.scale_level))
        )
    )
    assert same_slot.mean() >= SLOT_AGREEMENT
    delta = np.hypot(
        got.abs_x.numpy()[both] - np.asarray(want.abs_x)[both],
        got.abs_y.numpy()[both] - np.asarray(want.abs_y)[both],
    )
    assert np.quantile(delta, 0.99) <= P99_PX
    d_got, d_want = got.descriptor.numpy()[both], np.asarray(want.descriptor)[both]
    cosine = (d_got * d_want).sum(-1) / (
        np.linalg.norm(d_got, axis=-1) * np.linalg.norm(d_want, axis=-1)
    )
    assert cosine.min() >= MIN_COSINE
    # Measured here (52 valid pairs): all slots agree, positions within
    # 1.2e-4 px, θ within 6e-6 rad, descriptors within 1.4e-5, cosine
    # ≥ 0.9999999; the pyramids differ by float32 ulps (see POS_ATOL).
    assert delta.max() <= 1e-3 and cosine.min() >= 0.99999


def test_detect_and_describe_single_image_equals_batch_row(described):
    images, pcfg, _, got = described
    one = port.detect_and_describe(torch.from_numpy(images[1]), pcfg, device="cpu")
    assert one.valid.shape == (pcfg.descriptor_pair_capacity(),)
    for field in ("valid", "octave", "abs_x", "abs_y", "theta", "descriptor"):
        assert torch.equal(getattr(one, field), getattr(got, field)[1]), field


def test_per_octave_describe_path_holds_the_same_keypoints(described):
    images, pcfg, _, got = described
    per_octave = port.detect_and_describe_batched(
        torch.from_numpy(images), dataclasses.replace(pcfg, compact_describe=False),
        device="cpu",
    )
    total = sum(pcfg.refine_capacity(o) for o in range(pcfg.num_octaves))
    assert per_octave.valid.shape == (2, total * pcfg.max_orientations_per_keypoint)
    for b in range(2):
        v, w = got.valid[b], per_octave.valid[b]
        assert torch.equal(got.theta[b][v], per_octave.theta[b][w])
        assert torch.equal(got.descriptor[b][v], per_octave.descriptor[b][w])


def test_describe_refuses_tf32_matrix_products_on_cuda(monkeypatch):
    from sift_scale_space_extrema_detection_tpu_torch.ops.descriptor import (
        _require_full_float32_matmul,
    )

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    _require_full_float32_matmul(torch.device("cpu"))
    with pytest.raises(RuntimeError, match="allow_tf32"):
        _require_full_float32_matmul(torch.device("cuda", 0))
