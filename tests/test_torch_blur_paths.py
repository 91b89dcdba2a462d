"""The port's blur-by-blur frontend and its pooled refinement against the
JAX package, on the CPU.

Every ``blur`` but ``"fused"`` builds the scale space one blur at a time,
scans each trio on its own and caps it per trio, then compacts the trios
(the JAX package's default path). The four frontend entry points of both
packages get the same numpy frames with the same ``blur``: keypoint fields,
the per-trio ``Extrema`` layout and counters, and descriptors. Off the TPU
the JAX package's ``"pallas"`` is its separable blur
(``ops/pallas/blur.py:115``), and the port's ``"pallas"``/``"cuda"`` on the
CPU is ``blur_separable``: both are held against the JAX package's
separable run, which is its call with no ``blur`` at all.

``unified_refine`` and ``refine_tail_pool`` pool the octaves' candidates
(the JAX package's ``refine_keypoints_multi``), which changes results once
a pool or its ladder overflows: on such inputs the JAX package's pooled
result differs from its per-octave result, and the port's equals the JAX
package's, on the per-trio route (no masks), on the mask route of the fused
path, and through the fused pyramid (the Pallas kernel in interpret mode).

Each JAX program here is compiled once per test, and a test holds all the
entry points of one strategy, so that no xdist worker compiles a program
another worker compiles too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_scale_space_extrema_detection_tpu.config import SiftConfig as JaxConfig
from sift_scale_space_extrema_detection_tpu.models import frontend as jfront
from sift_scale_space_extrema_detection_tpu.models import slam as jslam
from sift_scale_space_extrema_detection_tpu.ops import gaussian as jgauss
from sift_scale_space_extrema_detection_tpu.ops.pallas import blur as jblur
import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.core.types import Extrema, exact_scalar
from sift_scale_space_extrema_detection_tpu_torch.ops.descriptor import DescribedKeypoints
from sift_scale_space_extrema_detection_tpu_torch.models import frontend as pfront
from sift_scale_space_extrema_detection_tpu_torch.models import slam as pslam
from sift_scale_space_extrema_detection_tpu_torch.ops import gaussian as pgauss
from sift_scale_space_extrema_detection_tpu_torch.ops.extrema import pack_extrema_codes

from tests.test_torch_visual_slam import render_sequence
from tests.torch_port_helpers import (
    _to_port,
    jax_ransac_draws,
    keypoints_to_port,
    textured_images,
)

torch.set_num_threads(2)

CPU = dict(device="cpu")
# Positions in units of the octave's own pixel. tests/test_torch_frontend.py
# holds the fused path to 1e-4, where the two packages' DoGs differ by a few
# float32 ulps. Blur by blur, the two blurs differ by up to 2e-6
# (tests/test_torch_blur_kernel.py's XLA_ATOL: XLA's convolution sums in
# another order than the tap loop), and refined coordinates by up to
# 1.5e-4 on these frames; on identical DoGs (the pooled refinement) they
# agree to 1e-5.
POS_ATOL = 2e-4
MIN_COSINE = 0.999
JCFG = JaxConfig(num_octaves=2, max_keypoints_per_trio=64)
PCFG = port.from_reference_config(JCFG)
INT_FIELDS = ("valid", "reject_reason", "octave", "scale_level", "local_y", "local_x")


def _images(dtype=np.float32):
    """2 × 64×96 textured frames; the seed gives frames free of near-ties
    between the two packages' DoG values, so the slot sets are equal."""
    return textured_images(13, 2, 64, 96).astype(dtype)


def _octave_units(keypoints):
    """Each slot's pixel size in input pixels: 2^(octave-1)."""
    return torch.pow(2.0, keypoints.octave.to(torch.float64) - 1)


def assert_keypoints_equal(got, want, pos_atol=POS_ATOL):
    """Integer fields equal; positions within ``pos_atol`` of the octave's
    pixel, sigma and value within ``1e-4`` relative (exact in float64)."""
    for field in INT_FIELDS:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    v = want.valid
    assert int(v.sum()) > 10, "degenerate fixture"
    scale = _octave_units(want)[v]
    for field in ("abs_y", "abs_x"):
        delta = (getattr(got, field)[v].double() - getattr(want, field)[v].double()).abs()
        assert float((delta / scale).max()) <= pos_atol, field
    for field in ("abs_sigma", "value"):
        np.testing.assert_allclose(
            getattr(got, field)[v].numpy(), getattr(want, field)[v].numpy(), rtol=1e-4,
            atol=1e-7, err_msg=field,
        )


def assert_extrema_equal(got, want):
    """The per-trio slot layout and counters, bit for bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = _to_port(Extrema, w)
        for field in ("y", "x", "scale_level", "valid", "num_candidates", "num_low_contrast"):
            assert torch.equal(getattr(g, field), getattr(w, field)), field


def assert_described_equal(got, want):
    want = _to_port(DescribedKeypoints, want)
    for field in ("valid", "octave", "scale_level"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    v = want.valid
    assert int(v.sum()) > 10, "degenerate fixture"
    scale = _octave_units(want)[v]
    for field in ("abs_y", "abs_x"):
        delta = (getattr(got, field)[v].double() - getattr(want, field)[v].double()).abs()
        assert float((delta / scale).max()) <= POS_ATOL, field
    d_got, d_want = got.descriptor[v].double(), want.descriptor[v].double()
    cosine = (d_got * d_want).sum(-1) / (d_got.norm(dim=-1) * d_want.norm(dim=-1))
    assert float(cosine.min()) >= MIN_COSINE


# --- every strategy, every entry point ---------------------------------------


def _jax_entry_points(images, blur):
    """The JAX package's four frontend entry points in one compiled
    program; ``blur=None`` is its call with no ``blur`` (its default)."""
    kw = {} if blur is None else dict(blur=blur)

    def run(x):
        return (
            jfront.detect_batched(x, JCFG, **kw),
            jfront.detect(x[1], JCFG, **kw),
            jfront.detect_and_describe_batched(x, JCFG, **kw),
            jfront.detect_and_describe(x[1], JCFG, **kw),
        )

    return jax.jit(run)(jnp.asarray(images))


def _first(result):
    return type(result)(**{k: v[None] for k, v in vars(result).items()})


def _check_entry_points(images, want, blur):
    """The port's four entry points with ``blur`` against the JAX results."""
    (wk, we), (wk1, we1), wd, wd1 = want
    x = torch.from_numpy(images)
    kp, ex = port.detect_batched(x, PCFG, blur, **CPU)
    assert_keypoints_equal(kp, keypoints_to_port(wk))
    assert_extrema_equal(ex, we)
    # The per-trio layout: segment t of octave o holds keypoints_per_trio(o) slots.
    assert [e.capacity for e in ex] == [
        PCFG.keypoints_per_trio(o) * PCFG.trios_per_octave for o in range(PCFG.num_octaves)
    ]
    kp1, ex1 = port.detect(x[1], PCFG, blur, **CPU)
    assert_keypoints_equal(_first(kp1), _first(keypoints_to_port(wk1)))
    assert_extrema_equal([_first(e) for e in ex1],
                         [jax.tree.map(lambda a: a[None], e) for e in we1])
    assert_described_equal(port.detect_and_describe_batched(x, PCFG, blur, **CPU), wd)
    assert_described_equal(
        _first(port.detect_and_describe(x[1], PCFG, blur, **CPU)),
        jax.tree.map(lambda a: a[None], wd1),
    )


def test_jax_pallas_blur_is_its_separable_blur_off_the_tpu():
    x = jnp.asarray(np.random.default_rng(0).random((2, 32, 48)).astype(np.float32))
    for sigma in (0.75, 1.6, 4.0):
        assert jnp.array_equal(jblur.blur_pallas(x, sigma), jgauss.blur_separable(x, sigma))


def test_separable_pallas_and_cuda_match_the_jax_default_call():
    """The JAX package's call with no ``blur`` (its ``"separable"``) against
    the port's ``blur="separable"``, and the blur kernel's names, which run
    the same tap loop on the CPU."""
    images = _images()
    want = _jax_entry_points(images, None)
    for blur in ("separable", "pallas", "cuda"):
        _check_entry_points(images, want, blur)


@pytest.mark.parametrize("blur", ["matmul", "exact"])
def test_entry_points_match_jax(blur):
    images = _images(np.float64 if blur == "exact" else np.float32)
    _check_entry_points(images, _jax_entry_points(images, blur), blur)
    if blur == "exact":
        assert port.detect_batched(torch.from_numpy(images), PCFG, blur, **CPU)[0].abs_x.dtype \
            == torch.float64


def test_fused_default_is_unchanged_and_differs_from_the_per_trio_cap():
    """No ``blur`` is the fused path; capped per octave, its slots are not
    the per-trio path's once a trio saturates."""
    x = torch.from_numpy(_images())
    cfg = dataclasses.replace(PCFG, max_keypoints_per_trio=4, min_keypoints_per_trio=4)
    default, _ = port.detect_batched(x, cfg, **CPU)
    fused, _ = port.detect_batched(x, cfg, "fused", **CPU)
    trio, ex = port.detect_batched(x, cfg, "separable", **CPU)
    for field in INT_FIELDS + ("abs_x", "abs_y"):
        assert torch.equal(getattr(default, field), getattr(fused, field)), field
    assert max(int(e.num_candidates.max()) for e in ex) > 4  # a trio overflows its cap
    assert not torch.equal(fused.valid, trio.valid)


def test_blur_names_are_checked():
    x = torch.from_numpy(_images())
    for call in (port.detect_batched, port.detect_and_describe_batched):
        with pytest.raises(ValueError, match="unknown blur"):
            call(x, PCFG, "box", **CPU)
        for blur in ("cuda", "pallas"):
            with pytest.raises(ValueError, match="float64"):
                call(x.double(), PCFG, blur, **CPU)
    with pytest.raises(ValueError, match="unknown blur"):
        port.detect(x[0], PCFG, "gaussian", **CPU)


# --- the pooled refinement -----------------------------------------------------

POOL_CFG = JaxConfig(num_octaves=3, max_keypoints_per_trio=256)
FLAGS = ("unified_refine", "refine_tail_pool")


def _noise_dogs():
    """DoG stacks of white noise, 2 images × 5 planes at 64×96, 32×48 and
    16×24: every octave holds more candidates than its capacity, so both
    pools and their ladders overflow."""
    rng = np.random.default_rng(3)
    return [(0.03 * rng.standard_normal((2, 5, h, w))).astype(np.float32)
            for h, w in ((64, 96), (32, 48), (16, 24))]


def _jax_detect_from_dog(dogs, cfg, masks=None):
    n = len(dogs)
    arrays = [jnp.asarray(a) for a in dogs + (masks or [])]

    def one(*a):
        return jfront.detect_from_dog(list(a[:n]), cfg, list(a[n:]) if masks else None)

    keypoints, _ = jax.jit(jax.vmap(one))(*arrays)
    return keypoints_to_port(keypoints)


@pytest.mark.parametrize("route", ["per_trio", "masks"])
def test_pooled_refinement_matches_jax_where_it_overflows(route):
    """Fails on a port that ignores the flags: the JAX package's pooled
    results differ from its per-octave result here, and the port's equal
    them."""
    dogs = _noise_dogs()
    masks = port_masks = None
    if route == "masks":  # the fused path's selection, from packed trio codes
        thr = exact_scalar(POOL_CFG.contrast_prefilter_threshold, torch.float32)
        port_masks = [pack_extrema_codes(torch.from_numpy(d), thr) for d in dogs]
        masks = [m.numpy() for m in port_masks]
    per_octave = _jax_detect_from_dog(dogs, POOL_CFG, masks)
    for flag in FLAGS:
        flagged = dataclasses.replace(POOL_CFG, **{flag: True})
        want = _jax_detect_from_dog(dogs, flagged, masks)
        assert not torch.equal(want.reject_reason, per_octave.reject_reason), flag
        pcfg = port.from_reference_config(flagged)
        got, _ = port.detect_from_dog([torch.from_numpy(d) for d in dogs], pcfg, port_masks)
        assert_keypoints_equal(got, want, pos_atol=1e-5)
        # detect_octaves slices the pool back at each octave's capacity.
        parts, _ = pfront.detect_octaves([torch.from_numpy(d) for d in dogs], pcfg, port_masks)
        assert [p.capacity for p in parts] == [POOL_CFG.refine_capacity(o) for o in range(3)]
        assert all(bool((p.octave == o).all()) for o, p in enumerate(parts))


def test_unified_refine_through_the_fused_pyramid_matches_jax():
    """Frames whose octave 0 saturates, through the JAX package's fused
    pyramid (the Pallas kernel in interpret mode) and the port's fused
    path, with a pool of 40 % of the slots: octave 0 alone overflows it."""
    rng = np.random.default_rng(1)
    images = np.clip(textured_images(0, 2, 96, 128) + 0.08 * rng.standard_normal((2, 96, 128)),
                     0, 1).astype(np.float32)
    cfg = JaxConfig(num_octaves=3, max_keypoints_per_trio=256, refine_pool_compaction=0.4)
    _, dogs, masks = jfront.build_pyramid_fused(
        jnp.asarray(images), cfg, emit_scales=False, emit_masks=True, interpret=True
    )
    dogs, masks = [np.asarray(d) for d in dogs], [np.asarray(m) for m in masks]
    flagged = dataclasses.replace(cfg, unified_refine=True)
    per_octave = _jax_detect_from_dog(dogs, cfg, masks)
    want = _jax_detect_from_dog(dogs, flagged, masks)
    assert not torch.equal(want.reject_reason, per_octave.reject_reason)
    got, _ = port.detect_batched(torch.from_numpy(images), port.from_reference_config(flagged),
                                 **CPU)
    assert_keypoints_equal(got, want)


@pytest.mark.parametrize("flag", FLAGS)
def test_pooled_refinement_without_overflow_is_the_per_octave_result(flag):
    x = torch.from_numpy(_images())
    cfg = dataclasses.replace(PCFG, num_octaves=3)
    for blur in ("fused", "separable"):
        want, _ = port.detect_batched(x, cfg, blur, **CPU)
        got, _ = port.detect_batched(x, dataclasses.replace(cfg, **{flag: True}), blur, **CPU)
        for field in dataclasses.fields(want):
            assert torch.equal(getattr(got, field.name), getattr(want, field.name)), field.name


@pytest.mark.parametrize("flag", FLAGS)
def test_the_describe_path_refines_per_octave_whatever_the_flags(flag):
    """As the JAX package's describe paths do (``models/frontend.py:373-378``,
    ``:419-424``): the flags change detection on these frames and leave the
    described keypoints as they are."""
    dogs = [torch.from_numpy(d) for d in _noise_dogs()]
    cfg = port.from_reference_config(POOL_CFG)
    flagged = dataclasses.replace(cfg, **{flag: True})
    assert not torch.equal(port.detect_from_dog(dogs, cfg)[0].reject_reason,
                           port.detect_from_dog(dogs, flagged)[0].reject_reason)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(np.clip(textured_images(0, 2, 96, 128)
                                 + 0.08 * rng.standard_normal((2, 96, 128)), 0, 1)
                         .astype(np.float32))
    cfg = dataclasses.replace(cfg, refine_pool_compaction=0.4)
    flagged = dataclasses.replace(cfg, **{flag: True})
    for blur in ("fused", "separable"):
        want = port.detect_and_describe_batched(x, cfg, blur, **CPU)
        got = port.detect_and_describe_batched(x, flagged, blur, **CPU)
        for field in dataclasses.fields(want):
            assert torch.equal(getattr(got, field.name), getattr(want, field.name)), field.name


def test_pooled_refinement_reruns_bit_equal_and_drops_nothing():
    """The pool's write-back keeps every slot its own: a rerun is bit-equal,
    and every candidate slot the per-octave path refines is present."""
    dogs = [torch.from_numpy(d) for d in _noise_dogs()]
    cfg = dataclasses.replace(port.from_reference_config(POOL_CFG), unified_refine=True)
    a, _ = port.detect_from_dog(dogs, cfg)
    b, _ = port.detect_from_dog(dogs, cfg)
    per_octave, _ = port.detect_from_dog(dogs, port.from_reference_config(POOL_CFG))
    for field in dataclasses.fields(a):
        assert torch.equal(getattr(a, field.name), getattr(b, field.name)), field.name
    assert torch.equal(a.reject_reason >= 0, per_octave.reject_reason >= 0)


# --- SLAM, streaming and the surfaces on the per-trio path ---------------------


@pytest.fixture(scope="module")
def _no_persistent_jax_cache():
    """The JAX SLAM compiles with JAX's persistent cache off: loading a
    cached SLAM executable can crash XLA:CPU (``ROADMAP.md`` §3)."""
    before = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", before)


SLAM_SIFT = dict(num_octaves=2, max_keypoints_per_trio=256)


def test_build_tracks_from_images_matches_the_jax_default(monkeypatch, _no_persistent_jax_cache):
    """The JAX package's ``build_tracks_from_images`` with its own frontend
    and default ``blur`` against the port's with ``blur="separable"``, the
    port drawing the JAX package's RANSAC samples: the same track table.
    (With seed 0, two candidates of frame 0 sit on a near-tie of the two
    packages' float32 DoGs, which moves two tracks; seeds 1 to 4 have none.)"""
    images, _, _, k_mat = render_sequence(np.random.default_rng(1), num_frames=6)
    want = jslam.build_tracks_from_images(images, JaxConfig(**SLAM_SIFT), k_mat=k_mat,
                                          reassoc_window=2)
    monkeypatch.setattr(pslam, "_pair_draws", jax_ransac_draws)
    got = port.build_tracks_from_images(images, port.SiftConfig(**SLAM_SIFT), k_mat=k_mat,
                                        reassoc_window=2, blur="separable", **CPU)
    np.testing.assert_array_equal(got[1], want[1])  # visible
    assert got[1].sum() > 100
    # Pixel positions: refined coordinates, within POS_ATOL of octave 1's pixel.
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=POS_ATOL)
    np.testing.assert_array_equal(got[2], want[2])  # keypoints per frame


def test_slam_session_on_the_per_trio_path_is_the_batch_run(monkeypatch):
    """``blur`` reaches the frontend of the batch run and of every streaming
    step (each blurs through ``BLUR_STRATEGIES``), and streaming gives the
    batch run's bits."""
    blurs = []

    def counting(image, sigma):
        blurs.append(sigma)
        return pgauss.blur_separable(image, sigma)

    monkeypatch.setitem(pfront.BLUR_STRATEGIES, "separable", counting)
    images, _, _, k_mat = render_sequence(np.random.default_rng(12), num_frames=7)
    sift = port.SiftConfig(**SLAM_SIFT)
    slam_cfg = port.SlamConfig(ba_interval=3, ba_window=6, bootstrap_baseline=2)
    batch = port.run_slam_from_images(images, k_mat, sift, slam_cfg, reassoc_window=2,
                                      blur="separable", **CPU)
    per_chunk = sift.scales_per_octave_total * sift.num_octaves - (sift.num_octaves - 1)
    assert len(blurs) == per_chunk  # one chunk of 7 frames
    sess = port.SlamSession(k_mat, sift, slam_cfg, blur="separable", reassoc_window=2, **CPU)
    for image in images:
        sess.add_frame(image)
    result = sess.finalize()
    assert len(blurs) == 3 * per_chunk  # and the session's two steps
    np.testing.assert_array_equal(result.rotations, batch.rotations)
    np.testing.assert_array_equal(result.translations, batch.translations)
    np.testing.assert_array_equal(result.points, batch.points)
