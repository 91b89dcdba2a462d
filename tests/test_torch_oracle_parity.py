"""The port's float64 oracle leg: ``blur="exact"`` scale space, DoG, the
mask-free extrema scan and refinement, against the reference oracle and
the JAX package's float64 path, on the CPU.

Scale space and DoG are compared bit for bit; refined keypoints match
exactly on integer identity and to 1e-10 on float attributes (the oracle's
decision margins are far larger, ``tests/test_pipeline_parity.py``). The
port's copy of the oracle is pinned to the original, function by function,
bit for bit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sift_scale_space_extrema_detection_tpu import SiftConfig as JaxConfig
from sift_scale_space_extrema_detection_tpu.models import frontend as jfrontend
from sift_scale_space_extrema_detection_tpu.ops import extrema as jextrema
from sift_scale_space_extrema_detection_tpu.ops import gaussian as jgauss
from sift_scale_space_extrema_detection_tpu.utils import oracle as joracle
import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.core.types import (
    REJECT_REASON_NAMES,
    Extrema,
)
from sift_scale_space_extrema_detection_tpu_torch.ops import extrema as pextrema
from sift_scale_space_extrema_detection_tpu_torch.ops import gaussian as pgauss
from sift_scale_space_extrema_detection_tpu_torch.utils import oracle as poracle

from tests.torch_port_helpers import _to_port, keypoints_to_port

torch.set_num_threads(2)

CFG = port.SiftConfig()
SIGMAS = [0.7, 0.9375, 1.2263, 2.0, 3.2, 7.5]


# --- the copy of the oracle is the original ------------------------------------


def _deep_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_deep_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_deep_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def _small_image(seed=3, h=14, w=18):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 0.5 + 0.2 * np.sin(xx / 2.0) * np.cos(yy / 3.0) + 0.1 * rng.standard_normal((h, w))
    return np.round(np.clip(img, 0.0, 1.0) * 255.0) / 255.0


def test_oracle_copy_exports_the_originals_names():
    public = lambda m: sorted(n for n in vars(m) if not n.startswith("__"))  # noqa: E731
    assert public(poracle) == public(joracle)
    assert poracle.JS_EPSILON == joracle.JS_EPSILON


@pytest.mark.parametrize("sigma", SIGMAS)
def test_oracle_copy_kernel_and_blur_bit_equal(sigma):
    image = _small_image()
    assert _deep_equal(poracle.gaussian_kernel(sigma), joracle.gaussian_kernel(sigma))
    assert _deep_equal(poracle.blur(image, sigma), joracle.blur(image, sigma))
    assert poracle.js_round(3 * sigma) == joracle.js_round(3 * sigma)


@pytest.mark.parametrize("rate", [0.5, 2.0, 1.5])
def test_oracle_copy_resize_bit_equal(rate):
    image = _small_image()
    assert _deep_equal(poracle.linear_resize(image, rate), joracle.linear_resize(image, rate))


def test_oracle_copy_pipeline_bit_equal():
    # Every stage function, through the whole pipeline and one by one.
    image = _small_image()
    got = poracle.detect(image, number_of_octaves=2)
    want = joracle.detect(image, number_of_octaves=2)
    assert _deep_equal(got, want)
    assert sum(len(t["localExtremas"]) for o in want["candidateKeypoints"] for t in o) > 3
    space = joracle.compute_scale_space(image, 2)
    assert _deep_equal(poracle.compute_scale_space(image, 2), space)
    dog = joracle.compute_difference_of_gaussians(space)
    assert _deep_equal(poracle.compute_difference_of_gaussians(space), dog)
    trio = [d["image"] for d in dog[0][:3]]
    assert _deep_equal(poracle.find_extremas(trio, 3), joracle.find_extremas(trio, 3))
    candidates = joracle.find_candidate_keypoints(dog, 3)
    assert _deep_equal(poracle.find_candidate_keypoints(dog, 3), candidates)
    assert _deep_equal(
        poracle.refine_candidate_keypoints(dog, candidates, number_of_octaves=2),
        joracle.refine_candidate_keypoints(dog, candidates, number_of_octaves=2),
    )
    planes = [d["image"] for d in dog[0]]
    for fn in ("_gradient", "_hessian"):
        assert _deep_equal(getattr(poracle, fn)(planes, 2, 5, 7), getattr(joracle, fn)(planes, 2, 5, 7))
    hess = joracle._hessian(planes, 2, 5, 7)
    assert _deep_equal(poracle._inverse3x3(hess), joracle._inverse3x3(hess))
    assert poracle._inverse3x3([[0.0] * 3] * 3) is None
    assert poracle._det2(1.5, 2.0, 3.0, 4.5) == joracle._det2(1.5, 2.0, 3.0, 4.5)
    assert poracle._minor(hess, 1, 2) == joracle._minor(hess, 1, 2)


# --- the exact blur --------------------------------------------------------------


@pytest.mark.parametrize("sigma", SIGMAS)
def test_kernel_matches_oracle_and_jax_bitwise(sigma):
    ours = pgauss.gaussian_kernel_2d(sigma)
    np.testing.assert_array_equal(ours, poracle.gaussian_kernel(sigma))
    np.testing.assert_array_equal(ours, jgauss.gaussian_kernel_2d(sigma))


@pytest.mark.parametrize("sigma", SIGMAS)
def test_kernel_properties(sigma):
    k = pgauss.gaussian_kernel_2d(sigma)
    assert k.shape[0] == 2 * pgauss.js_round(3 * sigma) + 1
    assert abs(k.sum() - 1.0) < 1e-12
    np.testing.assert_array_equal(k, k.T)
    k1 = pgauss.gaussian_kernel_1d(sigma)
    np.testing.assert_allclose(np.outer(k1, k1), k, rtol=1e-13, atol=1e-300)


@pytest.mark.parametrize("sigma", [0.7, 1.2263, 3.2])
def test_blur_exact_matches_oracle_and_jax_bitwise(test_image, sigma):
    ours = pgauss.blur_exact(torch.from_numpy(test_image), sigma).numpy()
    np.testing.assert_array_equal(ours, poracle.blur(test_image, sigma))
    np.testing.assert_array_equal(
        ours, np.asarray(jgauss.blur_exact(jnp.asarray(test_image), sigma))
    )


def test_blur_exact_batch_dims(test_image):
    x = torch.from_numpy(np.stack([test_image] * 3))[None]
    out = pgauss.blur_exact(x, 1.5)
    assert out.shape == x.shape and out.dtype == torch.float64
    assert torch.equal(out[0, 0], out[0, 2])
    np.testing.assert_array_equal(out[0, 1].numpy(), poracle.blur(test_image, 1.5))


def test_blur_exact_sigma_larger_than_image(test_image):
    """Octave-4 regime: the kernel radius exceeds the image; clamp borders."""
    small = np.ascontiguousarray(test_image[:6, :8])
    sigma = 12.8 * np.sqrt(2 ** (10 / 3) - 1)  # octave 4, scale 5 regime
    ours = pgauss.blur_exact(torch.from_numpy(small), sigma).numpy()
    np.testing.assert_array_equal(ours, poracle.blur(small, sigma))


def test_blur_exact_rounds_twice_per_tap():
    # A fused multiply-add would round once; on this image that differs.
    image = torch.from_numpy(_small_image(5, 24, 24))
    fused = None
    kernel = pgauss.gaussian_kernel_2d(1.2263)
    r = (kernel.shape[0] - 1) // 2
    padded = torch.from_numpy(np.pad(image.numpy(), r, mode="edge"))
    for i in range(kernel.shape[0]):
        for j in range(kernel.shape[1]):
            tap = padded[j : j + 24, i : i + 24]
            fused = tap * float(kernel[i, j]) if fused is None else torch.addcmul(
                fused, tap, torch.tensor(float(kernel[i, j]), dtype=torch.float64)
            )
    exact = pgauss.blur_exact(image, 1.2263)
    np.testing.assert_array_equal(exact.numpy(), poracle.blur(image.numpy(), 1.2263))
    assert not torch.equal(fused, exact)


# --- the float64 pipeline --------------------------------------------------------


@pytest.fixture(scope="module")
def port_scale_space(test_image):
    return port.build_scale_space(torch.from_numpy(test_image)[None], CFG, blur="exact", device="cpu")


@pytest.fixture(scope="module")
def port_dog(port_scale_space):
    return port.build_dog(port_scale_space)


@pytest.fixture(scope="module")
def port_detection(port_dog):
    return port.detect_from_dog(port_dog, CFG)


@pytest.fixture(scope="module")
def jax_dog(test_image):
    return jfrontend.build_dog(
        jfrontend.build_scale_space(jnp.asarray(test_image), JaxConfig(), blur="exact")
    )


def test_scale_space_bit_parity(port_scale_space, oracle_result):
    assert len(port_scale_space) == CFG.num_octaves
    h, w = 96, 128
    for o, octave in enumerate(port_scale_space):
        assert octave.shape == (1, CFG.scales_per_octave_total, h, w)
        assert octave.dtype == torch.float64
        h, w = -(-h // 2), -(-w // 2)
        for s in range(CFG.scales_per_octave_total):
            np.testing.assert_array_equal(
                octave[0, s].numpy(), oracle_result["scaleSpace"][o][s]["image"],
                err_msg=f"octave {o} scale {s}",
            )


def test_dog_bit_parity_with_oracle_and_jax(port_dog, jax_dog, oracle_result):
    for o, octave in enumerate(port_dog):
        assert octave.shape[1] == CFG.dog_per_octave
        np.testing.assert_array_equal(octave[0].numpy(), np.asarray(jax_dog[o]))
        for s in range(CFG.dog_per_octave):
            np.testing.assert_array_equal(
                octave[0, s].numpy(), oracle_result["differenceOfGaussians"][o][s]["image"],
                err_msg=f"octave {o} dog {s}",
            )


def test_extrema_parity(port_detection, oracle_result):
    _, extrema = port_detection
    total_ref = total_ours = 0
    cap = CFG.max_keypoints_per_trio
    for o, e in enumerate(extrema):
        for trio in range(CFG.trios_per_octave):
            ref_trio = oracle_result["candidateKeypoints"][o][trio]
            ref = ref_trio["localExtremas"]
            assert int(e.num_candidates[0, trio]) == len(ref)
            assert int(e.num_low_contrast[0, trio]) == ref_trio["lowContrastCount"]
            seg = slice(trio * CFG.keypoints_per_trio(o), (trio + 1) * CFG.keypoints_per_trio(o))
            valid = e.valid[0, seg].numpy()
            assert valid.sum() == len(ref) <= cap, "capacity overflow in the test image"
            assert e.y[0, seg].numpy()[valid].tolist() == [k["y"] for k in ref]
            assert e.x[0, seg].numpy()[valid].tolist() == [k["x"] for k in ref]
            assert e.value[0, seg].numpy()[valid].tolist() == [k["value"] for k in ref]
            assert bool((e.scale_level[0, seg] == trio + 1).all())
            total_ref += len(ref)
        total_ours += int(e.valid.sum())
    assert total_ours == total_ref > 20


def test_refined_keypoints_parity(port_detection, oracle_result):
    keypoints, _ = port_detection
    ref_kps = oracle_result["refinedKeypoints"]
    assert len(ref_kps) > 5
    ids = np.nonzero(keypoints.valid[0].numpy())[0]
    ours = {
        (int(keypoints.octave[0, i]), int(keypoints.scale_level[0, i]),
         int(keypoints.local_y[0, i]), int(keypoints.local_x[0, i])): i
        for i in ids
    }
    assert len(ours) == len(ids)  # no duplicate identities
    key = lambda kp: (kp["octave"], kp["scaleLevel"], kp["localY"], kp["localX"])  # noqa: E731
    assert sorted(ours) == sorted(key(kp) for kp in ref_kps)
    for kp in ref_kps:
        i = ours[key(kp)]
        for field, name, tol in (
            ("abs_x", "absoluteX", dict(rtol=0, atol=1e-10)),
            ("abs_y", "absoluteY", dict(rtol=0, atol=1e-10)),
            ("abs_sigma", "absoluteSigma", dict(rtol=1e-10)),
            ("value", "interpolatedValue", dict(rtol=0, atol=1e-10)),
        ):
            np.testing.assert_allclose(float(getattr(keypoints, field)[0, i]), kp[name], **tol)


def test_rejection_taxonomy_parity(port_detection, oracle_result):
    counts = port_detection[0].reject_counts()[0].tolist()
    assert counts == [oracle_result["rejectionCounts"][name] for name in REJECT_REASON_NAMES]


def test_low_contrast_positions_parity(port_dog, oracle_result):
    """The low-contrast pre-filter rejects match the reference's records
    one to one: positions, values, row-major order."""
    total = 0
    cap = CFG.max_keypoints_per_trio
    for o, d in enumerate(port_dog):
        low = pextrema.find_low_contrast_extrema(d, CFG)
        for trio in range(CFG.trios_per_octave):
            ref = oracle_result["candidateKeypoints"][o][trio]["lowContrastKeypoints"]
            seg = slice(trio * cap, (trio + 1) * cap)
            valid = low.valid[0, seg].numpy()
            assert valid.sum() == len(ref)
            assert int(low.num_candidates[0, trio]) == int(low.num_low_contrast[0, trio]) == len(ref)
            assert low.y[0, seg].numpy()[valid].tolist() == [k["y"] for k in ref]
            assert low.x[0, seg].numpy()[valid].tolist() == [k["x"] for k in ref]
            assert low.value[0, seg].numpy()[valid].tolist() == [k["value"] for k in ref]
            total += len(ref)
    assert total > 5


def test_per_keypoint_decision_parity(port_detection, oracle_result):
    """Every candidate's accept/reject fate matches the oracle's decision
    log one to one, in the reference's iteration order."""
    keypoints, extrema = port_detection
    by_octave = {}
    for d in oracle_result["decisions"]:
        by_octave.setdefault(d["octave"], []).append(d)
    offset = checked = 0
    for octave, e in enumerate(extrema):
        cap = CFG.refine_capacity(octave)
        sel = pextrema.compact_extrema(e, cap)
        refs = by_octave.get(octave, [])
        valid = sel.valid[0].numpy()
        assert valid.sum() == len(refs)
        reasons = keypoints.reject_reason[0, offset : offset + cap].numpy()[valid]
        got = list(zip(
            sel.scale_level[0].numpy()[valid].tolist(), sel.y[0].numpy()[valid].tolist(),
            sel.x[0].numpy()[valid].tolist(), [REJECT_REASON_NAMES[r] for r in reasons],
        ))
        assert got == [(r["scaleLevel"], r["y"], r["x"], r["reason"]) for r in refs]
        checked += len(refs)
        offset += cap
    assert checked == len(oracle_result["decisions"]) > 20


def test_detection_matches_jax_float64(port_detection, jax_dog):
    # Compiled: eagerly the JAX path dispatches its ops one by one.
    jkp, jex = jax.jit(lambda dog: jfrontend.detect_from_dog(dog, JaxConfig()))(jax_dog)
    keypoints, extrema = port_detection
    want = keypoints_to_port(jkp)
    for field in ("octave", "scale_level", "local_y", "local_x", "valid", "reject_reason"):
        assert torch.equal(getattr(keypoints, field)[0], getattr(want, field)), field
    v = want.valid
    for field in ("abs_y", "abs_x", "abs_sigma", "value"):
        got = getattr(keypoints, field)[0]
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got[v].numpy(), getattr(want, field)[v].numpy(), rtol=1e-10, atol=1e-10)
    for e, je in zip(extrema, jex):
        w = _to_port(Extrema, je)
        for field in ("y", "x", "scale_level", "value", "valid", "num_candidates", "num_low_contrast"):
            assert torch.equal(getattr(e, field)[0], getattr(w, field)), field


# --- the per-trio buffers against JAX, and selection from packed planes ---------------


def _random_packed(rng, b, h, w, t):
    codes = rng.integers(0, 3, size=(b, t, h, w))
    codes[:, :, [0, -1], :] = 0  # the kernel zeroes the border
    codes[:, :, :, [0, -1]] = 0
    packed = np.zeros((b, h, w), np.int32)
    for i in range(t):
        packed |= codes[:, i].astype(np.int32) << (2 * i)
    return codes, packed


@pytest.mark.parametrize("fn", ["find_extrema", "find_low_contrast_extrema"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_scan_buffers_match_jax(fn, dtype):
    rng = np.random.default_rng(17)
    dog = (0.006 * rng.standard_normal((2, CFG.dog_per_octave, 20, 28))).astype(dtype)
    got = getattr(pextrema, fn)(torch.from_numpy(dog), CFG, 48)
    for b in range(2):
        want = _to_port(Extrema, getattr(jextrema, fn)(jnp.asarray(dog[b]), JaxConfig(), 48))
        assert int(want.valid.sum()) > 5
        for field in ("y", "x", "scale_level", "value", "valid", "num_candidates", "num_low_contrast"):
            assert torch.equal(getattr(got, field)[b], getattr(want, field)), field
    assert got.value.dtype == torch.from_numpy(dog).dtype


@pytest.mark.parametrize("capacity", [16, 64])
def test_buffers_from_masks_and_compaction_match_jax(capacity):
    rng = np.random.default_rng(capacity)
    t = CFG.dog_per_octave - 2
    _, packed = _random_packed(rng, 2, 12, 16, t)
    packed = packed * (rng.random(packed.shape) < 0.15)  # sparse candidates
    dog = rng.standard_normal((2, CFG.dog_per_octave, 12, 16))
    got = pextrema.find_extrema_from_masks(torch.from_numpy(packed), torch.from_numpy(dog), CFG, capacity)
    squeezed = pextrema.compact_extrema(got, 24)
    assert pextrema.compact_extrema(got, got.capacity) is got
    for b in range(2):
        jgot = jextrema.find_extrema_from_masks(jnp.asarray(packed[b]), jnp.asarray(dog[b]), JaxConfig(), capacity)
        for ours, theirs in ((got, jgot), (squeezed, jextrema.compact_extrema(jgot, 24))):
            want = _to_port(Extrema, theirs)
            for field in ("y", "x", "scale_level", "value", "valid", "num_candidates", "num_low_contrast"):
                assert torch.equal(getattr(ours, field)[b], getattr(want, field)), field


def test_scan_and_masks_routes_give_the_same_buffers():
    rng = np.random.default_rng(23)
    dog = torch.from_numpy((0.02 * rng.standard_normal((2, CFG.dog_per_octave, 18, 22))).astype(np.float32))
    thr = float(np.float32(CFG.contrast_prefilter_threshold))
    scanned = pextrema.find_extrema(dog, CFG, 32)
    from_masks = pextrema.find_extrema_from_masks(pextrema.pack_extrema_codes(dog, thr), dog, CFG, 32)
    for field in ("y", "x", "scale_level", "value", "valid", "num_candidates", "num_low_contrast"):
        assert torch.equal(getattr(scanned, field), getattr(from_masks, field)), field


@pytest.mark.parametrize(
    "h,w,t,cap",
    [
        (8, 16, 3, 16),  # overflow: far more candidates than capacity
        (16, 128, 5, 64),  # the main path's trio count
        (32, 256, 2, 8),  # tiny capacity
        (8, 16, 1, 512),  # underflow: capacity > candidates
        (9, 13, 3, 32),  # a plane that is no multiple of 128
    ],
)
def test_cross_trio_selection_matches_a_plain_scan(h, w, t, cap):
    rng = np.random.default_rng(h * w + t)
    codes, packed = _random_packed(rng, 2, h, w, t)
    cfg = port.SiftConfig(scales_per_octave=t)
    dog = torch.from_numpy(rng.standard_normal((2, t + 2, h, w)))
    got = pextrema.select_refine_candidates(torch.from_numpy(packed), dog, cfg, cap)
    for b in range(2):
        where = np.argwhere(codes[b] == 1)[:cap]  # (trio, y, x), trio-major, row-major
        n = len(where)
        assert got.valid[b].tolist() == [True] * n + [False] * (cap - n)
        assert got.scale_level[b, :n].tolist() == (where[:, 0] + 1).tolist()
        assert got.y[b, :n].tolist() == where[:, 1].tolist()
        assert got.x[b, :n].tolist() == where[:, 2].tolist()
        np.testing.assert_array_equal(got.num_candidates[b].numpy(), (codes[b] == 1).sum(axis=(1, 2)))
        np.testing.assert_array_equal(got.num_low_contrast[b].numpy(), (codes[b] == 2).sum(axis=(1, 2)))


def test_selection_zero_candidates():
    cfg = port.SiftConfig(scales_per_octave=3)
    packed = torch.zeros((1, 16, 128), dtype=torch.int32)
    dog = torch.zeros((1, 5, 16, 128), dtype=torch.float64)
    for e in (
        pextrema.select_refine_candidates(packed, dog, cfg, 32),
        pextrema.find_extrema_from_masks(packed, dog, cfg, 32),
        pextrema.find_extrema(dog, cfg, 32),
    ):
        assert int(e.valid.sum()) == 0
        assert int(e.num_candidates.sum()) == 0 and int(e.num_low_contrast.sum()) == 0
        assert bool((e.y == 1).all() & (e.x == 1).all() & (e.scale_level >= 1).all())
