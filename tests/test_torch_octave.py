"""The fused octave's plain PyTorch version against the JAX Pallas kernel.

The JAX side runs ``ops/pallas/octave.py::fused_octave`` in interpret mode
(as ``tests/test_pallas_octave.py`` does) with the plane-major DoG
(``flat_detect=False``); the port's side is ``fused_octave_reference``,
which the port's CUDA kernel matches bit for bit on the card. Inputs are
made with numpy from a seed and handed to both packages.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sift_scale_space_extrema_detection_tpu.config import SiftConfig as JaxConfig
from sift_scale_space_extrema_detection_tpu.ops import dog as jdog
from sift_scale_space_extrema_detection_tpu.ops import gaussian as jgauss
from sift_scale_space_extrema_detection_tpu.ops import resize as jresize
from sift_scale_space_extrema_detection_tpu.ops.pallas.octave import (
    fused_octave as jax_fused_octave,
)
from sift_scale_space_extrema_detection_tpu_torch.ops import dog as pdog
from sift_scale_space_extrema_detection_tpu_torch.ops import gaussian as pgauss
from sift_scale_space_extrema_detection_tpu_torch.ops import resize as presize
from sift_scale_space_extrema_detection_tpu_torch.ops.extrema import (
    unpack_mask_codes,
)
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import launch_counts, launches_since
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import (
    fused_octave,
    fused_octave_reference,
)

torch.set_num_threads(2)

# float32 DoG and seed: the port rounds every product and sum on its own,
# while XLA:CPU may contract the JAX kernel's tap sums into FMAs, so the
# two differ by a few float32 ulps of values below 1.
DOG_ATOL = 2e-6

# (octave, base shape, upsample2x, scales_per_octave, blob sigma): the
# base is squared noise, or for the heavily blurred upper octaves random
# Gaussian blobs of about the octave's scale, so every case has candidates.
CASES = {
    # octave 0: the 2x upsample happens inside the kernel (48x64 plane).
    "octave0_upsample": (0, (2, 24, 32), True, 5, None),
    # octave >= 1: scale 0 is the unblurred base.
    "octave1_unblurred_base": (1, (2, 24, 32), False, 5, 3.0),
    # octave 2's largest radius (23) passes half the 24x32 plane.
    "radius_past_half_plane": (2, (2, 24, 32), False, 5, 6.0),
    # 9 trios: the packed plane widens to int32.
    "nine_trios_int32": (1, (1, 24, 32), False, 9, 3.0),
}


def _base(shape, seed, blob_sigma):
    rng = np.random.default_rng(seed)
    if blob_sigma is None:
        return (rng.random(shape) ** 2).astype(np.float32)
    b, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.full(shape, 0.5)
    for i in range(b):
        for _ in range(h * w // 60):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            s = blob_sigma * rng.uniform(0.7, 1.4)
            r2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s)
            out[i] += rng.uniform(-0.4, 0.4) * np.exp(-r2)
    return out.astype(np.float32)


def _sigmas(cfg, octave):
    return [
        None if (octave > 0 and s == 0) else cfg.offset_sigma(octave, s)
        for s in range(cfg.scales_per_octave_total)
    ]


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    octave, shape, up2, spo, blob_sigma = CASES[request.param]
    cfg = JaxConfig(scales_per_octave=spo)
    base = _base(shape, 3, blob_sigma)
    sigmas = _sigmas(cfg, octave)
    thr = cfg.contrast_prefilter_threshold
    _, dog, seed, masks = jax_fused_octave(
        jnp.asarray(base), sigmas, spo, emit_scales=False, emit_masks=True,
        contrast_thr=thr, interpret=True, upsample2x=up2,
    )
    ref = tuple(np.asarray(a) for a in (dog, seed, masks))
    return dict(base=base, sigmas=sigmas, spo=spo, thr=thr, up2=up2, jax=ref)


def test_fused_octave_reference_matches_jax_kernel(case):
    dog, seed, masks = fused_octave_reference(
        torch.from_numpy(case["base"]), case["sigmas"], case["spo"],
        case["thr"], upsample2x=case["up2"],
    )
    jdog_, jseed, jmasks = case["jax"]
    assert dog.shape == jdog_.shape and seed.shape == jseed.shape
    assert dog.dtype == seed.dtype == torch.float32
    np.testing.assert_allclose(dog.numpy(), jdog_, rtol=0, atol=DOG_ATOL)
    np.testing.assert_allclose(seed.numpy(), jseed, rtol=0, atol=DOG_ATOL)
    assert str(masks.dtype).split(".")[-1] == str(jmasks.dtype)
    n_trios = len(case["sigmas"]) - 3
    got = unpack_mask_codes(masks, n_trios).numpy()
    want = (jmasks.astype(np.int32)[:, None] >> (2 * np.arange(n_trios))[:, None, None]) & 3
    np.testing.assert_array_equal(got, want)
    assert (got == 1).any(), "case has no candidates to compare"


def test_fused_octave_wrapper_runs_plain_version_on_cpu(case):
    before = launch_counts()
    args = (torch.from_numpy(case["base"]), case["sigmas"], case["spo"], case["thr"])
    got = fused_octave(*args, upsample2x=case["up2"])
    want = fused_octave_reference(*args, upsample2x=case["up2"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert launches_since(before)["fused_octave"] == 0  # no kernel was launched


@pytest.mark.parametrize("sigma", [0.8, 2.0, 6.3])
def test_blur_separable_matches_jax(sigma):
    rng = np.random.default_rng(7)
    x = rng.random((2, 20, 28)).astype(np.float32)
    got = pgauss.blur_separable(torch.from_numpy(x), sigma).numpy()
    want = np.asarray(jgauss.blur_separable(jnp.asarray(x), sigma))
    # XLA's convolution sums the taps in its own order: float32 rounding.
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_resize_and_dog_equal_jax():
    rng = np.random.default_rng(8)
    x = rng.random((2, 3, 7, 9)).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        presize.upsample2x_nn(t).numpy(), np.asarray(jresize.upsample2x_nn(x))
    )
    np.testing.assert_array_equal(
        presize.downsample2x_nn(t).numpy(),
        np.asarray(jresize.downsample2x_nn(x)),
    )
    np.testing.assert_array_equal(
        pdog.difference_of_gaussians(t).numpy(),
        np.asarray(jdog.difference_of_gaussians(jnp.asarray(x))),
    )
