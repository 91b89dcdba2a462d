"""The stand-alone blur of the port against the JAX package.

The JAX side is ``ops/pallas/blur.py::blur_pallas`` in interpret mode (as
``tests/test_pallas_blur.py`` runs it) and the XLA ``blur_separable``; the
port's side is ``blur_fused``, which on the CPU runs its plain version
(``ops/gaussian.py::blur_separable``) and on the card a CUDA kernel that
matches it bit for bit. The scale space built blur by blur, and the fused
pyramid's Gaussian stacks, are held against the JAX ``build_scale_space``.
The same numpy arrays go into both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_scale_space_extrema_detection_tpu.config import SiftConfig as JaxConfig
from sift_scale_space_extrema_detection_tpu.models import frontend as jfront
from sift_scale_space_extrema_detection_tpu.ops import gaussian as jgauss
from sift_scale_space_extrema_detection_tpu.ops.pallas.blur import blur_pallas
import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.blur import blur_fused
from tests.torch_port_helpers import textured_images

torch.set_num_threads(2)

# Against the Pallas kernel: the JAX package's own bar for it.
PALLAS_ATOL = 1e-5
# Against the XLA blur: both sum float32 products of values below 1 in tap
# order; XLA:CPU may fuse a product into the sum, a few ulps of difference.
XLA_ATOL = 2e-6

# The three shapes of the JAX package's kernel tests: one stripe, several
# stripes with their halos, a height that no stripe height divides.
SHAPES = {
    "one_stripe": ((2, 40, 56), 1.6),
    "multiple_stripes": ((1, 300, 130), 2.0),
    "non_multiple_height": ((1, 275, 96), 1.4),
}


@pytest.mark.parametrize("name", SHAPES)
def test_blur_matches_pallas_kernel_and_xla_blur(name):
    shape, sigma = SHAPES[name]
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    before = blur_fused.launches
    got = blur_fused(torch.from_numpy(x), sigma).numpy()
    assert blur_fused.launches == before  # the plain version: no launch on the CPU
    pallas = np.asarray(blur_pallas(jnp.asarray(x), sigma, interpret=True))
    xla = np.asarray(jgauss.blur_separable(jnp.asarray(x), sigma))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=PALLAS_ATOL)
    np.testing.assert_allclose(got, xla, rtol=0, atol=XLA_ATOL)


def test_blur_takes_a_radius_past_the_plane():
    # The TPU kernel's size gate sends such a blur to XLA; the port has none.
    x = np.random.default_rng(1).random((2, 10, 14)).astype(np.float32)
    got = blur_fused(torch.from_numpy(x), 12.0).numpy()
    want = np.asarray(jgauss.blur_separable(jnp.asarray(x), 12.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=XLA_ATOL)


@pytest.fixture(scope="module")
def scale_spaces():
    images = textured_images(10, 2, 48, 64)
    cfg = JaxConfig(num_octaves=3, scales_per_octave=5)
    want = jfront.build_scale_space(jnp.asarray(images), cfg, "separable")
    return images, cfg, [np.array(w) for w in want]


@pytest.mark.parametrize("blur", sorted(port.BLUR_STRATEGIES))
def test_build_scale_space_matches_jax(scale_spaces, blur):
    images, cfg, want = scale_spaces
    got = port.build_scale_space(
        torch.from_numpy(images), port.from_reference_config(cfg), blur, device="cpu"
    )
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=XLA_ATOL)


def test_fused_pyramid_stacks_equal_the_scale_space(scale_spaces):
    images, cfg, want = scale_spaces
    pcfg = port.from_reference_config(cfg)
    dogs, masks, stacks = port.build_pyramid_fused(
        torch.from_numpy(images), pcfg, emit_scales=True, device="cpu"
    )
    blur_by_blur = port.build_scale_space(
        torch.from_numpy(images), pcfg, "cuda", device="cpu"
    )
    for s, d, b, w in zip(stacks, dogs, blur_by_blur, want):
        assert torch.equal(s, b)  # the same tap loop, the same seeds
        np.testing.assert_allclose(s.numpy(), w, rtol=0, atol=XLA_ATOL)
        assert torch.equal(d, port.build_dog([s])[0])
    # Asking for the stacks changes nothing else.
    plain_dogs, plain_masks = port.build_pyramid_fused(
        torch.from_numpy(images), pcfg, device="cpu"
    )
    assert all(torch.equal(a, b) for a, b in zip(dogs, plain_dogs))
    assert all(torch.equal(a, b) for a, b in zip(masks, plain_masks))


def test_build_dog_matches_jax(scale_spaces):
    _, _, want = scale_spaces
    got = port.build_dog([torch.from_numpy(w) for w in want])
    for g, w in zip(got, jfront.build_dog([jnp.asarray(w) for w in want])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
