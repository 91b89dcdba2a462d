"""The describe stages' primitives of the port against the JAX package:
scale-space gradients, bilinear sampling and first-k selection.

The same numpy arrays go into both; each function is a fixed sequence of
float32 operations with no sum of more than two products, so the results
are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_scale_space_extrema_detection_tpu.ops import extrema as jextrema
from sift_scale_space_extrema_detection_tpu.ops import sampling as jsampling
from sift_scale_space_extrema_detection_tpu_torch.ops.extrema import (
    first_k_set_indices,
)
from sift_scale_space_extrema_detection_tpu_torch.ops.sampling import (
    bilinear_sample,
    scale_space_gradients,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("shape", [(3, 9, 12), (2, 4, 3, 5), (2, 7)])
def test_scale_space_gradients_match_jax(shape):
    stack = np.random.default_rng(0).random(shape).astype(np.float32)
    want = jsampling.scale_space_gradients(jnp.asarray(stack))
    got = scale_space_gradients(torch.from_numpy(stack))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[0][..., 0, :].any() and not got[0][..., -1, :].any()
    assert not got[1][..., 0].any() and not got[1][..., -1].any()


def _positions(rng, n, h, w):
    """Positions inside, on, and well past every border of an h×w plane."""
    ys = rng.uniform(-3.0, h + 2.0, n).astype(np.float32)
    xs = rng.uniform(-3.0, w + 2.0, n).astype(np.float32)
    ys[:6] = [0.0, h - 1.0, -0.25, h - 0.5, 2.0, h - 1.0]
    xs[:6] = [0.0, w - 1.0, 1.5, 2.0, -7.0, w + 4.0]
    return ys, xs


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(1)
    h, w = 11, 14
    image = rng.random((h, w)).astype(np.float32)
    ys, xs = _positions(rng, 400, h, w)
    ys, xs = ys.reshape(20, 20), xs.reshape(20, 20)
    want = jsampling.bilinear_sample(jnp.asarray(image), jnp.asarray(ys), jnp.asarray(xs))
    got = bilinear_sample(
        torch.from_numpy(image), torch.from_numpy(ys), torch.from_numpy(xs)
    )
    # Called op by op (no jit), XLA:CPU rounds each product and sum alone.
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Clamped before the fractional part: past the border is the border value.
    assert got[0, 4] == image[2, 0] and got[0, 5] == image[h - 1, w - 1]
    assert got[0, 2] == 0.5 * image[0, 1] + 0.5 * image[0, 2]


def test_bilinear_sample_picks_each_samples_plane():
    rng = np.random.default_rng(2)
    p, h, w = 5, 8, 9
    stack = rng.random((p, h, w)).astype(np.float32)
    ys, xs = _positions(rng, 60, h, w)
    ys, xs = ys.reshape(6, 10), xs.reshape(6, 10)
    plane = rng.integers(0, p, (6, 1))
    got = bilinear_sample(
        torch.from_numpy(stack), torch.from_numpy(ys), torch.from_numpy(xs),
        torch.from_numpy(plane),
    )
    for i in range(6):
        one = bilinear_sample(
            torch.from_numpy(stack[plane[i, 0]]),
            torch.from_numpy(ys[i]), torch.from_numpy(xs[i]),
        )
        assert torch.equal(got[i], one)


@pytest.mark.parametrize(
    "n, density, capacity",
    [(1000, 0.3, 64), (1000, 0.01, 64), (257, 0.5, 300), (130, 0.0, 8)],
    ids=["more_bits_than_capacity", "fewer_bits", "capacity_past_length", "no_bit"],
)
def test_first_k_set_indices_matches_jax(n, density, capacity):
    rng = np.random.default_rng(3)
    mask = rng.random((3, n)) < density
    want = jax.vmap(lambda m: jextrema.first_k_set_indices(m, capacity))(
        jnp.asarray(mask)
    )
    got = first_k_set_indices(torch.from_numpy(mask), capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    idx, valid, total = got
    np.testing.assert_array_equal(total.numpy(), mask.sum(-1))
    assert not idx[~valid].any()  # invalid slots hold index 0
    for row in range(3):
        np.testing.assert_array_equal(
            idx[row][valid[row]].numpy(), np.nonzero(mask[row])[0][:capacity]
        )


def test_first_k_set_indices_is_batched_over_leading_dims():
    rng = np.random.default_rng(4)
    mask = torch.from_numpy(rng.random((2, 3, 50)) < 0.4)
    idx, valid, total = first_k_set_indices(mask, 7)
    assert idx.shape == valid.shape == (2, 3, 7) and total.shape == (2, 3)
    flat = first_k_set_indices(mask.reshape(6, 50), 7)
    assert torch.equal(idx.reshape(6, 7), flat[0])
    assert torch.equal(valid.reshape(6, 7), flat[1])
