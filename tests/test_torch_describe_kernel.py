"""The window-sampling kernel's plain version against the JAX Pallas kernel.

The JAX side is ``ops/pallas/describe.py::window_sample_pair`` in interpret
mode, called directly on one chunk of 128 slots with the inputs its caller
would build (padded slabs, aligned window starts, window-local
coordinates); the port's side is ``window_sample_pair_reference``, which
the port's CUDA kernel matches bit for bit on the card. The same stacks,
slots and plane coordinates go into both.

The coordinates are multiples of 1/64 px: the JAX package folds the scale
level into the row coordinate (``y + s·H``), which would round other
positions to a coarser float32 grid than the port samples at. On this grid
both sample the same positions and differ only by the exact zeros that the
TPU kernel's tent-weight contraction adds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_scale_space_extrema_detection_tpu.config import SiftConfig as JaxConfig
from sift_scale_space_extrema_detection_tpu.ops.pallas import describe as jdescribe
import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.ops.descriptor import _inbounds_mask
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import launch_counts, launches_since
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.describe import (
    window_sample_pair,
    window_sample_pair_reference,
)
from tests.torch_port_helpers import textured_images

torch.set_num_threads(2)

# The JAX package's own bar for this kernel is near-bit-equal; gradients
# here reach a few hundredths, whose float32 ulp is ~2e-9.
ATOL = 1e-7
M = jdescribe.CHUNK
GRID = 16


@pytest.fixture(scope="module")
def stacks():
    cfg = port.SiftConfig(num_octaves=3)
    images = torch.from_numpy(textured_images(5, 2, 96, 128))
    return cfg, port.build_scale_space(images, cfg, device="cpu")


def _slots_and_coords(cfg, stacks, separable):
    """128 slots over all images, octaves and levels, about one in eight
    invalid, with a 16×16 grid of plane coordinates each, on multiples of
    1/64 px: the descriptor stage's rotated grid, or (``separable``) the
    orientation stage's axis-aligned one."""
    rng = np.random.default_rng(6)
    b = rng.integers(0, stacks[0].shape[0], M)
    octave = rng.integers(0, len(stacks), M)
    scale = rng.integers(1, cfg.scales_per_octave + 1, M)
    valid = rng.random(M) > 0.125
    hs = np.array([s.shape[-2] for s in stacks])[octave]
    ws = np.array([s.shape[-1] for s in stacks])[octave]
    # Centres anywhere on the plane, corners included: samples past the
    # border are clamped by both sides and masked from the comparison.
    cy = rng.uniform(0, hs - 1)
    cx = rng.uniform(0, ws - 1)
    # Half-widths up to 0.9 of the stage's largest: the orientation grid
    # reaches 3·λ_ori·σ, the descriptor grid λ_descr·(nh+1)/nh·σ.
    reach = 3.0 * cfg.lambda_ori if separable else 7.5
    half = rng.uniform(2.0, 0.9 * jdescribe.max_sigma_loc(cfg) * reach, M)
    theta = np.zeros(M) if separable else rng.uniform(0, 2 * np.pi, M)
    u = np.linspace(-1.0, 1.0, GRID)
    uy, ux = np.repeat(u, GRID), np.tile(u, GRID)
    c, s = np.cos(theta)[:, None], np.sin(theta)[:, None]
    ys = cy[:, None] + half[:, None] * (s * ux + c * uy)
    xs = cx[:, None] + half[:, None] * (c * ux - s * uy)
    if separable:  # an exact outer product: row i shares y, column j shares x
        ys = np.repeat(np.round(ys[:, ::GRID] * 64) / 64, GRID, axis=1)
        xs = np.tile(np.round(xs[:, :GRID] * 64) / 64, (1, GRID))
    else:
        ys, xs = np.round(ys * 64) / 64, np.round(xs * 64) / 64
    table = np.stack([b, octave, scale, valid], axis=1).astype(np.int32)
    return table, ys.astype(np.float32), xs.astype(np.float32), hs, ws


def _jax_kernel(cfg, stacks, table, ys, xs, hs, ws, grid):
    """The Pallas kernel in interpret mode, fed as
    ``describe_compact_batched_windowed`` feeds it."""
    jcfg = JaxConfig(num_octaves=cfg.num_octaves)
    slabs, _ = jdescribe.pad_stacks_for_windows(
        [jnp.asarray(s.numpy()) for s in stacks], jcfg
    )
    rows, lanes = jdescribe.window_geometry(jcfg, "ori" if grid else "desc")
    hf = hs.astype(np.float32)[:, None]
    wf = ws.astype(np.float32)[:, None]
    level = table[:, 2].astype(np.float32)[:, None]
    ys_flat = (np.clip(ys, 0.0, hf - 1.0) + level * hf) - np.float32(1.0) * hf
    xs_cl = np.clip(xs, 0.0, wf - 1.0)
    r0, c0 = jdescribe.window_starts(
        jnp.asarray(ys_flat), jnp.asarray(xs_cl), jnp.asarray(table[:, 1]),
        [s.shape[1:] for s in slabs], rows, lanes,
    )
    r0, c0 = np.asarray(r0), np.asarray(c0)
    idx = np.stack([table[:, 0], table[:, 1], r0, c0, table[:, 3]], axis=1)
    ys_loc = ys_flat - r0.astype(np.float32)[:, None]
    xs_loc = xs_cl - c0.astype(np.float32)[:, None]
    if grid:
        ys_loc, xs_loc = ys_loc[:, ::grid], xs_loc[:, :grid]
    gy, gx = jdescribe.window_sample_pair(
        tuple(slabs), jnp.asarray(idx.astype(np.int32)), jnp.asarray(ys_loc),
        jnp.asarray(xs_loc), rows, lanes, grid=grid, interpret=True,
    )
    return np.asarray(gy), np.asarray(gx)


@pytest.mark.parametrize("grid", [0, GRID], ids=["general", "separable_grid16"])
def test_plain_version_matches_pallas_kernel_on_one_chunk(stacks, grid):
    cfg, stacks = stacks
    table, ys, xs, hs, ws = _slots_and_coords(cfg, stacks, separable=bool(grid))
    want_gy, want_gx = _jax_kernel(cfg, stacks, table, ys, xs, hs, ws, grid)
    got_gy, got_gx = window_sample_pair_reference(
        stacks, torch.from_numpy(table), torch.from_numpy(ys), torch.from_numpy(xs)
    )
    valid = table[:, 3] != 0
    assert not got_gy[~valid].any() and not got_gx[~valid].any()
    inside = _inbounds_mask(ys, xs, hs[:, None], ws[:, None]) & valid[:, None]
    assert inside.sum() > 0.3 * inside.size and (~inside[valid]).sum() > 100
    assert np.abs(want_gy[inside]).max() > 1e-3  # a comparison of real gradients
    np.testing.assert_allclose(got_gy.numpy()[inside], want_gy[inside], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_gx.numpy()[inside], want_gx[inside], rtol=0, atol=ATOL)


def test_wrapper_runs_the_plain_version_on_the_cpu(stacks):
    cfg, stacks = stacks
    table, ys, xs, _, _ = _slots_and_coords(cfg, stacks, separable=False)
    args = (stacks, torch.from_numpy(table), torch.from_numpy(ys), torch.from_numpy(xs))
    before = launch_counts()
    got = window_sample_pair(*args)
    want = window_sample_pair_reference(*args)
    assert launches_since(before)["window_sample_pair"] == 0  # no kernel launch on the CPU
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_plain_version_clamps_level_and_skips_unknown_octaves(stacks):
    cfg, stacks = stacks
    ys = torch.full((4, 3), 10.25)
    xs = torch.full((4, 3), 12.5)
    last = stacks[0].shape[1] - 1
    table = torch.tensor(
        [[0, 0, last + 7, 1], [0, 0, last, 1], [0, 3, 1, 1], [0, -1, 1, 1]],
        dtype=torch.int32,
    )
    gy, gx = window_sample_pair_reference(stacks, table, ys, xs)
    assert torch.equal(gy[0], gy[1]) and torch.equal(gx[0], gx[1]) and gy[1].any()
    assert not gy[2:].any() and not gx[2:].any()
