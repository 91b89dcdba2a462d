"""The hand-written CUDA kernel against its plain version, on the card.

Marked ``cuda``: each test skips where there is no CUDA device (decided in
a fixture, never at import). On a GPU machine, without jax installed:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX, so it runs where jax is absent.
"""

import numpy as np
import pytest
import torch

import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.models.frontend import (
    _as_unit_float,
    build_pyramid_fused,
)
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import (
    fused_octave,
    fused_octave_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# (base shape, upsample2x, octave, scales_per_octave): octave 0 with the
# in-kernel upsample; an unblurred base; a radius (47) past the whole
# 10x14 plane; 9 trios in int32 masks; a ragged 33x47 plane.
CASES = [
    ((2, 24, 32), True, 0, 5),
    ((2, 24, 32), False, 1, 5),
    ((2, 10, 14), False, 3, 5),
    ((1, 24, 32), False, 1, 9),
    ((3, 33, 47), False, 2, 3),
]


@pytest.mark.parametrize("shape, up2, octave, spo", CASES)
def test_kernel_matches_plain_version_bit_for_bit(device, shape, up2, octave, spo):
    cfg = port.SiftConfig(scales_per_octave=spo)
    sigmas = [
        None if (octave > 0 and s == 0) else cfg.offset_sigma(octave, s)
        for s in range(cfg.scales_per_octave_total)
    ]
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.random(shape).astype(np.float32)).to(device)
    thr = cfg.contrast_prefilter_threshold
    before = fused_octave.launches
    got = fused_octave(base, sigmas, spo, thr, upsample2x=up2)
    torch.cuda.synchronize()
    assert fused_octave.launches == before + 1
    want = fused_octave_reference(base, sigmas, spo, thr, upsample2x=up2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        # Both round every product and sum separately in float32.
        assert torch.equal(g, w)


def test_detect_batched_on_card_matches_cpu(device):
    rng = np.random.default_rng(1)
    images = torch.from_numpy((rng.random((2, 48, 64)) * 255).astype(np.uint8))
    cfg = port.SiftConfig(num_octaves=3, scales_per_octave=5)
    # Bit-equal pyramids: the uint8 scaling divides like the CPU does, and
    # the kernel rounds like the plain version.
    dogs, masks = build_pyramid_fused(_as_unit_float(images.to(device)), cfg)
    cpu_dogs, cpu_masks = build_pyramid_fused(_as_unit_float(images), cfg)
    for d, m, cd, cm in zip(dogs, masks, cpu_dogs, cpu_masks):
        assert torch.equal(d.cpu(), cd) and torch.equal(m.cpu(), cm)
    got, _ = port.detect_batched(images.to(device), cfg)
    want, _ = port.detect_batched(images, cfg)
    assert torch.equal(got.valid.cpu(), want.valid)
    assert torch.equal(got.reject_reason.cpu(), want.reject_reason)
    v = want.valid
    # Refinement is the same float32 op sequence; the card's exp2 and
    # division may differ from the CPU's in the last ulp.
    torch.testing.assert_close(got.abs_x.cpu()[v], want.abs_x[v], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.abs_y.cpu()[v], want.abs_y[v], rtol=1e-5, atol=1e-5)
