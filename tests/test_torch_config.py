"""The port's framework-free copies equal the JAX package's originals.

The port cannot import ``SiftConfig``, the reject codes or the tap
functions from the JAX package (its ``__init__`` imports jax and flax),
so it holds copies; these tests pin every copy to the original exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import sift_scale_space_extrema_detection_tpu.core.types as jtypes
from sift_scale_space_extrema_detection_tpu.config import SiftConfig as JaxConfig
from sift_scale_space_extrema_detection_tpu.ops import gaussian as jgauss
import sift_scale_space_extrema_detection_tpu_torch.core.types as ptypes
from sift_scale_space_extrema_detection_tpu_torch.config import (
    SiftConfig,
    from_reference_config,
)
from sift_scale_space_extrema_detection_tpu_torch.ops import gaussian as pgauss

torch.set_num_threads(2)

CONFIGS = [
    {},
    {"num_octaves": 4, "scales_per_octave": 5, "max_keypoints_per_trio": 512},
    {"num_octaves": 3, "scales_per_octave": 9, "min_keypoints_per_trio": 16},
    {"scales_per_octave": 2, "edge_ratio": 7.5, "refine_compaction": 0.25},
]


def test_fields_and_defaults_equal():
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(JaxConfig)]
    pf = [(f.name, f.type, f.default) for f in dataclasses.fields(SiftConfig)]
    assert pf == jf
    assert dataclasses.asdict(SiftConfig()) == dataclasses.asdict(JaxConfig())


@pytest.mark.parametrize("overrides", CONFIGS)
def test_derived_values_equal(overrides):
    j, p = JaxConfig(**overrides), SiftConfig(**overrides)
    for name in (
        "scales_per_octave_total",
        "dog_per_octave",
        "trios_per_octave",
        "k",
        "contrast_threshold_scaled",
        "contrast_prefilter_threshold",
        "edge_threshold",
    ):
        assert getattr(p, name) == getattr(j, name), name
    for name in (
        "describe_capacity",
        "descriptor_pair_capacity",
        "max_keypoints_per_octave",
        "max_keypoints_total",
    ):
        assert getattr(p, name)() == getattr(j, name)(), name
    for octave in range(p.num_octaves + 1):
        assert p.keypoints_per_trio(octave) == j.keypoints_per_trio(octave)
        assert p.refine_capacity(octave) == j.refine_capacity(octave)
        assert p.base_blur_level(octave) == j.base_blur_level(octave)
        for scale in range(p.scales_per_octave_total):
            # Bit-equal floats: the evaluation order is copied.
            assert p.offset_sigma(octave, scale) == j.offset_sigma(octave, scale)
            assert p.target_sigma(octave, scale) == j.target_sigma(octave, scale)


def test_quality_preset_and_validation_equal():
    assert dataclasses.asdict(SiftConfig.quality(num_octaves=3)) == (
        dataclasses.asdict(JaxConfig.quality(num_octaves=3))
    )
    with pytest.raises(ValueError):
        SiftConfig(upright=True, compact_describe=False)


@pytest.mark.parametrize("overrides", CONFIGS)
def test_from_reference_config_round_trips(overrides):
    j = JaxConfig(**overrides)
    p = from_reference_config(j)
    assert isinstance(p, SiftConfig)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert JaxConfig(**dataclasses.asdict(p)) == j


def test_from_reference_config_rejects_unknown_fields():
    @dataclasses.dataclass
    class Other:
        num_octaves: int = 3
        not_a_field: int = 1

    with pytest.raises(TypeError):
        from_reference_config(Other())


def test_reject_codes_equal():
    for name in (
        "ACCEPTED",
        "REJECT_LOW_CONTRAST",
        "REJECT_EDGE",
        "REJECT_OUT_OF_BOUNDS",
        "REJECT_MAX_ITERATIONS",
        "REJECT_SINGULAR_HESSIAN",
        "REJECT_REASON_NAMES",
        "NUM_REJECT_REASONS",
    ):
        assert getattr(ptypes, name) == getattr(jtypes, name), name
    for cls in ("Keypoints", "Extrema"):
        assert [f.name for f in dataclasses.fields(getattr(ptypes, cls))] == [
            f.name for f in dataclasses.fields(getattr(jtypes, cls))
        ]


SIGMAS = [0.1, 0.5, 0.8, 1.2489995996796797, 2.0, 3.9, 15.6, 0.7 / 6]


@pytest.mark.parametrize("sigma", SIGMAS)
def test_tap_functions_bit_equal(sigma):
    assert pgauss.js_round(3 * sigma) == jgauss.js_round(3 * sigma)
    assert pgauss.kernel_radius(sigma) == jgauss.kernel_radius(sigma)
    p, j = pgauss.gaussian_kernel_1d(sigma), jgauss.gaussian_kernel_1d(sigma)
    assert p.dtype == j.dtype == np.float64
    np.testing.assert_array_equal(p, j)
    assert pgauss.taps_f32(sigma) == tuple(
        float(v) for v in j.astype(np.float32)
    )


def test_js_round_ties_go_up():
    # Math.round semantics, not round-half-even.
    assert [pgauss.js_round(v) for v in (0.5, 1.5, 2.5, -0.5)] == [1, 2, 3, 0]
