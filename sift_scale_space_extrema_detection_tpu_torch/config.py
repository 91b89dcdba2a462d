"""Frozen configuration for the SIFT scale-space frontend.

A framework-free copy of ``sift_scale_space_extrema_detection_tpu.config``:
importing any module of the JAX package runs its ``__init__``, which pulls
in jax and flax, so the port cannot import the original. Every field,
default, property and method is the same, with the same float evaluation
order (``tests/test_torch_config.py`` pins the two equal). The reference
constants and their sources are documented in the JAX package's module;
the fields that tune TPU-only code paths are kept so a configuration
round-trips between the packages (:func:`from_reference_config`).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    # --- reference algorithm constants -----------------------------------
    num_octaves: int = 5
    scales_per_octave: int = 3
    min_blur_level: float = 0.8
    assumed_blur: float = 0.5
    chunk_size: int = 32  # display tiling in the reference; unused here
    min_interpixel_distance: float = 0.5
    contrast_threshold: float = 0.015
    contrast_prefilter_factor: float = 0.8
    edge_ratio: float = 10.0
    max_refine_iterations: int = 5
    convergence_threshold: float = 0.6
    kernel_radius_sigmas: float = 3.0

    # --- static-shape capacities ------------------------------------------
    # Max extrema kept per (octave, trio): fixed capacity + validity mask
    # in place of the reference's dynamic candidate lists.
    max_keypoints_per_trio: int = 1024
    # Refinement slots per octave as a fraction of the per-trio total.
    refine_compaction: float = 0.5
    # Single-entry refinement ladder, used when the schedule is empty.
    refine_active_compaction: float = 0.35
    # Before Newton iteration k+1, only the first
    # ``max(64, int(slots * schedule[min(k-1, len-1)]))`` still-active
    # slots keep iterating; the rest keep REJECT_MAX_ITERATIONS.
    refine_compaction_schedule: tuple = (0.35, 0.15, 0.08)
    # Cross-octave refinement variants of the JAX package; off by default
    # and not implemented by the port (the per-octave path always runs).
    unified_refine: bool = False
    refine_pool_compaction: float = 0.7
    refine_tail_pool: bool = False
    # Floor of the per-octave capacity schedule.
    min_keypoints_per_trio: int = 64

    # --- descriptor extension (not yet ported; kept for round-trips) ------
    lambda_ori: float = 1.5
    lambda_descr: float = 6.0
    n_orientation_bins: int = 36
    orientation_smooth_iterations: int = 6
    orientation_peak_ratio: float = 0.8
    max_orientations_per_keypoint: int = 2
    orientation_grid_size: int = 16
    descriptor_n_hist: int = 4
    descriptor_n_ori: int = 8
    descriptor_grid_size: int = 16
    descriptor_clip: float = 0.2
    compact_describe: bool = True
    describe_compaction: float = 0.5
    descriptor_pair_compaction: float = 0.75
    upright: bool = False
    window_describe: bool = True

    def __post_init__(self):
        if self.upright and not self.compact_describe:
            raise ValueError(
                "upright=True requires compact_describe=True (the "
                "per-octave describe path has no upright mode)"
            )

    # ----------------------------------------------------------------------
    @property
    def scales_per_octave_total(self) -> int:
        """Gaussian images per octave: s+3 (reference/background.js:106)."""
        return self.scales_per_octave + 3

    @property
    def dog_per_octave(self) -> int:
        """DoG images per octave: s+2 (reference/background.js:272)."""
        return self.scales_per_octave + 2

    @property
    def trios_per_octave(self) -> int:
        """Extrema trios per octave: DoG scales 1..s (background.js:377)."""
        return self.scales_per_octave

    @property
    def k(self) -> float:
        """Scale multiplier 2^(1/n_spo) (reference/background.js:100)."""
        return math.pow(2.0, 1.0 / self.scales_per_octave)

    @property
    def contrast_threshold_scaled(self) -> float:
        """``((2^(1/n) - 1) / (2^(1/3) - 1)) * 0.015``
        (reference/src/sift.js:285). Evaluation order matches JS."""
        return (
            (math.pow(2.0, 1.0 / self.scales_per_octave) - 1.0)
            / (math.pow(2.0, 1.0 / 3.0) - 1.0)
        ) * self.contrast_threshold

    @property
    def contrast_prefilter_threshold(self) -> float:
        """Pre-filter threshold: thr * 0.8 (reference/src/sift.js:293)."""
        return self.contrast_threshold_scaled * self.contrast_prefilter_factor

    @property
    def edge_threshold(self) -> float:
        """Edge test threshold (c+1)^2/c (reference/background.js:598)."""
        c = self.edge_ratio
        return ((c + 1.0) * (c + 1.0)) / c

    @classmethod
    def quality(cls, **overrides) -> "SiftConfig":
        """Detection-density preset (standard SIFT sigma0 = 1.6 and
        OpenCV-like thresholds); a documented divergence from the
        reference, see the JAX package's ``SiftConfig.quality``."""
        base = dict(
            min_blur_level=1.6,
            contrast_threshold=0.0133,
            contrast_prefilter_factor=0.5,
        )
        base.update(overrides)
        return cls(**base)

    def keypoints_per_trio(self, octave: int) -> int:
        """Per-trio slot capacity for one octave (shrinks 2x per octave)."""
        return max(self.min_keypoints_per_trio, self.max_keypoints_per_trio >> octave)

    def refine_capacity(self, octave: int) -> int:
        """Candidate slots fed to refinement per octave."""
        total = self.keypoints_per_trio(octave) * self.trios_per_octave
        return min(total, max(64, int(total * self.refine_compaction)))

    def describe_capacity(self) -> int:
        """Compacted keypoint slots fed to the unified describe pass."""
        total = sum(self.refine_capacity(o) for o in range(self.num_octaves))
        return min(total, max(128, int(total * self.describe_compaction)))

    def descriptor_pair_capacity(self) -> int:
        """Compacted (keypoint, orientation) pairs in the descriptor pass."""
        if self.upright:
            return self.describe_capacity()
        full = self.describe_capacity() * self.max_orientations_per_keypoint
        return min(
            full, max(128, int(full * self.descriptor_pair_compaction))
        )

    def max_keypoints_per_octave(self) -> int:
        return self.max_keypoints_per_trio * self.trios_per_octave

    def max_keypoints_total(self) -> int:
        return self.max_keypoints_per_octave() * self.num_octaves

    # --- blur ladder -------------------------------------------------------
    def base_blur_level(self, octave: int) -> float:
        """Blur level of an octave's base image: min_blur_level for octave
        0, then the running product ``b * k^spo`` computed by repeated
        multiplication exactly as the reference does
        (background.js:89, :114-122)."""
        b = self.min_blur_level
        for _ in range(octave):
            b = b * math.pow(self.k, self.scales_per_octave)
        return b

    def target_sigma(self, octave: int, scale: int) -> float:
        """Absolute blur of (octave, scale): base * k^scale
        (reference/background.js:157-173)."""
        return self.base_blur_level(octave) * math.pow(self.k, scale)

    def offset_sigma(self, octave: int, scale: int) -> float:
        """Incremental blur applied to the octave base image to reach the
        target blur (semigroup relation, reference/background.js:162-177).
        Octave 0 blurs from ``assumed_blur``; octaves >0 from the
        inherited base blur level."""
        target = self.target_sigma(octave, scale)
        base = self.assumed_blur if octave == 0 else self.base_blur_level(octave)
        return math.sqrt((target * target) - (base * base))


def from_reference_config(cfg) -> SiftConfig:
    """The port's config from any dataclass with the JAX ``SiftConfig``'s
    fields (read through ``dataclasses.asdict``).

    Raises ``TypeError`` on a field the port does not know, so a
    configuration never crosses over with a setting silently dropped.
    """
    return SiftConfig(**dataclasses.asdict(cfg))
