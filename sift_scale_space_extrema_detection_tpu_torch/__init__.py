"""PyTorch/CUDA port of the SIFT scale-space extrema detection frontend.

The detect and describe paths of ``sift_scale_space_extrema_detection_tpu``
(Gaussian scale space, DoG, 26-neighbour extrema, quadratic refinement,
orientation assignment, 128-D descriptors) in PyTorch, with the fused
octave kernel, the window-sampling kernel of the describe stages and the
stand-alone blur hand-written in CUDA for Hopper (sm_90a). The package
imports torch and numpy only; the JAX package stays the reference it is
tested against.
"""

from .config import SiftConfig, from_reference_config
from .core.types import (
    ACCEPTED,
    NUM_REJECT_REASONS,
    REJECT_EDGE,
    REJECT_LOW_CONTRAST,
    REJECT_MAX_ITERATIONS,
    REJECT_OUT_OF_BOUNDS,
    REJECT_REASON_NAMES,
    REJECT_SINGULAR_HESSIAN,
    Extrema,
    Keypoints,
    concat_keypoints,
)
from .models.frontend import (
    BLUR_STRATEGIES,
    build_dog,
    build_pyramid_fused,
    build_scale_space,
    detect,
    detect_and_describe,
    detect_and_describe_batched,
    detect_batched,
    detect_from_dog,
)
from .ops.descriptor import DescribedKeypoints, concat_described

__all__ = [
    "SiftConfig",
    "from_reference_config",
    "Extrema",
    "Keypoints",
    "concat_keypoints",
    "DescribedKeypoints",
    "concat_described",
    "BLUR_STRATEGIES",
    "build_dog",
    "build_pyramid_fused",
    "build_scale_space",
    "detect",
    "detect_batched",
    "detect_from_dog",
    "detect_and_describe",
    "detect_and_describe_batched",
    "ACCEPTED",
    "REJECT_LOW_CONTRAST",
    "REJECT_EDGE",
    "REJECT_OUT_OF_BOUNDS",
    "REJECT_MAX_ITERATIONS",
    "REJECT_SINGULAR_HESSIAN",
    "REJECT_REASON_NAMES",
    "NUM_REJECT_REASONS",
]
