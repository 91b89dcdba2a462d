"""PyTorch/CUDA port of the SIFT scale-space extrema detection frontend.

The detect path of ``sift_scale_space_extrema_detection_tpu`` (Gaussian
scale space, DoG, 26-neighbour extrema, quadratic refinement) in PyTorch,
with the fused octave kernel hand-written in CUDA for Hopper (sm_90a).
The package imports torch and numpy only; the JAX package stays the
reference it is tested against.
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
from .models.frontend import detect, detect_batched, detect_from_dog

__all__ = [
    "SiftConfig",
    "from_reference_config",
    "Extrema",
    "Keypoints",
    "concat_keypoints",
    "detect",
    "detect_batched",
    "detect_from_dog",
    "ACCEPTED",
    "REJECT_LOW_CONTRAST",
    "REJECT_EDGE",
    "REJECT_OUT_OF_BOUNDS",
    "REJECT_MAX_ITERATIONS",
    "REJECT_SINGULAR_HESSIAN",
    "REJECT_REASON_NAMES",
    "NUM_REJECT_REASONS",
]
