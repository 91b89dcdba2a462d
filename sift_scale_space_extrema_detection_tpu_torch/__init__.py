"""PyTorch/CUDA port of the SIFT scale-space extrema detection framework.

The detect and describe paths of ``sift_scale_space_extrema_detection_tpu``
(Gaussian scale space, DoG, 26-neighbour extrema, quadratic refinement,
orientation assignment, 128-D descriptors) in PyTorch, with the fused
octave kernel, the describe stages' kernels and the
stand-alone blur hand-written in CUDA for Hopper (sm_90a); the float64
``blur="exact"`` leg that is bit-faithful to the reference oracle
(``utils/oracle.py``); and the geometry back end: descriptor matching,
RANSAC two-view pose, and the ``sfm`` subpackage (PnP, pose graph, Schur
bundle adjustment, trajectory evaluation); and SLAM on top: the
incremental back end with checkpoint/resume (``models/slam.py``), visual
tracks from images, and the streaming session (``models/streaming.py``).
The user surfaces sit on top: the CLI (``python -m
sift_scale_space_extrema_detection_tpu_torch.cli IMAGE``: keypoints,
descriptors, galleries) and the dataset evaluator (``python -m
sift_scale_space_extrema_detection_tpu_torch.evaluate DIR``: a TUM-RGBD or
KITTI sequence → trajectory → ATE/RPE), over the image I/O
(``core/image.py``, the native loader ``core/native_io.py``), the dataset
layer (``data/``: TUM and KITTI readers and writers, pose files) and
``utils/visualize.py``. The ``parallel`` subpackage runs the frontend,
keyframe matching, bundle adjustment and SLAM over the ranks of a
``torch.distributed`` group.
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
from .models.slam import (
    SlamConfig,
    SlamResult,
    build_tracks_from_images,
    evaluate_ate,
    run_slam,
    run_slam_from_images,
)
from .models.streaming import SlamSession
from . import data, parallel, sfm
from .ops.descriptor import DescribedKeypoints, concat_described
from .ops.matching import Matches, descriptor_distances, match_descriptors
from .ops.ransac import (
    EssentialResult,
    estimate_essential_ransac,
    recover_pose,
    refine_relative_pose,
    sampson_error,
)

__all__ = [
    "SiftConfig",
    "from_reference_config",
    "Extrema",
    "Keypoints",
    "concat_keypoints",
    "DescribedKeypoints",
    "concat_described",
    "Matches",
    "EssentialResult",
    "descriptor_distances",
    "match_descriptors",
    "estimate_essential_ransac",
    "recover_pose",
    "refine_relative_pose",
    "sampson_error",
    "data",
    "parallel",
    "sfm",
    "SlamConfig",
    "SlamResult",
    "SlamSession",
    "build_tracks_from_images",
    "evaluate_ate",
    "run_slam",
    "run_slam_from_images",
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
