"""Dataset ingestion: TUM-RGBD and KITTI odometry loaders + pose IO.

The reference has no dataset layer (it loads one image via a browser
file picker, reference/main.js:52-118); this package is part of the
SLAM extension mandated by BASELINE.json (ATE vs reference on
TUM-RGBD/KITTI sequences). The JAX package's ``data/`` subpackage, copied:
both packages read what the other writes.
"""

from .kitti import KittiSequence, load_kitti_sequence, write_kitti_sequence
from .poses import (
    cam_to_world_to_wc,
    quat_to_rotation,
    read_tum_trajectory,
    rotation_to_quat,
    wc_to_cam_to_world,
    write_tum_trajectory,
)
from .tum import TumSequence, associate, load_tum_sequence, write_tum_sequence

__all__ = [
    "KittiSequence",
    "TumSequence",
    "associate",
    "cam_to_world_to_wc",
    "load_kitti_sequence",
    "load_tum_sequence",
    "quat_to_rotation",
    "read_tum_trajectory",
    "rotation_to_quat",
    "wc_to_cam_to_world",
    "write_kitti_sequence",
    "write_tum_sequence",
    "write_tum_trajectory",
]
