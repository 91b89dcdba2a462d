"""Shared helpers of the port's tests: inputs from a seed, and converters
that carry the JAX package's results into the port's dataclasses."""

import dataclasses

import numpy as np
import torch

from sift_scale_space_extrema_detection_tpu_torch.core.types import Keypoints


def textured_images(seed: int, b: int, h: int, w: int) -> np.ndarray:
    """``(b, h, w)`` float32 frames in [0, 1]: a smooth pattern plus 60
    random Gaussian blobs each, which gives keypoints at every octave."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = []
    for k in range(b):
        img = 0.5 + 0.1 * np.sin(xx / 6.0 + k) * np.cos(yy / 8.0)
        for _ in range(60):
            cy, cx = rng.uniform(8, h - 8), rng.uniform(8, w - 8)
            r = rng.uniform(1.5, 5.0)
            img += rng.uniform(-0.35, 0.35) * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r)
            )
        imgs.append(np.clip(img, 0.0, 1.0))
    return np.stack(imgs).astype(np.float32)


def _to_port(cls, result):
    """A JAX struct-of-arrays result (or any object with the fields of
    ``cls``) as the port's dataclass of CPU tensors."""
    return cls(
        **{
            f.name: torch.from_numpy(np.array(getattr(result, f.name)))
            for f in dataclasses.fields(cls)
        }
    )


def keypoints_to_port(result) -> Keypoints:
    return _to_port(Keypoints, result)
