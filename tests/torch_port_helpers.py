"""Shared helpers of the port's tests: inputs from a seed, and converters
that carry the JAX package's results into the port's dataclasses."""

import dataclasses

import numpy as np
import torch

from sift_scale_space_extrema_detection_tpu_torch.core.types import Keypoints
from sift_scale_space_extrema_detection_tpu_torch.ops.matching import Matches
from sift_scale_space_extrema_detection_tpu_torch.sfm.ba import BAState, Observations
from sift_scale_space_extrema_detection_tpu_torch.sfm.pose_graph import PoseGraphEdges


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


def ba_state_to_port(state) -> BAState:
    return _to_port(BAState, state)


def observations_to_port(obs) -> Observations:
    return _to_port(Observations, obs)


def edges_to_port(edges) -> PoseGraphEdges:
    return _to_port(PoseGraphEdges, edges)


def matches_to_port(matches) -> Matches:
    return _to_port(Matches, matches)


def jax_ransac_draws(valid: torch.Tensor, num_hypotheses: int, generator: torch.Generator):
    """The sample indices the JAX package's ``estimate_essential_ransac``
    draws for ``jax.random.PRNGKey(generator.initial_seed())``: a stand-in
    for the port's ``ops/ransac.py::sample_minimal_sets`` and
    ``models/slam.py::_pair_draws`` (the port seeds each RANSAC call with the
    integer the JAX package keys it with)."""
    import jax
    import jax.numpy as jnp

    ok = jnp.asarray(valid.cpu().numpy())
    u = jax.random.uniform(jax.random.PRNGKey(generator.initial_seed()), (num_hypotheses, ok.shape[0]))
    idx = jax.lax.top_k(jnp.where(ok[None, :], u, -1.0), 8)[1]
    return torch.from_numpy(np.asarray(idx).astype(np.int64)).to(valid.device)


def _texture(rng, size, sigma):
    """A blurred uniform-noise texture in [0, 1] (the JAX package's
    separable blur, as its SLAM tests make it)."""
    import jax.numpy as jnp

    from sift_scale_space_extrema_detection_tpu.ops.gaussian import blur_separable

    tex = np.asarray(blur_separable(jnp.asarray(rng.random(size)), sigma))
    return (tex - tex.min()) / max(tex.max() - tex.min(), 1e-9)


# The loop-closure scenes of ``tests/test_slam.py``: 160×160 frames.
K_LOOP = np.array([[200.0, 0, 80.0], [0, 200.0, 80.0], [0, 0, 1.0]])


def loop_gap_images() -> np.ndarray:
    """The same texture before and after three blank frames."""
    tex = _texture(np.random.default_rng(7), (200, 200), 1.2)
    blank = np.full((160, 160), 0.5)
    return np.stack([tex[4:164, 6:166], blank, blank, blank, tex[0:160, 0:160]]).astype(np.float32)


def loop_distractor_images() -> np.ndarray:
    """Texture A, nine different distractor textures, texture A shifted."""
    rng = np.random.default_rng(11)
    tex = _texture(rng, (200, 200), 1.2)
    frames = [tex[4:164, 6:166]] + [_texture(rng, (160, 160), 2.0) for _ in range(9)]
    return np.stack(frames + [tex[0:160, 0:160]]).astype(np.float32)


def rotation_angle_deg(r_est, r_true) -> float:
    """Angle of ``r_est·r_trueᵀ`` in degrees."""
    rr = np.asarray(r_est) @ np.asarray(r_true).T
    return float(np.degrees(np.arccos(np.clip((np.trace(rr) - 1) / 2, -1, 1))))
