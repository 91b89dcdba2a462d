"""Multi-rank execution: data-parallel frontend, keyframe-sharded matching
and landmark-sharded bundle adjustment.

Port of the JAX package's ``parallel/distributed.py`` onto
``torch.distributed`` (``parallel/multihost.py`` says how ranks share the
work: every rank passes the same full inputs and gets the same full
outputs).

- **Frontend**: the batch axis is split over the ranks; each rank runs the
  whole detect+describe path (the fused octave kernel per octave, the
  window-sampling kernel per describe stage) on its frames, and the results
  are gathered.
- **Keyframe matching**: the keyframes are split over the ranks; each rank
  matches the query against its keyframes in one mapped call, and the
  matches are gathered.
- **Bundle adjustment**: the landmark block is split over the ranks. Each
  rank holds the observations of its landmarks (grouped by owner on the
  host, the same numpy on every rank) and computes their Schur contribution
  (``sfm/ba.py::shard_schur_pieces``); one ``all_reduce`` of the four
  camera-side partial sums per LM iteration gives every rank the same
  reduced camera system, which each solves; the landmarks back-substitute
  locally, and are gathered once at the end.

A rank that rounds or branches otherwise than another would pair the
collectives wrongly: everything outside the sharded pieces is computed by
every rank from the same inputs in the same order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import SiftConfig
from ..core.device import on_device, require_full_float32_matmul
from ..models.frontend import detect_and_describe_batched
from ..ops.descriptor import DescribedKeypoints
from ..ops.matching import match_descriptors
from ..sfm.ba import (
    BAState,
    Observations,
    _obs_terms,
    backsub_landmarks,
    huber_cost,
    huber_weights,
    segment_tables,
    shard_schur_pieces,
    solve_reduced,
)
from ..sfm.geometry import so3_exp
from .multihost import global_mesh, mesh_device, mesh_group, put_global


def make_mesh(
    n_devices: int | None = None, axis: str = "shard", device_type: str = "cuda"
) -> DeviceMesh:
    """1-D mesh over the initialised group, on ``device_type`` (see
    :func:`~.multihost.global_mesh`). A mesh spans every rank: ``n_devices``,
    when given, must be the world size. There is no fallback to the CPU."""
    if n_devices is not None and n_devices != dist.get_world_size():
        raise ValueError(
            f"make_mesh: {n_devices} devices asked for, the group has "
            f"{dist.get_world_size()} ranks"
        )
    return global_mesh(axis, device_type)


def _pad_rows(x: torch.Tensor, multiple: int, value=0) -> torch.Tensor:
    """``x`` with its first axis padded by ``value`` rows to a multiple of
    ``multiple``."""
    pad = (-x.shape[0]) % multiple
    if not pad:
        return x
    return torch.cat([x, x.new_full((pad, *x.shape[1:]), value)])


def all_gather_rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each), concatenated along the
    first axis in rank order, on every rank."""
    group, world, _ = mesh_group(mesh)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def detect_and_describe_data_parallel(
    images, cfg: SiftConfig, mesh: DeviceMesh
) -> DescribedKeypoints:
    """``detect_and_describe_batched`` with the batch axis split over the
    ranks: ``images`` (B, H, W), the same on every rank (a tensor or
    numpy, any dtype the frontend takes), is padded with blank frames to a
    multiple of the world size; each rank describes its contiguous share on
    the mesh's device, and every rank returns the whole batch's result. An
    image is described on its own, so the pad changes no result."""
    images = torch.as_tensor(images)
    _, world, _ = mesh_group(mesh)
    batch = images.shape[0]
    local = put_global(_pad_rows(images, world), mesh)
    out = detect_and_describe_batched(local, cfg, device=local.device)
    return DescribedKeypoints(**{
        f.name: all_gather_rows(getattr(out, f.name), mesh)[:batch]
        for f in dataclasses.fields(out)
    })


def match_against_keyframes_sharded(
    query_desc: torch.Tensor,
    query_valid: torch.Tensor,
    keyframe_desc: torch.Tensor,
    keyframe_valid: torch.Tensor,
    mesh: DeviceMesh,
    ratio: float = 0.8,
):
    """Match one query set against many keyframes, split by keyframe.

    ``keyframe_desc`` (K, M, 128) / ``keyframe_valid`` (K, M) are padded
    with keyframes of no valid slot to a multiple of the world size; each
    rank maps :func:`~..ops.matching.match_descriptors` over its keyframes
    in one call. Returns ``(index (K, N), distance (K, N), valid (K, N))``
    on every rank.
    """
    _, world, _ = mesh_group(mesh)
    dev = mesh_device(mesh)
    q_desc, q_valid = query_desc.to(dev), query_valid.to(dev)
    num = keyframe_desc.shape[0]
    kd = put_global(_pad_rows(keyframe_desc, world), mesh)
    kv = put_global(_pad_rows(keyframe_valid, world, False), mesh)

    def one(d_b, v_b):
        m = match_descriptors(q_desc, q_valid, d_b, v_b, ratio=ratio, device=dev)
        return m.index, m.distance, m.valid

    local = torch.func.vmap(one)(kd, kv)
    return tuple(all_gather_rows(t, mesh)[:num] for t in local)


def _pad_landmarks(state: BAState, n_shards: int) -> tuple[BAState, int]:
    """Pad the landmark axis to a multiple of the world size."""
    points = _pad_rows(state.points, n_shards)
    return dataclasses.replace(state, points=points), points.shape[0]


def _owner_buffers(obs: Observations, n_shards: int, l_local: int):
    """The observations grouped by the shard that owns their landmark:
    ``(cam, lm, uv, valid)`` numpy arrays of shape ``(n_shards, n_max)``,
    row ``s`` holding exactly the valid observations of shard ``s``'s
    landmarks in their order, padded with invalid slots. ``n_max`` is a
    power of two (the JAX package's compile buckets, kept so both solve the
    same system). The same numpy on every rank."""
    lm = obs.landmark.cpu().numpy()
    cam = obs.camera.cpu().numpy()
    uv = obs.uv.cpu().numpy()
    valid = obs.valid.cpu().numpy()
    owner = np.clip(lm // l_local, 0, n_shards - 1)
    counts = np.bincount(owner[valid], minlength=n_shards)
    n_max = 1 << max(3, (max(int(counts.max()), 1) - 1).bit_length())
    cam_s = np.zeros((n_shards, n_max), cam.dtype)
    # A pad slot points at its shard's first landmark, so that its local
    # index stays in range; it is masked all the same.
    lm_s = np.repeat((np.arange(n_shards, dtype=lm.dtype) * l_local)[:, None], n_max, axis=1)
    uv_s = np.zeros((n_shards, n_max, 2), uv.dtype)
    valid_s = np.zeros((n_shards, n_max), bool)
    for s in range(n_shards):
        idx = np.flatnonzero(valid & (owner == s))
        cam_s[s, : len(idx)] = cam[idx]
        lm_s[s, : len(idx)] = lm[idx]
        uv_s[s, : len(idx)] = uv[idx]
        valid_s[s, : len(idx)] = True
    return cam_s, lm_s, uv_s, valid_s


def distributed_bundle_adjust(
    state: BAState,
    obs: Observations,
    mesh: DeviceMesh,
    num_iterations: int = 10,
    num_fixed_cameras: int = 1,
    huber_delta: float | None = None,
) -> tuple[BAState, torch.Tensor]:
    """Landmark-sharded Levenberg-Marquardt bundle adjustment over the ranks.

    The semantics of :func:`~..sfm.ba.bundle_adjust` (IRLS Huber weighting
    with ``huber_delta``, the same robust cost in the accept test, the same
    damping schedule), with the Schur reduction of the landmark block summed
    over the ranks. ``state``/``obs`` are the full problem, the same on
    every rank; the work runs on the mesh's device. Returns ``(refined
    state, final cost)``, the same on every rank. Each call adds one to
    ``distributed_bundle_adjust.calls``.
    """
    distributed_bundle_adjust.calls += 1
    group, world, rank = mesh_group(mesh)
    dev = mesh_device(mesh)
    require_full_float32_matmul(dev)
    state = on_device(state, dev)
    num_landmarks = state.points.shape[0]
    num_cameras = state.rotations.shape[0]
    state, l_padded = _pad_landmarks(state, world)
    l_local = l_padded // world

    rows = [put_global(a, mesh)[0] for a in _owner_buffers(obs, world, l_local)]
    cam, lm, uv, valid = rows[0].long(), rows[1].long(), rows[2].to(state.points.dtype), rows[3]
    lm_local = lm - rank * l_local
    own = valid & (lm_local >= 0) & (lm_local < l_local)
    cam = cam.clamp(0, num_cameras - 1)
    # The index tables depend on the ids and the validity alone: built once.
    segments = (
        segment_tables(cam, num_cameras),
        segment_tables(torch.where(own, lm_local, l_local), l_local),
    )
    k_mat = state.k_mat

    def local_residuals(rots, ts, points):
        x = points[lm_local.clamp(0, l_local - 1)]
        return _obs_terms(rots, ts, k_mat, x, cam, uv, own)[0]

    def total_cost(res):
        cost = huber_cost(res, huber_delta)
        dist.all_reduce(cost, group=group)
        return cost

    rots, ts = state.rotations, state.translations
    points = put_global(state.points, mesh)
    cost = total_cost(local_residuals(rots, ts, points))
    lam = torch.full((), 1e-4, dtype=points.dtype, device=dev)
    for _ in range(num_iterations):
        pieces = shard_schur_pieces(
            rots, ts, k_mat, points, cam, lm_local, uv, own, lam, num_cameras,
            huber_weights(local_residuals(rots, ts, points), huber_delta), segments,
        )
        # The four camera-side partial sums, in one buffer and one reduction.
        sums = (pieces.h_cc, pieces.b_c, pieces.s_off, pieces.rhs_off)
        flat = torch.cat([t.reshape(-1) for t in sums])
        dist.all_reduce(flat, group=group)
        h_cc, b_c, s_off, rhs_off = (
            part.reshape(t.shape)
            for part, t in zip(flat.split([t.numel() for t in sums]), sums)
        )
        delta_c = solve_reduced(h_cc, b_c, s_off, rhs_off, lam, num_fixed_cameras)
        delta_l = backsub_landmarks(pieces, delta_c)

        rots_new = so3_exp(delta_c[:, :3]) @ rots
        ts_new = ts + delta_c[:, 3:]
        points_new = points + delta_l
        cost_new = total_cost(local_residuals(rots_new, ts_new, points_new))
        accept = cost_new < cost
        rots = torch.where(accept, rots_new, rots)
        ts = torch.where(accept, ts_new, ts)
        points = torch.where(accept, points_new, points)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.where(accept, lam * 0.3, lam * 6.0).clamp(1e-9, 1e5)

    points = all_gather_rows(points, mesh)[:num_landmarks]
    return BAState(rotations=rots, translations=ts, points=points, k_mat=k_mat), cost


distributed_bundle_adjust.calls = 0
