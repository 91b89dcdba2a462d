"""Incremental SfM / SLAM.

Port of the JAX package's ``models/slam.py``. Monocular pipeline over a
sequence of per-frame landmark measurements:

1. **Bootstrap** — RANSAC essential matrix between frames ``(0, kb)``, pose
   recovery, midpoint triangulation of the common landmarks (scale gauge:
   unit baseline).
2. **Tracking** — frames are localized in windows of ``ba_interval`` frames
   against the map frozen at the window start: robust PnP chained frame to
   frame (motion-model init from the previous pose), then one batched
   triangulation of every landmark that became two-view observable in the
   window; one host fetch per window.
3. **Windowed BA** — Schur-complement bundle adjustment refines the
   trailing window (older poses frozen); a final global BA refines
   everything (first pose fixed, Huber robust), pruning outliers between
   rounds.

Orchestration runs on the host in numpy, as in the JAX package: the
per-frame bookkeeping is sequential. The numerics (RANSAC, PnP,
triangulation, BA, pose graph, matching) are the port's tensor functions on
the device the entry point resolves (``core/device.py``).

**Precision.** The JAX package runs its back end in float32 on its chip and
in float64 in its tests, by a global switch. Here ``dtype`` says it:
``torch.float32`` (the default) or ``torch.float64``. The JAX code's
explicit float32 casts stay where they are: the map points and window
pixels handed to PnP and triangulation, and the rays of every pair
verification and loop-edge measurement, are rounded to float32. Where
JAX then mixes them with ``dtype`` values it computes in ``dtype``, which
is what the port does; the pair verification and the loop-edge
measurement see only float32 inputs, so their RANSAC runs in float32
whatever ``dtype`` is, in both packages.

**RANSAC draws.** Each RANSAC call is seeded with the integer the JAX
package keys it with (0 at bootstrap, ``f`` for the pair ``(f-1, f)``,
``10_000 + p`` for loop pair ``p``, ``a·100_003 + b`` for a loop edge), in a
CPU ``torch.Generator``, so a card run and a CPU run draw the same
hypotheses. The pads that fix a draw's slot count are the JAX package's.

**What each solve sees.** The JAX package pads the map to a power-of-two
bucket of the track count and hands every BA all tracks, so that a few
compiled programs serve every window. Here a window's PnP sees only the
mapped landmarks the window sees, and a BA only the landmarks its
observations name (renumbered in order): the same systems, but their
arithmetic no longer depends on how many tracks exist. Descriptor matching
and pair verification are mapped over frame pairs, as in the JAX package,
but in dispatches of a fixed ``PAIR_GROUP`` pairs at a capacity the
configuration fixes, so that a pair's result does not depend on how many
pairs a run handles. A streaming session, whose track count grows from step
to step and which matches a few pairs a step, therefore computes each
window as the batch run does, bit for bit.

**Over a mesh.** With a ``mesh`` of ``parallel/`` every rank runs the
whole pipeline on the same inputs: the frontend data-parallel, the window
and loop matching query-sharded, and each BA of at least
``SlamConfig.dist_ba_min_landmarks`` landmarks landmark-sharded, each
gathered or reduced so that every rank holds the same result. Everything
else (RANSAC seeds, the pose gate, pruning, the BA schedule) is host numpy
that every rank computes alike, so the ranks stay in step.

Data association is an input (per-frame ``(landmark_id, pixel)`` pairs):
exact with the synthetic generator, from descriptor matching with the image
frontend (:func:`build_tracks_from_images`).
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext

import numpy as np
import torch

from ..core.device import Device, on_device, require_full_float32_matmul, resolve_device
from ..ops.matching import match_descriptors
from ..ops.ransac import essential_from_samples, estimate_essential_ransac
from ..parallel.distributed import (
    all_gather_rows,
    detect_and_describe_data_parallel,
    distributed_bundle_adjust,
)
from ..parallel.multihost import mesh_device, mesh_group
from ..sfm import geometry as geo
from ..sfm.ba import BAState, Observations, bundle_adjust, reprojection_residuals
from ..sfm.evaluate import absolute_trajectory_error
from ..sfm.pnp import solve_pnp
from ..sfm.pose_graph import PoseGraphEdges, optimize_pose_graph
from ..utils.checkpoint import checkpoint_exists, restore_checkpoint_flat, save_checkpoint
from .frontend import detect_and_describe_batched


@dataclasses.dataclass
class SlamConfig:
    ba_interval: int = 5  # run windowed BA every N frames
    ba_window: int = 8  # trailing keyframes optimized in windowed BA
    ba_iterations: int = 6
    final_ba_iterations: int = 15
    final_ba_rounds: int = 2  # BA+prune rounds (2nd re-solves after prune)
    huber_px: float = 2.0
    pnp_iterations: int = 10
    ransac_hypotheses: int = 256
    ransac_threshold_px: float = 1.5
    min_triangulation_deg: float = 1.0  # parallax gate for new landmarks
    # Pose-graph step before the final BA: odometry edges between
    # consecutive frames plus loop-closure edges between distant frame
    # pairs that co-observe enough landmarks. Loop edges are MEASURED (see
    # measure_loop_edge), independent of the drifting estimates except for
    # the monocular scale.
    use_pose_graph: bool = False
    loop_min_covisible: int = 12
    loop_min_frame_gap: int = 5
    loop_max_edges: int = 16  # highest-covisibility pairs get fresh solves
    # Monocular bootstrap pair = frames (0, bootstrap_baseline). Wider
    # baselines give proportionally more parallax to the essential-matrix
    # init; frames 1..k-1 are localized by the windowed PnP against the
    # bootstrap map.
    bootstrap_baseline: int = 1
    # Catastrophic-pose gate: a windowed-PnP pose whose camera-centre step
    # exceeds ``pose_jump_gate`` x the rolling median inter-frame step is
    # rejected — the frame holds the previous pose and records no
    # observations, so a garbage pose can neither enter BA nor poison later
    # triangulations. Scale-free (a ratio of estimated steps). 0 disables.
    pose_jump_gate: float = 25.0
    # Minimum landmark count before a BA goes through the landmark-sharded
    # solver on a mesh (run_slam._ba). The JAX package compares it with the
    # map padded to a power-of-two bucket of the track count; here a BA sees
    # only the landmarks its observations name (see the module), and the
    # threshold is compared with that count.
    dist_ba_min_landmarks: int = 4096
    # Run the windowed BA every N tracking windows (1 = every window). The
    # final window always runs BA.
    ba_every: int = 1


@dataclasses.dataclass
class SlamResult:
    rotations: np.ndarray  # (F, 3, 3) estimated world→camera
    translations: np.ndarray  # (F, 3)
    points: np.ndarray  # (L, 3) map landmarks (NaN where never seen)
    landmark_valid: np.ndarray  # (L,) bool
    num_observations: int


def _target(device: Device, mesh=None) -> torch.device:
    """The device an entry point works on: the card unless ``device`` names
    another, and an error where there is no card (``core/device.py``). A
    ``mesh`` must lie on a device of the same type."""
    target = resolve_device(torch.empty(0), device)
    if mesh is not None and mesh.device_type != target.type:
        raise ValueError(
            f"a {mesh.device_type!r} mesh cannot serve a run on {target}: make the "
            "mesh on the device type the run asks for"
        )
    return target


def _generator(seed: int) -> torch.Generator:
    """The draw of one RANSAC call (see the module), on the CPU."""
    return torch.Generator().manual_seed(int(seed))


def _prof_iter(iterable, st, name):
    """Wrap each loop-body execution of ``iterable`` in a profile stage.

    The ``with`` around ``yield`` times from just before the yield until
    control re-enters the generator — exactly the caller's loop body.
    """
    for item in iterable:
        with st(name):
            yield item


def _sorted_pad(lm: np.ndarray, valid: np.ndarray | None = None) -> int:
    """Power-of-two bound on the valid observations of one landmark, passed
    as ``bundle_adjust(sorted_pad=...)`` so the sorted assembly's padded
    table is sized to the data instead of the number of cameras."""
    if valid is not None:
        lm = lm[valid]
    if len(lm) == 0:
        return 1
    m = int(np.bincount(lm).max())
    return 1 << max(0, (m - 1).bit_length())


def _pad_obs(cam, lm, uv, valid, device, dtype) -> Observations:
    """Observation buffers padded to the next power-of-two bucket (the JAX
    package's compile-cache buckets, kept so both solve the same system)."""
    n = len(cam)
    pad = (1 << max(8, (n - 1).bit_length())) - n
    return Observations(
        camera=torch.as_tensor(np.pad(cam, (0, pad)), dtype=torch.int32, device=device),
        landmark=torch.as_tensor(np.pad(lm, (0, pad)), dtype=torch.int32, device=device),
        uv=torch.as_tensor(np.pad(uv, ((0, pad), (0, 0))), dtype=dtype, device=device),
        valid=torch.as_tensor(np.pad(valid, (0, pad)), device=device),
    )


def _f32(array, device, dtype) -> torch.Tensor:
    """``array`` rounded to float32, as a ``dtype`` tensor (see the module)."""
    return torch.as_tensor(np.asarray(array, np.float32), device=device).to(dtype)


def measure_loop_edge(
    pixels: np.ndarray,
    visible: np.ndarray,
    k_mat: np.ndarray,
    est_r: np.ndarray,
    est_t: np.ndarray,
    frame_a: int,
    frame_b: int,
    cfg: SlamConfig,
    device: Device = None,
    dtype: torch.dtype = torch.float32,
):
    """Fresh two-view relative-pose measurement for a loop edge a→b.

    Essential-matrix RANSAC over the pair's co-observed pixel rays yields
    the relative rotation and translation *direction* independently of the
    trajectory estimate; only the monocular scale (unobservable from two
    views) is borrowed from the estimate's baseline. Returns ``(rel_r
    (3,3), rel_t (3,))`` in the pose-graph edge convention (``T_b ≈ T_ab ∘
    T_a`` for world→camera poses), or ``None`` when the pair has too few
    co-observations or too little RANSAC support. ``device``: see
    ``core/device.py``; ``dtype`` is that of the ray computation, the RANSAC
    runs in float32 (see the module).
    """
    target = _target(device)
    ids = np.where(visible[frame_a] & visible[frame_b])[0]
    min_pts = max(8, cfg.loop_min_covisible)
    if len(ids) < min_pts:
        return None
    k_t = torch.as_tensor(k_mat, dtype=dtype, device=target)
    fx = float(k_mat[0, 0])
    rays = [
        geo.backproject(torch.as_tensor(pixels[f, ids], dtype=dtype, device=target), k_t)
        .to(torch.float32)
        for f in (frame_a, frame_b)
    ]
    cap = 1 << max(6, (len(ids) - 1).bit_length())
    pad = cap - len(ids)
    res = estimate_essential_ransac(
        torch.nn.functional.pad(rays[0], (0, 0, 0, pad)),
        torch.nn.functional.pad(rays[1], (0, 0, 0, pad)),
        torch.arange(cap, device=target) < len(ids),
        _generator(frame_a * 100_003 + frame_b),
        num_hypotheses=cfg.ransac_hypotheses,
        inlier_threshold=cfg.ransac_threshold_px / fx,
        device=target,
    )
    if int(res.num_inliers) < min_pts // 2:
        return None
    rel_r = res.rotation.cpu().numpy().astype(np.float64)
    t_dir = res.translation.cpu().numpy().astype(np.float64)
    # Monocular two-view geometry fixes only the translation direction
    # (cheirality fixes its sign); the scale comes from the estimated
    # baseline of the pair — the one quantity a loop edge cannot measure.
    rel_t_est = est_t[frame_b] - (est_r[frame_b] @ est_r[frame_a].T) @ est_t[frame_a]
    return rel_r, t_dir * float(np.linalg.norm(rel_t_est))


def run_slam(
    pixels: np.ndarray,
    visible: np.ndarray,
    k_mat: np.ndarray,
    cfg: SlamConfig | None = None,
    mesh=None,
    checkpoint_dir: str | None = None,
    checkpoint_interval: int = 10,
    resume: bool = False,
    _stop_after: int | None = None,
    profile=None,
    device: Device = None,
    dtype: torch.dtype = torch.float32,
) -> SlamResult:
    """Run incremental SLAM over per-frame measurements.

    ``pixels``: (F, L, 2) pixel measurement of landmark l in frame f;
    ``visible``: (F, L) bool association mask. Landmark ids are global (as
    descriptor-track ids would be after matching).

    ``mesh``: a ``DeviceMesh`` of ``parallel/`` routes every bundle
    adjustment of at least ``cfg.dist_ba_min_landmarks`` landmarks through
    the landmark-sharded solver (``parallel/distributed.py``); every rank
    passes the same inputs and gets the same result. ``None`` runs every
    BA on this device alone.

    ``checkpoint_dir`` enables periodic persistence of the full SLAM state
    (poses, map, observations) every ``checkpoint_interval`` frames, in the
    npz + JSON format of ``utils/checkpoint.py`` (or a ``mem://`` store);
    ``resume=True`` restores the latest checkpoint and continues
    mid-sequence — a checkpoint written by the JAX package resumes here too.
    ``_stop_after`` aborts after processing that frame index (fault
    injection for the resume tests, and the streaming session's step); the
    final BA is skipped for a stopped run. ``profile``: an optional
    :class:`~..utils.profile.StageProfile` that records per-stage
    wall-clock (syncing at stage boundaries — attribution, not headline
    speed). ``device``: see ``core/device.py``; ``dtype``: see the module.
    """
    cfg = cfg or SlamConfig()
    target = _target(device, mesh)
    require_full_float32_matmul(target)

    def _st(name):
        return profile.stage(name) if profile is not None else nullcontext()

    def tensor(array, dt=None):
        return torch.as_tensor(np.asarray(array), device=target).to(dt or dtype)

    def fetch(*values):
        return [v.cpu().numpy() for v in values]

    num_frames, num_landmarks = visible.shape
    k_t = tensor(k_mat)
    fx = k_mat[0, 0]

    def _ba(state, obs, num_iterations, num_fixed_cameras, sorted_pad=0):
        # Shard the landmark block only when it is large enough to pay for
        # the reductions over the ranks (the JAX package measured composed
        # SLAM 0.47x as fast with every small windowed BA sharded).
        if mesh is not None and state.points.shape[0] >= cfg.dist_ba_min_landmarks:
            return distributed_bundle_adjust(
                state,
                obs,
                mesh,
                num_iterations=num_iterations,
                num_fixed_cameras=num_fixed_cameras,
                huber_delta=cfg.huber_px,
            )
        return bundle_adjust(
            state,
            obs,
            num_iterations=num_iterations,
            num_fixed_cameras=num_fixed_cameras,
            huber_delta=cfg.huber_px,
            sorted_pad=sorted_pad,
            device=target,
        )

    def _ba_problem(rotations, translations, cam, lm, uv, valid):
        """The BA state and observations over the landmarks ``lm`` names
        (renumbered in order), and those landmarks' ids."""
        ids, local = np.unique(lm, return_inverse=True)
        state = BAState(
            rotations=tensor(rotations),
            translations=tensor(translations),
            points=tensor(points[ids]),
            k_mat=k_t,
        )
        return state, _pad_obs(cam, local, uv, valid, target, dtype), ids

    def _store_points(ids, upd):
        keep = lm_valid[ids]
        points[ids[keep]] = upd[keep]

    est_r = np.zeros((num_frames, 3, 3))
    est_t = np.zeros((num_frames, 3))
    points = np.full((num_landmarks, 3), np.nan)
    lm_valid = np.zeros(num_landmarks, bool)
    first_seen_kf = np.full(num_landmarks, -1, np.int64)

    # Observation buffers: lists of ARRAYS (one per batch append),
    # concatenated lazily.
    obs_cam: list[np.ndarray] = []
    obs_lm: list[np.ndarray] = []
    obs_uv: list[np.ndarray] = []

    def _obs_arrays():
        if not obs_cam:
            return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros((0, 2))
        return np.concatenate(obs_cam), np.concatenate(obs_lm), np.concatenate(obs_uv)

    def _save_ckpt(frame: int) -> None:
        if checkpoint_dir is None:
            return
        oc, ol, ouv = _obs_arrays()
        save_checkpoint(
            checkpoint_dir,
            {
                "frame": np.asarray(frame),
                "est_r": est_r,
                "est_t": est_t,
                "points": points,
                "lm_valid": lm_valid,
                "first_seen_kf": first_seen_kf,
                "obs_cam": oc,
                "obs_lm": ol,
                "obs_uv": ouv,
                "recent_steps": np.asarray(recent_steps, np.float64),
            },
            step=None,  # single rolling checkpoint
        )

    resume_frame = -1
    resumed_steps = None
    if resume and checkpoint_dir is not None:
        state_path = checkpoint_dir.rstrip("/") + "/state"
        if checkpoint_exists(state_path):
            ck = restore_checkpoint_flat(state_path)
            resume_frame = int(ck["frame"])
            # Prefix assignment: the live arrays may be LARGER than at
            # checkpoint time — the streaming session appends frames and
            # opens new tracks between resumes; ids are append-only, so rows
            # beyond the checkpoint keep their init values.
            fr = ck["est_r"].shape[0]
            est_r[:fr] = ck["est_r"]
            est_t[:fr] = ck["est_t"]
            lp = ck["points"].shape[0]
            points[:lp] = ck["points"]
            lm_valid[:lp] = ck["lm_valid"].astype(bool)
            first_seen_kf[:lp] = ck["first_seen_kf"]
            obs_cam = [np.asarray(ck["obs_cam"], np.int64)]
            obs_lm = [np.asarray(ck["obs_lm"], np.int64)]
            obs_uv = [np.asarray(ck["obs_uv"]).reshape(-1, 2)]
            resumed_steps = ck.get("recent_steps")

    # ---- bootstrap from frames (0, kb) (skipped on resume) -------------
    # Frames 1..kb-1 are posed by the windowed PnP below against the
    # bootstrap map; frame kb's observations are recorded by its own window
    # pass.
    kb = max(1, min(cfg.bootstrap_baseline, num_frames - 1))
    if resume_frame < 1:
        ids = np.where(visible[0] & visible[kb])[0]
        rays1 = geo.backproject(tensor(pixels[0, ids]), k_t)
        rays2 = geo.backproject(tensor(pixels[kb, ids]), k_t)
        res = estimate_essential_ransac(
            rays1,
            rays2,
            torch.ones(len(ids), dtype=torch.bool, device=target),
            _generator(0),
            num_hypotheses=cfg.ransac_hypotheses,
            inlier_threshold=float(cfg.ransac_threshold_px / fx),
            device=target,
        )
        est_r[0] = np.eye(3)
        est_t[0] = 0.0
        est_r[kb], est_t[kb], inl = fetch(res.rotation, res.translation, res.inliers)
        tri, depths = geo.triangulate_midpoint(
            tensor(est_r[0]), tensor(est_t[0]), tensor(est_r[kb]), tensor(est_t[kb]),
            rays1, rays2,
        )
        tri, depths = fetch(tri, depths)
        good = inl & np.all(depths > 0.1, axis=-1)
        new_ids = ids[good]
        points[new_ids] = tri[good]
        lm_valid[new_ids] = True
        for f in (0, 1) if kb == 1 else (0,):
            obs_cam.append(np.full(len(new_ids), f, np.int64))
            obs_lm.append(new_ids.astype(np.int64))
            obs_uv.append(pixels[f, new_ids])
        # Every landmark seen at bootstrap records its earliest frame so its
        # first observation enters triangulation/BA later.
        first_seen_kf[visible[0]] = 0
        if kb == 1:
            first_seen_kf[visible[1] & ~visible[0]] = 1
        # kb > 1: the window loop starts at frame 1 and stamps first-seen in
        # frame order.

    # ---- incremental tracking in windows --------------------------------
    # Frames are tracked in windows of ``ba_interval`` frames against the
    # map FROZEN at the window start: one pass (_track_and_map_window)
    # chains the PnP solves through the window AND triangulates every
    # landmark that became two-view observable anywhere in it — the
    # candidate pairs are selected on the host before the pass from
    # visibility bookkeeping alone — with one host fetch per window; then
    # the windowed BA runs once.
    win = max(1, cfg.ba_interval)

    # Rolling inter-frame camera-centre steps of ACCEPTED tracked frames
    # (pose_jump_gate); seeded with the bootstrap pair's per-frame step. A
    # resume restores them from the checkpoint, which makes it exact: the
    # JAX package checkpoints no steps and re-seeds them from the
    # checkpointed (BA-refined) trajectory, as the port does for such a
    # checkpoint, and the gate can then decide otherwise than the
    # uninterrupted run (ROADMAP.md §3).
    recent_steps: list[float] = []
    if resume_frame < 1:
        c_kb = -est_r[kb].T @ est_t[kb]
        recent_steps.append(float(np.linalg.norm(c_kb)) / kb)
    elif resumed_steps is not None:
        recent_steps = [float(v) for v in resumed_steps]
    else:
        for f in range(max(1, resume_frame - 11), resume_frame + 1):
            c0 = -est_r[f - 1].T @ est_t[f - 1]
            c1 = -est_r[f].T @ est_t[f]
            s_len = float(np.linalg.norm(c1 - c0))
            if s_len > 0.0:
                recent_steps.append(s_len)

    start_f = max(1 if kb > 1 else 2, resume_frame + 1)
    for base in range(start_f, num_frames, win):
        end = min(base + win, num_frames)  # exclusive
        w_act = end - base
        vis_w = visible[base:end]  # (w_act, L)

        mask_w = vis_w & lm_valid[None, :]
        counts = mask_w.sum(axis=1)

        # Candidate selection BEFORE the pass: a PREVIEW first-seen stamp
        # (assuming no frame gets gated) picks the pairs; the authoritative
        # update below applies gating, and candidates whose preview
        # disagrees are dropped after the fetch.
        fs_prev = first_seen_kf.copy()
        for i_f, f in enumerate(range(base, end)):
            fs_prev[vis_w[i_f] & (fs_prev < 0)] = f
        any_vis_prev = vis_w.any(axis=0)
        last_prev = base + (w_act - 1) - np.argmax(vis_w[::-1], axis=0)
        cand = np.where(~lm_valid & (fs_prev >= 0) & any_vis_prev & (last_prev > fs_prev))[0]
        n_cand = len(cand)
        cap = 1 << max(5, (max(n_cand, 1) - 1).bit_length())
        f0s = fs_prev[cand]
        f1s = last_prev[cand]
        a_in_win = np.zeros(cap, bool)
        a_in_win[:n_cand] = f0s >= base
        a_idx = np.zeros(cap, np.int64)
        a_idx[:n_cand] = np.maximum(f0s - base, 0)
        b_idx = np.zeros(cap, np.int64)
        b_idx[:n_cand] = f1s - base
        r_a_ext = np.broadcast_to(np.eye(3), (cap, 3, 3)).copy()
        t_a_ext = np.zeros((cap, 3))
        ext_rows = np.where(~a_in_win[:n_cand])[0]
        r_a_ext[ext_rows] = est_r[f0s[ext_rows]]
        t_a_ext[ext_rows] = est_t[f0s[ext_rows]]
        uv_a = np.zeros((cap, 2), np.float32)
        uv_b = np.zeros((cap, 2), np.float32)
        uv_a[:n_cand] = pixels[f0s, cand]
        uv_b[:n_cand] = pixels[f1s, cand]

        # The PnP leg sees the mapped landmarks the window sees, and nothing
        # of the rest of the map (see the module).
        seen = np.flatnonzero(mask_w.any(axis=0))

        with _st("pnp_tri"):
            rs, ts, tri, depths = _track_and_map_window(
                _f32(np.nan_to_num(points[seen], nan=1.0), target, dtype),
                _f32(pixels[base:end, seen], target, dtype),
                torch.as_tensor(mask_w[:, seen], device=target),
                k_t,
                tensor(est_r[base - 1]),
                tensor(est_t[base - 1]),
                _f32(r_a_ext, target, dtype),
                _f32(t_a_ext, target, dtype),
                torch.as_tensor(a_in_win, device=target),
                torch.as_tensor(a_idx, device=target),
                torch.as_tensor(b_idx, device=target),
                _f32(uv_a, target, dtype),
                _f32(uv_b, target, dtype),
                iterations=cfg.pnp_iterations,
                huber_delta=cfg.huber_px,
            )
            r_h, t_h, p_tri, d_tri = fetch(rs, ts, tri, depths)
        if profile is not None:
            profile.count()

        # --- catastrophic-pose gate (host; see SlamConfig) --------------
        # Sequential so a frame after a rejected one is judged against the
        # HELD (sane) centre, not the garbage one.
        gated = np.zeros(w_act, bool)
        c_prev = -est_r[base - 1].T @ est_t[base - 1]
        for i_f, f in enumerate(range(base, end)):
            c_new = -r_h[i_f].T @ t_h[i_f]
            step_len = float(np.linalg.norm(c_new - c_prev))
            med = float(np.median(recent_steps)) if len(recent_steps) >= 3 else None
            if (
                cfg.pose_jump_gate > 0
                and med is not None
                and step_len > cfg.pose_jump_gate * max(med, 1e-12)
            ):
                gated[i_f] = True
                est_r[f] = est_r[f - 1]
                est_t[f] = est_t[f - 1]
            else:
                est_r[f] = r_h[i_f]
                est_t[f] = t_h[i_f]
                if counts[i_f] >= 6 and step_len > 0.0:
                    recent_steps.append(step_len)
                    del recent_steps[:-12]
                c_prev = c_new

        # Lost frames (<6 mapped landmarks: pose merely held, never solved)
        # are excluded from mapping exactly like gated ones.
        excluded = gated | (counts < 6)

        # --- record observations of mapped landmarks -------------------
        with _st("obs_record"):
            for i_f, f in enumerate(range(base, end)):
                if excluded[i_f]:
                    continue  # lost/rejected frame: pose held, no obs
                ids = np.where(mask_w[i_f])[0]
                obs_cam.append(np.full(len(ids), f, np.int64))
                obs_lm.append(ids.astype(np.int64))
                obs_uv.append(pixels[f, ids])

        # --- first-seen bookkeeping, in frame order --------------------
        # Gated/lost frames are invisible to mapping: their held pose must
        # not anchor a future triangulation.
        vis_eff = vis_w if not excluded.any() else vis_w & ~excluded[:, None]
        for i_f, f in enumerate(range(base, end)):
            if excluded[i_f]:
                continue
            first_seen_kf[vis_eff[i_f] & (first_seen_kf < 0)] = f

        # --- map insertion from the window's triangulation -------------
        # Candidate = landmark not yet in the map, first seen at f0, visible
        # again at some window frame > f0; pair (f0, last visible window
        # frame) maximizes baseline.
        if n_cand > 0:
            p = p_tri[:n_cand]
            depths_h = d_tri[:n_cand]
            # Drop candidates that touched a gated frame, or whose preview
            # first-seen stamp was reverted by the gating-aware update.
            ok = ~excluded[f1s - base]
            inw = np.where(a_in_win[:n_cand])[0]
            ok[inw] &= ~excluded[a_idx[inw]]
            ok &= first_seen_kf[cand] == f0s
            # Parallax gate: rays must subtend enough angle.
            c_a = -np.einsum("nji,nj->ni", est_r[f0s], est_t[f0s])
            c_b = -np.einsum("nji,nj->ni", est_r[f1s], est_t[f1s])
            d_a = p - c_a
            d_b = p - c_b
            cosang = np.sum(d_a * d_b, axis=-1) / np.maximum(
                np.linalg.norm(d_a, axis=-1) * np.linalg.norm(d_b, axis=-1), 1e-9
            )
            ang_ok = cosang < np.cos(np.radians(cfg.min_triangulation_deg))
            good = ok & np.all(depths_h > 0.1, axis=-1) & ang_ok
            add = cand[good]
            points[add] = p[good]
            lm_valid[add] = True
            for fs in (f0s[good], f1s[good]):
                obs_cam.append(fs.astype(np.int64))
                obs_lm.append(add.astype(np.int64))
                obs_uv.append(pixels[fs, add])

        # --- windowed BA (every ``ba_every`` windows + final window) ---
        # Window index on the GLOBAL grid (first window starts at 1 with a
        # wide bootstrap, else 2) so ba_every keeps the same phase across
        # checkpoint resumes. The end-of-data window forces BA only for a
        # true final window (not a fault-injection or streaming step).
        win_index = (base - (1 if kb > 1 else 2)) // win
        every = max(1, cfg.ba_every)
        ba_due = (win_index % every) == (every - 1) or (
            end == num_frames and _stop_after is None
        )
        n_obs = sum(len(a) for a in obs_cam)
        if ba_due and n_obs > 30:
            with _st("ba_windowed"):
                f = end - 1
                fixed = max(1, f + 1 - cfg.ba_window)
                lm_cat = np.concatenate(obs_lm)
                state, obs, ids = _ba_problem(
                    est_r[: f + 1], est_t[: f + 1], np.concatenate(obs_cam), lm_cat,
                    np.concatenate(obs_uv), np.ones(n_obs, bool),
                )
                refined, _ = _ba(
                    state, obs, cfg.ba_iterations, fixed, sorted_pad=_sorted_pad(lm_cat)
                )
                r_h, t_h, upd = fetch(refined.rotations, refined.translations, refined.points)
                est_r[: f + 1] = r_h
                est_t[: f + 1] = t_h
                _store_points(ids, upd)
            if profile is not None:
                profile.count()

        if checkpoint_dir is not None and (
            (end - 1) // checkpoint_interval > (base - 1) // checkpoint_interval
            or end == num_frames
        ):
            _save_ckpt(end - 1)
        if _stop_after is not None and end - 1 >= _stop_after:
            # Fault injection: persist and abort at the window boundary.
            _save_ckpt(end - 1)
            return SlamResult(
                rotations=est_r,
                translations=est_t,
                points=points,
                landmark_valid=lm_valid,
                num_observations=sum(len(a) for a in obs_cam),
            )

    # ---- optional pose-graph optimization -----------------------------
    if cfg.use_pose_graph and num_frames >= 3:
        # Odometry edges carry the BA-refined consecutive relative poses.
        # Loop edges are MEASURED: the highest-covisibility distant pairs
        # each get a fresh essential-matrix RANSAC over their co-observed
        # pixels (measure_loop_edge).
        src, dst, rel_r, rel_t, wgt = [], [], [], [], []

        def add_edge(a, b, weight):
            ra_inv = est_r[a].T
            ta_inv = -ra_inv @ est_t[a]
            src.append(a)
            dst.append(b)
            rel_r.append(est_r[b] @ ra_inv)
            rel_t.append(est_r[b] @ ta_inv + est_t[b])
            wgt.append(weight)

        for f in range(num_frames - 1):
            add_edge(f, f + 1, 1.0)
        covis = visible.astype(np.int32) @ visible.astype(np.int32).T
        pairs = [
            (int(covis[a, b]), a, b)
            for a in range(num_frames)
            for b in range(a + cfg.loop_min_frame_gap, num_frames)
            if covis[a, b] >= cfg.loop_min_covisible
        ]
        pairs.sort(reverse=True)
        for _, a, b in pairs[: cfg.loop_max_edges]:
            edge = measure_loop_edge(
                pixels, visible, k_mat, est_r, est_t, a, b, cfg, device=target, dtype=dtype
            )
            if edge is None:
                continue
            src.append(a)
            dst.append(b)
            rel_r.append(edge[0])
            rel_t.append(edge[1])
            wgt.append(0.5)

        edges = PoseGraphEdges(
            src=tensor(src, torch.int32),
            dst=tensor(dst, torch.int32),
            rel_rotation=tensor(np.stack(rel_r)),
            rel_translation=tensor(np.stack(rel_t)),
            weight=tensor(wgt),
        )
        opt_r, opt_t, _ = optimize_pose_graph(tensor(est_r), tensor(est_t), edges, device=target)
        est_r, est_t = (a.astype(np.float64) for a in fetch(opt_r, opt_t))

    # ---- final global BA with outlier pruning -------------------------
    oc, ol, ouv = _obs_arrays()
    n_obs_total = len(oc)
    if n_obs_total > 30:
        obs_valid = np.ones(n_obs_total, bool)
        for _round in _prof_iter(range(cfg.final_ba_rounds), _st, "ba_final"):
            state, obs, ids = _ba_problem(est_r, est_t, oc, ol, ouv, obs_valid)
            refined, _ = _ba(
                state, obs, cfg.final_ba_iterations, 1, sorted_pad=_sorted_pad(ol, obs_valid)
            )
            est_r, est_t, upd, res = fetch(
                refined.rotations, refined.translations, refined.points,
                reprojection_residuals(refined, obs),
            )
            est_r, est_t = est_r.astype(np.float64), est_t.astype(np.float64)
            _store_points(ids, upd)
            # Prune observations whose residual exceeds 3·Huber-δ — Huber
            # only downweights gross outliers, it cannot zero them.
            err = np.linalg.norm(res[:n_obs_total], axis=-1)
            obs_valid = obs_valid & (err < 3.0 * cfg.huber_px)

    return SlamResult(
        rotations=est_r,
        translations=est_t,
        points=points,
        landmark_valid=lm_valid,
        num_observations=n_obs_total,
    )


def _track_and_map_window(
    points,
    pix_w,
    mask_w,
    k_mat,
    r0,
    t0,
    r_a_ext,
    t_a_ext,
    a_in_win,
    a_idx,
    b_idx,
    uv_a,
    uv_b,
    iterations,
    huber_delta,
):
    """One tracking window: chained PnP + triangulation, no host read.

    PnP leg: ``points`` (L, 3) frozen map (invalid slots hold finite filler
    — masked); ``pix_w``: (W, L, 2); ``mask_w``: (W, L) (visible AND in-map
    at window start). Each frame's solve starts from the previous frame's
    pose; a frame with <6 associations holds the previous pose (the
    lost-tracking fallback, a ``torch.where``).

    Triangulation leg: candidate landmark pairs are selected on the host
    before the pass; each candidate's first-seen pose comes from
    ``r_a_ext/t_a_ext`` when the frame precedes the window (``a_in_win``
    False) or from the window's poses at ``a_idx`` otherwise; the last-seen
    pose is always the window pose at ``b_idx``. Candidates touching a frame
    the host-side pose gate later rejects are discarded on the host.
    Returns ``(rs, ts, tri_points, tri_depths)``.
    """
    rs, ts = [], []
    r_prev, t_prev = r0, t0
    for uv, m in zip(pix_w, mask_w):
        r_new, t_new, _ = solve_pnp(
            points, uv, m, k_mat, r_prev, t_prev,
            iterations=iterations, huber_delta=huber_delta, device=points.device,
        )
        ok = m.sum() >= 6
        r_prev = torch.where(ok, r_new, r_prev)
        t_prev = torch.where(ok, t_new, t_prev)
        rs.append(r_prev)
        ts.append(t_prev)
    rs, ts = torch.stack(rs), torch.stack(ts)

    w = rs.shape[0]
    a_c = a_idx.clamp(0, w - 1)
    b_c = b_idx.clamp(0, w - 1)
    r_a = torch.where(a_in_win[:, None, None], rs[a_c], r_a_ext)
    t_a = torch.where(a_in_win[:, None], ts[a_c], t_a_ext)
    rays_a = geo.backproject(uv_a, k_mat)[:, None, :]
    rays_b = geo.backproject(uv_b, k_mat)[:, None, :]
    pts, depths = geo.triangulate_midpoint(r_a, t_a, rs[b_c], ts[b_c], rays_a, rays_b)
    return rs, ts, pts[:, 0], depths[:, 0]


# Frame pairs per batched dispatch of matching and of pair verification. A
# dispatch always holds this many pairs (the last group is filled with pairs
# of no valid slot), so that it has the same shape in a batch run and in a
# streaming step, and a pair's result does not depend on which run, or which
# other pairs, it was dispatched with.
PAIR_GROUP = 8


def _groups(num_pairs):
    """``(lo, real)`` of each dispatch over ``num_pairs`` pairs: the first
    pair and a ``(PAIR_GROUP,)`` host mask of the pairs that exist."""
    for lo in range(0, num_pairs, PAIR_GROUP):
        real = np.arange(lo, lo + PAIR_GROUP) < num_pairs
        yield lo, real


def _match_pairs(desc, valid, frames_a, frames_b, ratio):
    """Matches of the frame pairs ``frames_a[p] → frames_b[p]`` of ``desc``
    (F, S, D) / ``valid`` (F, S): host arrays ``(index, valid)`` of shape
    (P, S) mapping frame-a slots → frame-b slots, in one read each.

    The pairs go ``PAIR_GROUP`` at a time through one mapped
    :func:`~..ops.matching.match_descriptors` (the JAX package maps it over
    all pairs at once); one group's (S, S) distance matrices are the peak
    memory.
    """
    num, s = len(frames_a), desc.shape[1]
    if num == 0:
        return np.zeros((0, s), np.int32), np.zeros((0, s), bool)
    dev = desc.device

    def one(d_a, v_a, d_b, v_b):
        m = match_descriptors(d_a, v_a, d_b, v_b, ratio=ratio, device=dev)
        return m.index, m.valid

    match = torch.func.vmap(one)
    a_all = np.asarray(frames_a, np.int64)
    b_all = np.asarray(frames_b, np.int64)
    index, ok = [], []
    for lo, real in _groups(num):
        a = torch.as_tensor(np.resize(a_all[lo:], PAIR_GROUP) * real, device=dev)
        b = torch.as_tensor(np.resize(b_all[lo:], PAIR_GROUP) * real, device=dev)
        live = torch.as_tensor(real, device=dev)[:, None]
        i, v = match(desc[a], valid[a] & live, desc[b], valid[b] & live)
        index.append(i[: int(real.sum())])
        ok.append(v[: int(real.sum())])
    return torch.cat(index).cpu().numpy(), torch.cat(ok).cpu().numpy()


def _match_consecutive(desc, valid, ratio):
    """Matches of every consecutive frame pair: ``desc``: (F, S, D);
    returns host arrays ``(index, valid)`` of shape (F-1, S) mapping frame
    f-1 slots → frame f slots."""
    f = desc.shape[0]
    return _match_pairs(desc, valid, np.arange(f - 1), np.arange(1, f), ratio)


def _pair_draws(valid: torch.Tensor, num_hypotheses: int, generator: torch.Generator):
    """The sample indices of one pair verification: those of
    :func:`~..ops.ransac.sample_minimal_sets`, with the keys drawn slot by
    slot (``H`` keys a slot) so that a slot's keys do not depend on how many
    padded slots follow it."""
    u = torch.rand(
        (valid.shape[0], num_hypotheses), generator=generator, device=generator.device
    ).to(valid.device).T
    u = torch.where(valid[None, :], u, -1.0)
    return u.sort(dim=1, descending=True, stable=True).indices[:, :8]


def _verify_pairs(uv1, uv2, mask, k_mat, seeds, thr, num_hypotheses, capacity, device):
    """Essential-matrix RANSAC over frame pairs, in float32.

    ``uv1``/``uv2``: (P, PAD, 2) correspondences, each pair's first
    ``mask[p].sum()`` slots valid; ``mask``: (P, PAD); ``seeds``: (P,) the
    draw of each pair; ``capacity`` >= PAD: the slots every solve runs over,
    fixed by the configuration (the frames' descriptor slots). Returns
    (P, PAD) host inlier flags, in one read.

    Each pair draws over its PAD slots (the JAX package's pad, which the
    parity tests' substituted draws need; :func:`_pair_draws` makes the
    draw itself independent of PAD), and the pairs are solved ``PAIR_GROUP``
    at a time by one mapped :func:`~..ops.ransac.essential_from_samples` at
    ``capacity`` slots, as the JAX package maps its verifier over all
    pairs. Neither depends on how many pairs a run verifies, so the
    streaming session's steps verify the batch run's pairs bit for bit. A
    pair of fewer than 8 matches has no model and no inliers.
    """
    num, pad = mask.shape
    if num == 0:
        return np.zeros((0, pad), bool)
    k_t = torch.as_tensor(k_mat, dtype=torch.float32, device=device)
    draws = torch.stack([
        _pair_draws(torch.from_numpy(mask[p]), num_hypotheses, _generator(seed))
        for p, seed in enumerate(seeds)
    ])
    widen = ((0, 0), (0, capacity - pad), (0, 0))
    rays = [
        geo.backproject(torch.as_tensor(np.pad(uv, widen), device=device), k_t)
        for uv in (uv1, uv2)
    ]
    valid = torch.as_tensor(np.pad(mask, widen[:2]), device=device)
    draws = draws.to(device)

    def one(r1, r2, v, idx):
        return essential_from_samples(r1, r2, v, idx, inlier_threshold=thr).inliers

    solve = torch.func.vmap(one)
    inliers = []
    for lo, real in _groups(num):
        sel = torch.as_tensor(np.resize(np.arange(lo, num), PAIR_GROUP), device=device)
        live = torch.as_tensor(real, device=device)[:, None]
        got = solve(rays[0][sel], rays[1][sel], valid[sel] & live, draws[sel])
        inliers.append(got[: int(real.sum())])
    return torch.cat(inliers)[:, :pad].cpu().numpy()


def _capacity(desc) -> int:
    """The slots of a pair verification over frames of ``desc`` (F, S, D): a
    pair has at most S matches; the power of two the JAX package's pad
    reaches at S."""
    return 1 << max(6, (desc.shape[1] - 1).bit_length())


def _frame_sketches(desc, valid):
    """One L2-normalized 128-D place-recognition sketch per frame: the mean
    of the frame's valid descriptors, renormalized (the pooled-descriptor
    global image vector). Cosine similarity between sketches ranks frame
    pairs for loop closure in one (F, 128)·(128, F) product."""
    d = desc * valid[..., None]
    s = d.sum(dim=1) / valid.sum(dim=1, keepdim=True).to(desc.dtype).clamp(min=1.0)
    return s / torch.linalg.norm(s, dim=-1, keepdim=True).clamp(min=1e-9)


def _match_window(desc, valid, query_f, kf_table, ratio, mesh=None):
    """Re-association matches of query frames against keyframes.

    ``query_f``: (Q,) frame indices of the queries; ``kf_table``: (Q, W)
    keyframe indices per query (-1 = unused slot). Returns host arrays
    ``(index, valid)`` of shape (Q, W, S) mapping query slots → keyframe
    slots; an unused slot holds index 0 and no valid match, as a match
    against an empty frame does (:func:`_match_pairs`).

    With a ``mesh`` the queries are split over the ranks, each rank's share
    padded with unused rows to the same count, and the matches gathered: the
    same result, since a pair's matches do not depend on the pairs
    dispatched with it.
    """
    if mesh is not None:
        _, world, rank = mesh_group(mesh)
        num = len(query_f)
        share = -(-num // world)
        pad = share * world - num
        query_f = np.pad(np.asarray(query_f), (0, pad))
        kf_table = np.pad(kf_table, ((0, pad), (0, 0)), constant_values=-1)
        mine = slice(rank * share, (rank + 1) * share)
        got = _match_window(desc, valid, query_f[mine], kf_table[mine], ratio)
        dev = mesh_device(mesh)
        return tuple(
            all_gather_rows(torch.from_numpy(a).to(dev), mesh)[:num].cpu().numpy()
            for a in got
        )
    q, w, s = len(query_f), kf_table.shape[1], desc.shape[1]
    index = np.zeros((q, w, s), np.int32)
    ok = np.zeros((q, w, s), bool)
    rows, cols = np.nonzero(kf_table >= 0)
    got_index, got_ok = _match_pairs(
        desc, valid, np.asarray(query_f)[rows], kf_table[rows, cols], ratio
    )
    index[rows, cols] = got_index
    ok[rows, cols] = got_ok
    return index, ok


def _upload_dtype(images: np.ndarray):
    """Integer frames upload as they are (uint8: 4x, uint16: 2x fewer bytes
    than float32) and are scaled on the device (``models/frontend.py``);
    anything else uploads as float32."""
    dtype = np.asarray(images[:1]).dtype
    return dtype if dtype in (np.uint8, np.uint16) else np.float32


def describe_frames(
    images: np.ndarray,
    sift_cfg,
    frontend_chunk: int = 16,
    profile=None,
    device: Device = None,
    mesh=None,
):
    """``detect_and_describe_batched`` over (F, H, W) frames (uint8,
    uint16, or float in [0, 1]) in chunks of ``frontend_chunk`` frames,
    which bounds peak device memory; the chunks' results concatenated on
    the device. ``device``: see ``core/device.py``. With a ``mesh`` a chunk
    is ``frontend_chunk`` frames a rank, split over the ranks by
    ``detect_and_describe_data_parallel`` (which pads a chunk to a multiple
    of the world size), and every rank gets every frame's result.

    The JAX package pads the tail chunk to the chunk size so that one
    compiled program serves every chunk; eager PyTorch compiles nothing, so
    the tail runs as it is (each image is described on its own, so the
    padding changes no result).
    """
    target = _target(device, mesh)

    def _st(name):
        return profile.stage(name) if profile is not None else nullcontext()

    if mesh is not None:
        frontend_chunk *= mesh_group(mesh)[1]
    up_dtype = _upload_dtype(images)
    parts = []
    for lo in _prof_iter(range(0, images.shape[0], frontend_chunk), _st, "frontend"):
        with _st("frontend_upload"):
            part = torch.from_numpy(
                np.ascontiguousarray(images[lo : lo + frontend_chunk], up_dtype)
            )
            if mesh is None:
                part = part.to(target)
        if mesh is None:
            out = detect_and_describe_batched(part, sift_cfg, device=target)
        else:
            out = detect_and_describe_data_parallel(part, sift_cfg, mesh)
        if profile is not None:
            # Attribution-only sync: splits device compute out of the fetch
            # stage (production runs stay asynchronous until the fetch).
            with _st("frontend_compute"):
                profile.sync(out)
        parts.append(out)
    if len(parts) == 1:
        return parts[0]
    return type(parts[0])(
        **{f.name: torch.cat([getattr(p, f.name) for p in parts])
           for f in dataclasses.fields(parts[0])}
    )


def build_tracks_from_images(
    images: np.ndarray,
    sift_cfg,
    k_mat: np.ndarray | None = None,
    match_ratio: float = 0.9,
    max_tracks: int = 4096,
    ransac_threshold_px: float = 2.0,
    reassoc_window: int = 0,
    frontend_chunk: int = 16,
    profile=None,
    max_match_px: float | None = None,
    loop_stride: int = 0,
    loop_min_gap: int = 10,
    loop_min_matches: int = 12,
    loop_query_stride: int = 1,
    loop_topk: int = 8,
    device: Device = None,
    mesh=None,
):
    """Frontend + sequential descriptor matching → landmark tracks.

    ``images``: (F, H, W) grayscale (uint8, uint16, or float in [0, 1]).
    Runs detect+describe (``detect_and_describe_batched``, in chunks of
    ``frontend_chunk`` frames, which bounds peak device memory), matches
    each frame against its predecessor (Lowe ratio + mutual cross-check),
    geometrically verifies each pair with essential-matrix RANSAC when
    ``k_mat`` is given (unverified descriptor matches on synthetic texture
    are about half wrong), and chains the surviving matches into tracks.
    Returns ``(pixels (F, L, 2), visible (F, L))`` ready for
    :func:`run_slam`, plus per-frame keypoint counts for diagnostics.

    ``max_match_px`` enables motion-prior gating: a consecutive-pair match
    is dropped when the keypoints are further apart than this many pixels;
    window re-association matches get the gate scaled by the frame gap.
    ``reassoc_window`` > 0 additionally matches each frame against that many
    older keyframes to re-acquire tracks lost in the immediate predecessor.
    ``loop_stride`` > 0 runs the loop-closure association pass.
    ``device``: see ``core/device.py``; descriptors stay on it, the track
    bookkeeping is host numpy. With a ``mesh`` the frontend runs
    data-parallel and the window and loop matching query-sharded over its
    ranks; the tracks are those of the run without one.

    The frontend is :func:`describe_frames`, the association
    :func:`build_tracks_from_described`.
    """
    target = _target(device, mesh)
    described = describe_frames(images, sift_cfg, frontend_chunk, profile, target, mesh)
    return build_tracks_from_described(
        described, k_mat, match_ratio=match_ratio, max_tracks=max_tracks,
        ransac_threshold_px=ransac_threshold_px, reassoc_window=reassoc_window,
        profile=profile, max_match_px=max_match_px, loop_stride=loop_stride,
        loop_min_gap=loop_min_gap, loop_min_matches=loop_min_matches,
        loop_query_stride=loop_query_stride, loop_topk=loop_topk, device=target,
        mesh=mesh,
    )


def build_tracks_from_described(
    described,
    k_mat: np.ndarray | None = None,
    match_ratio: float = 0.9,
    max_tracks: int = 4096,
    ransac_threshold_px: float = 2.0,
    reassoc_window: int = 0,
    profile=None,
    max_match_px: float | None = None,
    loop_stride: int = 0,
    loop_min_gap: int = 10,
    loop_min_matches: int = 12,
    loop_query_stride: int = 1,
    loop_topk: int = 8,
    device: Device = None,
    mesh=None,
):
    """The association half of :func:`build_tracks_from_images`, from
    described keypoints ``(F, S)`` (a ``DescribedKeypoints``; its arguments
    and result are that function's). ``device``: see ``core/device.py``
    (the card the keypoints lie on, else the default card)."""
    target = resolve_device(described.descriptor, device)
    _target(target, mesh)
    described = on_device(described, target)

    def _st(name):
        return profile.stage(name) if profile is not None else nullcontext()

    with _st("frontend_fetch"):
        valid = described.valid.cpu().numpy()
        xs = described.abs_x.cpu().numpy()
        ys = described.abs_y.cpu().numpy()
        # Descriptors stay on the device: every matching pass reads them
        # there.
    if profile is not None:
        profile.count()

    num_frames = valid.shape[0]
    track_of = np.full(valid.shape, -1, np.int64)  # (F, slots)
    d_all = described.descriptor
    v_all = described.valid
    next_track = chain_frames(
        d_all, v_all, 0, xs, ys, valid, track_of, 0, 0, k_mat, match_ratio, max_tracks,
        ransac_threshold_px, reassoc_window, max_match_px, profile, mesh,
    )

    # --- loop-closure data association (optional) -----------------------
    # Consecutive+window matching can never re-associate a feature with a
    # track last seen many frames ago. This pass is place recognition:
    # every frame past ``loop_min_gap`` is descriptor-matched against a
    # ``loop_stride``-subsampled set of old frames; pairs with enough mutual
    # matches are essential-RANSAC verified, and inlier matches MERGE the
    # two track ids (union-find), giving the back end genuine cross-loop
    # co-observations.
    if loop_stride > 0 and num_frames > loop_min_gap + 1:
        qf = np.arange(loop_min_gap, num_frames, max(1, loop_query_stride))
        n_full = max(1, (num_frames - loop_min_gap + loop_stride - 1) // loop_stride)
        # Compact place recognition: one sketch per frame and one (F, F)
        # cosine-similarity product rank every (query, old frame) pair; only
        # each query's ``loop_topk`` most similar strided candidates get
        # the full descriptor match. ``loop_topk=0`` restores brute force.
        n_cols = n_full if loop_topk <= 0 else min(n_full, loop_topk)
        sim = None
        if 0 < loop_topk < n_full:
            with _st("loop_sketch"):
                require_full_float32_matmul(target)
                sk = _frame_sketches(d_all, v_all)
                sim = (sk @ sk.T).cpu().numpy()
            if profile is not None:
                profile.count()
        kf_table = np.full((len(qf), n_cols), -1, np.int64)
        for i, f in enumerate(qf):
            cands = np.arange(0, f - loop_min_gap + 1, loop_stride)
            if sim is not None and len(cands) > n_cols:
                order = np.argsort(-sim[f, cands], kind="stable")[:n_cols]
                cands = np.sort(cands[order])
            kf_table[i, : min(len(cands), n_cols)] = cands[:n_cols]
        with _st("loop_match"):
            l_idx, l_val = _match_window(d_all, v_all, qf, kf_table, match_ratio, mesh)
        if profile is not None:
            profile.count()
        # Candidate pairs with enough mutual matches for verification.
        cand_pairs = []  # (f, kf, src_slots, dst_slots)
        for i, f in enumerate(qf):
            for c in range(n_cols):
                kf = kf_table[i, c]
                if kf < 0:
                    continue
                src = np.where(l_val[i, c])[0]
                if len(src) >= max(8, loop_min_matches):
                    cand_pairs.append((int(f), int(kf), src, l_idx[i, c, src]))
        if cand_pairs and k_mat is not None:
            cap = 1 << max(6, (max(len(s) for _, _, s, _ in cand_pairs) - 1).bit_length())
            n_p = len(cand_pairs)
            uv1 = np.zeros((n_p, cap, 2), np.float32)
            uv2 = np.zeros((n_p, cap, 2), np.float32)
            msk = np.zeros((n_p, cap), bool)
            for p, (f, kf, src, dst) in enumerate(cand_pairs):
                n = len(src)
                uv1[p, :n, 0] = xs[f, src]
                uv1[p, :n, 1] = ys[f, src]
                uv2[p, :n, 0] = xs[kf, dst]
                uv2[p, :n, 1] = ys[kf, dst]
                msk[p, :n] = True
            with _st("loop_verify"):
                inl = _verify_pairs(
                    uv1, uv2, msk, k_mat, [10_000 + p for p in range(n_p)],
                    ransac_threshold_px / float(k_mat[0, 0]), 256, _capacity(d_all), target,
                )
            if profile is not None:
                profile.count()
            parent = np.arange(next_track, dtype=np.int64)

            def _find(a: int) -> int:
                while parent[a] != a:
                    parent[a] = parent[parent[a]]
                    a = parent[a]
                return a

            for p, (f, kf, src, dst) in enumerate(cand_pairs):
                keep = inl[p, : len(src)]
                # Essential-matrix verification is VACUOUS at near-zero
                # baseline — a loop closure typically revisits a viewpoint,
                # E → 0, and every aliased match passes. A robust
                # displacement-consistency gate keeps matches within 3×MAD
                # (+2 px floor) of the median displacement.
                if not keep.any():
                    continue  # zero RANSAC inliers: no median to gate on
                ddx = xs[f, src] - xs[kf, dst]
                ddy = ys[f, src] - ys[kf, dst]
                mdx, mdy = np.median(ddx[keep]), np.median(ddy[keep])
                dev = np.hypot(ddx - mdx, ddy - mdy)
                mad = np.median(dev[keep])
                keep = keep & (dev <= 3.0 * mad + 2.0)
                if keep.sum() < loop_min_matches:
                    continue
                for s_slot, d_slot in zip(src[keep], dst[keep]):
                    ta = track_of[f, s_slot]
                    tb = track_of[kf, d_slot]
                    if ta < 0 or tb < 0 or ta == tb:
                        continue
                    ra, rb = _find(int(ta)), _find(int(tb))
                    if ra != rb:
                        parent[max(ra, rb)] = min(ra, rb)
            roots = np.array([_find(t) for t in range(next_track)], np.int64)
            uniq, remap = np.unique(roots, return_inverse=True)
            live = track_of >= 0
            track_of[live] = remap[roots[track_of[live]]]
            next_track = len(uniq)

    pixels, visible = tracks_to_arrays(track_of, xs, ys, next_track)
    return pixels, visible, valid.sum(axis=-1)


def chain_frames(
    desc,
    desc_valid,
    desc_base,
    xs,
    ys,
    valid,
    track_of,
    next_track,
    start,
    k_mat,
    match_ratio,
    max_tracks,
    ransac_threshold_px,
    reassoc_window,
    max_match_px,
    profile=None,
    mesh=None,
) -> int:
    """Chain frames ``start ..`` into the tracks of ``track_of`` (F, S) (-1 =
    untracked; frames before ``start`` already chained) and return the new
    track count; the batch run chains every frame at once, the streaming
    session a window at a time, with the same matches, draws and rules.

    ``desc``/``desc_valid``: the frames' descriptors on the device, from
    frame ``desc_base`` on (they must reach back to ``start - 1 -
    reassoc_window``); ``xs``/``ys``/``valid``: (F, S) host arrays. Frame 0
    opens a track for every valid keypoint. Each later frame is matched to
    its predecessor (Lowe ratio + mutual cross-check), the pair verified by
    essential-matrix RANSAC when ``k_mat`` is given (unverified descriptor
    matches on synthetic texture are about half wrong), the keypoints left
    untracked matched against up to ``reassoc_window`` older keyframes, and
    the rest open new tracks up to ``max_tracks``. ``max_match_px``: see
    :func:`build_tracks_from_images`; ``mesh``: the window matching is
    query-sharded over its ranks (:func:`_match_window`).
    """

    def _st(name):
        return profile.stage(name) if profile is not None else nullcontext()

    def _count():
        if profile is not None:
            profile.count()

    num_frames = valid.shape[0]
    if start == 0:
        js = np.where(valid[0])[0][:max_tracks]
        track_of[0, js] = next_track + np.arange(len(js))
        next_track += len(js)
        start = 1
    if start >= num_frames:
        return next_track
    lo = start - 1
    with _st("match_consecutive"):
        cons_idx, cons_val = _match_consecutive(
            desc[lo - desc_base : num_frames - desc_base],
            desc_valid[lo - desc_base : num_frames - desc_base],
            match_ratio,
        )
        if max_match_px is not None:
            # Motion-prior gate: drop matches whose displacement exceeds the
            # per-pair budget (aliased matches on repetitive texture).
            j = np.clip(cons_idx, 0, xs.shape[1] - 1)
            dx = np.take_along_axis(xs[lo + 1 :], j, axis=1) - xs[lo:-1]
            dy = np.take_along_axis(ys[lo + 1 :], j, axis=1) - ys[lo:-1]
            cons_val = cons_val & (dx * dx + dy * dy <= max_match_px**2)
        pair_is = [np.where(ok)[0] for ok in cons_val]
        pair_js = [cons_idx[p, pi] for p, pi in enumerate(pair_is)]
    _count()

    if k_mat is not None:
        counts = [len(pi) for pi in pair_is]
        cap = 1 << max(6, (max(max(counts), 1) - 1).bit_length())
        uv1 = np.zeros((len(pair_is), cap, 2), np.float32)
        uv2 = np.zeros((len(pair_is), cap, 2), np.float32)
        mask = np.zeros((len(pair_is), cap), bool)
        for p, (pi, pj) in enumerate(zip(pair_is, pair_js)):
            n = len(pi)
            uv1[p, :n, 0] = xs[lo + p, pi]
            uv1[p, :n, 1] = ys[lo + p, pi]
            uv2[p, :n, 0] = xs[lo + p + 1, pj]
            uv2[p, :n, 1] = ys[lo + p + 1, pj]
            mask[p, :n] = True
        with _st("ransac_verify"):
            inliers = _verify_pairs(
                uv1, uv2, mask, k_mat, range(start, num_frames),
                ransac_threshold_px / float(k_mat[0, 0]), 256, _capacity(desc), desc.device,
            )
        _count()
        for p, n in enumerate(counts):
            if n >= 8:  # below 8 the model is underdetermined: keep all
                keep = inliers[p, :n]
                pair_is[p] = pair_is[p][keep]
                pair_js[p] = pair_js[p][keep]

    q0 = max(2, start)  # the first frame with an older keyframe
    if reassoc_window > 0 and q0 < num_frames:
        qf = np.arange(q0, num_frames)
        kf_table = np.full((len(qf), reassoc_window), -1, np.int64)
        for i, f in enumerate(qf):
            kfs = range(max(0, f - 1 - reassoc_window), f - 1)
            kf_table[i, : len(kfs)] = list(kfs)
        with _st("match_window"):
            w_idx_all, w_val_all = _match_window(
                desc, desc_valid, qf - desc_base,
                np.where(kf_table >= 0, kf_table - desc_base, -1), match_ratio, mesh,
            )
        _count()

    for f in _prof_iter(range(start, num_frames), _st, "chain_tracks"):
        # Chain matches into existing tracks (the mutual cross-check makes
        # the match one-to-one, so plain fancy indexing is race-free).
        pair_i, pair_j = pair_is[f - start], pair_js[f - start]
        prev_t = track_of[f - 1, pair_i]
        has_track = prev_t >= 0
        track_of[f, pair_j[has_track]] = prev_t[has_track]

        # Window re-association: keypoints the predecessor match left
        # untracked are matched against up to ``reassoc_window`` older
        # frames (most recent wins).
        if reassoc_window > 0 and f >= 2:
            kfs = list(range(max(0, f - 1 - reassoc_window), f - 1))
            # Row f - q0 ↔ query frame f, slots [0:len(kfs)] in the same
            # oldest→newest order.
            w_idx = w_idx_all[f - q0, : len(kfs)]
            w_val = w_val_all[f - q0, : len(kfs)]
            for wk in range(len(kfs) - 1, -1, -1):
                kf = kfs[wk]
                src = np.where(w_val[wk])[0]  # frame-f slots
                dst = w_idx[wk, src]  # matched keyframe slots
                ok = (track_of[f, src] < 0) & (track_of[kf, dst] >= 0)
                if max_match_px is not None:
                    gate = max_match_px * (f - kf)
                    dxy = (xs[f, src] - xs[kf, dst]) ** 2 + (ys[f, src] - ys[kf, dst]) ** 2
                    ok &= dxy <= gate * gate
                track_of[f, src[ok]] = track_of[kf, dst[ok]]
        # Unmatched valid keypoints open new tracks up to capacity.
        js = np.where(valid[f] & (track_of[f] < 0))[0]
        js = js[: max(0, max_tracks - next_track)]
        track_of[f, js] = next_track + np.arange(len(js))
        next_track += len(js)
    return next_track


def tracks_to_arrays(track_of, xs, ys, n_tracks):
    """``(pixels (F, n_tracks, 2), visible (F, n_tracks))`` of the slot →
    track table ``track_of`` (F, S) (-1 = untracked) and the slots' pixel
    positions ``xs``/``ys`` (F, S)."""
    num_frames = track_of.shape[0]
    pixels = np.zeros((num_frames, n_tracks, 2))
    visible = np.zeros((num_frames, n_tracks), bool)
    f_idx, j_idx = np.where(track_of >= 0)
    t_idx = track_of[f_idx, j_idx]
    pixels[f_idx, t_idx, 0] = xs[f_idx, j_idx]
    pixels[f_idx, t_idx, 1] = ys[f_idx, j_idx]
    visible[f_idx, t_idx] = True
    return pixels, visible


def run_slam_from_images(
    images: np.ndarray,
    k_mat: np.ndarray,
    sift_cfg,
    slam_cfg: SlamConfig | None = None,
    match_ratio: float = 0.9,
    mesh=None,
    reassoc_window: int = 0,
    frontend_chunk: int = 16,
    profile=None,
    max_match_px: float | None = None,
    loop_stride: int = 0,
    loop_query_stride: int = 1,
    loop_topk: int = 8,
    device: Device = None,
    dtype: torch.dtype = torch.float32,
    max_tracks: int = 4096,
    **slam_kwargs,
) -> SlamResult:
    """Full visual SLAM: pixels in → trajectory + map out.

    Composes the SIFT frontend (detect+describe, batched), sequential
    descriptor tracking (:func:`build_tracks_from_images`) and the
    incremental geometric back end (:func:`run_slam`). With a ``mesh`` the
    whole pipeline runs over its ranks: the data-parallel frontend, the
    query-sharded window matching and the landmark-sharded BA (see
    :func:`run_slam`). ``slam_kwargs`` forward to :func:`run_slam`
    (checkpointing etc.). ``device``: see ``core/device.py``; ``dtype``: the
    back end's (see the module). ``max_tracks`` is the tracking's room (the
    JAX package fixes it at its default, 4096); once it is full, no new
    track opens.
    """
    target = _target(device, mesh)
    pixels, visible, _ = build_tracks_from_images(
        images, sift_cfg, k_mat=k_mat, match_ratio=match_ratio, max_tracks=max_tracks,
        reassoc_window=reassoc_window, frontend_chunk=frontend_chunk,
        profile=profile, max_match_px=max_match_px, loop_stride=loop_stride,
        loop_query_stride=loop_query_stride, loop_topk=loop_topk, device=target, mesh=mesh,
    )
    return run_slam(
        pixels, visible, k_mat, slam_cfg, mesh=mesh, profile=profile, device=target,
        dtype=dtype, **slam_kwargs,
    )


def evaluate_ate(
    result: SlamResult, gt_rotations, gt_translations, device: Device = None
) -> float:
    """Monocular ATE RMSE (Umeyama-aligned) against ground truth, in
    float64. ``device``: see ``core/device.py``."""
    target = _target(device)

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=target)

    return float(
        absolute_trajectory_error(
            tensor(result.rotations),
            tensor(result.translations),
            tensor(gt_rotations),
            tensor(gt_translations),
        )
    )
