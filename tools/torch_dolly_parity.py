#!/usr/bin/env python3
"""Where the port's SLAM on ``chip_smoke.py`` phase 16's TUM rehearsal parts
from the JAX package's, leg by leg, at the gated association (30 px gate,
re-association window 2) and a given track room.

Run from the repository root (about half an hour at 80 frames and both
track rooms on 8 CPU cores, most of it the JAX package compiling and running
its frontend and its float64 back end; ``--legs`` and ``--max-tracks`` cut
it):

    python3 tools/torch_dolly_parity.py [--frames 80] [--max-tracks 4096 65536] \\
        [--legs a b c d] [--b-stops 41 61 71] [--device cpu|cuda] [--no-jax]

It writes the rehearsal once (``chip_smoke.write_rehearsal_sequence``: 200
frames of ``benchmarks/slam_bench.py``'s dolly, seed 0, 640×480, TUM layout)
under ``build/dolly_parity/``, decodes its first ``--frames`` frames as
``evaluate`` does, and describes them with ``evaluate``'s ``SiftConfig`` (4
octaves × 3 scales, 512 per trio) and ``blur="separable"`` in both packages.
The JAX package runs on the CPU in this process; the port on ``--device``.
For each track room it prints one JSON line per leg:

- (c) each package whole, its own frontend, association and draws: tracks,
  landmarks, observations, ATE, RPE (the port's on ``--device``, and on the
  CPU too where that is the card).
- (a) the association on the same keypoints (the port's, described on the
  CPU and handed to the JAX package in place of its frontend) with the JAX
  package's draws in the port's ``_pair_draws``: whether the track tables
  (``pixels``, ``visible``, per-frame counts) are bit-equal, else the first
  frame, the first track and the first stage that differ there: nearest
  neighbour, ratio test, cross-check and pair verification, each package's
  own function run on the same inputs (the motion gate is one numpy
  expression in both), else re-association or new tracks. Where pair
  verification differs it also prints, for that pair, the slots whose
  verdicts differ with their Sampson errors under each package's final model
  beside the threshold, the hypotheses whose inlier counts differ (the
  minimal solves, before the polish), and how each package's inlier count
  for that pair falls over 40 copies of its correspondences moved by at
  most one float32 ulp each (``perturbed``). ``pinned`` repeats the association
  with the port's pair verification replaced by the JAX package's verdicts
  on the same inputs, which tests every other stage. On ``--device cuda``
  the leg also holds the card's association against the CPU's on the
  card's keypoints (the port's own draws).
- (b) the two back ends on the same tracks (the JAX package's table of leg
  (a)), in float32 with the port's own bootstrap draws and with the JAX
  package's (``ops/ransac.py::sample_minimal_sets``), and in float64 with the
  JAX package's: ATE, landmarks, observations, the first frame whose
  rotations differ by more than 1e-3, the largest rotation and translation
  differences. In float64 also the JAX package against itself with every
  visible pixel one float64 ulp up (the gap rounding alone opens), and with
  ``--b-stops`` both float64 back ends stopped after those frames (the gap
  as the run goes).
- (d) the port whole with the JAX package's draws in both ``_pair_draws`` and
  ``sample_minimal_sets``, beside leg (c)'s JAX run: how much of the gap the
  draw scheme makes.

``--no-jax`` runs the port's legs alone (the card's machine has no usable
JAX package); the legs that need the JAX package are then skipped, with a
line that says so.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

GATE_PX = chip_smoke.SLAM_MATCH_GATE_PX
REASSOC = 2
RATIO = 0.9  # evaluate's --match-ratio
RANSAC_PX = 2.0  # build_tracks_from_images' ransac_threshold_px
HYPOTHESES = 256  # pair verification's, models/slam.py
ROTATION_GAP = 1e-3
PERTURBATIONS = 40  # one-ulp perturbations of a split pair's correspondences


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def load_frames(frames: int):
    """The rehearsal's first ``frames`` frames as ``evaluate`` hands them to
    SLAM, with its intrinsics and truth."""
    import shutil

    from sift_scale_space_extrema_detection_tpu_torch.core.image import pad_to_tpu_friendly
    from sift_scale_space_extrema_detection_tpu_torch.data import tum

    work = os.path.join(ROOT, "build", "dolly_parity")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    size = (chip_smoke.WIDTH, chip_smoke.HEIGHT)
    argv, _, _ = chip_smoke.write_rehearsal_sequence("tum", work, chip_smoke.SURFACE_FRAMES, size)
    seq = tum.load_tum_sequence(argv[0], max_frames=frames)
    images = pad_to_tpu_friendly(seq.load_images())
    shutil.rmtree(work, ignore_errors=True)
    return images, np.asarray(seq.k_mat), seq.gt_rotations, seq.gt_translations


def trajectory_errors(result, gt_r, gt_t) -> dict:
    """ATE and RPE of a result of either package, computed by the port in
    float64 on the CPU, as ``evaluate`` computes them."""
    import torch

    from sift_scale_space_extrema_detection_tpu_torch.sfm.evaluate import (
        absolute_trajectory_error,
        relative_pose_error,
    )

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64)

    est_r, est_t = t(result.rotations), t(result.translations)
    return dict(ate=float(absolute_trajectory_error(est_r, est_t, t(gt_r), t(gt_t))),
                rpe=float(relative_pose_error(est_r, est_t, t(gt_r), t(gt_t))))


def summary(result, gt_r, gt_t, visible=None) -> dict:
    out = dict(landmarks=int(np.asarray(result.landmark_valid).sum()),
               observations=int(result.num_observations), **trajectory_errors(result, gt_r, gt_t))
    if visible is not None:
        out["tracks"] = int(visible.shape[1])
    return out


def pose_gap(a, b, frames=None) -> dict:
    """The first frame whose rotations differ by more than ``ROTATION_GAP``
    (largest entry) and the largest rotation and translation differences,
    over the first ``frames`` frames (default all)."""
    ra, rb, ta, tb = (np.asarray(x)[:frames] for x in (a.rotations, b.rotations,
                                                       a.translations, b.translations))
    dr = np.abs(ra - rb).max(axis=(1, 2))
    dt = np.abs(ta - tb).max(axis=1)
    apart = np.nonzero(dr > ROTATION_GAP)[0]
    scale = float(np.abs(tb).max())
    return dict(first_frame_rotation_apart=int(apart[0]) if len(apart) else None,
                max_rotation_diff=float(dr.max()), max_translation_diff=float(dt.max()),
                largest_translation=scale)


def first_split(got, want):
    """``None`` where two track tables ``(pixels, visible, counts)`` are
    bit-equal, else ``(frame, track)`` of the first difference (a frame of
    -1: the per-frame counts differ)."""
    if not np.array_equal(got[2], want[2]):
        return -1, None
    (gp, gv), (wp, wv) = got[:2], want[:2]
    n = max(gv.shape[1], wv.shape[1])

    def widen(a):
        return np.pad(a, [(0, 0), (0, n - a.shape[1])] + [(0, 0)] * (a.ndim - 2))

    gp, gv, wp, wv = widen(gp), widen(gv), widen(wp), widen(wv)
    bad = (gv != wv) | (gv & (gp != wp).any(axis=-1))
    if not bad.any():
        return None
    f = int(np.nonzero(bad.any(axis=1))[0][0])
    return f, int(np.nonzero(bad[f])[0][0])


class Reference:
    """The JAX package, imported on demand (never by the port)."""

    def __init__(self):
        import jax

        jax.config.update("jax_enable_compilation_cache", False)
        import jax.numpy as jnp

        from sift_scale_space_extrema_detection_tpu import SiftConfig
        from sift_scale_space_extrema_detection_tpu.models import frontend, slam
        from sift_scale_space_extrema_detection_tpu.ops import matching, ransac
        from sift_scale_space_extrema_detection_tpu.ops.descriptor import DescribedKeypoints
        from sift_scale_space_extrema_detection_tpu.sfm import geometry

        self.jax, self.jnp = jax, jnp
        self.slam, self.frontend, self.matching = slam, frontend, matching
        self.ransac, self.geometry = ransac, geometry
        self.described_cls = DescribedKeypoints
        self.sift_cfg = SiftConfig(num_octaves=4, scales_per_octave=3, max_keypoints_per_trio=512)

    def release(self):
        """Drops every compiled program: a long run of JIT compilations
        otherwise exhausts the process's memory mappings (LLVM's "Cannot
        allocate memory")."""
        import gc

        self.jax.clear_caches()
        gc.collect()

    @contextlib.contextmanager
    def x64(self, on: bool):
        before = self.jax.config.jax_enable_x64
        self.jax.config.update("jax_enable_x64", on)
        try:
            yield
        finally:
            self.jax.config.update("jax_enable_x64", before)

    @contextlib.contextmanager
    def given_keypoints(self, described):
        """The JAX package's ``build_tracks_from_images`` on ``described``
        (the port's, numpy) in place of its frontend's keypoints."""
        jnp = self.jnp
        fields = {f.name: jnp.asarray(described[f.name])
                  for f in dataclasses.fields(self.described_cls)}
        saved = self.frontend.detect_and_describe_batched_jit

        def frontend(images, sift_cfg, blur="separable"):
            return self.described_cls(**fields)

        self.frontend.detect_and_describe_batched_jit = frontend
        try:
            yield
        finally:
            self.frontend.detect_and_describe_batched_jit = saved

    def describe(self, images, chunk):
        """The JAX package's own keypoints of ``images``, numpy, described as
        its ``build_tracks_from_images`` describes them: chunks of
        ``chunk`` frames, the tail padded to the chunk."""
        parts = []
        for lo in range(0, images.shape[0], chunk):
            part = images[lo : lo + chunk]
            n = part.shape[0]
            if lo:
                part = np.concatenate([part, np.zeros((chunk - n,) + part.shape[1:], part.dtype)])
            out = self.frontend.detect_and_describe_batched_jit(
                self.jnp.asarray(part), self.sift_cfg, "separable")
            parts.append({f.name: np.asarray(getattr(out, f.name))[:n]
                          for f in dataclasses.fields(out)})
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def tracks(self, described, k_mat, max_tracks):
        """The JAX package's association of ``described`` keypoints (numpy)."""
        kw = dict(match_ratio=RATIO, max_tracks=max_tracks, reassoc_window=REASSOC,
                  max_match_px=GATE_PX, blur="separable")
        frames = described["valid"].shape[0]
        with self.given_keypoints(described):
            # One chunk: the injected keypoints are the whole sequence's.
            return self.slam.build_tracks_from_images(
                np.zeros((frames, 1, 1), np.float32), self.sift_cfg, k_mat,
                frontend_chunk=frames, **kw)

    def run_slam(self, pixels, visible, k_mat, slam_cfg, **kw):
        return self.slam.run_slam(pixels, visible, k_mat,
                                  self.slam.SlamConfig(**dataclasses.asdict(slam_cfg)), **kw)

    def draws(self):
        """The JAX package's sample indices, as a stand-in for the port's
        ``_pair_draws`` and ``sample_minimal_sets``."""
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from torch_port_helpers import jax_ransac_draws

        return jax_ransac_draws


@contextlib.contextmanager
def patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def stage_report(ref, described, k_mat, f, jax_draws, gate_px=GATE_PX):
    """Each stage's outputs at the frame pair ``f-1 → f`` in both packages,
    on the same inputs (``gate_px``: the motion gate, None for none);
    returns the first stage that differs and its evidence."""
    import torch

    from sift_scale_space_extrema_detection_tpu_torch.models import slam as pslam
    from sift_scale_space_extrema_detection_tpu_torch.ops import matching as pmatch
    from sift_scale_space_extrema_detection_tpu_torch.ops import ransac as pransac
    from sift_scale_space_extrema_detection_tpu_torch.sfm import geometry as pgeo

    jnp = ref.jnp
    desc, valid = described["descriptor"], described["valid"]
    xs, ys = described["abs_x"], described["abs_y"]
    a, b = f - 1, f

    # Matching, split into its tests: nearest neighbour, ratio test,
    # cross-check.
    jm = [ref.matching.match_descriptors(jnp.asarray(desc[a]), jnp.asarray(valid[a]),
                                         jnp.asarray(desc[b]), jnp.asarray(valid[b]),
                                         ratio=RATIO, mutual=m) for m in (False, True)]
    pm = [pmatch.match_descriptors(torch.from_numpy(desc[a]), torch.from_numpy(valid[a]),
                                   torch.from_numpy(desc[b]), torch.from_numpy(valid[b]),
                                   ratio=RATIO, mutual=m, device="cpu") for m in (False, True)]
    live = valid[a]
    j_idx, p_idx = np.asarray(jm[0].index), pm[0].index.numpy()
    checks = [
        ("nearest neighbour", live & (j_idx != p_idx)),
        ("ratio test", np.asarray(jm[0].valid) != pm[0].valid.numpy()),
        ("cross-check", np.asarray(jm[1].valid) != pm[1].valid.numpy()),
    ]
    for name, bad in checks:
        if bad.any():
            return name, dict(pair=[a, b], slots=np.nonzero(bad)[0][:10].tolist())

    # The motion gate on the (equal) matches: the same numpy expression in
    # both packages.
    idx, ok = j_idx, np.asarray(jm[1].valid)
    dx = xs[b][np.clip(idx, 0, xs.shape[1] - 1)] - xs[a]
    dy = ys[b][np.clip(idx, 0, ys.shape[1] - 1)] - ys[a]
    gated = ok if gate_px is None else ok & (dx * dx + dy * dy <= gate_px**2)
    src = np.nonzero(gated)[0]
    dst = idx[src]

    # Pair verification on the same correspondences.
    n = len(src)
    cap = 1 << max(6, (max(n, 1) - 1).bit_length())
    uv1 = np.zeros((1, cap, 2), np.float32)
    uv2 = np.zeros((1, cap, 2), np.float32)
    mask = np.zeros((1, cap), bool)
    uv1[0, :n] = np.stack([xs[a, src], ys[a, src]], -1)
    uv2[0, :n] = np.stack([xs[b, dst], ys[b, dst]], -1)
    mask[0, :n] = True
    thr = RANSAC_PX / float(k_mat[0, 0])
    key = np.asarray(ref.jax.random.PRNGKey(f))[None]
    j_in = np.asarray(ref.slam._verify_pairs(
        jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask), jnp.asarray(k_mat, jnp.float32),
        jnp.asarray(key), thr, HYPOTHESES))[0]
    with patched(pslam, "_pair_draws", jax_draws):
        p_in = pslam._verify_pairs(uv1, uv2, mask, k_mat, [f], thr, HYPOTHESES,
                                   pslam._capacity(torch.from_numpy(desc)), torch.device("cpu"))[0]
    bad = (j_in != p_in) & mask[0]
    if n >= 8 and bad.any():
        evidence = verification_evidence(ref, uv1[0], uv2[0], mask[0], k_mat, f, thr, jax_draws,
                                          pransac, pgeo)
        evidence["perturbed"] = perturbed_verdicts(
            ref, uv1, uv2, mask, k_mat, f, thr, jax_draws, pslam._capacity(torch.from_numpy(desc)))
        slots = np.nonzero(bad)[0]
        evidence.update(pair=[a, b], matches=n, inliers_jax=int(j_in[:n].sum()),
                        inliers_port=int(p_in[:n].sum()), slots=slots.tolist(),
                        jax_says=j_in[slots].tolist(), port_says=p_in[slots].tolist(),
                        sampson_jax=[evidence["sampson_jax"][s] for s in slots],
                        sampson_port=[evidence["sampson_port"][s] for s in slots])
        return "pair verification", evidence
    return None, {}


def perturbed_verdicts(ref, uv1, uv2, mask, k_mat, f, thr, jax_draws, capacity,
                       trials=PERTURBATIONS):
    """Each package's inlier count for one pair verification over
    ``trials`` copies of its correspondences, each pixel coordinate moved by
    at most one float32 ulp (seeded): how often each count comes out. Where
    a package's verdict moves under such a perturbation, its verdict on the
    unperturbed input is a matter of rounding."""
    import collections

    import torch

    from sift_scale_space_extrema_detection_tpu_torch.models import slam as pslam

    jnp = ref.jnp
    rng = np.random.default_rng(0)
    key = np.asarray(ref.jax.random.PRNGKey(f))[None]
    n = int(mask.sum())
    got = {"jax": collections.Counter(), "port": collections.Counter()}
    with patched(pslam, "_pair_draws", jax_draws):
        for _ in range(trials):
            a, b = (np.nextafter(uv, uv + rng.integers(-1, 2, uv.shape).astype(np.float32)
                                 * mask[..., None]) for uv in (uv1, uv2))
            j = np.asarray(ref.slam._verify_pairs(
                jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask),
                jnp.asarray(k_mat, jnp.float32), jnp.asarray(key), thr, HYPOTHESES))[0]
            p = pslam._verify_pairs(a, b, mask, k_mat, [f], thr, HYPOTHESES, capacity,
                                    torch.device("cpu"))[0]
            got["jax"][int(j[:n].sum())] += 1
            got["port"][int(p[:n].sum())] += 1
    return {name: {str(k): v for k, v in sorted(c.items())} for name, c in got.items()}


def verification_evidence(ref, uv1, uv2, mask, k_mat, f, thr, jax_draws, pransac, pgeo):
    """One pair verification in both packages on the same correspondences
    and draws: each package's final model's Sampson errors for every slot,
    the threshold, and the hypotheses (minimal solves) whose inlier counts
    differ, with each package's eight polished candidates."""
    import torch

    from sift_scale_space_extrema_detection_tpu_torch.models.slam import _generator

    jax, jnp, jr = ref.jax, ref.jnp, ref.ransac
    thr2 = thr * thr
    k32 = jnp.asarray(k_mat, jnp.float32)
    r1 = ref.geometry.backproject(jnp.asarray(uv1), k32).astype(jnp.float32)
    r2 = ref.geometry.backproject(jnp.asarray(uv2), k32).astype(jnp.float32)
    v = jnp.asarray(mask)
    key = jax.random.PRNGKey(f)
    res = jr.estimate_essential_ransac(r1, r2, v, key, num_hypotheses=HYPOTHESES,
                                       inlier_threshold=thr)

    @jax.jit
    def counts_of(rays1, rays2, valid, key):
        w = valid.astype(rays1.dtype)
        t1 = jr._normalizing_transform(rays1, w)
        t2 = jr._normalizing_transform(rays2, w)
        u = jax.random.uniform(key, (HYPOTHESES, rays1.shape[0]))
        _, idx = jax.lax.top_k(jnp.where(valid[None, :], u, -1.0), 8)
        rows = jr._epipolar_rows(rays1 @ t1.T, rays2 @ t2.T)
        e_h = jr._project_to_essential(t2.T @ jr._eight_point_nullvec(rows[idx])
                                       .reshape(-1, 3, 3) @ t1)
        return jnp.sum((jr.sampson_error(e_h, rays1, rays2) < thr2) & valid[None, :], axis=-1)

    j_counts = np.asarray(counts_of(r1, r2, v, key))
    kt = torch.as_tensor(k_mat, dtype=torch.float32)
    q1 = pgeo.backproject(torch.from_numpy(uv1), kt)
    q2 = pgeo.backproject(torch.from_numpy(uv2), kt)
    pv = torch.from_numpy(mask)
    idx = jax_draws(pv, HYPOTHESES, _generator(f))
    got = pransac.essential_from_samples(q1, q2, pv, idx, thr)
    w = pv.to(torch.float32)
    t1 = pransac._normalizing_transform(q1, w)
    t2 = pransac._normalizing_transform(q2, w)
    rows = pransac._epipolar_rows(q1 @ t1.T, q2 @ t2.T)
    e_h = pransac._project_to_essential(
        t2.T @ pransac._eight_point_nullvec(rows[idx]).reshape(-1, 3, 3) @ t1)
    p_counts = ((pransac.sampson_error(e_h, q1, q2) < thr2) & pv[None, :]).sum(-1).numpy()
    differ = np.nonzero(j_counts != p_counts)[0]
    order = sorted(differ, key=lambda h: -abs(int(j_counts[h]) - int(p_counts[h])))
    j_top = np.asarray(jax.lax.top_k(jnp.asarray(j_counts), 8)[1])
    p_top = torch.from_numpy(p_counts).sort(descending=True, stable=True).indices[:8].numpy()
    return dict(
        threshold_sq=thr2,
        sampson_jax=np.asarray(jr.sampson_error(res.e_mat, r1, r2)).tolist(),
        sampson_port=pransac.sampson_error(got.e_mat, q1, q2).numpy().tolist(),
        hypotheses_whose_count_differs=len(differ),
        largest_count_differences=[[int(h), int(j_counts[h]), int(p_counts[h])] for h in order[:5]],
        candidates_jax=[[int(h), int(j_counts[h])] for h in j_top],
        candidates_port=[[int(h), int(p_counts[h])] for h in p_top],
        normalizing_transform_max_diff=float(np.abs(
            np.asarray(jr._normalizing_transform(r1, v.astype(jnp.float32))) - t1.numpy()).max()),
    )


def leg_a(ref, described, k_mat, max_tracks, jax_draws):
    """The association of both packages on the same keypoints: the JAX
    package's and the port's tables and the leg's record."""
    from sift_scale_space_extrema_detection_tpu_torch.models import slam as pslam

    port_described = _to_port(described)
    t0 = time.perf_counter()
    want = ref.tracks(described, k_mat, max_tracks)
    jax_s = time.perf_counter() - t0
    track = dict(match_ratio=RATIO, max_tracks=max_tracks, reassoc_window=REASSOC,
                 max_match_px=GATE_PX, device="cpu")
    t0 = time.perf_counter()
    with patched(pslam, "_pair_draws", jax_draws):
        got = pslam.build_tracks_from_described(port_described, k_mat, **track)
    port_s = time.perf_counter() - t0
    split = first_split(got, want)
    record = dict(leg="a", max_tracks=max_tracks, frames=int(described["valid"].shape[0]),
                  tracks_jax=int(want[1].shape[1]), tracks_port=int(got[1].shape[1]),
                  bit_equal=split is None, seconds_jax=round(jax_s, 2),
                  seconds_port=round(port_s, 2))
    if split is not None:
        frame, trk = split
        record.update(first_frame=frame, first_track=trk)
        if frame > 0:
            stage, evidence = stage_report(ref, described, k_mat, frame, jax_draws)
            record.update(first_stage=stage or "re-association or new tracks",
                          evidence=evidence)

    # Pair verification pinned to the JAX package's verdicts on the same
    # inputs: every other stage against the reference.
    jnp = ref.jnp

    def reference_verdicts(uv1, uv2, mask, k_mat, seeds, thr, num_hypotheses, capacity, device):
        keys = np.stack([np.asarray(ref.jax.random.PRNGKey(s)) for s in seeds])
        return np.asarray(ref.slam._verify_pairs(
            jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask),
            jnp.asarray(k_mat, jnp.float32), jnp.asarray(keys), thr, num_hypotheses))

    with patched(pslam, "_verify_pairs", reference_verdicts):
        pinned = pslam.build_tracks_from_described(port_described, k_mat, **track)
    split = first_split(pinned, want)
    record["pinned"] = dict(bit_equal=split is None,
                            first_frame=None if split is None else split[0],
                            first_track=None if split is None else split[1])
    emit(record)
    return want, got, record


def _to_port(described: dict):
    import torch

    from sift_scale_space_extrema_detection_tpu_torch.ops.descriptor import DescribedKeypoints

    return DescribedKeypoints(**{f.name: torch.from_numpy(described[f.name])
                                 for f in dataclasses.fields(DescribedKeypoints)})


def leg_a_card(described_card, k_mat, max_tracks, dev):
    """The card's association against the CPU's on the card's keypoints,
    with the port's own draws."""
    import torch

    from sift_scale_space_extrema_detection_tpu_torch.core.device import on_device
    from sift_scale_space_extrema_detection_tpu_torch.models import slam as pslam

    track = dict(match_ratio=RATIO, max_tracks=max_tracks, reassoc_window=REASSOC,
                 max_match_px=GATE_PX)
    t0 = time.perf_counter()
    card = pslam.build_tracks_from_described(described_card, k_mat, **track, device=dev)
    card_s = time.perf_counter() - t0
    cpu = pslam.build_tracks_from_described(on_device(described_card, torch.device("cpu")),
                                            k_mat, **track, device="cpu")
    split = first_split(card, cpu)
    emit(dict(leg="a", variant="card against cpu", device=str(dev), max_tracks=max_tracks,
              tracks_card=int(card[1].shape[1]), tracks_cpu=int(cpu[1].shape[1]),
              bit_equal=split is None, first_frame=None if split is None else split[0],
              first_track=None if split is None else split[1], seconds_card=round(card_s, 2)))


def leg_b(ref, tables, k_mat, slam_cfg, gt_r, gt_t, max_tracks, jax_draws, stops=()):
    """The two back ends on the same tracks: in float32 with the port's own
    bootstrap draws and with the JAX package's, in float64 with the JAX
    package's. In float64 also the JAX package against itself with every
    visible pixel moved one float64 ulp up: the gap that rounding alone
    opens on these tracks. ``stops``: frames after which both float64 back
    ends also stop (``_stop_after``, at the end of that tracking window), to
    read the gap as the run goes."""
    import torch

    from sift_scale_space_extrema_detection_tpu_torch.models import slam as pslam
    from sift_scale_space_extrema_detection_tpu_torch.ops import ransac as pransac

    pixels, visible = tables[:2]
    base = dict(leg="b", max_tracks=max_tracks, tracks=int(visible.shape[1]))

    def port_run(dtype, draws, **kw):
        with contextlib.ExitStack() as stack:
            if draws == "jax":
                stack.enter_context(patched(pransac, "sample_minimal_sets", jax_draws))
            return pslam.run_slam(pixels, visible, k_mat, slam_cfg, dtype=dtype, device="cpu",
                                  **kw)

    def gap(got, want, frames=None):
        return dict(landmarks_equal=bool(np.array_equal(got.landmark_valid, want.landmark_valid)),
                    **pose_gap(got, want, frames))

    for bits in (32, 64):
        dtype = torch.float32 if bits == 32 else torch.float64
        with ref.x64(bits == 64):
            t0 = time.perf_counter()
            want = ref.run_slam(pixels, visible, k_mat, slam_cfg)
            jax_s = time.perf_counter() - t0
            for draws in ("port", "jax") if bits == 32 else ("jax",):
                t0 = time.perf_counter()
                got = port_run(dtype, draws)
                emit(dict(base, float_bits=bits, port_draws=draws, port=summary(got, gt_r, gt_t),
                          jax=summary(want, gt_r, gt_t), **gap(got, want),
                          seconds_jax=round(jax_s, 2),
                          seconds_port=round(time.perf_counter() - t0, 2)))
            if bits == 64:
                nudged = np.where(visible[..., None], np.nextafter(pixels, np.inf), pixels)
                again = ref.run_slam(nudged, visible, k_mat, slam_cfg)
                emit(dict(base, float_bits=bits, variant="jax against jax, pixels one ulp up",
                          jax_nudged=summary(again, gt_r, gt_t), **gap(again, want)))
                for stop in stops:
                    want_s = ref.run_slam(pixels, visible, k_mat, slam_cfg, _stop_after=stop)
                    got_s = port_run(dtype, "jax", _stop_after=stop)
                    emit(dict(base, float_bits=bits, port_draws="jax", stopped_after=stop,
                              observations_equal=got_s.num_observations
                              == want_s.num_observations,
                              **gap(got_s, want_s, stop + 1)))
        ref.release()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--max-tracks", type=int, nargs="+", default=[4096, 65536])
    ap.add_argument("--legs", nargs="+", default=["a", "b", "c", "d"], choices=["a", "b", "c", "d"])
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    ap.add_argument("--no-jax", action="store_true", help="run the port's legs only")
    ap.add_argument("--b-stops", type=int, nargs="*", default=[],
                    help="frames after which leg (b)'s float64 back ends also stop")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import torch

    import sift_scale_space_extrema_detection_tpu_torch as port
    from sift_scale_space_extrema_detection_tpu_torch.models import slam as pslam
    from sift_scale_space_extrema_detection_tpu_torch.ops import ransac as pransac

    dev = torch.device(args.device)
    ref = None
    if not args.no_jax:
        try:
            ref = Reference()
        except ImportError as err:
            emit(dict(skipped="the JAX package's legs", reason=str(err)))
    if ref is None:
        emit(dict(skipped="legs (a) against the reference, (b) and (d)",
                  reason="they need the JAX package"))

    t0 = time.perf_counter()
    images, k_mat, gt_r, gt_t = load_frames(args.frames)
    sift_cfg = port.SiftConfig(num_octaves=4, scales_per_octave=3, max_keypoints_per_trio=512)
    slam_cfg = port.SlamConfig(ba_interval=5, bootstrap_baseline=1, ba_every=1,
                               use_pose_graph=False)  # evaluate's
    emit(dict(frames=int(images.shape[0]), size=list(images.shape[1:]), device=str(dev),
              torch=torch.__version__, seconds=round(time.perf_counter() - t0, 2)))

    def describe(device):
        t0 = time.perf_counter()
        d = pslam.describe_frames(images, sift_cfg, chip_smoke.SLAM_CHUNK, device=device,
                                  blur="separable")
        return d, time.perf_counter() - t0

    port_cpu, cpu_s = describe("cpu")
    described = {f.name: getattr(port_cpu, f.name).numpy() for f in dataclasses.fields(port_cpu)}
    port_desc = {"cpu": port_cpu}
    port_card = None
    if dev.type != "cpu":
        port_card, card_s = describe(dev)
        port_desc[str(dev)] = port_card
        emit(dict(described="card against cpu", seconds_card=round(card_s, 2),
                  seconds_cpu=round(cpu_s, 2), equal=all(
                      torch.equal(getattr(port_card, f.name).cpu(), getattr(port_cpu, f.name))
                      for f in dataclasses.fields(port_cpu))))
    jax_draws = jax_desc = None
    if ref is not None:
        jax_draws = ref.draws()
        if "c" in args.legs:
            t0 = time.perf_counter()
            jax_desc = ref.describe(images, chip_smoke.SLAM_CHUNK)
            ref.release()
            emit(dict(described="jax", seconds=round(time.perf_counter() - t0, 2)))

    for max_tracks in args.max_tracks:
        track = dict(match_ratio=RATIO, max_tracks=max_tracks, reassoc_window=REASSOC,
                     max_match_px=GATE_PX)
        jax_whole = None
        if "c" in args.legs:
            devices = [dev] + ([torch.device("cpu")] if dev.type != "cpu" else [])
            for d in devices:
                t0 = time.perf_counter()
                pixels, visible, _ = pslam.build_tracks_from_described(
                    port_desc[str(d)], k_mat, **track, device=d)
                result = pslam.run_slam(pixels, visible, k_mat, slam_cfg, device=d)
                emit(dict(leg="c", package="port", device=str(d), max_tracks=max_tracks,
                          **summary(result, gt_r, gt_t, visible),
                          seconds=round(time.perf_counter() - t0, 2)))
            if ref is not None:
                t0 = time.perf_counter()
                pixels, visible, _ = ref.tracks(jax_desc, k_mat, max_tracks)
                jax_whole = ref.run_slam(pixels, visible, k_mat, slam_cfg)
                ref.release()
                emit(dict(leg="c", package="jax", device="cpu", max_tracks=max_tracks,
                          **summary(jax_whole, gt_r, gt_t, visible),
                          seconds=round(time.perf_counter() - t0, 2)))
        if "a" in args.legs and port_card is not None:
            leg_a_card(port_card, k_mat, max_tracks, dev)
        if ref is None:
            continue
        tables = got = None
        if {"a", "b", "d"} & set(args.legs):
            tables, got, _ = leg_a(ref, described, k_mat, max_tracks, jax_draws)
            ref.release()
        if "b" in args.legs:
            leg_b(ref, tables, k_mat, slam_cfg, gt_r, gt_t, max_tracks, jax_draws, args.b_stops)
        if "d" in args.legs:
            t0 = time.perf_counter()
            with patched(pransac, "sample_minimal_sets", jax_draws):
                result = pslam.run_slam(got[0], got[1], k_mat, slam_cfg, device="cpu")
            record = dict(leg="d", max_tracks=max_tracks, device="cpu",
                          port=summary(result, gt_r, gt_t, got[1]),
                          seconds=round(time.perf_counter() - t0, 2))
            if jax_whole is not None:
                record["jax_whole"] = summary(jax_whole, gt_r, gt_t)
            emit(record)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
