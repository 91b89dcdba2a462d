#!/usr/bin/env python3
"""Where the port's SLAM parts from the JAX package's on ``slam_bench``'s
loop-closure regime (``--trajectory loop --final-rounds 0``), with and
without loop association and the pose graph.

Run from the repository root (about forty minutes at the defaults on 8 CPU
cores, ten for ``--legs a e``; most of it the JAX package compiling and
running its frontend and its back ends):

    python3 tools/torch_loop_parity.py [--frames 80] [--size 640x480] [--seed 0] \\
        [--legs a b c e] [--trials 10]

It renders the out-and-back loop with the port's
``benchmarks/slam_bench.py::render_loop_sequence`` (its frames are the
original's within one 8-bit level, ``tests/test_torch_bench_scripts.py``),
uploads it as uint16 as ``slam_bench`` does, and takes ``slam_bench``'s
configurations for the flags (``SiftConfig(num_octaves=3,
max_keypoints_per_trio=256)``, the separable blur, chunks of 16 frames,
re-association window 2, no match gate, ``final_ba_rounds=0``, room 4,096).
Three regimes: ``open`` (no loop association), ``closure``
(``--loop-stride 1``) and ``closure+pose-graph`` (``--loop-stride 1
--pose-graph``, the regime ``chip_smoke.py`` phase 22 runs beside ``open``).
The JAX package runs on the CPU in this process, the port on the CPU. One
JSON line per leg and regime:

- (c) each package whole, its own frontend, association and draws:
  tracks, landmarks, observations, ATE, RPE.
- (a) the association of both packages on the same keypoints (the port's)
  with the JAX package's draws in the port's ``_pair_draws``, for loop
  strides 0 and 1: whether the track tables are bit-equal, else the first
  frame and track that differ and, there, the first stage of the
  consecutive association that differs
  (``tools/torch_dolly_parity.py::stage_report``, no gate); ``pinned``
  repeats the association with the port's pair verifications (consecutive
  and loop) replaced by the JAX package's verdicts on the same inputs,
  which tests every other stage. For stride 1 it also holds each stage of the
  loop pass against the reference on the same inputs: the candidate table
  the frame sketches rank (``place recognition``), the loop matches on the
  JAX package's table, and the verification of the JAX package's candidate
  pairs (``loop verification``), with the largest sketch-similarity
  difference, how many pairs' verdicts differ, how many of those merge
  other slots (after the displacement gate and the 12-match floor), and for
  the first three such pairs each package's inlier counts over 40 copies of
  the pair's correspondences moved by at most one float32 ulp
  (``tools/torch_dolly_parity.py::perturbed_verdicts``).
- (b) the two back ends on the same tracks (the JAX package's table of leg
  (a)): in float32 with the JAX package's draws in
  ``sample_minimal_sets``, in float64 with them, and the JAX package in
  float64 against itself with every visible pixel one float64 ulp up (the
  gap that rounding alone opens on these tracks): ATE, landmarks, and where
  the poses part (``tools/torch_dolly_parity.py::pose_gap``).
- (e) the pose graph's inputs on the same tracks in float64 with the JAX
  package's draws, from the poses it starts from (the closure regime's, as
  ``final_ba_rounds=0`` leaves them): for each loop edge the regime
  measures, the largest rotation-entry difference between the two packages'
  ``measure_loop_edge`` and the largest by which the JAX package's own edge
  moves when every pixel moves by at most one float32 ulp (``--trials``
  copies; the edge's RANSAC runs on float32 rays); and both packages'
  ``optimize_pose_graph`` on the same edges (the JAX package's), with the
  largest pose differences.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from torch_dolly_parity import (  # noqa: E402
    HYPOTHESES,
    RANSAC_PX,
    Reference,
    _to_port,
    emit,
    first_split,
    patched,
    perturbed_verdicts,
    pose_gap,
    stage_report,
    summary,
)

RATIO = 0.9  # run_slam_from_images' match_ratio, which slam_bench leaves as it is
REASSOC = 2  # slam_bench's --reassoc
CHUNK = 16  # slam_bench's --chunk
LOOP_MIN_GAP, LOOP_MIN_MATCHES, LOOP_TOPK = 10, 12, 8  # the association's defaults
REGIMES = {"open": (0, False), "closure": (1, False), "closure+pose-graph": (1, True)}


def association_kw(loop_stride: int) -> dict:
    return dict(match_ratio=RATIO, max_tracks=4096, reassoc_window=REASSOC, max_match_px=None,
                loop_stride=loop_stride, loop_query_stride=1, loop_topk=LOOP_TOPK)


def jax_tracks(ref, described, k_mat, loop_stride: int):
    """The JAX package's association of ``described`` keypoints (numpy)."""
    frames = described["valid"].shape[0]
    with ref.given_keypoints(described):
        return ref.slam.build_tracks_from_images(
            np.zeros((frames, 1, 1), np.float32), ref.sift_cfg, k_mat, frontend_chunk=frames,
            blur="separable", **association_kw(loop_stride))


def candidate_table(sim: np.ndarray, frames: int, loop_stride: int) -> np.ndarray:
    """The loop pass's (query, candidate) table from a sketch-similarity
    matrix, as both packages build it."""
    qf = np.arange(LOOP_MIN_GAP, frames)
    n_full = max(1, (frames - LOOP_MIN_GAP + loop_stride - 1) // loop_stride)
    n_cols = min(n_full, LOOP_TOPK)
    table = np.full((len(qf), n_cols), -1, np.int64)
    for i, f in enumerate(qf):
        cands = np.arange(0, f - LOOP_MIN_GAP + 1, loop_stride)
        if LOOP_TOPK < n_full and len(cands) > n_cols:
            order = np.argsort(-sim[f, cands], kind="stable")[:n_cols]
            cands = np.sort(cands[order])
        table[i, : min(len(cands), n_cols)] = cands[:n_cols]
    return table


def loop_stages(ref, described, k_mat, jax_draws, loop_stride=1) -> dict:
    """Each stage of the loop pass in both packages on the same inputs;
    the first stage that differs (None: none) and its evidence."""
    import torch

    from sift_scale_space_extrema_detection_tpu_torch.models import slam as pslam

    jnp, jslam = ref.jnp, ref.slam
    desc, valid = described["descriptor"], described["valid"]
    xs, ys = described["abs_x"], described["abs_y"]
    frames = valid.shape[0]
    qf = np.arange(LOOP_MIN_GAP, frames)
    out = {}

    jd, jv = jnp.asarray(desc), jnp.asarray(valid)
    pd, pv = torch.from_numpy(desc), torch.from_numpy(valid)
    jsk = jslam._frame_sketches(jd, jv)
    j_sim = np.asarray(jnp.einsum("fd,gd->fg", jsk, jsk, preferred_element_type=jnp.float32))
    psk = pslam._frame_sketches(pd, pv)
    p_sim = (psk @ psk.T).numpy()
    j_table = candidate_table(j_sim, frames, loop_stride)
    p_table = candidate_table(p_sim, frames, loop_stride)
    out["sketch_similarity_max_diff"] = float(np.abs(j_sim - p_sim).max())
    differ = np.nonzero((j_table != p_table).any(axis=1))[0]
    if len(differ):
        out.update(first_stage="place recognition",
                   queries_whose_candidates_differ=qf[differ].tolist()[:10])
        return out

    j_idx, j_val = (np.asarray(a) for a in jslam._match_window_any(
        jd, jv, jnp.asarray(qf, jnp.int32), jnp.asarray(j_table, jnp.int32), RATIO, None))
    p_idx, p_val = pslam._match_window(pd, pv, qf, j_table, RATIO, None)
    bad = (j_val != p_val) | (j_val & (j_idx != p_idx))
    out["loop_matches"] = int(j_val.sum())
    if bad.any():
        q, c, s = (int(v[0]) for v in np.nonzero(bad))
        out.update(first_stage="loop matching", query=int(qf[q]), candidate=int(j_table[q, c]),
                   slot=s)
        return out

    pairs = []
    for i, f in enumerate(qf):
        for c in range(j_table.shape[1]):
            kf = j_table[i, c]
            src = np.where(j_val[i, c])[0] if kf >= 0 else []
            if len(src) >= max(8, LOOP_MIN_MATCHES):
                pairs.append((int(f), int(kf), src, j_idx[i, c, src]))
    out["candidate_pairs"] = len(pairs)
    if not pairs:
        out["first_stage"] = None
        return out
    cap = 1 << max(6, (max(len(s) for _, _, s, _ in pairs) - 1).bit_length())
    uv1 = np.zeros((len(pairs), cap, 2), np.float32)
    uv2 = np.zeros((len(pairs), cap, 2), np.float32)
    mask = np.zeros((len(pairs), cap), bool)
    for p, (f, kf, src, dst) in enumerate(pairs):
        n = len(src)
        uv1[p, :n] = np.stack([xs[f, src], ys[f, src]], -1)
        uv2[p, :n] = np.stack([xs[kf, dst], ys[kf, dst]], -1)
        mask[p, :n] = True
    thr = RANSAC_PX / float(k_mat[0, 0])
    seeds = [10_000 + p for p in range(len(pairs))]
    keys = np.stack([np.asarray(ref.jax.random.PRNGKey(s)) for s in seeds])
    j_in = np.asarray(jslam._verify_pairs(
        jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask), jnp.asarray(k_mat, jnp.float32),
        jnp.asarray(keys), thr, HYPOTHESES))
    with patched(pslam, "_pair_draws", jax_draws):
        p_in = pslam._verify_pairs(uv1, uv2, mask, k_mat, seeds, thr, HYPOTHESES,
                                   pslam._capacity(pd), torch.device("cpu"))
    bad = (j_in != p_in) & mask
    split = np.nonzero(bad.any(axis=1))[0]

    def kept(inliers, p):
        """The slots pair ``p`` merges on these verdicts: the inliers
        within 3×MAD (+2 px) of their median displacement, none below
        ``LOOP_MIN_MATCHES`` (both packages' rule)."""
        f, kf, src, dst = pairs[p]
        keep = inliers[p, : len(src)].copy()
        if keep.any():
            ddx, ddy = xs[f, src] - xs[kf, dst], ys[f, src] - ys[kf, dst]
            dev = np.hypot(ddx - np.median(ddx[keep]), ddy - np.median(ddy[keep]))
            keep &= dev <= 3.0 * np.median(dev[keep]) + 2.0
        return keep if keep.sum() >= LOOP_MIN_MATCHES else np.zeros_like(keep)

    merging = [p for p in split if not np.array_equal(kept(j_in, p), kept(p_in, p))]
    out.update(pairs_whose_verdicts_differ=len(split), pairs_whose_merges_differ=len(merging),
               pairs_that_merge_jax=sum(bool(kept(j_in, p).any()) for p in range(len(pairs))))
    out["first_pairs_that_differ"] = [
        dict(pair=[pairs[p][0], pairs[p][1]], matches=int(mask[p].sum()),
             inliers_jax=int(j_in[p].sum()), inliers_port=int(p_in[p].sum()),
             merged_jax=int(kept(j_in, p).sum()), merged_port=int(kept(p_in, p).sum()),
             perturbed=perturbed_verdicts(ref, uv1[p : p + 1], uv2[p : p + 1], mask[p : p + 1],
                                          k_mat, seeds[p], thr, jax_draws, pslam._capacity(pd)))
        for p in (merging or list(split))[:3]]
    out["first_stage"] = "loop verification" if len(split) else None
    return out


def leg_e(ref, tables, k_mat, cfgs, jax_draws, trials) -> dict:
    """The loop edges and the pose graph of the closure+pose-graph regime
    in both packages on the same inputs (see the module)."""
    import torch

    from sift_scale_space_extrema_detection_tpu.sfm import pose_graph as jpg
    from sift_scale_space_extrema_detection_tpu_torch.models import slam as pslam
    from sift_scale_space_extrema_detection_tpu_torch.ops import ransac as pransac
    from sift_scale_space_extrema_detection_tpu_torch.sfm import pose_graph as ppg

    jnp = ref.jnp
    pixels, visible = tables[:2]
    cfg = cfgs["closure+pose-graph"][1]
    jcfg = ref.slam.SlamConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(0)
    frames = visible.shape[0]
    with ref.x64(True), patched(pransac, "sample_minimal_sets", jax_draws):
        start = ref.run_slam(pixels, visible, k_mat, cfgs["closure"][1])
        est_r, est_t = np.asarray(start.rotations), np.asarray(start.translations)
        covis = visible.astype(np.int32) @ visible.astype(np.int32).T
        pairs = sorted(((int(covis[a, b]), a, b) for a in range(frames)
                        for b in range(a + cfg.loop_min_frame_gap, frames)
                        if covis[a, b] >= cfg.loop_min_covisible), reverse=True)
        src = list(range(frames - 1))
        dst = list(range(1, frames))
        rel_r = [est_r[b] @ est_r[a].T for a, b in zip(src, dst)]
        rel_t = [est_r[b] @ (-est_r[a].T @ est_t[a]) + est_t[b] for a, b in zip(src, dst)]
        weight = [1.0] * len(src)
        edges = []
        for _, a, b in pairs[: cfg.loop_max_edges]:
            want = ref.slam.measure_loop_edge(pixels, visible, k_mat, est_r, est_t, a, b, jcfg)
            got = pslam.measure_loop_edge(pixels, visible, k_mat, est_r, est_t, a, b, cfg,
                                          device="cpu", dtype=torch.float64)
            if want is None or got is None:
                edges.append(dict(pair=[a, b], jax=want is not None, port=got is not None))
                continue
            spread = 0.0
            for _ in range(trials):
                px = pixels.astype(np.float32)
                px = np.nextafter(px, px + rng.integers(-1, 2, px.shape).astype(np.float32))
                moved = ref.slam.measure_loop_edge(px.astype(np.float64), visible, k_mat, est_r,
                                                   est_t, a, b, jcfg)
                if moved is not None:
                    spread = max(spread, float(np.abs(moved[0] - want[0]).max()))
            edges.append(dict(pair=[a, b], port_against_jax=float(np.abs(got[0] - want[0]).max()),
                              jax_one_f32_ulp=spread))
            src.append(a)
            dst.append(b)
            rel_r.append(want[0])
            rel_t.append(want[1])
            weight.append(0.5)
        j_out = jpg.optimize_pose_graph(jnp.asarray(est_r), jnp.asarray(est_t), jpg.PoseGraphEdges(
            src=jnp.asarray(src, jnp.int32), dst=jnp.asarray(dst, jnp.int32),
            rel_rotation=jnp.asarray(np.stack(rel_r)), rel_translation=jnp.asarray(np.stack(rel_t)),
            weight=jnp.asarray(weight)))
        p_out = ppg.optimize_pose_graph(
            torch.from_numpy(est_r), torch.from_numpy(est_t), ppg.PoseGraphEdges(
                src=torch.tensor(src, dtype=torch.int32), dst=torch.tensor(dst, dtype=torch.int32),
                rel_rotation=torch.from_numpy(np.stack(rel_r)),
                rel_translation=torch.from_numpy(np.stack(rel_t)),
                weight=torch.tensor(weight, dtype=torch.float64)), device="cpu")
    measured = [e for e in edges if "port_against_jax" in e]
    return dict(
        leg="e", edges=edges,
        edges_within_the_references_own_spread=sum(
            e["port_against_jax"] <= e["jax_one_f32_ulp"] for e in measured),
        edges_measured=len(measured),
        pose_graph_on_the_same_edges=dict(
            max_rotation_diff=float(np.abs(np.asarray(j_out[0]) - p_out[0].numpy()).max()),
            max_translation_diff=float(np.abs(np.asarray(j_out[1]) - p_out[1].numpy()).max()),
            cost_jax=float(j_out[2]), cost_port=float(p_out[2])))


def reference_verdicts(ref):
    """A stand-in for the port's ``_verify_pairs`` that returns the JAX
    package's verdicts on the same correspondences and keys."""
    jnp = ref.jnp

    def verdicts(uv1, uv2, mask, k_mat, seeds, thr, num_hypotheses, capacity, device):
        keys = np.stack([np.asarray(ref.jax.random.PRNGKey(s)) for s in seeds])
        return np.asarray(ref.slam._verify_pairs(
            jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask),
            jnp.asarray(k_mat, jnp.float32), jnp.asarray(keys), thr, num_hypotheses))

    return verdicts


def jax_configs(ref, sift_cfg, slam_cfg):
    from sift_scale_space_extrema_detection_tpu import SiftConfig

    return (SiftConfig(**dataclasses.asdict(sift_cfg)),
            ref.slam.SlamConfig(**dataclasses.asdict(slam_cfg)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--size", default="640x480")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--legs", nargs="+", default=["a", "b", "c", "e"],
                    choices=["a", "b", "c", "e"])
    ap.add_argument("--trials", type=int, default=10,
                    help="leg (e)'s one-ulp copies of the pixels per loop edge")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import torch

    from sift_scale_space_extrema_detection_tpu_torch.benchmarks import slam_bench
    from sift_scale_space_extrema_detection_tpu_torch.models import slam as pslam
    from sift_scale_space_extrema_detection_tpu_torch.ops import ransac as pransac

    ref = Reference()
    jax_draws = ref.draws()
    w, h = (int(v) for v in args.size.split("x"))
    t0 = time.perf_counter()
    images, gt_r, gt_t, k_mat = slam_bench.render_loop_sequence(
        np.random.default_rng(args.seed), args.frames, w, h)
    images = slam_bench.to_uint16(images)
    cfgs = {name: slam_bench.configs(final_rounds=0, pose_graph=pg)
            for name, (_, pg) in REGIMES.items()}
    sift_cfg = cfgs["open"][0]
    ref.sift_cfg = jax_configs(ref, *cfgs["open"])[0]
    port_desc = pslam.describe_frames(images, sift_cfg, CHUNK, device="cpu", blur="separable")
    described = {f.name: getattr(port_desc, f.name).numpy()
                 for f in dataclasses.fields(port_desc)}
    emit(dict(frames=args.frames, size=[h, w], seed=args.seed, torch=torch.__version__,
              seconds=round(time.perf_counter() - t0, 2)))

    if "c" in args.legs:
        jax_desc = ref.describe(images, CHUNK)
        ref.release()
        for name, (stride, _) in REGIMES.items():
            slam_cfg = cfgs[name][1]
            t0 = time.perf_counter()
            pixels, visible, _ = pslam.build_tracks_from_described(
                port_desc, k_mat, **association_kw(stride), device="cpu")
            result = pslam.run_slam(pixels, visible, k_mat, slam_cfg, device="cpu")
            emit(dict(leg="c", regime=name, package="port",
                      **summary(result, gt_r, gt_t, visible),
                      seconds=round(time.perf_counter() - t0, 2)))
            t0 = time.perf_counter()
            pixels, visible, _ = jax_tracks(ref, jax_desc, k_mat, stride)
            result = ref.run_slam(pixels, visible, k_mat, slam_cfg)
            ref.release()
            emit(dict(leg="c", regime=name, package="jax",
                      **summary(result, gt_r, gt_t, visible),
                      seconds=round(time.perf_counter() - t0, 2)))

    if not {"a", "b", "e"} & set(args.legs):
        return 0
    tables = {}
    for stride in (0, 1):
        t0 = time.perf_counter()
        want = jax_tracks(ref, described, k_mat, stride)
        with patched(pslam, "_pair_draws", jax_draws):
            got = pslam.build_tracks_from_described(
                _to_port(described), k_mat, **association_kw(stride), device="cpu")
        split = first_split(got, want)
        record = dict(leg="a", loop_stride=stride, tracks_jax=int(want[1].shape[1]),
                      tracks_port=int(got[1].shape[1]), bit_equal=split is None,
                      first_frame=None if split is None else split[0],
                      first_track=None if split is None else split[1])
        if split is not None and split[0] > 0:
            stage, evidence = stage_report(ref, described, k_mat, split[0], jax_draws,
                                           gate_px=None)
            record.update(first_stage=stage or "re-association, new tracks or the loop pass",
                          evidence=evidence)
        with patched(pslam, "_verify_pairs", reference_verdicts(ref)):
            pinned = pslam.build_tracks_from_described(
                _to_port(described), k_mat, **association_kw(stride), device="cpu")
        split = first_split(pinned, want)
        record["pinned"] = dict(bit_equal=split is None,
                                first_frame=None if split is None else split[0],
                                first_track=None if split is None else split[1])
        if stride:
            merged = int(tables[0][1].shape[1]) - int(want[1].shape[1])
            record.update(tracks_merged_jax=merged,
                          loop_stages=loop_stages(ref, described, k_mat, jax_draws, stride))
        record["seconds"] = round(time.perf_counter() - t0, 2)
        emit(record)
        tables[stride] = want
        ref.release()

    if "e" in args.legs:
        t0 = time.perf_counter()
        record = leg_e(ref, tables[1], k_mat, cfgs, jax_draws, args.trials)
        emit(dict(record, seconds=round(time.perf_counter() - t0, 2)))
        ref.release()
    if "b" not in args.legs:
        return 0
    for name, (stride, _) in REGIMES.items():
        slam_cfg = cfgs[name][1]
        pixels, visible = tables[stride][:2]
        base = dict(leg="b", regime=name, tracks=int(visible.shape[1]))
        for bits in (32, 64):
            dtype = torch.float32 if bits == 32 else torch.float64
            with ref.x64(bits == 64):
                t0 = time.perf_counter()
                want = ref.run_slam(pixels, visible, k_mat, slam_cfg)
                with patched(pransac, "sample_minimal_sets", jax_draws):
                    got = pslam.run_slam(pixels, visible, k_mat, slam_cfg, dtype=dtype,
                                         device="cpu")
                emit(dict(base, float_bits=bits, port=summary(got, gt_r, gt_t),
                          jax=summary(want, gt_r, gt_t), **pose_gap(got, want),
                          seconds=round(time.perf_counter() - t0, 2)))
                if bits == 64:
                    nudged = np.where(visible[..., None], np.nextafter(pixels, np.inf), pixels)
                    again = ref.run_slam(nudged, visible, k_mat, slam_cfg)
                    emit(dict(base, float_bits=bits, variant="jax against jax, pixels one ulp up",
                              jax_nudged=summary(again, gt_r, gt_t), **pose_gap(again, want)))
            ref.release()
    return 0


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        raise SystemExit(main())
