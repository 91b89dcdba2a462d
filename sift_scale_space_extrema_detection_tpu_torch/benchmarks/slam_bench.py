"""End-to-end visual SLAM throughput and accuracy of the port on one card.

The port of the JAX package's ``benchmarks/slam_bench.py``: renders a
synthetic blob-field sequence (:func:`render_sequence`, the dolly, by
default; ``--trajectory`` picks the out-and-back loop, the orbit or the
zigzag), runs ``run_slam_from_images`` (images → detect + describe → tracks
→ PnP / triangulation → BA) and reports frames/s, ATE and the map's size.
The host-side tracking and geometry glue is part of the measurement on
purpose: it is the production path.

Three modes, each printing the original's rows and summary:

- the headline run: one warm-up pass over the whole sequence, then one
  timed pass (``--breakdown`` attributes it by stage through
  ``utils/profile.py::StageProfile``, which synchronises between stages);
- ``--streaming``: ``SlamSession`` frame by frame and ``finalize``, with the
  median and largest latency of a window step;
- ``--suite``: every shape × ``--seeds`` seeds with the current flags, a row
  each (``ate``, ``fps``, ``lm``) and each shape's median and worst ATE
  (the first row of the run carries the warm-up).

Frames are shipped as uint16 unless ``--f32-upload``. Renders are cached on
disk (host rendering takes ~14 s a 40-frame 640×480 sequence) under
``$SLAM_BENCH_RENDER_CACHE_TORCH``, by default ``slam_render_cache_torch``
in the temporary directory: never the original's cache, so a port render is
never read back as the JAX package's or the other way round.

``--no-window-describe`` is accepted and changes nothing: the TPU's
window-DMA describe route is left out of the port by design (the describe
kernel serves every describe). The tracking's room is
``run_slam_from_images``'s default, 4,096 tracks, the JAX package's fixed
value.

Run: ``python -m sift_scale_space_extrema_detection_tpu_torch.benchmarks.slam_bench
[--frames 40] [--size 640x480] [--trajectory dolly|loop|orbit|zigzag]
[--suite --seeds 5] [--streaming] [--breakdown] [--device cuda|cpu] ...``
(every flag of the original, ``--help``). Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from ..config import SiftConfig
from ..models.slam import SlamConfig, evaluate_ate, run_slam_from_images
from ..models.streaming import SlamSession
from ..sfm import geometry as geo
from ..utils.profile import StageProfile
from ..utils.synthetic import render_blob_image, textured_blob_field
from . import (
    device_entry,
    launch_counts,
    path_kernels,
    path_launches,
    peak_gib,
    probe_device,
    require_launches,
    sync,
)

RENDER_CACHE_DIR = os.environ.get(
    "SLAM_BENCH_RENDER_CACHE_TORCH",
    os.path.join(tempfile.gettempdir(), "slam_render_cache_torch"),
)


def _so3(w) -> np.ndarray:
    """``so3_exp`` of an axis-angle in float32, as the original takes it
    (``np.asarray(geo.so3_exp(jnp.asarray(w)))``)."""
    return geo.so3_exp(torch.tensor(w, dtype=torch.float32)).numpy()


def _intrinsics(w, h) -> np.ndarray:
    return np.array(
        [[260.0 * w / 320, 0, w / 2], [0, 260.0 * w / 320, h / 2], [0, 0, 1.0]]
    )


def _cached_render(fn, shape_name, seed, num_frames, w, h, cache_dir=None):
    """Disk-cache rendered sequences (host rendering is ~14 s each) under
    ``cache_dir`` (default :data:`RENDER_CACHE_DIR`; ``""`` renders without
    the cache)."""
    cache_dir = RENDER_CACHE_DIR if cache_dir is None else cache_dir
    if not cache_dir:
        return fn(np.random.default_rng(seed), num_frames, w, h)
    key = f"{shape_name}_s{seed}_f{num_frames}_{w}x{h}.npz"
    path = os.path.join(cache_dir, key)
    if os.path.exists(path):
        d = np.load(path)
        return d["images"], d["gt_r"], d["gt_t"], d["k_mat"]
    out = fn(np.random.default_rng(seed), num_frames, w, h)
    os.makedirs(cache_dir, exist_ok=True)
    np.savez(path, images=out[0], gt_r=out[1], gt_t=out[2], k_mat=out[3])
    return out


def render_loop_sequence(rng, num_frames, w, h):
    """Closed-loop out-and-back dolly: A → B → A along the blob field.

    The return leg revisits the outbound viewpoints (offset by half a step
    so frames are not bit-identical), closing the loop at frame N-1 ≈ frame
    0: the loop-closure benchmark for ``--loop-stride`` / ``--pose-graph``.
    """
    k_mat = _intrinsics(w, h)
    half = num_frames // 2
    x_hi = 3.5 + 0.14 * (half + 1)
    n_pts = int(160 * (x_hi + 3.5) / 7.0)
    pts = rng.uniform([-3.5, -1.8, 4.0], [x_hi, 1.8, 9.0], size=(n_pts, 3))
    rpts, amps, ss = textured_blob_field(rng, pts)

    rots, ts, imgs = [], [], []
    for f in range(num_frames):
        # Outbound f = 0..half; the return retraces at the same speed,
        # half-step offset. A gentle yaw wiggle keeps rotation alive.
        x = 0.14 * (f if f <= half else (num_frames - f - 0.5))
        r = _so3([0.0, 0.02 * np.sin(0.5 * f), 0.0])
        center = np.array([x, 0.0, 0.0])
        t = -r @ center
        imgs.append(
            render_blob_image(
                rpts, r, t, k_mat, (w, h),
                amplitudes=amps, sigma_scales=ss,
                rng=np.random.default_rng(100 + f),
            )
        )
        rots.append(r)
        ts.append(t)
    return np.stack(imgs), np.stack(rots), np.stack(ts), k_mat


def render_orbit_sequence(rng, num_frames, w, h):
    """Orbit-lite: a slow arc around the blob field's centre, ~1.3°/frame of
    viewpoint change, the camera re-aimed at the centre each frame."""
    k_mat = _intrinsics(w, h)
    target = np.array([0.0, 0.0, 6.5])
    pts = rng.uniform([-3.0, -1.8, 4.0], [3.0, 1.8, 9.0], size=(220, 3))
    rpts, amps, ss = textured_blob_field(rng, pts)

    def look_at(center):
        fwd = target - center
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        return np.stack([right, up, fwd])  # world→camera rows

    rots, ts, imgs = [], [], []
    radius = 6.5
    for f in range(num_frames):
        ang = 0.022 * f  # rad; lateral step ≈ 0.14 (the dolly's speed)
        center = target + radius * np.array(
            [np.sin(ang), 0.02 * np.sin(0.3 * f), -np.cos(ang)]
        )
        r = look_at(center)
        t = -r @ center
        imgs.append(
            render_blob_image(
                rpts, r, t, k_mat, (w, h),
                amplitudes=amps, sigma_scales=ss,
                rng=np.random.default_rng(100 + f),
            )
        )
        rots.append(r)
        ts.append(t)
    return np.stack(imgs), np.stack(rots), np.stack(ts), k_mat


def render_zigzag_sequence(rng, num_frames, w, h):
    """Zigzag dolly: forward advance with alternating lateral sweeps
    (direction reversals exercise the motion-prior gate and the PnP
    motion-model init)."""
    k_mat = _intrinsics(w, h)
    x_hi = 3.5 + 0.1 * num_frames
    n_pts = int(160 * (x_hi + 3.5) / 7.0)
    pts = rng.uniform([-3.5, -1.8, 4.0], [x_hi, 1.8, 9.0], size=(n_pts, 3))
    rpts, amps, ss = textured_blob_field(rng, pts)

    rots, ts, imgs = [], [], []
    for f in range(num_frames):
        r = _so3([0.0, 0.015 * np.sin(0.4 * f), 0.0])
        center = np.array(
            [0.1 * f, 0.35 * np.sin(0.75 * f), 0.25 * np.sin(0.35 * f)]
        )
        t = -r @ center
        imgs.append(
            render_blob_image(
                rpts, r, t, k_mat, (w, h),
                amplitudes=amps, sigma_scales=ss,
                rng=np.random.default_rng(100 + f),
            )
        )
        rots.append(r)
        ts.append(t)
    return np.stack(imgs), np.stack(rots), np.stack(ts), k_mat


def render_sequence(rng, num_frames, w, h, keep=None):
    """The dolly: a slow lateral translation with a slow rotation past a
    textured blob field that extends along the path at constant density
    (the generator family of the visual-SLAM tests). ``keep``: the frame
    indices rendered (default all; a frame does not depend on the others)."""
    k_mat = _intrinsics(w, h)
    x_hi = 3.5 + 0.14 * num_frames
    n_pts = int(160 * (x_hi + 3.5) / 7.0)
    pts = rng.uniform([-3.5, -1.8, 4.0], [x_hi, 1.8, 9.0], size=(n_pts, 3))
    rpts, amps, ss = textured_blob_field(rng, pts)

    rots, ts, imgs = [], [], []
    for f in range(num_frames) if keep is None else keep:
        r = _so3([0.004 * f, -0.01 * f, 0.002 * f])
        center = np.array([0.14 * f, 0.01 * f, 0.0])
        t = -r @ center
        imgs.append(
            render_blob_image(
                rpts, r, t, k_mat, (w, h),
                amplitudes=amps, sigma_scales=ss,
                rng=np.random.default_rng(100 + f),
            )
        )
        rots.append(r)
        ts.append(t)
    return np.stack(imgs), np.stack(rots), np.stack(ts), k_mat


RENDERS = {
    "dolly": render_sequence,
    "loop": render_loop_sequence,
    "orbit": render_orbit_sequence,
    "zigzag": render_zigzag_sequence,
}


def to_uint16(images: np.ndarray) -> np.ndarray:
    """The bench's upload: frames in [0, 1] as uint16 (the synthetic
    texture's contrast is finer than 8-bit depth)."""
    return np.round(np.clip(images, 0.0, 1.0) * 65535.0).astype(np.uint16)


def configs(quality=False, no_window_describe=False, upright=False, describe_compaction=0.5,
            desc_grid=16, ba_interval=5, ba_iters=6, final_rounds=2, bootstrap=1,
            pose_graph=False, ba_every=1) -> tuple[SiftConfig, SlamConfig]:
    """The original's ``SiftConfig`` and ``SlamConfig`` for these flags."""
    kw_cfg = dict(
        num_octaves=3,
        max_keypoints_per_trio=256,
        window_describe=not no_window_describe,
        upright=upright,
        describe_compaction=describe_compaction,
        descriptor_grid_size=desc_grid,
        orientation_grid_size=desc_grid,
    )
    sift_cfg = SiftConfig.quality(**kw_cfg) if quality else SiftConfig(**kw_cfg)
    slam_cfg = SlamConfig(
        ba_interval=ba_interval,
        ba_window=max(8, ba_interval),
        ba_iterations=ba_iters,
        final_ba_rounds=final_rounds,
        bootstrap_baseline=bootstrap,
        use_pose_graph=pose_graph,
        ba_every=ba_every,
    )
    return sift_cfg, slam_cfg


def run(frames=40, size="640x480", blur="separable", quality=False, reassoc=2, match_gate=None,
        describe_compaction=0.5, ba_iters=6, final_rounds=2, desc_grid=16, chunk=16,
        ba_interval=5, upright=False, bootstrap=1, f32_upload=False, ba_every=1,
        trajectory="dolly", suite=False, seeds=5, loop_stride=0, loop_query_stride=1,
        loop_topk=8, pose_graph=False, streaming=False, no_window_describe=False,
        breakdown=False, device="cuda", render_cache=None, shapes=None, on_row=None) -> dict:
    """The benchmark's JSON object for the mode the flags pick (see the
    module). ``render_cache``: the renders' directory (None: the default,
    ``""``: none); ``shapes``: the suite's shapes (default all four);
    ``on_row``: called with each suite row as it is made."""
    dev = probe_device(str(device))
    w, h = (int(v) for v in size.split("x"))
    sift_cfg, slam_cfg = configs(quality, no_window_describe, upright, describe_compaction,
                                 desc_grid, ba_interval, ba_iters, final_rounds, bootstrap,
                                 pose_graph, ba_every)
    kw = dict(
        blur=blur,
        reassoc_window=reassoc,
        max_match_px=match_gate,
        frontend_chunk=chunk,
        loop_stride=loop_stride,
        loop_query_stride=loop_query_stride,
        loop_topk=loop_topk,
        device=dev,
    )
    kernels = path_kernels(blur, True, upright)

    def upload(images):
        return images if f32_upload else to_uint16(images)

    def slam(images, k_mat, **extra):
        result = run_slam_from_images(images, k_mat, sift_cfg, slam_cfg, **kw, **extra)
        sync(dev)
        return result

    if suite:
        rows = []
        before = launch_counts()
        for shape in shapes or RENDERS:
            for seed in range(seeds):
                imgs_s, gr, gtt, km = _cached_render(RENDERS[shape], shape, seed, frames, w, h,
                                                     render_cache)
                imgs_s = upload(imgs_s)
                t0 = time.perf_counter()
                res = slam(imgs_s, km)
                dtr = time.perf_counter() - t0
                ate = evaluate_ate(res, gr, gtt, device=dev)
                row = {
                    "shape": shape,
                    "seed": seed,
                    "ate": round(float(ate), 4),
                    "fps": round(frames / dtr, 2),
                    "lm": int(res.landmark_valid.sum()),
                }
                rows.append(row)
                if on_row is not None:
                    on_row(row)
        launches = path_launches(before)
        require_launches(dev, launches, kernels, "slam_bench --suite")
        summary = {}
        for shape in shapes or RENDERS:
            ates = [r["ate"] for r in rows if r["shape"] == shape]
            fpss = [r["fps"] for r in rows if r["shape"] == shape]
            summary[shape] = {
                "ate_median": round(float(np.median(ates)), 4),
                "ate_worst": round(max(ates), 4),
                "fps_median": round(float(np.median(fpss)), 2),
            }
        all_ates = [r["ate"] for r in rows]
        return {
            "suite": summary,
            "frames": frames,
            "image": f"{w}x{h}",
            "seeds": seeds,
            "ate_median_all": round(float(np.median(all_ates)), 4),
            "ate_worst_all": round(max(all_ates), 4),
            "rows": rows,
            "launches": launches,
            "device": device_entry(dev),
        }

    t_render = time.perf_counter()
    images, gt_r, gt_t, k_mat = _cached_render(RENDERS[trajectory], trajectory, 0, frames, w, h,
                                               render_cache)
    t_render = time.perf_counter() - t_render
    images = upload(images)

    if streaming:
        def run_streaming():
            sess = SlamSession(
                k_mat, sift_cfg, slam_cfg, blur=blur,
                reassoc_window=reassoc, max_match_px=match_gate, device=dev,
            )
            lat = []
            for im in images:
                t1 = time.perf_counter()
                upd = sess.add_frame(im)
                if upd is not None:
                    sync(dev)
                    lat.append(time.perf_counter() - t1)
            result = sess.finalize()
            sync(dev)
            return result, lat

        t0 = time.perf_counter()
        run_streaming()  # warm-up pass
        t_first_pass = time.perf_counter() - t0
        before = launch_counts()
        t0 = time.perf_counter()
        (result, latencies), peak = peak_gib(run_streaming, dev)
        dt = time.perf_counter() - t0
        launches = path_launches(before)
        require_launches(dev, launches, kernels, "slam_bench --streaming")
        ate = evaluate_ate(result, gt_r, gt_t, device=dev)
        return {
            "mode": "streaming",
            "frames": frames,
            "image": f"{w}x{h}",
            "slam_frames_per_s": round(frames / dt, 2),
            "total_s": round(dt, 2),
            "ate": round(ate, 4),
            "landmarks": int(result.landmark_valid.sum()),
            "window_step_ms_median": round(1e3 * statistics.median(latencies), 1),
            "window_step_ms_max": round(1e3 * max(latencies), 1),
            "first_pass_s": round(t_first_pass, 2),
            "peak_gib": peak,
            "launches": launches,
            "device": device_entry(dev),
        }

    # The warm-up pass over the whole sequence: the first launches, the
    # kernels' build and the allocator's growth stay out of the timed pass.
    t0 = time.perf_counter()
    slam(images, k_mat)
    t_first_pass = time.perf_counter() - t0
    prof = StageProfile() if breakdown else None
    before = launch_counts()
    t0 = time.perf_counter()
    result, peak = peak_gib(lambda: slam(images, k_mat, profile=prof), dev)
    dt = time.perf_counter() - t0
    launches = path_launches(before)
    require_launches(dev, launches, kernels, f"slam_bench --trajectory {trajectory}")
    ate = evaluate_ate(result, gt_r, gt_t, device=dev)
    dump = os.environ.get("SLAM_BENCH_DUMP")
    if dump:
        np.savez(dump, rotations=np.asarray(result.rotations),
                 translations=np.asarray(result.translations), gt_r=gt_r, gt_t=gt_t)
    out = {
        "frames": frames,
        "image": f"{w}x{h}",
        "slam_frames_per_s": round(frames / dt, 2),
        "total_s": round(dt, 2),
        "ate": round(ate, 4),
        "landmarks": int(result.landmark_valid.sum()),
        "observations": int(result.num_observations),
        "first_pass_s": round(t_first_pass, 2),
        "render_s": round(t_render, 2),
        "trajectory": trajectory,
        "peak_gib": peak,
        "launches": launches,
    }
    if prof is not None:
        out["breakdown"] = prof.report(total_frames=frames)
    out["device"] = device_entry(dev)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--size", default="640x480")
    ap.add_argument("--blur", default="separable",
                    choices=["fused", "separable", "matmul", "cuda", "pallas"],
                    help="frontend path (separable: the JAX package's default, plain PyTorch; "
                    "fused: the octave kernel K1; cuda/pallas: the blur kernel K3)")
    ap.add_argument("--quality", action="store_true",
                    help="SiftConfig.quality() detection preset (sigma0 1.6 + OpenCV-equivalent "
                    "thresholds; ~3x keypoint density)")
    ap.add_argument("--reassoc", type=int, default=2, help="window re-association depth")
    ap.add_argument("--match-gate", type=float, default=None, metavar="PX",
                    help="motion-prior match gate in pixels (drops long-range aliased matches; "
                    "see build_tracks_from_images)")
    ap.add_argument("--describe-compaction", type=float, default=0.5,
                    help="describe-slot compaction fraction")
    ap.add_argument("--ba-iters", type=int, default=6, help="LM iterations per windowed BA")
    ap.add_argument("--final-rounds", type=int, default=2,
                    help="final global BA + outlier-prune rounds")
    ap.add_argument("--desc-grid", type=int, default=16, help="descriptor G x G sample grid")
    ap.add_argument("--chunk", type=int, default=16,
                    help="frontend batch chunk (frames described per call)")
    ap.add_argument("--ba-interval", type=int, default=5,
                    help="tracking window = BA cadence in frames")
    ap.add_argument("--upright", action="store_true",
                    help="upright descriptors (skip orientation assignment)")
    ap.add_argument("--bootstrap", type=int, default=1, metavar="K",
                    help="monocular init pair = frames (0, K)")
    ap.add_argument("--f32-upload", action="store_true",
                    help="upload float32 frames instead of uint16")
    ap.add_argument("--ba-every", type=int, default=1,
                    help="run windowed BA every N tracking windows (SlamConfig.ba_every; the "
                    "final window always runs)")
    ap.add_argument("--trajectory", choices=tuple(RENDERS), default="dolly",
                    help="dolly = lateral translation (throughput headline); loop = out-and-back "
                    "(loop-closure bench); orbit = slow arc with look-at rotation; zigzag = "
                    "alternating lateral sweeps")
    ap.add_argument("--suite", action="store_true",
                    help="robustness matrix: every trajectory shape x --seeds seeds with the "
                    "current flags; per-run rows + median/worst summary")
    ap.add_argument("--seeds", type=int, default=5, help="seeds per trajectory shape in --suite")
    ap.add_argument("--loop-stride", type=int, default=0, metavar="S",
                    help="loop-closure data association: match each frame against every S-th "
                    "old frame and merge verified tracks")
    ap.add_argument("--loop-query-stride", type=int, default=1, metavar="Q",
                    help="query only every Q-th frame in the loop-closure pass")
    ap.add_argument("--loop-topk", type=int, default=8, metavar="K",
                    help="sketch-based place recognition: full matching only for each query's K "
                    "most similar candidates; 0 = brute force")
    ap.add_argument("--pose-graph", action="store_true",
                    help="run the measured-loop-edge pose graph before the final BA "
                    "(SlamConfig.use_pose_graph)")
    ap.add_argument("--streaming", action="store_true",
                    help="drive the online SlamSession (frame-by-frame ingest + finalize) "
                    "instead of the batch pipeline; reports the window step's latency")
    ap.add_argument("--no-window-describe", action="store_true",
                    help="accepted and changes nothing: the TPU's window-DMA describe route is "
                    "left out of the port by design (the describe kernel serves every describe)")
    ap.add_argument("--breakdown", action="store_true",
                    help="per-stage wall-clock attribution (syncs at stage boundaries; see "
                    "utils/profile.py)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    probe_device(args.device)
    kw = {k: v for k, v in vars(args).items()}
    out = run(**kw, on_row=lambda row: print(json.dumps(row), flush=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
