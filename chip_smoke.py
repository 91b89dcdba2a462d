#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and ``nvcc``, and imports nothing of JAX.

Phases (any failure exits non-zero and prints no result):

1. device — CUDA present; the card's name and power limit; the TF32
   settings (the describe stages' histograms are float32 matrix products
   and need TF32 off; nothing on the path convolves).
2. build — the CUDA kernels are built from the checkout's sources.
3. fused octave vs plain — at every octave geometry of the main path, on a
   few full-size images, the kernel against its plain PyTorch version on
   the same CUDA tensors, without and with ``emit_scales``: DoG, seed and
   Gaussian stack max abs diff <= 1e-6, masks equal on >= 99.99 % of pixels.
4. the detect path — ``detect_batched`` on 64 × 480×640 frames (the bench
   recipe) at 4 octaves × 5 scales, handed once as a CPU tensor with no
   ``device`` (the results must lie on the card): each octave launches the
   kernel, valid keypoints exist and are finite, and the same batch through
   the plain version agrees (slot agreement >= 0.999, p99 position delta
   <= 0.1 px).
5. timings of the fused octave — per octave at batch 64, kernel against
   plain (CUDA events, in turns plain/kernel/kernel/plain), the kernel with
   ``emit_scales`` beside it, and the whole ``detect_batched`` in frames/s
   (host clock around synchronised runs).
6. the describe path — ``detect_and_describe_batched`` on the same batch
   (once as a CPU tensor with no ``device``, results on the card):
   the fused octave launches per octave, the window-sampling kernel per
   describe stage and the stand-alone blur never; valid descriptors exist,
   are finite and have unit norm; the same batch through the plain versions
   agrees (slot agreement >= 0.999, p99 of the θ difference <= 1e-3 rad,
   min cosine >= 0.999).
7. window sampling vs plain — the batch's real slots and coordinates of
   both describe stages through the kernel and its plain version: max abs
   diff <= 1e-6, invalid slots exactly zero. Then the per-octave describe
   (``compact_describe=False``) on the same batch: two sampling launches
   per octave, and every field equal to the same path through the plain
   sampler (descriptors and θ within 1e-6).
8. the scale-space path — ``build_scale_space(blur="cuda")`` on the whole
   batch launches the blur kernel once per blurred scale and equals the
   fused pyramid's Gaussian stacks within 1e-6.
9. blur vs plain — every blurred (octave, scale) of that path, on the
   64-frame base the path blurs, through the stand-alone blur kernel and
   its plain version: max abs diff <= 1e-6.
10. timings of the describe and blur kernels — window sampling per stage
    and the blur per (octave, scale) at batch 64 (CUDA events, kernel
    against plain in turns; the blur also against two cuDNN ``conv2d``
    calls), and ``detect_and_describe_batched`` in frames/s with its stages.
11. the clamped mode — the octave and blur kernels are each two
    instantiations, and the 4-octave paths above plan only the unclamped
    one. ``detect_batched`` at the default configuration (5 octaves × 3
    scales) on the same batch launches the octave kernel five times, once in
    the clamped mode (octave 4: radius 116 on 60×80), and agrees with the
    plain version (bars of phase 4). Then that octave's 64 bases through the
    octave kernel, and its largest blur through the blur kernel, each planned
    clamped, counted as clamped, equal to the plain version (max abs diff
    <= 1e-6, masks >= 99.99 %) and timed against it.

12. the oracle leg — ``build_scale_space(blur="exact")`` → ``build_dog`` →
    ``detect_from_dog`` in float64 on one 96×128 frame, on the card, against
    the same calls with ``device="cpu"``: scale space and DoG bit for bit,
    the same keypoint slots and reject codes, float fields within 1e-10.
13. two views at full width — two 480×640 frames of one blob field (150
    blobs, rendered from a seed by ``utils/synthetic.py``) →
    ``detect_and_describe_batched`` at the main configuration (all three
    counts zeroed before and read after: the octave kernel launches exactly
    once per octave, the sampling kernel twice, the blur kernel never; both
    kernels equal their plain versions on these frames and this path's slots
    within 1e-6, masks on >= 99.99 % of pixels, and the described result
    equals the plain path's) → ``match_descriptors`` on all 1,800 ×
    1,800 pair slots → ``backproject`` → ``estimate_essential_ransac`` (512
    hypotheses, 2 px) → ``triangulate_midpoint`` → ``pnp_dlt`` +
    ``solve_pnp``: results on the card, rotation error < 1°, translation
    cosine > 0.995, every inlier depth positive, PnP within the same bars;
    the same descriptors and generator seed through ``device="cpu"`` give
    the same match indices on >= 99 % of valid slots and a rotation within
    0.1° of the card's. Matching, RANSAC, its batched SVD and PnP are timed
    (host clock around synchronised runs, after a warm-up).
14. bundle adjustment and the pose graph at a real size — the problem recipe
    of ``benchmarks/ba_bench.py``: (a) dense, sorted assembly, 50 cameras ×
    4,096 landmarks × 25,600 observations, 10 LM iterations; (b) matrix-free
    CG, 1,000 cameras × 100,000 landmarks × 300,000 observations, 10
    iterations × 32 CG steps. The cost falls, the final RMS reprojection
    error is below 1 px (the noise is 0.5 px), (a) with ``assembly="scatter"``
    ends within 1e-3 relative of the sorted cost, and a second run of each
    gives bit-equal poses and points. ``optimize_pose_graph`` on a 200-node
    drifted loop lowers its cost by >= 100×. LM iterations/s, ms per
    iteration and peak device memory are printed.
15. SLAM, images → trajectory (``run_slam_from_images``, ``SlamSession``,
    ``run_slam`` with checkpoint/resume). (a) The JAX package's own bar:
    the 8 × 320×240 frames of ``tests/test_visual_slam.py``, more than 20
    landmarks and ATE < 0.06; the same tracks with ``device="cpu"`` within
    0.02 ATE. (b) Full width, ``benchmarks/slam_bench.py``'s default: 40 ×
    480×640 uint16 frames of a dolly past a blob field, frontend chunks of
    16, re-association over 2 keyframes: the three counts zeroed before and
    read after (K1 9, K2 6, K3 0), a finite trajectory, more than 100
    landmarks, the ATE printed (a reading), a second run bit-equal; both
    kernels equal their plain versions on the first chunk. (c) The card's
    described keypoints through the association on the card and with
    ``device="cpu"``: visible masks agree on >= 99 % of entries. SLAM loses
    (b)'s tracks at its bootstrap, in both packages, and then rounding alone
    moves the ATE (``tools/torch_slam_sensitivity.py``): ``run_slam`` on the
    card's tracks, card against CPU, is printed. The bar is held on the same
    keypoints tracked with the JAX package's motion-prior match gate (30 px)
    and room for 16,384 tracks, which SLAM solves: ``run_slam`` in float32
    on the card and with ``device="cpu"``, ATE < 0.06 on both and within
    0.02 of each other. (d) ``SlamSession`` over the same frames as (b): 7
    provisional updates, K1 24, K2 16, K3 0, the ``mem://`` store empty after
    ``finalize``, the result bit-equal to (b)'s (hence its ATE within 0.02).
    (e) ``run_slam`` on (b)'s tracks stopped after the last frame of every
    tracking window into a ``mem://`` checkpoint and resumed: each bit-equal
    to the uninterrupted run.
    (f) Frames/s of the batch run (host clock around synchronised runs after
    a warm-up), its stage breakdown from a separate ``StageProfile`` run, the
    streaming window step's median and largest latency, peak device memory.
16. the user surfaces, ``cli.main`` and ``evaluate.main`` in-process on the
    card. (a) The CLI at full width: one 480×640 frame of the bench recipe
    written as a PNG by the port's writer, 5 octaves × 3 scales, capacity
    1024, ``--descriptors``: K1/K2/K3 launched 5/10/0 (one K1 launch in its
    clamped mode); its ``keypoints.json`` against the same command with
    ``--device cpu`` (slot agreement >= 0.999 by (octave, scale, row,
    column), p99 position delta <= 0.1 px) and its ``descriptors.npz``
    (rows matched within 0.1 px and 1e-3 rad on >= 99.9 %, min cosine >=
    0.999). ``--blur cuda`` launches K3 once per blurred scale (0/10/26) at
    the same bars; ``--blur matmul`` runs with TF32 off (its scale space
    within 1e-5 of the tap loop's) and is refused with it on. (b) One
    1241×376 KITTI frame through the CLI as it is and padded to 1280×384 by
    ``pad_to_tpu_friendly``: card against CPU at (a)'s bars, and K1 against
    its plain version on each frame's octaves (max abs diff <= 1e-6, masks
    >= 99.99 %). (c) The on-disk rehearsal: 200 × 640×480 frames in the TUM
    layout and 200 × 1241×376 in the KITTI layout, written by the port's
    writers from ``utils/synthetic.py`` (the dolly of ``slam_bench.py``'s
    recipe, seed 0); ``evaluate.main`` on each with its defaults: every
    frame decoded by the native loader, equal to the written pixels / 255;
    the trajectory bit-equal to ``run_slam_from_images`` on the same decoded
    and padded frames in this process; 200 rows read back from the
    trajectory file; K1/K2/K3 launched 52/26/0; K1 and K2 against their
    plain versions on the first 16 frames evaluate handed to SLAM, with its
    SiftConfig (4 octaves, capacity 512; phase 15's bars). Load seconds,
    SLAM frames/s, peak device memory and ATE / RPE / RRE are printed as
    readings: the defaults lose both sequences, in both packages. Then
    ``evaluate`` on the TUM sequence's first 40 frames with ``--match-gate
    30 --reassoc 2 --max-tracks 16384``, which SLAM solves, on the card and
    with ``--device cpu``: launches 12/6/0, both ATEs < 0.06 and within 0.02
    of each other (phase 15 (c)'s bars).

A kernel's ``bound_ms`` is the least time the card could take: the larger
of the bytes that must move (each input read once, each output written
once) over 3.35 TB/s and the float32 operations over 67 TFLOP/s.

The operation peak counts a fused multiply-add as two operations; the blur
kernels may not fuse (it would change the rounding), so for them half that
rate is the card's real ceiling. The bound keeps the published peak.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the kernels' JSON record, in which every number but ``bound_ms`` was
measured in this run. Each kernel's time before the octave and blur kernels
became one launch on shared-memory tiles is printed beside its timing, on
earlier lines.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

BATCH, HEIGHT, WIDTH = 64, 480, 640
CSRC = "sift_scale_space_extrema_detection_tpu_torch/ops/kernels/csrc/"
PALLAS = "sift_scale_space_extrema_detection_tpu/ops/pallas/"
MAX_ABS_ERR = 1e-6
MASK_AGREEMENT = 0.9999
SLOT_AGREEMENT = 0.999
P99_PX = 0.1
P99_THETA = 1e-3
MIN_COSINE = 0.999
NORM_ATOL = 1e-3
# The card's published peaks (NVIDIA H100 SXM data sheet).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12  # float32 outside the tensor cores
SAMPLE_FLOP = 40  # per gradient sample: 8 differences, 8 halvings, 2 blends of 9, clamps
# Each kernel's time at these shapes before the octave and blur kernels
# became one launch on shared-memory tiles (NVIDIA H100 80GB HBM3, 700.00 W,
# this script), and ``detect_batched``'s peak device memory then.
PREV_MS = {"fused_octave": 17.59, "window_sample_pair": 0.71, "blur_fused": 14.77}
PREV_DETECT_PEAK_GIB = 7.76


ORACLE_ATOL = 1e-10
TWO_VIEW_FOCAL = 520.0
TWO_VIEW_T = (-0.8, 0.05, 0.1)
TWO_VIEW_ROTVEC = (0.02, -0.08, 0.01)
TWO_VIEW_BLOBS = 150
TWO_VIEW_SATELLITES = 5
TWO_VIEW_SEED = 2
TWO_VIEW_BLOB_SIGMA = 24.0  # at unit depth: the test's 12 scaled with the focal length
RANSAC_HYPOTHESES = 512
RANSAC_PX = 2.0
MAX_ROTATION_DEG = 1.0
MIN_TRANSLATION_COS = 0.995
MATCH_AGREEMENT = 0.99
CPU_ROTATION_DEG = 0.1
BA_MAX_RMS_PX = 1.0
BA_SCATTER_RTOL = 1e-3
POSE_GRAPH_NODES = 200
POSE_GRAPH_GAIN = 100.0
SLAM_FRAMES = 40
SLAM_CHUNK = 16
SLAM_REF_LANDMARKS = 20  # tests/test_visual_slam.py:50
SLAM_REF_ATE = 0.06  # tests/test_visual_slam.py:54
SLAM_MIN_LANDMARKS = 100
SLAM_VISIBLE_AGREEMENT = 0.99
SLAM_ATE_GAP = 0.02  # the reference's streaming bound, tests/test_visual_slam.py:234
SLAM_MATCH_GATE_PX = 30.0  # ~1.7x the bench sequence's median flow between frames (17.4 px)
SLAM_MAX_TRACKS = 16_384  # the default 4,096 run out near frame 19 of 40
ORBIT_FRAMES = 50  # BASELINE config[3], tests/test_slam.py:46-60
ORBIT_LANDMARKS = 400
ORBIT_MIN_LANDMARKS = 200
ORBIT_ATE = 0.08  # 1 % of the orbit's radius
SHARD_WORLD = 2  # phase 17 (b): two gloo ranks on the one card
SHARD_TIMEOUT_S = 120  # every collective's limit
SHARD_ATOL = 1e-4  # tests/test_multihost.py:204-219
SHARD_BA = (50, 4096, 512)  # phase 14's dense problem: cameras, landmarks, observations a camera
BA_ITERATIONS = 10
SURFACE_FRAMES = 200  # each on-disk rehearsal sequence
SURFACE_SOLVED_FRAMES = 40  # the rehearsal's solved variant, run on the card and on the CPU
KITTI_SIZE = (1241, 376)  # KITTI odometry's gray frames, width x height
MATMUL_ATOL = 1e-5


def _make_batch(batch: int, h: int, w: int) -> np.ndarray:
    """The benchmark's frames: a smooth pattern with four blobs plus noise,
    quantised to 8-bit levels (the same recipe as ``bench.py``)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 0.4 + 0.2 * np.sin(xx / 9.0) * np.cos(yy / 11.0)
    for cy, cx, r, a in [
        (120, 160, 6.0, 0.5),
        (300, 400, 10.0, -0.35),
        (200, 520, 4.0, 0.45),
        (380, 100, 8.0, 0.3),
    ]:
        base = base + a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
    imgs = base[None] + 0.05 * rng.standard_normal((batch, h, w))
    return (np.round(np.clip(imgs, 0.0, 1.0) * 255.0) / 255.0).astype(np.float32)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _say(msg: str) -> None:
    print(msg, flush=True)


def _octave_sigmas(cfg, octave):
    return [
        None if (octave > 0 and s == 0) else cfg.offset_sigma(octave, s)
        for s in range(cfg.scales_per_octave_total)
    ]


def _event_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _in_turns(torch, kernel, plain, kernel_reps: int, plain_reps: int):
    """``(kernel_ms, plain_ms, rounds)``: both warmed up, then timed in
    turns plain/kernel/kernel/plain, each side the mean of its two rounds."""
    kernel()
    plain()
    rounds = [
        _event_ms(torch, plain, plain_reps),
        _event_ms(torch, kernel, kernel_reps),
        _event_ms(torch, kernel, kernel_reps),
        _event_ms(torch, plain, plain_reps),
    ]
    return (rounds[1] + rounds[2]) / 2, (rounds[0] + rounds[3]) / 2, rounds


def _bound(n_bytes: float, flop: float) -> tuple[float, str]:
    """``(bound_ms, bound_by)`` of work that moves ``n_bytes`` and does
    ``flop`` float32 operations."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
    by_flop = 1e3 * flop / PEAK_FLOP_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_flop else (by_flop, "operations")


def _blur_flop(pixels: int, radius: int) -> int:
    """Two passes of ``2r+1`` products and ``2r`` sums per pixel."""
    return 2 * (2 * (2 * radius + 1) - 1) * pixels


def _window_bytes(torch, stacks, table, ys, xs) -> float:
    """Bytes the window sampling must move for these slots: the slot table,
    the samples written for every slot, and for each valid slot its
    coordinates and the window of its plane that its samples' corners and
    their central differences touch, once."""
    m, n = ys.shape
    octave = table[:, 1].long()
    valid = table[:, 3] != 0
    hs = torch.tensor([s.shape[2] for s in stacks], device=ys.device)[octave]
    ws = torch.tensor([s.shape[3] for s in stacks], device=ys.device)[octave]

    def extent(coords, size):
        corner = coords.clamp(min=0).minimum((size - 1)[:, None]).floor().long()
        lo = (corner.amin(dim=1) - 1).clamp(min=0)
        hi = (corner.amax(dim=1) + 2).minimum(size - 1)
        return hi - lo + 1

    window = (extent(ys, hs) * extent(xs, ws))[valid].sum().item()
    return 16 * m + 8 * m * n + int(valid.sum()) * 8 * n + 4 * window


def _slot_agreement(got, want):
    return (
        (got.valid == want.valid)
        & (~got.valid | ((got.octave == want.octave) & (got.scale_level == want.scale_level)))
    ).float().mean().item()


def _rodrigues(w) -> np.ndarray:
    """Rotation matrix of the axis-angle ``w`` (numpy, float64)."""
    w = np.asarray(w, dtype=np.float64)
    theta = float(np.linalg.norm(w))
    k = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if theta < 1e-12:
        return np.eye(3) + k
    return np.eye(3) + np.sin(theta) / theta * k + (1.0 - np.cos(theta)) / theta**2 * (k @ k)


def _rotation_angle_deg(r_est, r_true) -> float:
    rr = np.asarray(r_est, dtype=np.float64) @ np.asarray(r_true, dtype=np.float64).T
    return float(np.degrees(np.arccos(np.clip((np.trace(rr) - 1.0) / 2.0, -1.0, 1.0))))


def _two_view_scene(synthetic, blobs=TWO_VIEW_BLOBS, satellites=TWO_VIEW_SATELLITES,
                    seed=TWO_VIEW_SEED):
    """Two 480×640 views of one blob field with real parallax: the geometry
    of the two-view test of the JAX package scaled to 640×480 (focal 520,
    blob radius doubled), with 150 blobs of five satellites for its 90 of
    three. The blobs' textures are alike, so the ratio test leaves 20 to 40
    matches of some 400 descriptors a frame whatever the field, about two
    thirds of them inliers, and not every field gives a pose inside the
    bars: of seeds 0-5, four do at 150 blobs × 5 satellites and two at 300 ×
    3. The default field passes with room to spare. The other arguments are
    for ``tests/test_torch_two_view.py``, which runs fields that fail
    through both packages and reads the same matches from both.
    Returns ``(frames (2, H, W) float32, k_mat, r2, t_dir)``."""
    rng = np.random.default_rng(seed)
    k_mat = np.array([[TWO_VIEW_FOCAL, 0, WIDTH / 2], [0, TWO_VIEW_FOCAL, HEIGHT / 2], [0, 0, 1.0]])
    pts = rng.uniform([-2.2, -1.6, 4.0], [2.2, 1.6, 9.0], size=(blobs, 3))
    r2, t_dir = _rodrigues(TWO_VIEW_ROTVEC), np.array(TWO_VIEW_T)
    rpts, amps, sscales = synthetic.textured_blob_field(
        rng, pts, satellites_per_point=satellites
    )
    frames = [
        synthetic.render_blob_image(
            rpts, r, t, k_mat, (WIDTH, HEIGHT), blob_sigma_at_unit_depth=TWO_VIEW_BLOB_SIGMA,
            amplitudes=amps, sigma_scales=sscales, rng=rng,
        )
        for r, t in ((np.eye(3), np.zeros(3)), (r2, t_dir))
    ]
    return np.stack(frames).astype(np.float32), k_mat, r2, t_dir


def _ba_problem(rng, c: int, l: int, opc: int):
    """The bundle-adjustment benchmark's problem (``benchmarks/ba_bench.py``),
    as numpy float32 arrays: a ring of ``c`` cameras orbiting a cloud of
    ``l`` points, ``opc`` observations per camera of points in front of it,
    0.5 px of pixel noise, the points started 0.05 off the truth."""
    dtype = np.float32
    pts = rng.uniform([-4, -4, -4], [4, 4, 4], size=(l, 3)).astype(dtype)
    k_mat = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], dtype)
    radius = 12.0
    rots, ts, cams, lms, uvs = [], [], [], [], []
    for ci in range(c):
        ang = 2.0 * np.pi * ci / max(c, 1)
        r = _rodrigues([0.0, ang, 0.0]).astype(dtype)
        center = radius * np.array([np.sin(ang), 0.1 * np.sin(3 * ang), -np.cos(ang)])
        t = (-r @ center).astype(dtype)
        depths = pts @ r.T[:, 2] + t[2]
        front = np.where(depths > 2.0)[0]
        sel = rng.choice(front, opc, replace=len(front) < opc)
        xc = pts[sel] @ r.T + t
        uv = xc[:, :2] / xc[:, 2:3] * 500.0 + [320, 240]
        uv += 0.5 * rng.normal(size=uv.shape)
        rots.append(r)
        ts.append(t)
        cams.append(np.full(opc, ci))
        lms.append(sel)
        uvs.append(uv)
    return dict(
        rotations=np.stack(rots),
        translations=np.stack(ts),
        points=pts + 0.05 * rng.normal(size=pts.shape).astype(dtype),
        k_mat=k_mat,
        camera=np.concatenate(cams).astype(np.int32),
        landmark=np.concatenate(lms).astype(np.int32),
        uv=np.concatenate(uvs).astype(dtype),
    )


def _circle_graph(rng, n: int, drift: float = 0.03):
    """An odometry chain around a circle plus the loop-closure edge
    ``n-1 → 0`` with true relative transforms, and initial poses drifted by
    accumulated noise (numpy float64): ``(est_r, est_t, src, dst, rel_r,
    rel_t)``."""
    rots, ts = [], []
    for i in range(n):
        ang = 2 * np.pi * i / n
        r = _rodrigues([0.0, ang, 0.0])
        rots.append(r)
        ts.append(-r @ np.array([np.cos(ang) * 5, 0.0, np.sin(ang) * 5]))
    src = np.array(list(range(n - 1)) + [n - 1])
    dst = np.array(list(range(1, n)) + [0])
    rel_r = [rots[d] @ rots[s].T for s, d in zip(src, dst)]
    rel_t = [rots[d] @ (-rots[s].T @ ts[s]) + ts[d] for s, d in zip(src, dst)]
    est_r, est_t = [rots[0]], [ts[0]]
    for i in range(1, n):
        est_r.append(_rodrigues(drift * rng.normal(size=3)) @ rots[i])
        est_t.append(ts[i] + drift * 5 * rng.normal(size=3))
    return np.stack(est_r), np.stack(est_t), src, dst, np.stack(rel_r), np.stack(rel_t)


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host_ms(torch, fn, reps: int, dev=None) -> float:
    """Mean host-clock time of ``fn()`` over ``reps`` calls, synchronised
    before and after (the card, unless ``dev`` is another device), after one
    warm-up call."""
    dev = torch.device("cuda") if dev is None else dev
    fn()
    _sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(torch, dev)
    return 1e3 * (time.perf_counter() - t0) / reps


def _phase_oracle_leg(torch, port) -> None:
    """Phase 12: the float64 ``blur="exact"`` leg on the card against the
    same calls on the CPU."""
    cfg = port.SiftConfig()
    frame = torch.from_numpy(_make_batch(1, 96, 128).astype(np.float64))
    t0 = time.perf_counter()
    space = port.build_scale_space(frame, cfg, blur="exact")
    dogs = port.build_dog(space)
    keypoints, _ = port.detect_from_dog(dogs, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want_space = port.build_scale_space(frame, cfg, blur="exact", device="cpu")
    want_dogs = port.build_dog(want_space)
    want, _ = port.detect_from_dog(want_dogs, cfg)
    _require(all(s.dtype == torch.float64 and s.device.type == "cpu" for s in want_space),
             "the CPU leg left float64 or the CPU")
    _require(all(s.is_cuda for s in space) and keypoints.valid.is_cuda,
             "the oracle leg of a CPU tensor did not run on the card")
    space_equal = all(torch.equal(a.cpu(), b) for a, b in zip(space, want_space))
    dog_equal = all(torch.equal(a.cpu(), b) for a, b in zip(dogs, want_dogs))
    valid = want.valid
    same_slots = all(
        torch.equal(getattr(keypoints, f).cpu(), getattr(want, f))
        for f in ("valid", "reject_reason", "octave", "scale_level", "local_y", "local_x")
    )
    float_err = max(
        (getattr(keypoints, f).cpu() - getattr(want, f))[valid].abs().max().item()
        for f in ("abs_x", "abs_y", "abs_sigma", "value")
    )
    _say(
        f"oracle leg: float64 blur='exact' on a 96x128 frame, {cfg.num_octaves} octaves x "
        f"{cfg.scales_per_octave} scales, card against CPU: scale space bit-equal "
        f"{space_equal}, DoG bit-equal {dog_equal}, keypoint slots and reject codes equal "
        f"{same_slots} ({int(valid.sum())} valid of {valid.numel()} slots, reject counts "
        f"{want.reject_counts().sum(0).tolist()}), float fields max abs diff {float_err:.3g}; "
        f"{seconds:.2f} s on the card"
    )
    _require(len(space) == cfg.num_octaves and space[0].dtype == torch.float64,
             "the oracle leg's scale space is not float64")
    _require(space_equal, "oracle leg: the scale space differs between card and CPU")
    _require(dog_equal, "oracle leg: the DoG differs between card and CPU")
    _require(int(valid.sum()) > 0, "oracle leg: no valid keypoint")
    _require(same_slots, "oracle leg: keypoint slots or reject codes differ")
    _require(float_err <= ORACLE_ATOL, f"oracle leg: float fields differ by {float_err}")


def _kernels_vs_plain(torch, frames, cfg, described):
    """K1 and K2 against their plain versions on ``frames`` (unit-float, on
    the card) at the shapes a described path gives them: the pyramids (DoG,
    Gaussian stacks, masks), the slots both describe stages sample, and the
    path's ``described`` result against the same path through the plain
    versions. Returns ``(octave_err, masks_same, sample_err, stage_shapes,
    slots_same, described_err)``."""
    from sift_scale_space_extrema_detection_tpu_torch.models.frontend import (
        build_pyramid_fused,
        detect_octaves,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.descriptor import describe_compact
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.describe import (
        window_sample_pair,
        window_sample_pair_reference,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import (
        fused_octave_reference,
    )

    dogs, masks, stacks = build_pyramid_fused(frames, cfg, emit_scales=True, device=frames.device)
    plain_dogs, plain_masks, plain_stacks = build_pyramid_fused(
        frames, cfg, octave_fn=fused_octave_reference, emit_scales=True, device=frames.device
    )
    octave_err = max(
        (a - b).abs().max().item() for a, b in zip(dogs + stacks, plain_dogs + plain_stacks)
    )
    masks_same = min((a == b).float().mean().item() for a, b in zip(masks, plain_masks))
    keypoints_list, _ = detect_octaves(dogs, cfg, masks)
    stages = []

    def recording(stacks, table, ys, xs):
        stages.append((table, ys, xs))
        return window_sample_pair(stacks, table, ys, xs)

    describe_compact(stacks, keypoints_list, cfg, sample_fn=recording)
    _require(len(stages) == 2, f"{len(stages)} describe stages sampled")
    sample_err = 0.0
    for table, ys, xs in stages:
        got = window_sample_pair(stacks, table, ys, xs)
        want = window_sample_pair_reference(stacks, table, ys, xs)
        sample_err = max(sample_err, *((g - w).abs().max().item() for g, w in zip(got, want)))
    plain_keypoints, _ = detect_octaves(plain_dogs, cfg, plain_masks)
    plain_described = describe_compact(
        plain_stacks, plain_keypoints, cfg, sample_fn=window_sample_pair_reference
    )
    _sync(torch, frames.device)
    slots_same = _slot_agreement(described, plain_described)
    both = described.valid & plain_described.valid
    described_err = (described.descriptor - plain_described.descriptor)[both].abs().max().item()
    shapes = [tuple(st[1].shape) for st in stages]
    return octave_err, masks_same, sample_err, shapes, slots_same, described_err


def _phase_two_view(torch, port, smi) -> tuple[float, float]:
    """Phase 13: two frames → relative pose → structure → PnP, on the card,
    against the same descriptors through ``device="cpu"``. The octave and
    sampling kernels are held against their plain versions on these frames
    and their slots; returns their largest differences ``(octave, sampling)``."""
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.blur import blur_fused
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.describe import window_sample_pair
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import fused_octave
    from sift_scale_space_extrema_detection_tpu_torch.ops.ransac import _eight_point_nullvec
    from sift_scale_space_extrema_detection_tpu_torch.sfm import geometry as geo
    from sift_scale_space_extrema_detection_tpu_torch.sfm.pnp import pnp_dlt, solve_pnp
    from sift_scale_space_extrema_detection_tpu_torch.utils import synthetic

    cfg = port.SiftConfig(num_octaves=4, scales_per_octave=5, max_keypoints_per_trio=512)
    frames, k_np, r2, t_dir = _two_view_scene(synthetic)
    t_unit = t_dir / np.linalg.norm(t_dir)
    frames = torch.from_numpy(frames)
    k_cpu = torch.from_numpy(k_np).float()
    thresh = RANSAC_PX / TWO_VIEW_FOCAL

    fused_octave.launches = window_sample_pair.launches = blur_fused.launches = 0
    described = port.detect_and_describe_batched(frames, cfg)
    torch.cuda.synchronize()
    launches = fused_octave.launches, window_sample_pair.launches, blur_fused.launches
    n_pairs = cfg.descriptor_pair_capacity()
    _require(launches == (cfg.num_octaves, 2, 0),
             f"the two-view path launched the octave, sampling and blur kernels {launches} times")
    _require(tuple(described.descriptor.shape) == (2, n_pairs, 128),
             f"two-view descriptor shape {tuple(described.descriptor.shape)}")

    # Both kernels against their plain versions at this path's shapes: the
    # two frames' pyramids, then the slots the path samples, then the whole.
    octave_err, masks_same, sample_err, stage_shapes, slots_same, described_err = (
        _kernels_vs_plain(torch, frames.cuda(), cfg, described)
    )
    _say(
        f"two views, kernels vs plain on these frames: DoG and Gaussian stacks max abs diff "
        f"{octave_err:.3g}, masks equal on {100 * masks_same:.4f} % of pixels, window samples "
        f"of both stages {stage_shapes} max abs diff {sample_err:.3g}; "
        f"the whole path through the plain versions: slot agreement {slots_same:.6f}, "
        f"descriptors max abs diff {described_err:.3g}"
    )
    _require(octave_err <= MAX_ABS_ERR, "two views: the octave kernel differs from its plain version")
    _require(masks_same >= MASK_AGREEMENT, "two views: the octave kernel's masks disagree")
    _require(sample_err <= MAX_ABS_ERR, "two views: the sampling kernel differs from its plain version")
    _require(slots_same >= SLOT_AGREEMENT, "two views: slots differ from the plain path's")
    _require(described_err <= MAX_ABS_ERR, "two views: descriptors differ from the plain path's")

    def two_view(desc, valid, abs_x, abs_y, k_mat, where):
        """Matching → rays → RANSAC from one frame pair's described slots."""
        matches = port.match_descriptors(desc[0], valid[0], desc[1], valid[1], device=where)
        index = matches.index.long()
        uv1 = torch.stack([abs_x[0], abs_y[0]], dim=-1).to(matches.index.device)
        uv2 = torch.stack([abs_x[1], abs_y[1]], dim=-1).to(matches.index.device)[index]
        k_mat = k_mat.to(matches.index.device)
        rays1, rays2 = geo.backproject(uv1, k_mat), geo.backproject(uv2, k_mat)
        result = port.estimate_essential_ransac(
            rays1, rays2, matches.valid, torch.Generator().manual_seed(0),
            num_hypotheses=RANSAC_HYPOTHESES, inlier_threshold=thresh, device=where,
        )
        return matches, uv2, rays1, rays2, result

    fields = (described.descriptor, described.valid, described.abs_x, described.abs_y)
    matches, uv2, rays1, rays2, result = two_view(*fields, k_cpu, None)
    torch.cuda.synchronize()
    _require(all(t.is_cuda for t in (described.descriptor, matches.index, result.rotation,
                                     result.inliers)),
             "the two-view path of CPU tensors did not run on the card")
    inl = result.inliers
    rot_err = _rotation_angle_deg(result.rotation.cpu().numpy(), r2)
    cos_t = abs(float(result.translation.double().cpu().numpy() @ t_unit))
    eye = torch.eye(3, device=rays1.device)
    tri, depths = geo.triangulate_midpoint(
        eye, eye.new_zeros(3), result.rotation, result.translation, rays1[inl], rays2[inl]
    )
    _say(
        f"two views: 2x{HEIGHT}x{WIDTH} frames of {TWO_VIEW_BLOBS} blobs, kernel launches "
        f"octave {launches[0]} sampling {launches[1]} blur {launches[2]}; valid descriptors "
        f"{described.valid.sum(dim=1).tolist()} of {n_pairs} pair slots, matches "
        f"{int(matches.valid.sum())}, RANSAC ({RANSAC_HYPOTHESES} hypotheses, {RANSAC_PX} px) "
        f"inliers {int(result.num_inliers)}; rotation error {rot_err:.4f} deg, translation "
        f"cosine {cos_t:.6f}, least inlier depth {depths.min().item():.3f}"
    )
    _require(int(matches.valid.sum()) >= 15 and int(result.num_inliers) >= 12,
             "two views: too few matches or inliers")
    _require(rot_err < MAX_ROTATION_DEG, "two views: rotation error above the bar")
    _require(cos_t > MIN_TRANSLATION_COS, "two views: translation direction off")
    _require(bool((depths > 0).all()) and bool(torch.isfinite(tri).all()),
             "two views: an inlier triangulates behind a camera")

    # PnP on the triangulated inliers recovers the second camera, in the
    # reconstruction's own scale (its translation has unit norm).
    ok = torch.ones(tri.shape[0], dtype=torch.bool, device=tri.device)
    k_dev = k_cpu.to(tri.device)
    r0, t0 = pnp_dlt(tri, uv2[inl], ok, k_dev)
    rot, t, rms = solve_pnp(tri, uv2[inl], ok, k_dev, r0, t0)
    pnp_err = _rotation_angle_deg(rot.cpu().numpy(), r2)
    pnp_cos = float((t / t.norm()).double().cpu().numpy() @ t_unit)
    _say(
        f"two views, PnP from pnp_dlt on {tri.shape[0]} triangulated inliers: rotation error "
        f"{pnp_err:.4f} deg, translation cosine {pnp_cos:.6f}, rms {rms.item():.3f} px"
    )
    _require(pnp_err < MAX_ROTATION_DEG and pnp_cos > MIN_TRANSLATION_COS,
             "two views: PnP does not recover the second camera")

    # The same descriptors and the same generator seed on the CPU.
    cpu_matches, _, _, _, cpu_result = two_view(*(f.cpu() for f in fields), k_cpu, "cpu")
    either = matches.valid.cpu() | cpu_matches.valid
    same = (matches.valid.cpu() == cpu_matches.valid) & (
        ~cpu_matches.valid | (matches.index.cpu() == cpu_matches.index)
    )
    agreement = same[either].float().mean().item()
    cpu_rot = _rotation_angle_deg(result.rotation.cpu().numpy(), cpu_result.rotation.numpy())
    _say(
        f"two views, card against device='cpu' on the same descriptors and seed: match "
        f"agreement {agreement:.6f} over {int(either.sum())} valid slots, inliers "
        f"{int(result.num_inliers)} vs {int(cpu_result.num_inliers)}, rotations {cpu_rot:.5f} "
        f"deg apart"
    )
    _require(agreement >= MATCH_AGREEMENT, "two views: the card's matches differ from the CPU's")
    _require(cpu_rot <= CPU_ROTATION_DEG, "two views: the card's rotation differs from the CPU's")

    desc, valid = described.descriptor, described.valid
    generator = torch.Generator().manual_seed(0)
    rows = torch.randn(RANSAC_HYPOTHESES, 8, 9, device=rays1.device)
    match_ms = _host_ms(
        torch, lambda: port.match_descriptors(desc[0], valid[0], desc[1], valid[1]), 10
    )
    ransac_ms = _host_ms(
        torch,
        lambda: port.estimate_essential_ransac(
            rays1, rays2, matches.valid, generator, num_hypotheses=RANSAC_HYPOTHESES,
            inlier_threshold=thresh,
        ),
        5,
    )
    svd_ms = _host_ms(torch, lambda: _eight_point_nullvec(rows), 5)
    dlt_ms = _host_ms(torch, lambda: pnp_dlt(tri, uv2[inl], ok, k_dev), 5)
    pnp_ms = _host_ms(torch, lambda: solve_pnp(tri, uv2[inl], ok, k_dev, r0, t0), 5)
    _say(
        f"timing two views: match_descriptors {n_pairs}x{n_pairs} {match_ms:.3f} ms, "
        f"estimate_essential_ransac {ransac_ms:.2f} ms (its batched SVD of "
        f"{tuple(rows.shape)} alone {svd_ms:.2f} ms), pnp_dlt {dlt_ms:.2f} ms, solve_pnp "
        f"{pnp_ms:.2f} ms per call on {tri.shape[0]} points [{smi}]"
    )
    return octave_err, sample_err


def _phase_solvers(torch, port, smi) -> None:
    """Phase 14: bundle adjustment (dense and CG) and the pose graph."""
    from sift_scale_space_extrema_detection_tpu_torch.sfm.ba import (
        BAState,
        Observations,
        bundle_adjust,
    )
    from sift_scale_space_extrema_detection_tpu_torch.sfm.pose_graph import (
        PoseGraphEdges,
        optimize_pose_graph,
        pose_graph_residuals,
    )

    sizes = {"dense": (50, 4096, 512), "cg": (1000, 100_000, 300)}
    iterations = 10
    for solver, (c, l, opc) in sizes.items():
        p = {k: torch.from_numpy(v) for k, v in _ba_problem(np.random.default_rng(0), c, l, opc).items()}
        state = BAState(p["rotations"], p["translations"], p["points"], p["k_mat"])
        obs = Observations(p["camera"], p["landmark"], p["uv"],
                           torch.ones(c * opc, dtype=torch.bool))
        n_obs = c * opc
        # All state lives on the card.
        state, obs = (type(v)(**{k: t.cuda() for k, t in vars(v).items()}) for v in (state, obs))

        def run(num_iterations=iterations, **kw):
            return bundle_adjust(state, obs, num_iterations=num_iterations, solver=solver,
                                 cg_iterations=32, **kw)

        def rms(cost):
            return float(torch.sqrt(2.0 * cost / n_obs))

        _, cost0 = run(num_iterations=0)
        run()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, cost = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        again, cost_again = run()
        same_bits = all(
            torch.equal(getattr(out, f), getattr(again, f))
            for f in ("rotations", "translations", "points")
        ) and torch.equal(cost, cost_again)
        name = "dense, sorted assembly" if solver == "dense" else "CG, 32 steps"
        _say(
            f"bundle adjustment ({name}): {c} cameras x {l} landmarks x {n_obs} observations, "
            f"{iterations} LM iterations: cost {cost0.item():.1f} -> {cost.item():.1f}, rms "
            f"{rms(cost0):.3f} -> {rms(cost):.3f} px, second run bit-equal {same_bits}; "
            f"{iterations / seconds:.2f} LM iterations/s, {1e3 * seconds / iterations:.2f} ms per "
            f"iteration, peak device memory {peak_gib:.3f} GiB [{smi}]"
        )
        _require(out.points.is_cuda and cost.is_cuda, "bundle_adjust left the card")
        _require(bool(torch.isfinite(out.points).all() & torch.isfinite(out.translations).all()),
                 f"bundle adjustment ({solver}): the state is not finite")
        _require(cost.item() < cost0.item(), f"bundle adjustment ({solver}): the cost did not fall")
        _require(rms(cost) < BA_MAX_RMS_PX, f"bundle adjustment ({solver}): rms above the bar")
        _require(same_bits, f"bundle adjustment ({solver}): two runs differ")
        if solver == "dense":
            _, scatter_cost = run(assembly="scatter")
            rel = abs(scatter_cost.item() - cost.item()) / cost.item()
            scatter_ms = _host_ms(torch, lambda: run(assembly="scatter"), 1)
            _say(
                f"bundle adjustment (dense, scatter assembly): final cost "
                f"{scatter_cost.item():.1f}, {rel:.3g} relative of the sorted cost; "
                f"{scatter_ms / iterations:.2f} ms per iteration [{smi}]"
            )
            _require(rel <= BA_SCATTER_RTOL, "the scatter assembly ends at another cost")
        del state, obs, out, again

    n = POSE_GRAPH_NODES
    est_r, est_t, src, dst, rel_r, rel_t = _circle_graph(np.random.default_rng(5), n)
    edges = PoseGraphEdges(
        src=torch.from_numpy(src).int(), dst=torch.from_numpy(dst).int(),
        rel_rotation=torch.from_numpy(rel_r).float(), rel_translation=torch.from_numpy(rel_t).float(),
        weight=torch.ones(len(src)),
    )
    rots, ts = torch.from_numpy(est_r).float(), torch.from_numpy(est_t).float()
    r0 = pose_graph_residuals(rots, ts, edges)
    cost0 = 0.5 * float((r0 * r0).sum())
    graph_iterations = 20
    opt_r, opt_t, cost = optimize_pose_graph(rots, ts, edges, graph_iterations)
    torch.cuda.synchronize()
    graph_ms = _host_ms(
        torch, lambda: optimize_pose_graph(rots, ts, edges, graph_iterations), 1
    )
    _say(
        f"pose graph: {n}-node drifted loop, {len(src)} edges, {graph_iterations} LM iterations: "
        f"cost {cost0:.4g} -> {cost.item():.4g} ({cost0 / max(cost.item(), 1e-30):.3g}x lower); "
        f"{graph_ms:.1f} ms per solve, {graph_ms / graph_iterations:.2f} ms per iteration [{smi}]"
    )
    _require(opt_r.is_cuda and opt_t.is_cuda, "optimize_pose_graph left the card")
    _require(bool(torch.isfinite(opt_r).all() & torch.isfinite(opt_t).all()),
             "pose graph: the poses are not finite")
    _require(cost.item() * POSE_GRAPH_GAIN <= cost0, "pose graph: the cost fell by less than 100x")


def _render_dolly(synthetic, rng, pts, k_mat, num_frames, size, step):
    """Frames of a slow lateral dolly (centre ``step·f``, a slow rotation)
    past a textured blob field: the recipe of the JAX package's SLAM tests
    and of ``benchmarks/slam_bench.py::render_sequence``, with the rotation
    by Rodrigues in numpy. Returns ``(frames, rotations, translations)``."""
    rpts, amps, sscales = synthetic.textured_blob_field(rng, pts)
    rots, ts, frames = [], [], []
    for f in range(num_frames):
        r = _rodrigues([0.004 * f, -0.01 * f, 0.002 * f])
        t = -r @ np.array([step[0] * f, step[1] * f, 0.0])
        frames.append(synthetic.render_blob_image(
            rpts, r, t, k_mat, size, amplitudes=amps, sigma_scales=sscales,
            rng=np.random.default_rng(100 + f),
        ))
        rots.append(r)
        ts.append(t)
    return np.stack(frames), np.stack(rots), np.stack(ts)


def _test_sequence(synthetic):
    """``tests/test_visual_slam.py::_render_sequence``, seed 0: 8 frames at
    320×240 past 110 blobs. Returns ``(frames, rotations, translations,
    k_mat)``."""
    rng = np.random.default_rng(0)
    k_mat = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
    pts = rng.uniform([-3.5, -1.8, 4.0], [3.5, 1.8, 9.0], size=(110, 3))
    return (*_render_dolly(synthetic, rng, pts, k_mat, 8, (320, 240), (0.28, 0.02)), k_mat)


def _bench_sequence(synthetic, num_frames: int, w: int, h: int):
    """``benchmarks/slam_bench.py::render_sequence``, seed 0: the blob field
    extends along the dolly path at constant density, the focal length
    scales with the width. Returns ``(frames, rotations, translations,
    k_mat)``."""
    rng = np.random.default_rng(0)
    focal = 260.0 * w / 320
    k_mat = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]])
    x_hi = 3.5 + 0.14 * num_frames
    n_pts = int(160 * (x_hi + 3.5) / 7.0)
    pts = rng.uniform([-3.5, -1.8, 4.0], [x_hi, 1.8, 9.0], size=(n_pts, 3))
    return (*_render_dolly(synthetic, rng, pts, k_mat, num_frames, (w, h), (0.14, 0.01)), k_mat)


def slam_bench_recipe(port, frames: int = SLAM_FRAMES, width: int = WIDTH, height: int = HEIGHT):
    """Phase 15's full-width SLAM recipe, ``benchmarks/slam_bench.py``'s
    default: the frames (uint16, as the bench uploads them), the truth, the
    configurations and the association arguments. ``solved`` holds the
    association arguments of the variant SLAM solves (the match gate and
    the track room, see phase 15 (c)). Returns a dict."""
    from sift_scale_space_extrema_detection_tpu_torch.utils import synthetic

    images, gt_r, gt_t, k_mat = _bench_sequence(synthetic, frames, width, height)
    return dict(
        images=np.round(np.clip(images, 0.0, 1.0) * 65535.0).astype(np.uint16),
        gt_r=gt_r,
        gt_t=gt_t,
        k_mat=k_mat,
        sift_cfg=port.SiftConfig(num_octaves=3, max_keypoints_per_trio=256,
                                 describe_compaction=0.5, descriptor_grid_size=16,
                                 orientation_grid_size=16),
        slam_cfg=port.SlamConfig(ba_interval=5, ba_window=8, ba_iterations=6,
                                 final_ba_rounds=2),
        reassoc_window=2,
        solved=dict(max_match_px=SLAM_MATCH_GATE_PX, max_tracks=SLAM_MAX_TRACKS),
    )


def _count_bas(slam_module):
    """Count the BAs of ``models/slam.py``: returns ``(read, restore)``;
    ``read()`` gives ``(single-device, sharded)`` calls since this call,
    ``restore()`` takes the counting wrapper off ``slam_module.bundle_adjust``."""
    from sift_scale_space_extrema_detection_tpu_torch.parallel import distributed_bundle_adjust

    inner, calls, base = slam_module.bundle_adjust, [0], distributed_bundle_adjust.calls

    def counted(*args, **kwargs):
        calls[0] += 1
        return inner(*args, **kwargs)

    slam_module.bundle_adjust = counted

    def read():
        return calls[0], distributed_bundle_adjust.calls - base

    def restore():
        slam_module.bundle_adjust = inner

    return read, restore


def _orbit_sequence(synthetic, frames=ORBIT_FRAMES):
    """BASELINE config[3]: ``orbit_sequence(default_rng(2), 50, 400,
    noise_px=0.4, outlier_frac=0.02)`` (tests/test_slam.py:46-60)."""
    return synthetic.orbit_sequence(np.random.default_rng(2), num_frames=frames,
                                    num_landmarks=ORBIT_LANDMARKS, noise_px=0.4,
                                    outlier_frac=0.02)


def _phase_slam(torch, port, smi, dev, frames=SLAM_FRAMES, width=WIDTH, height=HEIGHT):
    """Phase 15: images → trajectory, batch and streaming, on ``dev``.
    Returns ``(batch launches, streaming launches, octave_err, sample_err,
    refs)``; the launches are (K1, K2, K3) counts, ``refs`` the readings
    phase 17 holds its sharded runs against: the gated sequence's ATE
    (``solved_ate``) and config[3]'s ATE and BA count (``orbit_ate``,
    ``orbit_bas``)."""
    from sift_scale_space_extrema_detection_tpu_torch.models import slam as slam_module
    from sift_scale_space_extrema_detection_tpu_torch.models.frontend import _as_unit_float
    from sift_scale_space_extrema_detection_tpu_torch.models.slam import (
        build_tracks_from_described,
        describe_frames,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.blur import blur_fused
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.describe import window_sample_pair
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import fused_octave
    from sift_scale_space_extrema_detection_tpu_torch.utils import checkpoint, synthetic
    from sift_scale_space_extrema_detection_tpu_torch.utils.profile import StageProfile

    def zero():
        fused_octave.launches = window_sample_pair.launches = blur_fused.launches = 0

    def counts():
        return fused_octave.launches, window_sample_pair.launches, blur_fused.launches

    def finite(result):
        return bool(np.isfinite(result.rotations).all() & np.isfinite(result.translations).all())

    # (a) the JAX package's own bar, at its size; and the same tracks
    # through the back end with device="cpu" (a sequence SLAM solves, so
    # float32 rounding cannot move its ATE far).
    images, gt_r, gt_t, k_mat = _test_sequence(synthetic)
    small_cfg = port.SiftConfig(num_octaves=3, max_keypoints_per_trio=256)
    small_slam = port.SlamConfig(ba_interval=3, ba_window=6)
    zero()
    pixels, visible, _ = port.build_tracks_from_images(images, small_cfg, k_mat, device=dev)
    result = port.run_slam(pixels, visible, k_mat, small_slam, device=dev)
    small_launches = counts()
    ate = port.evaluate_ate(result, gt_r, gt_t, device=dev)
    ate_cpu = port.evaluate_ate(port.run_slam(pixels, visible, k_mat, small_slam, device="cpu"),
                                gt_r, gt_t, device="cpu")
    _say(
        f"SLAM, the reference's bar: 8 x 320x240 frames, build_tracks_from_images + run_slam: "
        f"launches {small_launches}, valid landmarks {int(result.landmark_valid.sum())} (bar > "
        f"{SLAM_REF_LANDMARKS}), ATE {ate:.4f} (bar < {SLAM_REF_ATE}); the same tracks with "
        f"device='cpu': ATE {ate_cpu:.4f} (bar: within {SLAM_ATE_GAP})"
    )
    _require(small_launches[0] > 0, "the SLAM path did not launch the octave kernel")
    _require(int(result.landmark_valid.sum()) > SLAM_REF_LANDMARKS, "SLAM: too few landmarks")
    _require(ate < SLAM_REF_ATE, "SLAM: ATE above the reference's bar")
    _require(abs(ate - ate_cpu) < SLAM_ATE_GAP, "SLAM: the card's ATE differs from the CPU's")

    # (b) full width: slam_bench.py's default recipe, uint16 frames.
    recipe = slam_bench_recipe(port, frames, width, height)
    images, gt_r, gt_t, k_mat = (recipe[k] for k in ("images", "gt_r", "gt_t", "k_mat"))
    sift_cfg, slam_cfg = recipe["sift_cfg"], recipe["slam_cfg"]
    chunks = -(-frames // SLAM_CHUNK)

    def batch(**kw):
        return port.run_slam_from_images(images, k_mat, sift_cfg, slam_cfg,
                                         reassoc_window=recipe["reassoc_window"],
                                         frontend_chunk=SLAM_CHUNK, device=dev, **kw)

    batch()  # warm-up
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero()
    t0 = time.perf_counter()
    result = batch()
    _sync(torch, dev)
    seconds = time.perf_counter() - t0
    launches = counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    ate_batch = port.evaluate_ate(result, gt_r, gt_t, device=dev)
    again = batch()
    same_bits = np.array_equal(again.rotations, result.rotations) and np.array_equal(
        again.translations, result.translations
    )
    n_landmarks = int(result.landmark_valid.sum())
    _say(
        f"SLAM batch: {frames} x {height}x{width} uint16 frames, run_slam_from_images "
        f"(ba_interval 5, ba_window 8, reassoc_window 2, chunks of {SLAM_CHUNK}): launches "
        f"K1/K2/K3 {launches} (expected {(3 * chunks, 2 * chunks, 0)}), valid landmarks "
        f"{n_landmarks} of {result.points.shape[0]} tracks, {result.num_observations} "
        f"observations, ATE {ate_batch:.4f} (a reading: the reference's spread 0.05-1.58), "
        f"second run bit-equal {same_bits}"
    )
    _require(launches == (3 * chunks, 2 * chunks, 0),
             f"the SLAM batch path launched K1/K2/K3 {launches} times")
    _require(finite(result), "SLAM batch: the trajectory is not finite")
    _require(n_landmarks > SLAM_MIN_LANDMARKS, "SLAM batch: too few landmarks")
    _require(same_bits, "SLAM batch: two runs differ")

    # Both kernels against their plain versions on the first chunk.
    first = torch.from_numpy(images[:SLAM_CHUNK]).to(dev)
    octave_err, masks_same, sample_err, stage_shapes, slots_same, described_err = (
        _kernels_vs_plain(torch, _as_unit_float(first), sift_cfg,
                          port.detect_and_describe_batched(first, sift_cfg, device=dev))
    )
    _say(
        f"SLAM, kernels vs plain on the first chunk {tuple(first.shape)}: DoG and Gaussian stacks "
        f"max abs diff {octave_err:.3g}, masks equal on {100 * masks_same:.4f} % of pixels, "
        f"window samples {stage_shapes} max abs diff {sample_err:.3g}; the chunk through the "
        f"plain versions: slot agreement {slots_same:.6f}, descriptors max abs diff "
        f"{described_err:.3g}"
    )
    _require(max(octave_err, sample_err, described_err) <= MAX_ABS_ERR,
             "SLAM: a kernel differs from its plain version on the first chunk")
    _require(masks_same >= MASK_AGREEMENT and slots_same >= SLOT_AGREEMENT,
             "SLAM: masks or slots differ from the plain path's on the first chunk")
    del first

    # (c) the card's described keypoints through the association on the
    # card and on the CPU. SLAM loses these tracks at its bootstrap, in both
    # packages (frame 1 comes out moving along the optical axis), and then a
    # rounding difference flips its gates: the ATE of run_slam on the card's
    # tracks, card against CPU, is a reading. The bar is held on the same
    # keypoints tracked with the match gate and the track room SLAM needs
    # here (PERF.md §6).
    described = describe_frames(images, sift_cfg, SLAM_CHUNK, device=dev)
    track = dict(reassoc_window=recipe["reassoc_window"])
    pixels, visible, _ = build_tracks_from_described(described, k_mat, device=dev, **track)
    cpu_described = type(described)(**{k: v.cpu() for k, v in vars(described).items()})
    _, cpu_visible, _ = build_tracks_from_described(cpu_described, k_mat, device="cpu", **track)
    n = max(visible.shape[1], cpu_visible.shape[1])
    padded = [np.pad(v, ((0, 0), (0, n - v.shape[1]))) for v in (visible, cpu_visible)]
    agreement = float((padded[0] == padded[1]).mean())
    card = port.run_slam(pixels, visible, k_mat, slam_cfg, device=dev)
    ate_card = port.evaluate_ate(card, gt_r, gt_t, device=dev)
    ate_cpu = port.evaluate_ate(port.run_slam(pixels, visible, k_mat, slam_cfg, device="cpu"),
                                gt_r, gt_t, device="cpu")
    g_pixels, g_visible, _ = build_tracks_from_described(described, k_mat, device=dev, **track,
                                                         **recipe["solved"])
    ate_solved = port.evaluate_ate(port.run_slam(g_pixels, g_visible, k_mat, slam_cfg, device=dev),
                                   gt_r, gt_t, device=dev)
    ate_solved_cpu = port.evaluate_ate(
        port.run_slam(g_pixels, g_visible, k_mat, slam_cfg, device="cpu"), gt_r, gt_t, device="cpu"
    )
    _say(
        f"SLAM card against device='cpu': tracks {visible.shape[1]} vs {cpu_visible.shape[1]}, "
        f"visible masks agree on {agreement:.6f} of entries; run_slam on the card's tracks, "
        f"float32: ATE {ate_card:.4f} on the card, {ate_cpu:.4f} on the CPU (a reading); on the "
        f"same keypoints tracked with a {SLAM_MATCH_GATE_PX:g} px match gate and room for "
        f"{SLAM_MAX_TRACKS} tracks ({g_visible.shape[1]} tracks): ATE {ate_solved:.4f} on the card, "
        f"{ate_solved_cpu:.4f} on the CPU (bars: < {SLAM_REF_ATE} and within {SLAM_ATE_GAP})"
    )
    _require(agreement >= SLAM_VISIBLE_AGREEMENT, "SLAM: the card's tracks differ from the CPU's")
    _require(max(ate_solved, ate_solved_cpu) < SLAM_REF_ATE,
             "SLAM: the gated full-width sequence is not solved")
    _require(abs(ate_solved - ate_solved_cpu) < SLAM_ATE_GAP,
             "SLAM: the card's float32 ATE differs from the CPU's")

    # (d) streaming over the same frames: each step verifies the batch run's
    # pairs and solves the batch run's windows (models/slam.py), so the
    # result is the batch run's, bit for bit.
    stored = set(checkpoint._MEM_STORE)
    sess = port.SlamSession(k_mat, sift_cfg, slam_cfg, reassoc_window=recipe["reassoc_window"],
                            device=dev)
    zero()
    step_ms = []
    for image in images:
        t0 = time.perf_counter()
        update = sess.add_frame(image)
        if update is not None:
            step_ms.append(1e3 * (time.perf_counter() - t0))
    streamed = sess.finalize()
    stream_launches = counts()
    ate_stream = port.evaluate_ate(streamed, gt_r, gt_t, device=dev)
    stream_same = np.array_equal(streamed.rotations, result.rotations) and np.array_equal(
        streamed.translations, result.translations
    )
    start, win = 2, slam_cfg.ba_interval
    steps = sum(1 for t in range(1, frames + 1) if t >= start + win and (t - start) % win == 0)
    calls = steps + ((frames - start) % win != 0)
    _say(
        f"SLAM streaming: SlamSession over the same {frames} frames: {len(step_ms)} provisional "
        f"updates (expected {steps}), launches K1/K2/K3 {stream_launches} (expected "
        f"{(3 * calls, 2 * calls, 0)}), after finalize bit-equal to the batch run {stream_same}, "
        f"ATE {ate_stream:.4f} against batch {ate_batch:.4f} (bar: within {SLAM_ATE_GAP}); "
        f"mem:// store empty again {set(checkpoint._MEM_STORE) == stored}"
    )
    _require(len(step_ms) == steps, "SLAM streaming: wrong number of provisional updates")
    _require(stream_launches == (3 * calls, 2 * calls, 0),
             f"the streaming path launched K1/K2/K3 {stream_launches} times")
    _require(finite(streamed), "SLAM streaming: the trajectory is not finite")
    _require(abs(ate_stream - ate_batch) < SLAM_ATE_GAP, "SLAM streaming: ATE far from batch")
    _require(stream_same, "SLAM streaming: the result differs from the batch run's")
    _require(set(checkpoint._MEM_STORE) == stored, "SLAM streaming: the mem:// store leaked")

    # (e) resume from a mem:// checkpoint after every tracking window, each
    # bit-equal to the uninterrupted run.
    store = "mem://chip_smoke_resume"
    stops = list(range(start + win - 1, frames - 1, win))
    resume_same = []
    for stop in stops:
        port.run_slam(pixels, visible, k_mat, slam_cfg, checkpoint_dir=store, _stop_after=stop,
                      device=dev)
        resumed = port.run_slam(pixels, visible, k_mat, slam_cfg, checkpoint_dir=store,
                                resume=True, device=dev)
        checkpoint.remove_checkpoint(store)
        resume_same.append(np.array_equal(resumed.rotations, card.rotations)
                           and np.array_equal(resumed.translations, card.translations))
    _say(f"SLAM resume: stopped after frames {stops}, resumed: bit-equal {resume_same}")
    _require(all(resume_same), "SLAM: a resumed run differs from the uninterrupted one")

    # (f) timings.
    prof = StageProfile()
    batch(profile=prof)
    report = prof.report(total_frames=frames)
    stages = ", ".join(
        f"{name} {v['ms_per_call'] * v['calls']:.1f} ms/{v['calls']}"
        for name, v in report["stages"].items()
    )
    _say(
        f"timing SLAM batch: {1e3 * seconds:.1f} ms for {frames} frames, {frames / seconds:.2f} "
        f"frames/s, peak device memory {peak_gib:.2f} GiB; streaming window step median "
        f"{np.median(step_ms):.1f} ms, max {max(step_ms):.1f} ms over {len(step_ms)} steps "
        f"[{smi}]"
    )
    _say(
        f"timing SLAM batch stages (profiled run, a synchronise at each stage boundary, "
        f"{report['total_s'] * 1e3:.1f} ms in all, {report['device_round_trips']} round trips): "
        f"{stages} [{smi}]"
    )

    # (g) BASELINE config[3], tracks only: the 50-keyframe orbit through
    # run_slam at the reference's bars.
    seq = _orbit_sequence(synthetic)
    orbit_cfg = port.SlamConfig()
    port.run_slam(seq.pixels, seq.visible, seq.k_mat, orbit_cfg, device=dev)  # warm-up
    read, restore = _count_bas(slam_module)
    try:
        _sync(torch, dev)
        t0 = time.perf_counter()
        orbit = port.run_slam(seq.pixels, seq.visible, seq.k_mat, orbit_cfg, device=dev)
        _sync(torch, dev)
        orbit_seconds = time.perf_counter() - t0
    finally:
        orbit_bas = read()[0]
        restore()
    orbit_ate = port.evaluate_ate(orbit, seq.rotations, seq.translations, device=dev)
    orbit_landmarks = int(orbit.landmark_valid.sum())
    _say(
        f"SLAM, BASELINE config[3]: orbit_sequence(default_rng(2), {ORBIT_FRAMES}, "
        f"{ORBIT_LANDMARKS}, noise 0.4 px, 2 % outliers) through run_slam, SlamConfig(): valid "
        f"landmarks {orbit_landmarks} (bar > {ORBIT_MIN_LANDMARKS}), ATE {orbit_ate:.4f} (bar < "
        f"{ORBIT_ATE}), {orbit_bas} BAs, {1e3 * orbit_seconds:.1f} ms, "
        f"{ORBIT_FRAMES / orbit_seconds:.2f} frames/s [{smi}]"
    )
    _require(orbit_landmarks > ORBIT_MIN_LANDMARKS, "config[3]: too few landmarks")
    _require(orbit_ate < ORBIT_ATE, "config[3]: ATE above the reference's bar")
    refs = dict(solved_ate=ate_solved, orbit_ate=orbit_ate, orbit_bas=orbit_bas)
    return launches, stream_launches, octave_err, sample_err, refs


def _described_fields(described) -> dict:
    import dataclasses

    return {f.name: getattr(described, f.name) for f in dataclasses.fields(described)}


def _same_solve(torch, a, b, cost_a, cost_b) -> bool:
    """Whether two BA results (states and costs) are the same bits."""
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("rotations", "translations", "points")) and torch.equal(cost_a, cost_b)


def _sharding_rank(rank, world, workdir, spec):
    """Phase 17 (b): one rank of the gloo group (spawned), on ``spec["device"]``
    ("cuda": every rank on the card the process is given). The data-parallel
    frontend on the main-path batch, K1 and K2 against their plain versions
    on this rank's share; with ``spec["full"]`` also the sharded BA on phase
    14's dense problem and config[3]'s orbit through ``run_slam(mesh=…)``.
    Writes ``rank<r>.json`` (readings, launches, bars' inputs) and, on rank
    0, the gathered frontend result ``frontend.npz``. The kernels are loaded
    from the library phase 2 built: a rebuild fails the rank."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    import sift_scale_space_extrema_detection_tpu_torch as port
    from sift_scale_space_extrema_detection_tpu_torch.models import slam as slam_module
    from sift_scale_space_extrema_detection_tpu_torch.models.frontend import _as_unit_float
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import _build
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.blur import blur_fused
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.describe import window_sample_pair
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import fused_octave
    from sift_scale_space_extrema_detection_tpu_torch.parallel import (
        detect_and_describe_data_parallel,
        distributed_bundle_adjust,
        initialize_multihost,
        make_mesh,
        put_global,
    )
    from sift_scale_space_extrema_detection_tpu_torch.sfm.ba import BAState, Observations
    from sift_scale_space_extrema_detection_tpu_torch.utils import synthetic

    torch.set_num_threads(2)
    on_card = spec["device"] == "cuda"
    built = set(os.listdir(_build.BUILD_DIR)) if on_card else set()
    initialize_multihost(f"file://{os.path.join(workdir, 'store2')}", world, rank,
                         backend="gloo", timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        mesh = make_mesh(world, device_type=spec["device"])
        dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        rec = dict(rank=rank, device=str(dev))
        cfg = port.SiftConfig(num_octaves=4, scales_per_octave=5, max_keypoints_per_trio=512)
        images = _make_batch(spec["batch"], spec["height"], spec["width"])
        detect_and_describe_data_parallel(images, cfg, mesh)  # warm-up
        _sync(torch, dev)
        fused_octave.launches = window_sample_pair.launches = blur_fused.launches = 0
        t0 = time.perf_counter()
        got = detect_and_describe_data_parallel(images, cfg, mesh)
        _sync(torch, dev)
        rec["frontend_ms"] = 1e3 * (time.perf_counter() - t0)
        rec["launches"] = [fused_octave.launches, window_sample_pair.launches, blur_fused.launches]
        share = spec["batch"] // world
        mine = _described_fields(got)
        local = type(got)(**{k: v[rank * share:(rank + 1) * share] for k, v in mine.items()})
        errs = _kernels_vs_plain(torch, _as_unit_float(put_global(images, mesh)), cfg, local)
        rec.update(zip(("octave_err", "masks_same", "sample_err", "stage_shapes", "slots_same",
                        "described_err"), errs))
        if rank == 0:
            np.savez(os.path.join(workdir, "frontend.npz"),
                     **{k: v.cpu().numpy() for k, v in mine.items()})
        del got, local, mine
        if spec["full"]:
            c, l, opc = spec["ba"]
            p = _ba_problem(np.random.default_rng(0), c, l, opc)
            state = BAState(*(torch.from_numpy(p[k]).to(dev)
                              for k in ("rotations", "translations", "points", "k_mat")))
            obs = Observations(torch.from_numpy(p["camera"]).to(dev),
                               torch.from_numpy(p["landmark"]).to(dev),
                               torch.from_numpy(p["uv"]).to(dev),
                               torch.ones(c * opc, dtype=torch.bool, device=dev))
            out, cost = distributed_bundle_adjust(state, obs, mesh, num_iterations=BA_ITERATIONS)
            _sync(torch, dev)
            t0 = time.perf_counter()
            again, cost_again = distributed_bundle_adjust(state, obs, mesh,
                                                          num_iterations=BA_ITERATIONS)
            _sync(torch, dev)
            rec["ba_ms_per_iteration"] = 1e3 * (time.perf_counter() - t0) / BA_ITERATIONS
            rec["ba_cost"] = cost.item()
            rec["ba_rms"] = float(torch.sqrt(2.0 * cost / (c * opc)))
            rec["ba_rerun_equal"] = _same_solve(torch, out, again, cost, cost_again)
            del state, obs, out, again

            seq = _orbit_sequence(synthetic, spec["orbit_frames"])
            orbit_cfg = port.SlamConfig(dist_ba_min_landmarks=0)
            read, restore = _count_bas(slam_module)
            try:
                _sync(torch, dev)
                t0 = time.perf_counter()
                orbit = port.run_slam(seq.pixels, seq.visible, seq.k_mat, orbit_cfg, mesh=mesh,
                                      device=dev)
                _sync(torch, dev)
                rec["orbit_seconds"] = time.perf_counter() - t0
            finally:
                rec["orbit_bas"] = list(read())
                restore()
            rec["orbit_ate"] = port.evaluate_ate(orbit, seq.rotations, seq.translations,
                                                 device=dev)
            rec["orbit_landmarks"] = int(orbit.landmark_valid.sum())
            every = [None] * world
            dist.all_gather_object(every, (orbit.rotations.tobytes(), orbit.translations.tobytes()))
            rec["orbit_same_on_every_rank"] = all(t == every[0] for t in every)
        if on_card:
            rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            rec["rebuilt"] = sorted(set(os.listdir(_build.BUILD_DIR)) - built)
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def _phase_sharding(torch, port, smi, dev, refs, batch=BATCH, size=(WIDTH, HEIGHT),
                    ba_sizes=SHARD_BA, slam_frames=SLAM_FRAMES, orbit_frames=ORBIT_FRAMES,
                    world=SHARD_WORLD):
    """Phase 17: sharding over ``torch.distributed``. (a) World 1 in this
    process (NCCL on the card, over a file store): the data-parallel
    frontend, keyframe-sharded matching, the sharded BA, composed SLAM and
    the streaming session with a mesh. (b) World ``world`` on gloo, every
    rank spawned on the same ``dev``: the frontend, the BA and config[3]'s
    orbit (:func:`_sharding_rank`). ``refs``: phase 15's readings. Returns
    ``(launches, octave_err, sample_err)``: the (K1, K2, K3) launches of the
    sharded main paths ((a) and every rank of (b)) and the kernels' largest
    differences from their plain versions on them."""
    import dataclasses
    import datetime
    import os
    import shutil

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from sift_scale_space_extrema_detection_tpu_torch.models import slam as slam_module
    from sift_scale_space_extrema_detection_tpu_torch.models.frontend import _as_unit_float
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.blur import blur_fused
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.describe import window_sample_pair
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import fused_octave
    from sift_scale_space_extrema_detection_tpu_torch.parallel import (
        detect_and_describe_data_parallel,
        distributed_bundle_adjust,
        initialize_multihost,
        make_mesh,
        match_against_keyframes_sharded,
    )
    from sift_scale_space_extrema_detection_tpu_torch.sfm.ba import (
        BAState,
        Observations,
        bundle_adjust,
    )

    on_card = dev.type == "cuda"
    total = [0, 0, 0]

    def zero():
        fused_octave.launches = window_sample_pair.launches = blur_fused.launches = 0

    def counts():
        got = (fused_octave.launches, window_sample_pair.launches, blur_fused.launches)
        for i, n in enumerate(got):
            total[i] += n
        return got

    width, height = size
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_sharding")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = port.SiftConfig(num_octaves=4, scales_per_octave=5, max_keypoints_per_trio=512)
    images_cpu = torch.from_numpy(_make_batch(batch, height, width))
    initialize_multihost(f"file://{os.path.join(work, 'store1')}", 1, 0,
                         backend="nccl" if on_card else "gloo",
                         timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        mesh = make_mesh(1, device_type=dev.type)

        # (a) the data-parallel frontend on the main-path batch.
        detect_and_describe_data_parallel(images_cpu, cfg, mesh)  # warm-up
        _sync(torch, dev)
        zero()
        got = detect_and_describe_data_parallel(images_cpu, cfg, mesh)
        _sync(torch, dev)
        launches = counts()
        want = port.detect_and_describe_batched(images_cpu, cfg, device=dev)
        same = all(torch.equal(a, want_field) for a, want_field in
                   zip(_described_fields(got).values(), _described_fields(want).values()))
        dp_ms = _host_ms(torch, lambda: detect_and_describe_data_parallel(images_cpu, cfg, mesh),
                         3, dev)
        plain_path_ms = _host_ms(torch, lambda: port.detect_and_describe_batched(
            images_cpu, cfg, device=dev), 3, dev)
        octave_err, masks_same, sample_err, stage_shapes, slots_same, described_err = (
            _kernels_vs_plain(torch, _as_unit_float(images_cpu.to(dev)), cfg, got)
        )
        _say(
            f"sharding (a), world 1 ({dist.get_backend()}): detect_and_describe_data_parallel "
            f"{batch}x{height}x{width}: launches K1/K2/K3 {launches} (expected "
            f"{(cfg.num_octaves, 2, 0)}), every field equal to detect_and_describe_batched's "
            f"{same}; K1/K2 vs plain on its inputs: DoG and stacks max abs diff {octave_err:.3g}, "
            f"masks equal on {100 * masks_same:.4f} % of pixels, window samples {stage_shapes} "
            f"max abs diff {sample_err:.3g}, slot agreement {slots_same:.6f}, descriptors max abs "
            f"diff {described_err:.3g}; {dp_ms:.2f} ms a batch (detect_and_describe_batched "
            f"{plain_path_ms:.2f} ms, a reading) [{smi}]"
        )
        if on_card:
            _require(launches == (cfg.num_octaves, 2, 0),
                     f"the data-parallel frontend launched K1/K2/K3 {launches} times")
        _require(same, "the data-parallel frontend differs from detect_and_describe_batched")
        _require(max(octave_err, sample_err, described_err) <= MAX_ABS_ERR,
                 "sharding: a kernel differs from its plain version")
        _require(masks_same >= MASK_AGREEMENT and slots_same >= SLOT_AGREEMENT,
                 "sharding: masks or slots differ from the plain path's")

        # Keyframe-sharded matching: frame 0 against frames 1-8.
        n_kf = min(8, batch - 1)
        q, qv = got.descriptor[0], got.valid[0]
        kf, kfv = got.descriptor[1:1 + n_kf], got.valid[1:1 + n_kf]
        idx, _, ok = match_against_keyframes_sharded(q, qv, kf, kfv, mesh)
        match_same = True
        for k in range(n_kf):
            ref = port.match_descriptors(q, qv, kf[k], kfv[k], device=dev)
            match_same &= bool(torch.equal(ok[k], ref.valid)
                               and torch.equal(idx[k][ref.valid], ref.index[ref.valid]))
        _say(
            f"sharding (a): match_against_keyframes_sharded, frame 0's {q.shape[0]} slots against "
            f"{n_kf} keyframes: {int(ok.sum())} matches, valid flags and indices equal to "
            f"match_descriptors per keyframe {match_same}"
        )
        _require(match_same, "sharded keyframe matching differs from match_descriptors")
        del got, q, qv, kf, kfv, idx, ok

        # The sharded BA on phase 14's dense problem.
        c, l, opc = ba_sizes
        p = {k: torch.from_numpy(v).to(dev)
             for k, v in _ba_problem(np.random.default_rng(0), c, l, opc).items()}
        state = BAState(p["rotations"], p["translations"], p["points"], p["k_mat"])
        obs = Observations(p["camera"], p["landmark"], p["uv"],
                           torch.ones(c * opc, dtype=torch.bool, device=dev))
        _, single_cost = bundle_adjust(state, obs, num_iterations=BA_ITERATIONS, device=dev)
        scatter, scatter_cost = bundle_adjust(state, obs, num_iterations=BA_ITERATIONS,
                                              assembly="scatter", device=dev)
        out, cost = distributed_bundle_adjust(state, obs, mesh, num_iterations=BA_ITERATIONS)
        again, cost_again = distributed_bundle_adjust(state, obs, mesh,
                                                      num_iterations=BA_ITERATIONS)
        ba_ms = _host_ms(torch, lambda: distributed_bundle_adjust(
            state, obs, mesh, num_iterations=BA_ITERATIONS), 1, dev) / BA_ITERATIONS
        rel = abs(cost.item() - single_cost.item()) / single_cost.item()
        rms = float(torch.sqrt(2.0 * cost / (c * opc)))

        rerun_same = _same_solve(torch, out, again, cost, cost_again)
        world1_cost = cost.item()
        _say(
            f"sharding (a): distributed_bundle_adjust, {c} cameras x {l} landmarks x {c * opc} "
            f"observations, {BA_ITERATIONS} LM iterations: cost {world1_cost:.1f} against "
            f"bundle_adjust's {single_cost.item():.1f} ({rel:.3g} relative), rms {rms:.3f} px, "
            f"rerun bit-equal {rerun_same}, bit-equal to bundle_adjust(assembly='scatter') "
            f"{_same_solve(torch, out, scatter, cost, scatter_cost)}; {ba_ms:.2f} ms per LM "
            f"iteration [{smi}]"
        )
        _require(rel <= BA_SCATTER_RTOL, "the sharded BA ends at another cost")
        _require(rms < BA_MAX_RMS_PX, "the sharded BA: rms above the bar")
        _require(rerun_same, "the sharded BA: two runs differ")
        del p, state, obs, out, again, scatter

        # Composed SLAM: phase 15's gated sequence with every BA sharded.
        recipe = slam_bench_recipe(port, slam_frames, width, height)
        images, gt_r, gt_t, k_mat = (recipe[k] for k in ("images", "gt_r", "gt_t", "k_mat"))
        sift_cfg = recipe["sift_cfg"]
        sharded_cfg = dataclasses.replace(recipe["slam_cfg"], dist_ba_min_landmarks=0)
        track = dict(reassoc_window=recipe["reassoc_window"], **recipe["solved"])
        read, restore = _count_bas(slam_module)
        try:
            unsharded = port.run_slam_from_images(images, k_mat, sift_cfg, recipe["slam_cfg"],
                                                  frontend_chunk=SLAM_CHUNK, device=dev, **track)
        finally:
            n_ba = read()[0]
            restore()
        ate_unsharded = port.evaluate_ate(unsharded, gt_r, gt_t, device=dev)
        zero()
        read, restore = _count_bas(slam_module)
        try:
            t0 = time.perf_counter()
            sharded = port.run_slam_from_images(images, k_mat, sift_cfg, sharded_cfg, mesh=mesh,
                                                frontend_chunk=SLAM_CHUNK, device=dev, **track)
            _sync(torch, dev)
            slam_seconds = time.perf_counter() - t0
        finally:
            slam_bas = read()
            restore()
        slam_launches = counts()
        ate = port.evaluate_ate(sharded, gt_r, gt_t, device=dev)
        chunks = -(-slam_frames // SLAM_CHUNK)
        _say(
            f"sharding (a): run_slam_from_images(mesh=...) on phase 15's gated sequence "
            f"({slam_frames} x {height}x{width}, {SLAM_MATCH_GATE_PX:g} px gate, "
            f"{SLAM_MAX_TRACKS} tracks), dist_ba_min_landmarks=0: launches K1/K2/K3 "
            f"{slam_launches} (expected {(3 * chunks, 2 * chunks, 0)}), BAs single/sharded "
            f"{slam_bas} (the run without a mesh: {n_ba} BAs), valid landmarks "
            f"{int(sharded.landmark_valid.sum())}, ATE {ate:.4f} (bars: < {SLAM_REF_ATE}, within "
            f"{SLAM_ATE_GAP} of phase 15's {refs['solved_ate']:.4f}; without a mesh here "
            f"{ate_unsharded:.4f}); {1e3 * slam_seconds:.1f} ms, "
            f"{slam_frames / slam_seconds:.2f} frames/s, a reading [{smi}]"
        )
        if on_card:
            _require(slam_launches == (3 * chunks, 2 * chunks, 0),
                     f"the sharded SLAM path launched K1/K2/K3 {slam_launches} times")
        _require(slam_bas == (0, n_ba) and n_ba > 0, "not every BA of the run was sharded")
        _require(np.isfinite(sharded.translations).all(), "sharded SLAM: not finite")
        _require(ate < SLAM_REF_ATE, "sharded SLAM: ATE above the bar")
        _require(abs(ate - refs["solved_ate"]) < SLAM_ATE_GAP,
                 "sharded SLAM: ATE far from the run without a mesh")

        # The streaming session with the same mesh: the sharded batch run's
        # result, bit for bit.
        zero()
        read, restore = _count_bas(slam_module)
        try:
            sess = port.SlamSession(k_mat, sift_cfg, sharded_cfg, mesh=mesh, device=dev,
                                    **track)
            for image in images:
                sess.add_frame(image)
            streamed = sess.finalize()
        finally:
            stream_bas = read()
            restore()
        stream_launches = counts()
        stream_same = np.array_equal(streamed.rotations, sharded.rotations) and np.array_equal(
            streamed.translations, sharded.translations)
        start, win = 2, sharded_cfg.ba_interval
        calls = sum(1 for t in range(1, slam_frames + 1)
                    if t >= start + win and (t - start) % win == 0)
        calls += (slam_frames - start) % win != 0
        _say(
            f"sharding (a): SlamSession(mesh=...) over the same frames: launches K1/K2/K3 "
            f"{stream_launches} (expected {(3 * calls, 2 * calls, 0)}), BAs single/sharded "
            f"{stream_bas}, bit-equal to the sharded batch run {stream_same}"
        )
        if on_card:
            _require(stream_launches == (3 * calls, 2 * calls, 0),
                     f"the sharded session launched K1/K2/K3 {stream_launches} times")
        _require(stream_bas[0] == 0 and stream_bas[1] > 0, "the session's BAs were not sharded")
        _require(stream_same, "the sharded session differs from the sharded batch run")
    finally:
        dist.destroy_process_group()

    # (b) world ``world`` on gloo, every rank on this device. The ranks need
    # the card's memory that this process's allocator still caches from the
    # phases before.
    want = {k: getattr(want, k).cpu().numpy() for k in ("valid", "abs_x", "abs_y", "descriptor")}
    if on_card:
        torch.cuda.empty_cache()
    spec = dict(device=dev.type, batch=batch, height=height, width=width, ba=ba_sizes,
                orbit_frames=orbit_frames, full=True)
    t0 = time.perf_counter()
    mp.spawn(_sharding_rank, args=(world, work, spec), nprocs=world)
    spawn_seconds = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    gathered = np.load(os.path.join(work, "frontend.npz"))
    valid = want["valid"]
    valid_same = np.array_equal(gathered["valid"], valid)
    diffs = {k: float(np.abs(gathered[k][valid] - want[k][valid]).max())
             for k in ("abs_x", "abs_y", "descriptor")}
    _say(
        f"sharding (b), world {world} (gloo, every rank on {dev}), spawned in "
        f"{spawn_seconds:.1f} s: the same {batch} frames, {batch // world} a rank: launches "
        f"K1/K2/K3 by rank {[r['launches'] for r in ranks]} (expected "
        f"{[cfg.num_octaves, 2, 0]} each); gathered against detect_and_describe_batched: valid "
        f"equal {valid_same}, max abs diff x {diffs['abs_x']:.3g}, y {diffs['abs_y']:.3g}, "
        f"descriptors {diffs['descriptor']:.3g} (bar {SHARD_ATOL}); K1/K2 vs plain on each "
        f"rank's share: DoG and stacks {max(r['octave_err'] for r in ranks):.3g}, window samples "
        f"{max(r['sample_err'] for r in ranks):.3g}, slots "
        f"{min(r['slots_same'] for r in ranks):.6f}; frontend ms by rank "
        f"{[round(r['frontend_ms'], 2) for r in ranks]} (readings) [{smi}]"
    )
    for r in ranks:
        for i, n in enumerate(r["launches"]):
            total[i] += n
        if on_card:
            _require(r["launches"] == [cfg.num_octaves, 2, 0],
                     f"rank {r['rank']} launched K1/K2/K3 {r['launches']} times")
            _require(not r["rebuilt"], f"rank {r['rank']} rebuilt the kernels: {r['rebuilt']}")
        _require(max(r["octave_err"], r["sample_err"], r["described_err"]) <= MAX_ABS_ERR,
                 f"rank {r['rank']}: a kernel differs from its plain version")
        _require(r["masks_same"] >= MASK_AGREEMENT and r["slots_same"] >= SLOT_AGREEMENT,
                 f"rank {r['rank']}: masks or slots differ from the plain path's")
    _require(valid_same and max(diffs.values()) <= SHARD_ATOL,
             "the world-2 frontend differs from the unsharded one")
    octave_err = max(octave_err, *(r["octave_err"] for r in ranks))
    sample_err = max(sample_err, *(r["sample_err"] for r in ranks))

    costs = [r["ba_cost"] for r in ranks]
    ba_rel = abs(costs[0] - world1_cost) / world1_cost
    _say(
        f"sharding (b): distributed_bundle_adjust on the same problem: cost by rank {costs} "
        f"({ba_rel:.3g} relative of world 1's), rms {ranks[0]['ba_rms']:.3f} px, reruns "
        f"bit-equal {[r['ba_rerun_equal'] for r in ranks]}; ms per LM iteration by rank "
        f"{[round(r['ba_ms_per_iteration'], 2) for r in ranks]} (readings) [{smi}]"
    )
    _require(len(set(costs)) == 1, "the ranks' BA costs differ")
    _require(ba_rel <= BA_SCATTER_RTOL, "the world-2 BA ends at another cost than world 1's")
    _require(all(r["ba_rerun_equal"] for r in ranks), "a world-2 BA rerun differs")

    o = ranks[0]
    _say(
        f"sharding (b): config[3]'s orbit ({orbit_frames} frames) through run_slam(mesh=...), "
        f"dist_ba_min_landmarks=0: valid landmarks {o['orbit_landmarks']} (bar > "
        f"{ORBIT_MIN_LANDMARKS}), ATE {o['orbit_ate']:.4f} (bars: < {ORBIT_ATE}, within "
        f"{SLAM_ATE_GAP} of phase 15's {refs['orbit_ate']:.4f}), BAs single/sharded by rank "
        f"{[r['orbit_bas'] for r in ranks]} (without a mesh: {refs['orbit_bas']}), every rank's "
        f"trajectory bit-equal to rank 0's {[r['orbit_same_on_every_rank'] for r in ranks]}; "
        f"seconds by rank {[round(r['orbit_seconds'], 3) for r in ranks]} (readings); peak "
        f"device memory by rank {[round(r.get('peak_gib', float('nan')), 3) for r in ranks]} GiB "
        f"[{smi}]"
    )
    _require(o["orbit_landmarks"] > ORBIT_MIN_LANDMARKS, "sharded config[3]: too few landmarks")
    _require(o["orbit_ate"] < ORBIT_ATE, "sharded config[3]: ATE above the bar")
    _require(abs(o["orbit_ate"] - refs["orbit_ate"]) < SLAM_ATE_GAP,
             "sharded config[3]: ATE far from the run without a mesh")
    _require(all(r["orbit_bas"] == [0, refs["orbit_bas"]] for r in ranks),
             "sharded config[3]: not every BA was sharded")
    _require(all(r["orbit_same_on_every_rank"] for r in ranks), "the ranks' trajectories differ")
    shutil.rmtree(work, ignore_errors=True)
    return tuple(total), octave_err, sample_err


def cli_records(outdir):
    """``keypoints.json``'s records and ``descriptors.npz`` (or ``None``) of a
    CLI run."""
    import os

    with open(os.path.join(outdir, "keypoints.json")) as f:
        records = json.load(f)["keypoints"]
    path = os.path.join(outdir, "descriptors.npz")
    if not os.path.exists(path):
        return records, None
    with np.load(path) as npz:
        return records, dict(npz)


def record_agreement(got, want):
    """``(matched share, p99 position delta px)`` of two runs' keypoint
    records, matched by (octave, scale, row, column) at acceptance; the share
    is over the larger count (the slot agreement of a CLI's output)."""
    import collections

    def key(r):
        return r["octave"], r["scaleLevel"], r["localY"], r["localX"]

    left = collections.defaultdict(list)
    for r in want:
        left[key(r)].append(r)
    deltas = [np.hypot(r["absoluteX"] - w["absoluteX"], r["absoluteY"] - w["absoluteY"])
              for r in got if left[key(r)] for w in [left[key(r)].pop()]]
    p99 = float(np.quantile(deltas, 0.99)) if deltas else float("nan")
    return len(deltas) / max(len(got), len(want), 1), p99


def descriptor_cosines(got, want):
    """``(matched share, min cosine)`` of two runs' descriptor rows: each row
    matched to the nearest row of ``want`` within 0.1 px and 1e-3 rad."""
    pos = np.hypot(got["abs_x"][:, None] - want["abs_x"][None],
                   got["abs_y"][:, None] - want["abs_y"][None])
    dtheta = np.abs(np.angle(np.exp(1j * (got["theta"][:, None] - want["theta"][None]))))
    cost = np.where((pos <= P99_PX) & (dtheta <= P99_THETA), pos + dtheta, np.inf)
    nearest = cost.argmin(axis=1)
    ok = np.isfinite(cost[np.arange(len(nearest)), nearest])
    cos = (got["descriptor"][ok] * want["descriptor"][nearest[ok]]).sum(axis=1)
    share = ok.sum() / max(len(got["abs_x"]), len(want["abs_x"]), 1)
    return share, float(cos.min()) if cos.size else float("nan")


def write_rehearsal_sequence(fmt, work, frames, size):
    """Phase 16's on-disk rehearsal sequence: ``frames`` frames of
    ``_bench_sequence`` (``benchmarks/slam_bench.py``'s dolly, seed 0) at
    ``size`` (width, height), written under ``work`` by the port's writers
    in the TUM (``fmt="tum"``) or KITTI (``"kitti"``, sequence 00) layout.
    Returns ``(argv, pixels, paths)``: ``evaluate``'s positional arguments,
    the 8-bit pixels written and the frames' files."""
    import os

    from sift_scale_space_extrema_detection_tpu_torch.data import (
        write_kitti_sequence,
        write_tum_sequence,
    )
    from sift_scale_space_extrema_detection_tpu_torch.utils import synthetic

    images, rots, ts, k_mat = _bench_sequence(synthetic, frames, *size)
    pixels = np.clip(np.round(images * 255.0), 0, 255).astype(np.uint8)
    if fmt == "tum":
        root = os.path.join(work, "rgbd_dataset_freiburg1_rehearsal")
        write_tum_sequence(root, images, 1305031102.175 + np.arange(frames) / 30.0, rots, ts)
        paths = [os.path.join(root, "rgb", f"{1305031102.175 + f / 30.0:.6f}.png")
                 for f in range(frames)]
        return [root], pixels, paths
    root = os.path.join(work, "kitti")
    write_kitti_sequence(root, "00", images, np.arange(frames) * 0.1, rots, ts, k_mat)
    paths = [os.path.join(root, "sequences", "00", "image_0", f"{f:06d}.png")
             for f in range(frames)]
    return [root, "--sequence", "00"], pixels, paths


def _quiet(main, argv):
    """``main(argv)`` with its standard output captured: ``(rc, text)``."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _phase_surfaces(torch, port, smi, dev, frames=SURFACE_FRAMES, size=(WIDTH, HEIGHT),
                    kitti_size=KITTI_SIZE, solved_frames=SURFACE_SOLVED_FRAMES):
    """Phase 16: the user surfaces, ``cli.main`` and ``evaluate.main``,
    in-process on ``dev``. Returns ``(launches, octave_err)``: the (K1, K2,
    K3) launches of the paths driven here, and the octave kernel's largest
    difference from its plain version at KITTI dims."""
    import os
    import shutil

    from sift_scale_space_extrema_detection_tpu_torch import cli, evaluate
    from sift_scale_space_extrema_detection_tpu_torch.core import native_io
    from sift_scale_space_extrema_detection_tpu_torch.core.image import (
        pad_to_tpu_friendly,
        write_png,
    )
    from sift_scale_space_extrema_detection_tpu_torch.data import read_tum_trajectory
    from sift_scale_space_extrema_detection_tpu_torch.models import slam as slam_module
    from sift_scale_space_extrema_detection_tpu_torch.models.frontend import _as_unit_float
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.blur import blur_fused
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.describe import window_sample_pair
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import (
        fused_octave,
        fused_octave_reference,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.resize import downsample2x_nn

    on_card = dev.type == "cuda"
    card = [] if on_card else ["--device", "cpu"]  # a CPU rehearsal runs both legs there
    total = [0, 0, 0]

    def zero():
        fused_octave.launches = window_sample_pair.launches = blur_fused.launches = 0
        fused_octave.clamped_launches = 0

    def counts():
        got = (fused_octave.launches, window_sample_pair.launches, blur_fused.launches)
        for i, n in enumerate(got):
            total[i] += n
        return got

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_surfaces")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = port.SiftConfig()  # the CLI's: 5 octaves x 3 scales, capacity 1024
    n_blurs = cfg.num_octaves * cfg.scales_per_octave_total - (cfg.num_octaves - 1)

    def cli_pair(path, name, flags, expected):
        """The CLI on ``dev`` (launches counted) and with ``--device cpu``,
        held to the bars; returns the card run's seconds and records."""
        out = os.path.join(work, name)
        zero()
        t0 = time.perf_counter()
        rc, text = _quiet(cli.main, [path, "-o", out + "_card", *flags, *card])
        seconds = time.perf_counter() - t0
        launches, clamped = counts(), fused_octave.clamped_launches
        _require(rc == 0, f"cli {name}: exit code {rc}")
        rc, _ = _quiet(cli.main, [path, "-o", out + "_cpu", *flags, "--no-galleries",
                                  "--device", "cpu"])
        _require(rc == 0, f"cli {name} --device cpu: exit code {rc}")
        got, got_desc = cli_records(out + "_card")
        want, want_desc = cli_records(out + "_cpu")
        matched, p99 = record_agreement(got, want)
        share, min_cos = descriptor_cosines(got_desc, want_desc)
        timing = [ln for ln in text.splitlines() if ln.startswith("pipeline:")]
        _say(
            f"cli {name} {' '.join(flags)}: launches K1/K2/K3 {launches} (expected {expected}), "
            f"K1 clamped {clamped}; {len(got)} keypoints against {len(want)} with --device cpu: "
            f"slot agreement {matched:.6f}, p99 position delta {p99:.3g} px; {len(got_desc['abs_x'])} "
            f"descriptors, matched {share:.6f}, min cosine {min_cos:.6f}; {timing[0]}, "
            f"{seconds:.2f} s for the whole command [{smi}]"
        )
        if on_card:
            _require(launches == expected, f"cli {name}: launches {launches}, expected {expected}")
        _require(len(want) > 0 and matched >= SLOT_AGREEMENT and p99 <= P99_PX,
                 f"cli {name}: the card's keypoints differ from the CPU's")
        _require(share >= SLOT_AGREEMENT and min_cos >= MIN_COSINE,
                 f"cli {name}: the card's descriptors differ from the CPU's")
        return clamped, got

    # (a) the CLI at full width: one frame of the bench recipe as a PNG.
    frame = np.round(_make_batch(1, size[1], size[0])[0] * 255.0).astype(np.uint8)
    path = os.path.join(work, "frame.png")
    write_png(path, frame)
    desc = ["--descriptors"]
    clamped, _ = cli_pair(path, "fused", desc, (cfg.num_octaves, 2 * cfg.num_octaves, 0))
    if on_card:
        _require(clamped == 1, "cli: the deepest octave did not take the clamped mode")
    _, cuda_records = cli_pair(path, "cuda", desc + ["--blur", "cuda"],
                               (0, 2 * cfg.num_octaves, n_blurs))
    # --blur matmul: full float32 products run, TF32 is refused.
    zero()
    rc, _ = _quiet(cli.main, [path, "-o", os.path.join(work, "matmul"), "--blur", "matmul",
                              "--no-galleries", *card])
    matmul_launches = counts()
    # Against --blur cuda, the other blur-by-blur path (the fused path caps
    # candidates by octave, these two by trio).
    matched, p99 = record_agreement(cli_records(os.path.join(work, "matmul"))[0], cuda_records)
    image = torch.from_numpy(frame)[None].to(dev).float() / torch.full((), 255.0, device=dev)
    space = port.build_scale_space(image, cfg, "matmul", device=dev)
    plain = port.build_scale_space(image, cfg, "separable", device=dev)
    matmul_err = max((a - b).abs().max().item() for a, b in zip(space, plain))
    del space, plain
    refused = True
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            cli.main([path, "-o", os.path.join(work, "tf32"), "--blur", "matmul", "--no-galleries"])
            refused = False
        except RuntimeError as err:
            refused = "allow_tf32" in str(err)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    _say(
        f"cli --blur matmul: exit code {rc}, launches K1/K2/K3 {matmul_launches}, against the "
        f"--blur cuda run: slot agreement {matched:.6f}, p99 {p99:.3g} px (readings); its scale space "
        f"against the tap loop's on the card: max abs diff {matmul_err:.3g} (bar {MATMUL_ATOL}); "
        f"with TF32 on: refused {refused}"
    )
    _require(rc == 0 and matmul_launches == (0, 0, 0), "cli --blur matmul did not run plainly")
    _require(matmul_err <= MATMUL_ATOL, "blur_matmul differs from the tap loop")
    _require(refused, "cli --blur matmul ran with TF32 on")

    # The rehearsal's sequences: the dolly of slam_bench.py's recipe, written
    # by the port's writers.
    t0 = time.perf_counter()
    seqs = {fmt: write_rehearsal_sequence(fmt, work, frames, wh)
            for fmt, wh in (("tum", size), ("kitti", kitti_size))}
    _say(f"rehearsal: wrote {frames} x {size[0]}x{size[1]} TUM and {frames} x "
         f"{kitti_size[0]}x{kitti_size[1]} KITTI frames in {time.perf_counter() - t0:.2f} s")

    # (b) KITTI dims through the CLI, as they are and padded; the octave
    # kernel against its plain version on each frame's octaves.
    kitti_frame = seqs["kitti"][1][0]
    octave_err = 0.0
    for name, pixels in (("kitti", kitti_frame), ("kitti_padded", pad_to_tpu_friendly(kitti_frame))):
        path = os.path.join(work, f"{name}.png")
        write_png(path, pixels)
        cli_pair(path, name, desc, (cfg.num_octaves, 2 * cfg.num_octaves, 0))
        base = torch.from_numpy(pixels)[None].to(dev).float() / torch.full((), 255.0, device=dev)
        worst, same = 0.0, 1.0
        for octave in range(cfg.num_octaves):
            sigmas = _octave_sigmas(cfg, octave)
            args = (base, sigmas, cfg.scales_per_octave, cfg.contrast_prefilter_threshold)
            got = fused_octave(*args, upsample2x=octave == 0, emit_scales=True)
            want = fused_octave_reference(*args, upsample2x=octave == 0, emit_scales=True)
            worst = max([worst] + [(g - w).abs().max().item() for i, (g, w) in
                                   enumerate(zip(got, want)) if i != 2])
            same = min(same, (got[2] == want[2]).float().mean().item())
            base = downsample2x_nn(want[1]).contiguous()
        _say(f"cli {name}: octave kernel vs plain on its {cfg.num_octaves} octaves "
             f"{tuple(pixels.shape)}: DoG/seed/stack max abs diff {worst:.3g}, masks equal on "
             f"{100 * same:.4f} % of pixels")
        _require(worst <= MAX_ABS_ERR and same >= MASK_AGREEMENT,
                 f"cli {name}: the octave kernel differs from its plain version")
        octave_err = max(octave_err, worst)

    # (c) the on-disk rehearsal: evaluate.main on each sequence, its frames
    # decoded natively, its trajectory the same bits as run_slam_from_images
    # on the same frames.
    calls = []
    run_slam_from_images = slam_module.run_slam_from_images

    def spy(images, *args, **kwargs):
        result = run_slam_from_images(images, *args, **kwargs)
        calls.append((images, args, kwargs, result))
        return result

    for fmt, (argv, pixels, paths) in seqs.items():
        traj = os.path.join(work, f"{fmt}_traj.txt")
        calls.clear()
        native_io.load_batch_gray.native_frames = 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        zero()
        slam_module.run_slam_from_images = spy
        try:
            rc, text = _quiet(evaluate.main, argv + ["--out-traj", traj, *card])
        finally:
            slam_module.run_slam_from_images = run_slam_from_images
        launches, native = counts(), native_io.load_batch_gray.native_frames
        peak_gib = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
        _require(rc == 0 and len(calls) == 1, f"evaluate {fmt}: exit code {rc}")
        images, args, kwargs, result = calls[0]
        metrics = json.loads(text.strip().splitlines()[-1])
        loaded = [ln for ln in text.splitlines() if "loaded in" in ln][0]
        decoded = native_io.load_batch_gray(paths, fallback=False)
        exact = (pixels.astype(np.float64) / 255.0).astype(np.float32)
        decoded_ok = np.array_equal(decoded, exact)
        padded = pad_to_tpu_friendly(decoded)
        same_frames = np.array_equal(images, padded)
        again = run_slam_from_images(padded, *args, **kwargs)
        same_bits = (np.array_equal(again.rotations, result.rotations)
                     and np.array_equal(again.translations, result.translations))
        rows = read_tum_trajectory(traj)[0].shape[0]
        chunks = -(-frames // SLAM_CHUNK)
        octaves = args[1].num_octaves
        expected = (octaves * chunks, 2 * chunks, 0)
        _say(
            f"evaluate {fmt}: {loaded.strip()}; natively decoded {native} "
            f"of {frames} frames, equal to the written pixels / 255 {decoded_ok}; frames handed to "
            f"SLAM {tuple(images.shape)} equal to the decoded and padded frames {same_frames}; "
            f"trajectory bit-equal to run_slam_from_images in this process {same_bits}; "
            f"{rows} rows read back; launches K1/K2/K3 {launches} (expected {expected})"
        )
        _say(
            f"timing evaluate {fmt}: SLAM {metrics['slam_frames_per_s']} frames/s "
            f"({metrics['landmarks']} landmarks), peak device memory {peak_gib:.2f} GiB; readings: "
            f"ATE {metrics.get('ate_rmse')}, RPE {metrics.get('rpe_trans_rmse')}, RRE "
            f"{metrics.get('rpe_rot_rmse_deg')} deg [{smi}]"
        )
        _require(metrics["frames"] == frames and rows == frames,
                 f"evaluate {fmt}: {metrics['frames']} frames, {rows} trajectory rows")
        _require(native == frames and decoded_ok and same_frames,
                 f"evaluate {fmt}: the frames were not decoded natively and exactly")
        _require(same_bits, f"evaluate {fmt}: the trajectory differs from run_slam_from_images")
        _require(np.isfinite(result.rotations).all() and np.isfinite(result.translations).all(),
                 f"evaluate {fmt}: the trajectory is not finite")
        if on_card:
            _require(launches == expected, f"evaluate {fmt}: launches {launches}")

        # Both kernels against their plain versions on the first chunk of
        # the frames evaluate handed to SLAM, with its SiftConfig.
        sift_cfg = args[1]
        first = torch.from_numpy(np.ascontiguousarray(images[:SLAM_CHUNK])).to(dev)
        octave_err, masks_same, sample_err, stage_shapes, slots_same, described_err = (
            _kernels_vs_plain(torch, _as_unit_float(first), sift_cfg,
                              port.detect_and_describe_batched(first, sift_cfg, device=dev))
        )
        _say(
            f"evaluate {fmt}, kernels vs plain on the first chunk {tuple(first.shape)} "
            f"({sift_cfg.num_octaves} octaves, capacity {sift_cfg.max_keypoints_per_trio}): DoG "
            f"and Gaussian stacks max abs diff {octave_err:.3g}, masks equal on "
            f"{100 * masks_same:.4f} % of pixels, window samples {stage_shapes} max abs diff "
            f"{sample_err:.3g}; the chunk through the plain versions: slot agreement "
            f"{slots_same:.6f}, descriptors max abs diff {described_err:.3g}"
        )
        _require(max(octave_err, sample_err, described_err) <= MAX_ABS_ERR,
                 f"evaluate {fmt}: a kernel differs from its plain version on the first chunk")
        _require(masks_same >= MASK_AGREEMENT and slots_same >= SLOT_AGREEMENT,
                 f"evaluate {fmt}: masks or slots differ from the plain path's on the first chunk")
        del first

    # (c) continued: evaluate card against --device cpu on a cut of the TUM
    # sequence, with the association SLAM needs to solve it (the defaults
    # lose it in both packages, PERF.md §6; the same flags as phase 15 (c)
    # and its re-association window).
    solved = ["--max-frames", str(solved_frames), "--match-gate", f"{SLAM_MATCH_GATE_PX:g}",
              "--reassoc", "2", "--max-tracks", str(SLAM_MAX_TRACKS)]
    zero()
    rc, text = _quiet(evaluate.main, seqs["tum"][0] + solved + card)
    launches = counts()
    _require(rc == 0, f"evaluate {' '.join(solved)}: exit code {rc}")
    metrics = json.loads(text.strip().splitlines()[-1])
    rc, text = _quiet(evaluate.main, seqs["tum"][0] + solved + ["--device", "cpu"])
    _require(rc == 0, f"evaluate {' '.join(solved)} --device cpu: exit code {rc}")
    cpu_metrics = json.loads(text.strip().splitlines()[-1])
    chunks = -(-solved_frames // SLAM_CHUNK)
    expected = (4 * chunks, 2 * chunks, 0)  # evaluate's 4 octaves
    _say(
        f"evaluate tum {' '.join(solved)}: launches K1/K2/K3 {launches} (expected {expected}); "
        f"{metrics['landmarks']} landmarks, ATE {metrics['ate_rmse']}, RPE "
        f"{metrics['rpe_trans_rmse']}, RRE {metrics['rpe_rot_rmse_deg']} deg, SLAM "
        f"{metrics['slam_frames_per_s']} frames/s; with --device cpu: {cpu_metrics['landmarks']} "
        f"landmarks, ATE {cpu_metrics['ate_rmse']} (bars: < {SLAM_REF_ATE} and within "
        f"{SLAM_ATE_GAP}) [{smi}]"
    )
    _require(metrics["frames"] == cpu_metrics["frames"] == solved_frames,
             "evaluate, solved variant: frame counts differ")
    if on_card:
        _require(launches == expected, f"evaluate, solved variant: launches {launches}")
    _require(max(metrics["ate_rmse"], cpu_metrics["ate_rmse"]) < SLAM_REF_ATE,
             "evaluate, solved variant: the sequence is not solved")
    _require(abs(metrics["ate_rmse"] - cpu_metrics["ate_rmse"]) < SLAM_ATE_GAP,
             "evaluate, solved variant: the card's ATE differs from the CPU's")
    shutil.rmtree(work, ignore_errors=True)
    return tuple(total), octave_err


def main() -> int:
    import dataclasses

    import torch

    # --- 1. device ------------------------------------------------------
    _require(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    _say(smi)
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    _say(
        f"device: {kind}, {torch.cuda.device_count()} visible, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; TF32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32} (the describe histograms are float32 "
        f"matrix products and need TF32 matmul off; nothing on the path convolves)"
    )
    _require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matrix products are on")

    from sift_scale_space_extrema_detection_tpu_torch import SiftConfig
    from sift_scale_space_extrema_detection_tpu_torch.core.types import concat_keypoints
    from sift_scale_space_extrema_detection_tpu_torch.models.frontend import (
        build_pyramid_fused,
        build_scale_space,
        detect_and_describe_batched,
        detect_batched,
        detect_octaves,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.descriptor import (
        concat_described,
        describe_compact,
        describe_octave,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.gaussian import (
        blur_separable,
        kernel_radius,
        taps_f32,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import _build
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.blur import (
        blur_fused,
        blur_tile_plan,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.describe import (
        window_sample_pair,
        window_sample_pair_reference,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import (
        fused_octave,
        fused_octave_reference,
        octave_tile_plan,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.resize import (
        downsample2x_nn,
        upsample2x_nn,
    )

    # --- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_kernels()
    _say(f"build: kernels built and loaded in {time.perf_counter() - t0:.2f} s")

    cfg = SiftConfig(num_octaves=4, scales_per_octave=5, max_keypoints_per_trio=512)
    spo, thr = cfg.scales_per_octave, cfg.contrast_prefilter_threshold
    images_cpu = torch.from_numpy(_make_batch(BATCH, HEIGHT, WIDTH))
    images = images_cpu.to(device)

    # --- 3. kernel vs plain at every octave geometry ----------------------
    max_err = 0.0
    base = images[:4].contiguous()
    for octave in range(cfg.num_octaves):
        sigmas = _octave_sigmas(cfg, octave)
        up2 = octave == 0
        want = fused_octave_reference(base, sigmas, spo, thr, upsample2x=up2, emit_scales=True)
        for emit_scales in (False, True):
            got = fused_octave(base, sigmas, spo, thr, upsample2x=up2, emit_scales=emit_scales)
            torch.cuda.synchronize()
            _require(len(got) == 3 + emit_scales, f"octave {octave}: {len(got)} results")
            dog_err = (got[0] - want[0]).abs().max().item()
            seed_err = (got[1] - want[1]).abs().max().item()
            stack_err = (got[3] - want[3]).abs().max().item() if emit_scales else 0.0
            same = (got[2] == want[2]).float().mean().item()
            _require(got[2].dtype == want[2].dtype, f"octave {octave} mask dtype")
            _say(
                f"kernel vs plain, octave {octave} {tuple(got[0].shape)}, emit_scales="
                f"{emit_scales}: dog max abs diff {dog_err:.3g}, seed {seed_err:.3g}, "
                + (f"stack {stack_err:.3g}, " if emit_scales else "")
                + f"masks equal on {100 * same:.4f} % of pixels"
            )
            _require(max(dog_err, seed_err, stack_err) <= MAX_ABS_ERR,
                     f"octave {octave} DoG/seed/stack differ by more than {MAX_ABS_ERR}")
            _require(same >= MASK_AGREEMENT, f"octave {octave} masks disagree")
            max_err = max(max_err, dog_err, seed_err, stack_err)
        del got
        base = downsample2x_nn(want[1]).contiguous()

    # --- 4. the main path ------------------------------------------------
    # Warm-up (allocator, first launches), and the device rule: a CPU tensor
    # with no ``device`` runs on the card.
    warm, _ = detect_batched(images_cpu, cfg)
    torch.cuda.synchronize()
    _require(warm.valid.is_cuda and warm.abs_x.is_cuda,
             "detect_batched of a CPU tensor did not run on the card")
    del warm
    torch.cuda.reset_peak_memory_stats()
    fused_octave.launches = 0
    keypoints, extrema = detect_batched(images, cfg)
    torch.cuda.synchronize()
    launches = fused_octave.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_slots = sum(cfg.refine_capacity(o) for o in range(cfg.num_octaves))
    valid = keypoints.valid
    n_valid = int(valid.sum())
    _say(
        f"main path: detect_batched {BATCH}x{HEIGHT}x{WIDTH}, "
        f"{cfg.num_octaves} octaves x {spo} scales: kernel launches {launches}, "
        f"valid keypoints {n_valid} of {BATCH * n_slots} slots, peak device "
        f"memory {peak_gib:.2f} GiB (with the three-pass kernel and its scratch: "
        f"{PREV_DETECT_PEAK_GIB} GiB), reject counts "
        f"{keypoints.reject_counts().sum(0).tolist()}"
    )
    _require(launches >= cfg.num_octaves, "the main path did not launch the kernel per octave")
    _require(tuple(valid.shape) == (BATCH, n_slots), f"keypoint shape {tuple(valid.shape)}")
    _require(n_valid > 0, "no valid keypoints")
    for name in ("abs_x", "abs_y", "abs_sigma", "value"):
        _require(bool(torch.isfinite(getattr(keypoints, name)[valid]).all()), f"{name} not finite")
    _require(bool((keypoints.abs_x[valid] >= 0).all() & (keypoints.abs_x[valid] < WIDTH).all()
                  & (keypoints.abs_y[valid] >= 0).all() & (keypoints.abs_y[valid] < HEIGHT).all()),
             "keypoints outside the frame")

    # The plain path's Gaussian stacks and per-octave keypoints are kept
    # for phase 6, which describes them through the plain sampler.
    dogs, masks, plain_stacks = build_pyramid_fused(
        images, cfg, octave_fn=fused_octave_reference, emit_scales=True
    )
    plain_keypoints, plain_extrema = detect_octaves(dogs, cfg, masks)
    plain = concat_keypoints(plain_keypoints)
    torch.cuda.synchronize()
    del dogs, masks
    agreement = _slot_agreement(keypoints, plain)
    both = keypoints.valid & plain.valid
    delta = torch.hypot(
        keypoints.abs_x[both] - plain.abs_x[both], keypoints.abs_y[both] - plain.abs_y[both]
    )
    p99 = torch.quantile(delta.double(), 0.99).item() if delta.numel() else float("nan")
    counters_equal = all(
        torch.equal(a.num_candidates, b.num_candidates) for a, b in zip(extrema, plain_extrema)
    )
    _say(
        f"main path vs plain on the card: valid {n_valid} vs {int(plain.valid.sum())}, "
        f"slot agreement {agreement:.6f}, p99 position delta {p99:.3g} px, "
        f"per-trio counters equal {counters_equal}"
    )
    _require(agreement >= SLOT_AGREEMENT, "slot agreement below the bar")
    _require(p99 <= P99_PX, "p99 position delta above the bar")

    # --- 5. timings of the fused octave -----------------------------------
    bases, base = [], images
    for octave in range(cfg.num_octaves):
        bases.append(base)
        _, seed, _ = fused_octave(base, _octave_sigmas(cfg, octave), spo, thr, upsample2x=octave == 0)
        base = downsample2x_nn(seed).contiguous()
    kernel_ms, plain_ms, scales_ms, octave_bounds = [], [], [], []
    for octave, base in enumerate(bases):
        args = (base, _octave_sigmas(cfg, octave), spo, thr)
        up2 = octave == 0
        # Least work: read the base; write DoG, seed and 2-byte masks.
        pixels = base.numel() * (4 if up2 else 1)
        n_scales = cfg.scales_per_octave_total
        radii = [0 if sg is None else kernel_radius(sg) for sg in args[1]]
        octave_bounds.append(_bound(
            4 * base.numel() + pixels * (4 * (n_scales - 1) + 4 + 2),
            sum(_blur_flop(pixels, r) for r in radii) + pixels * (n_scales - 1),
        ))

        def kernel(args=args, up2=up2):
            return fused_octave(*args, upsample2x=up2)

        def reference(args=args, up2=up2):
            return fused_octave_reference(*args, upsample2x=up2)

        k_ms, p_ms, rounds = _in_turns(torch, kernel, reference, 10, 3)
        kernel_ms.append(k_ms)
        plain_ms.append(p_ms)
        scales_ms.append(
            _event_ms(torch, lambda: fused_octave(*args, upsample2x=up2, emit_scales=True), 10)
        )
        _say(
            f"timing octave {octave} {tuple(base.shape)}{' (upsampled 2x)' if up2 else ''}: "
            f"kernel {k_ms:.3f} ms (rounds {rounds[1]:.3f}, {rounds[2]:.3f}), plain "
            f"{p_ms:.3f} ms (rounds {rounds[0]:.3f}, {rounds[3]:.3f}), plain/kernel "
            f"{p_ms / k_ms:.2f}x, bound {octave_bounds[-1][0]:.3f} ms by "
            f"{octave_bounds[-1][1]}; kernel with emit_scales {scales_ms[-1]:.3f} ms [{smi}]"
        )
    _say(
        f"timing fused octave, all {cfg.num_octaves} octaves at {BATCH} frames: kernel "
        f"{sum(kernel_ms):.3f} ms (three-pass kernel: {PREV_MS['fused_octave']} ms), with "
        f"emit_scales {sum(scales_ms):.3f} ms, plain {sum(plain_ms):.3f} ms, bound "
        f"{sum(b[0] for b in octave_bounds):.3f} ms [{smi}]"
    )

    iters = 5
    t_pyr = t_tail = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dogs, masks = build_pyramid_fused(images, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        detect_octaves(dogs, cfg, masks)
        torch.cuda.synchronize()
        t_pyr += t1 - t0
        t_tail += time.perf_counter() - t1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        detect_batched(images, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fps = BATCH * iters / seconds
    _say(
        f"timing detect_batched: {1e3 * seconds / iters:.2f} ms per {BATCH}-frame batch, "
        f"{fps:.1f} frames/s; pyramid {1e3 * t_pyr / iters:.2f} ms, selection + "
        f"refinement {1e3 * t_tail / iters:.2f} ms per batch [{smi}]"
    )

    del dogs, masks

    # --- 6. the describe path ----------------------------------------------
    warm = detect_and_describe_batched(images_cpu, cfg)  # warm-up, from a CPU tensor
    torch.cuda.synchronize()
    _require(warm.valid.is_cuda and warm.descriptor.is_cuda,
             "detect_and_describe_batched of a CPU tensor did not run on the card")
    del warm
    torch.cuda.reset_peak_memory_stats()
    fused_octave.launches = window_sample_pair.launches = blur_fused.launches = 0
    described = detect_and_describe_batched(images, cfg)
    torch.cuda.synchronize()
    describe_launches = {
        "fused_octave": fused_octave.launches,
        "window_sample_pair": window_sample_pair.launches,
        "blur_fused": blur_fused.launches,
    }
    describe_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    dvalid = described.valid
    n_described = int(dvalid.sum())
    _say(
        f"describe path: detect_and_describe_batched {BATCH}x{HEIGHT}x{WIDTH}: launches "
        f"{describe_launches}, valid descriptors {n_described} of "
        f"{BATCH * cfg.descriptor_pair_capacity()} pair slots "
        f"({cfg.describe_capacity()} keypoint slots per image), peak device memory "
        f"{describe_peak_gib:.2f} GiB"
    )
    _require(describe_launches["fused_octave"] >= cfg.num_octaves,
             "the describe path did not launch the octave kernel per octave")
    _require(describe_launches["window_sample_pair"] >= 2,
             "the describe path did not launch the sampling kernel per stage")
    _require(describe_launches["blur_fused"] == 0,
             "the fused-only describe path launched the stand-alone blur")
    _require(tuple(described.descriptor.shape) == (BATCH, cfg.descriptor_pair_capacity(), 128),
             f"descriptor shape {tuple(described.descriptor.shape)}")
    _require(n_described > 0, "no valid descriptors")
    _require(bool(torch.isfinite(described.descriptor).all()), "descriptors not finite")
    norms = described.descriptor[dvalid].norm(dim=-1)
    _require(bool(((norms - 1).abs() <= NORM_ATOL).all()), "descriptor norms off 1")
    theta = described.theta[dvalid]
    _require(bool(((theta >= 0) & (theta < 6.2831855)).all()), "theta outside [0, 2pi)")

    plain_described = describe_compact(
        plain_stacks, plain_keypoints, cfg, sample_fn=window_sample_pair_reference
    )
    torch.cuda.synchronize()
    del plain_stacks, plain_keypoints
    agreement = _slot_agreement(described, plain_described)
    both = dvalid & plain_described.valid
    dtheta = (described.theta[both] - plain_described.theta[both]).abs()
    dtheta = torch.minimum(dtheta, 6.2831855 - dtheta)
    p99_theta = torch.quantile(dtheta.double(), 0.99).item()
    # The cosine is taken where θ agrees: a pair whose θ differs describes
    # another rotation, which the θ quantile above accounts for.
    same = dtheta <= P99_THETA
    cosine = (described.descriptor[both][same] * plain_described.descriptor[both][same]).sum(-1)
    _say(
        f"describe path vs plain on the card: valid {n_described} vs "
        f"{int(plain_described.valid.sum())}, slot agreement {agreement:.6f}, theta "
        f"diff p99 {p99_theta:.3g} rad (max {dtheta.max().item():.3g}), min cosine "
        f"{cosine.min().item():.7f} over {int(same.sum())} pairs"
    )
    _require(agreement >= SLOT_AGREEMENT, "describe slot agreement below the bar")
    _require(p99_theta <= P99_THETA, "theta difference above the bar")
    _require(cosine.min().item() >= MIN_COSINE, "descriptor cosine below the bar")
    del plain_described

    # --- 7. window sampling vs plain on the batch's real slots ----------------
    dogs, masks, stacks = build_pyramid_fused(images, cfg, emit_scales=True)
    keypoints_list, _ = detect_octaves(dogs, cfg, masks)
    del dogs, masks
    stages = []  # the kernel's inputs, as the path gives them

    def recording(stacks, table, ys, xs):
        stages.append((table, ys, xs))
        return window_sample_pair(stacks, table, ys, xs)

    describe_compact(stacks, keypoints_list, cfg, sample_fn=recording)
    _require(len(stages) == 2, f"{len(stages)} describe stages sampled")
    sample_err, sample_ms, sample_plain_ms, sample_bounds = 0.0, [], [], []
    for name, (table, ys, xs) in zip(("orientation", "descriptor"), stages):
        got = window_sample_pair(stacks, table, ys, xs)
        want = window_sample_pair_reference(stacks, table, ys, xs)
        torch.cuda.synchronize()
        err = max((got[0] - want[0]).abs().max().item(), (got[1] - want[1]).abs().max().item())
        invalid = table[:, 3] == 0
        zeros = not bool(got[0][invalid].any() | got[1][invalid].any())
        _say(
            f"window sampling vs plain, {name} stage {tuple(ys.shape)}: max abs diff "
            f"{err:.3g}, {int(invalid.sum())} invalid slots zero {zeros}, largest "
            f"|gradient| {got[0].abs().max().item():.3g}"
        )
        _require(err <= MAX_ABS_ERR, f"{name} samples differ by more than {MAX_ABS_ERR}")
        _require(zeros, f"{name} stage: an invalid slot is not zero")
        _require(bool(got[0].any()), f"{name} stage sampled only zeros")
        sample_err = max(sample_err, err)
        del got, want

    # The per-octave describe, which ``compact_describe=False`` selects:
    # every slot of every octave, one single-stack slot table per octave.
    per_octave_cfg = dataclasses.replace(cfg, compact_describe=False)
    window_sample_pair.launches = 0
    per_octave = detect_and_describe_batched(images, per_octave_cfg)
    torch.cuda.synchronize()
    per_octave_launches = window_sample_pair.launches
    per_octave_plain = concat_described([
        describe_octave(stack, kp, octave, cfg, sample_fn=window_sample_pair_reference)
        for octave, (stack, kp) in enumerate(zip(stacks, keypoints_list))
    ])
    torch.cuda.synchronize()
    per_octave_err = max(
        (per_octave.descriptor - per_octave_plain.descriptor).abs().max().item(),
        (per_octave.theta - per_octave_plain.theta)[per_octave_plain.valid].abs().max().item(),
    )
    per_octave_same = all(
        torch.equal(getattr(per_octave, f), getattr(per_octave_plain, f))
        for f in ("valid", "octave", "scale_level", "abs_y", "abs_x", "abs_sigma")
    )
    _say(
        f"per-octave describe (compact_describe=False) {BATCH}x{HEIGHT}x{WIDTH}: sampling "
        f"launches {per_octave_launches} over {tuple(per_octave.valid.shape)} pair slots, "
        f"valid {int(per_octave.valid.sum())} (compacting path {n_described}); against the "
        f"plain sampler: slots equal {per_octave_same}, descriptor and theta max abs diff "
        f"{per_octave_err:.3g}"
    )
    _require(per_octave_launches == 2 * cfg.num_octaves,
             "the per-octave describe did not launch the sampling kernel twice per octave")
    _require(per_octave_same, "per-octave describe: slots differ from the plain sampler's")
    _require(per_octave_err <= MAX_ABS_ERR, "per-octave describe differs from the plain sampler's")
    _require(int(per_octave.valid.sum()) >= n_described,
             "the per-octave describe holds fewer descriptors than the compacting one")
    sample_err = max(sample_err, per_octave_err)
    del per_octave, per_octave_plain

    # --- 8. the scale-space path -----------------------------------------------
    n_blurs = cfg.scales_per_octave_total + (cfg.scales_per_octave_total - 1) * (cfg.num_octaves - 1)
    build_scale_space(images[:4], cfg, blur="cuda")  # warm-up
    fused_octave.launches = window_sample_pair.launches = blur_fused.launches = 0
    scale_space = build_scale_space(images, cfg, blur="cuda")
    torch.cuda.synchronize()
    blur_launches = blur_fused.launches
    space_err = max((a - b).abs().max().item() for a, b in zip(scale_space, stacks))
    _say(
        f"scale-space path: build_scale_space(blur='cuda') on {tuple(images.shape)}: blur "
        f"launches {blur_launches} (expected {n_blurs}), max abs diff to the fused "
        f"pyramid's stacks {space_err:.3g}"
    )
    _require(blur_launches == n_blurs, "the scale-space path did not launch one blur per scale")
    _require(space_err <= MAX_ABS_ERR, "scale space differs from the fused pyramid's stacks")
    _require(all(bool(torch.isfinite(s).all()) for s in scale_space), "scale space not finite")
    # The planes the path hands to the blur, octave by octave.
    octave_bases = [upsample2x_nn(images).contiguous()] + [
        downsample2x_nn(s[:, spo]).contiguous() for s in scale_space[:-1]
    ]
    del scale_space

    # --- 9. blur vs plain at every (octave, scale) of that path ------------------
    blur_err = 0.0
    for octave, base in enumerate(octave_bases):
        octave_err = 0.0
        for scale, sigma in enumerate(_octave_sigmas(cfg, octave)):
            if sigma is None:
                continue
            err = (blur_fused(base, sigma) - blur_separable(base, sigma)).abs().max().item()
            _require(err <= MAX_ABS_ERR, f"blur octave {octave} scale {scale} differs by {err}")
            octave_err = max(octave_err, err)
        blur_err = max(blur_err, octave_err)
        _say(
            f"blur vs plain, octave {octave} {tuple(base.shape)}, sigmas "
            f"{[round(sg, 3) for sg in _octave_sigmas(cfg, octave) if sg is not None]}: "
            f"max abs diff {octave_err:.3g}"
        )

    # --- 10. timings of the describe and blur kernels ---------------------------
    for name, (table, ys, xs) in zip(("orientation", "descriptor"), stages):
        k_ms, p_ms, rounds = _in_turns(
            torch,
            lambda: window_sample_pair(stacks, table, ys, xs),
            lambda: window_sample_pair_reference(stacks, table, ys, xs),
            10, 2,
        )
        n_valid = int((table[:, 3] != 0).sum())
        bound = _bound(
            _window_bytes(torch, stacks, table, ys, xs), SAMPLE_FLOP * n_valid * ys.shape[1]
        )
        sample_ms.append(k_ms)
        sample_plain_ms.append(p_ms)
        sample_bounds.append(bound)
        _say(
            f"timing window sampling, {name} stage {tuple(ys.shape)}, {n_valid} valid slots: "
            f"kernel {k_ms:.3f} ms (rounds {rounds[1]:.3f}, {rounds[2]:.3f}), plain {p_ms:.3f} "
            f"ms (rounds {rounds[0]:.3f}, {rounds[3]:.3f}), plain/kernel {p_ms / k_ms:.2f}x, "
            f"bound {bound[0]:.4f} ms by {bound[1]} [{smi}]"
        )
    _say(
        f"timing window sampling, both stages: kernel {sum(sample_ms):.3f} ms (before the "
        f"tiled octave and blur kernels, same source: {PREV_MS['window_sample_pair']} ms), "
        f"plain {sum(sample_plain_ms):.3f} ms [{smi}]"
    )
    del stages, stacks, keypoints_list

    import torch.nn.functional as F

    def library_blur(image, sigma):
        """The same blur as two cuDNN convolutions (1×k, then k×1) on
        replicate-padded planes; a yardstick only, the port never calls it."""
        taps = torch.tensor(taps_f32(sigma), device=image.device)
        r = (taps.numel() - 1) // 2
        x = F.pad(image[:, None], (r, r, 0, 0), mode="replicate")
        x = F.conv2d(x, taps.view(1, 1, 1, -1))
        x = F.pad(x, (0, 0, r, r), mode="replicate")
        return F.conv2d(x, taps.view(1, 1, -1, 1))[:, 0]

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    blur_ms = blur_plain_ms = blur_library_ms = 0.0
    blur_bytes = blur_flop = 0
    for octave, base in enumerate(octave_bases):
        for scale, sigma in enumerate(_octave_sigmas(cfg, octave)):
            if sigma is None:
                continue
            radius = kernel_radius(sigma)
            k_ms, p_ms, _ = _in_turns(
                torch, lambda: blur_fused(base, sigma), lambda: blur_separable(base, sigma), 5, 2
            )
            lib_err = (library_blur(base, sigma) - blur_fused(base, sigma)).abs().max().item()
            _require(lib_err <= 1e-5, f"the library yardstick computes another blur ({lib_err})")
            l_ms = _event_ms(torch, lambda: library_blur(base, sigma), 5)
            bound = _bound(8 * base.numel(), _blur_flop(base.numel(), radius))
            blur_ms += k_ms
            blur_plain_ms += p_ms
            blur_library_ms += l_ms
            blur_bytes += 8 * base.numel()
            blur_flop += _blur_flop(base.numel(), radius)
            _say(
                f"timing blur octave {octave} scale {scale} {tuple(base.shape)} sigma "
                f"{sigma:.4f} radius {radius}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, two "
                f"conv2d {l_ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]} [{smi}]"
            )
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    blur_bound = sum(
        _bound(8 * base.numel(), _blur_flop(base.numel(), kernel_radius(sigma)))[0]
        for octave, base in enumerate(octave_bases)
        for sigma in _octave_sigmas(cfg, octave) if sigma is not None
    )
    _say(
        f"timing blur, all {n_blurs} blurs of the scale-space path at {BATCH} "
        f"frames: kernel {blur_ms:.3f} ms (two-pass kernel: {PREV_MS['blur_fused']} ms), "
        f"plain {blur_plain_ms:.3f} ms, two conv2d "
        f"{blur_library_ms:.3f} ms, bound {blur_bound:.3f} ms [{smi}]"
    )
    del octave_bases

    marks = []

    def marking(stacks, table, ys, xs):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return window_sample_pair(stacks, table, ys, xs)

    t_stage = [0.0] * 4  # pyramid, selection + refinement, orientation, descriptor
    for _ in range(iters):
        marks.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dogs, masks, stacks = build_pyramid_fused(images, cfg, emit_scales=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        keypoints_list, _ = detect_octaves(dogs, cfg, masks)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        describe_compact(stacks, keypoints_list, cfg, sample_fn=marking)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for i, dt in enumerate((t1 - t0, t2 - t1, marks[1] - t2, t3 - marks[1])):
            t_stage[i] += dt
    del dogs, masks, stacks, keypoints_list
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        detect_and_describe_batched(images, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _say(
        f"timing detect_and_describe_batched: {1e3 * seconds / iters:.2f} ms per {BATCH}-frame "
        f"batch, {BATCH * iters / seconds:.1f} frames/s; with a synchronise between stages: "
        f"pyramid with stacks {1e3 * t_stage[0] / iters:.2f} ms, selection + refinement "
        f"{1e3 * t_stage[1] / iters:.2f} ms, compaction + orientation stage "
        f"{1e3 * t_stage[2] / iters:.2f} ms, pair compaction + descriptor stage "
        f"{1e3 * t_stage[3] / iters:.2f} ms per batch [{smi}]"
    )

    # --- 11. the clamped mode of the octave and blur kernels -------------------
    deep_cfg = SiftConfig()  # 5 octaves x 3 scales
    deep = cfg.num_octaves  # the octave past the paths above
    detect_batched(images[:4], deep_cfg)  # warm-up
    fused_octave.launches = fused_octave.clamped_launches = 0
    deep_keypoints, _ = detect_batched(images, deep_cfg)
    torch.cuda.synchronize()
    deep_launches = fused_octave.launches, fused_octave.clamped_launches
    dogs, masks = build_pyramid_fused(images, deep_cfg, octave_fn=fused_octave_reference)
    deep_plain = concat_keypoints(detect_octaves(dogs, deep_cfg, masks)[0])
    torch.cuda.synchronize()
    del dogs, masks
    agreement = _slot_agreement(deep_keypoints, deep_plain)
    both = deep_keypoints.valid & deep_plain.valid
    delta = torch.hypot(deep_keypoints.abs_x[both] - deep_plain.abs_x[both],
                        deep_keypoints.abs_y[both] - deep_plain.abs_y[both])
    p99 = torch.quantile(delta.double(), 0.99).item()
    from_deep = int((deep_keypoints.valid & (deep_keypoints.octave == deep)).sum())
    _say(
        f"clamped mode: detect_batched {BATCH}x{HEIGHT}x{WIDTH} at {deep_cfg.num_octaves} "
        f"octaves x {deep_cfg.scales_per_octave} scales: kernel launches {deep_launches[0]}, "
        f"of them clamped {deep_launches[1]}; valid {int(deep_keypoints.valid.sum())} vs plain "
        f"{int(deep_plain.valid.sum())} ({from_deep} from octave {deep}), slot agreement "
        f"{agreement:.6f}, p99 position delta {p99:.3g} px"
    )
    _require(deep_launches == (deep_cfg.num_octaves, 1),
             "the 5-octave path did not launch the clamped octave kernel once")
    _require(agreement >= SLOT_AGREEMENT and p99 <= P99_PX,
             "the 5-octave path disagrees with its plain version")
    _require(bool(torch.isfinite(deep_keypoints.abs_x[deep_keypoints.valid]).all()),
             "the 5-octave path's keypoints are not finite")
    del deep_keypoints, deep_plain

    base, deep_spo = images, deep_cfg.scales_per_octave
    for octave in range(deep):
        _, seed, _ = fused_octave(base, _octave_sigmas(deep_cfg, octave), deep_spo, thr,
                                  upsample2x=octave == 0)
        base = downsample2x_nn(seed).contiguous()
    sigmas = _octave_sigmas(deep_cfg, deep)
    radii = [0 if sg is None else kernel_radius(sg) for sg in sigmas]
    plane = tuple(base.shape[1:])
    _require(octave_tile_plan(*plane, tuple(radii)).clamped
             and blur_tile_plan(*plane, max(radii)).clamped,
             f"octave {deep} {plane} at radius {max(radii)} is not planned clamped")
    fused_octave.clamped_launches = blur_fused.clamped_launches = 0
    got = fused_octave(base, sigmas, deep_spo, thr, emit_scales=True)
    want = fused_octave_reference(base, sigmas, deep_spo, thr, emit_scales=True)
    blurred = blur_fused(base, sigmas[-1])
    torch.cuda.synchronize()
    _require((fused_octave.clamped_launches, blur_fused.clamped_launches) == (1, 1),
             "the clamped kernels were not launched")
    clamped_err = max((got[i] - want[i]).abs().max().item() for i in (0, 1, 3))
    clamped_same = (got[2] == want[2]).float().mean().item()
    clamped_blur_err = (blurred - blur_separable(base, sigmas[-1])).abs().max().item()
    _require(max(clamped_err, clamped_blur_err) <= MAX_ABS_ERR,
             "a clamped kernel differs from its plain version")
    _require(clamped_same >= MASK_AGREEMENT, "the clamped octave kernel's masks disagree")
    max_err, blur_err = max(max_err, clamped_err), max(blur_err, clamped_blur_err)
    del got, want, blurred
    k_ms, p_ms, _ = _in_turns(
        torch,
        lambda: fused_octave(base, sigmas, deep_spo, thr),
        lambda: fused_octave_reference(base, sigmas, deep_spo, thr),
        10, 3,
    )
    bk_ms, bp_ms, _ = _in_turns(
        torch, lambda: blur_fused(base, sigmas[-1]), lambda: blur_separable(base, sigmas[-1]), 10, 3
    )
    n_scales = len(sigmas)
    octave_bound = _bound(base.numel() * (4 + 4 * (n_scales - 1) + 4 + 2),
                          sum(_blur_flop(base.numel(), r) for r in radii)
                          + base.numel() * (n_scales - 1))
    blur_bound_deep = _bound(8 * base.numel(), _blur_flop(base.numel(), max(radii)))
    _say(
        f"clamped mode, octave {deep} {tuple(base.shape)} radii {radii}: octave kernel vs "
        f"plain max abs diff {clamped_err:.3g}, masks equal on {100 * clamped_same:.4f} % of "
        f"pixels, {k_ms:.3f} ms against plain {p_ms:.3f} ms (bound {octave_bound[0]:.4f} ms by "
        f"{octave_bound[1]}); blur kernel at radius {max(radii)} max abs diff "
        f"{clamped_blur_err:.3g}, {bk_ms:.3f} ms against plain {bp_ms:.3f} ms (bound "
        f"{blur_bound_deep[0]:.4f} ms by {blur_bound_deep[1]}) [{smi}]"
    )

    del images, images_cpu, base
    torch.cuda.empty_cache()

    # --- 12-14. the oracle leg, two views, the solvers ---------------------------
    import sift_scale_space_extrema_detection_tpu_torch as port

    _phase_oracle_leg(torch, port)
    two_view_err = _phase_two_view(torch, port, smi)
    max_err, sample_err = max(max_err, two_view_err[0]), max(sample_err, two_view_err[1])
    _phase_solvers(torch, port, smi)
    slam_launches, stream_launches, slam_octave_err, slam_sample_err, slam_refs = _phase_slam(
        torch, port, smi, device
    )
    max_err, sample_err = max(max_err, slam_octave_err), max(sample_err, slam_sample_err)
    surface_launches, surface_octave_err = _phase_surfaces(torch, port, smi, device)
    max_err = max(max_err, surface_octave_err)
    shard_launches, shard_octave_err, shard_sample_err = _phase_sharding(
        torch, port, smi, device, slam_refs
    )
    max_err, sample_err = max(max_err, shard_octave_err), max(sample_err, shard_sample_err)

    octave_bound_ms = sum(b[0] for b in octave_bounds)
    sample_bound_ms = sum(b[0] for b in sample_bounds)
    record = {
        "kernels": [
            {
                "name": "fused_octave",
                "route": "cuda",
                "source": CSRC + "octave.cu",
                "replaces": PALLAS + "octave.py:437",
                "launches": describe_launches["fused_octave"] + slam_launches[0]
                + stream_launches[0] + surface_launches[0] + shard_launches[0],
                "max_abs_err": max_err,
                "ms": sum(kernel_ms),
                "plain_ms": sum(plain_ms),
                "bound_ms": octave_bound_ms,
                "bound_by": max(octave_bounds)[1],
                "library_ms": None,
            },
            {
                "name": "window_sample_pair",
                "route": "cuda",
                "source": CSRC + "describe.cu",
                "replaces": PALLAS + "describe.py:288",
                "launches": describe_launches["window_sample_pair"] + slam_launches[1]
                + stream_launches[1] + surface_launches[1] + shard_launches[1],
                "max_abs_err": sample_err,
                "ms": sum(sample_ms),
                "plain_ms": sum(sample_plain_ms),
                "bound_ms": sample_bound_ms,
                "bound_by": max(sample_bounds)[1],
                "library_ms": None,
            },
            {
                "name": "blur_fused",
                "route": "cuda",
                "source": CSRC + "blur.cu",
                "replaces": PALLAS + "blur.py:98",
                "launches": blur_launches + slam_launches[2] + stream_launches[2]
                + surface_launches[2] + shard_launches[2],
                "max_abs_err": blur_err,
                "ms": blur_ms,
                "plain_ms": blur_plain_ms,
                "bound_ms": blur_bound,
                "bound_by": _bound(blur_bytes, blur_flop)[1],
                "library_ms": blur_library_ms,
            },
        ]
    }
    print(json.dumps(record))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
