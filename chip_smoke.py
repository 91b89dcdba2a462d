#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and ``nvcc``, and imports nothing of JAX.

Phases (any failure exits non-zero and prints no result):

Wherever a phase below zeroes and reads the launch counts of K1 (the
fused octave), K2 (window sampling) and K3 (the blur), it zeroes and reads
R1's (refinement's kernel) and R2's (selection's kernels, one count a
call) beside them and holds them too. R1: one launch an octave of each
frontend batch on the card (the frontend refines octave by octave), one a
pool under ``unified_refine`` (all octaves) and ``refine_tail_pool``
(octave 0, then the rest), none on tracks-only paths. R2: one an octave
wherever K1 made the packed plane (the fused route selects from it), none
on the scale-space paths. Phase 23's ranks report K1-K3 alone.

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
   (host clock around synchronised runs). Then refinement's kernel (R1,
   ``ops/kernels/refine.py::newton_ladder``) against its plain version
   (``ops/refine.py::newton_ladder_reference``) on each octave's DoG and
   candidates of that batch and of a 64 × 384×1280 batch at 4 octaves × 3
   scales (the KITTI benchmark cell's shape): every output field bit for
   bit, and each step's live slots equal to the plain version's counters;
   both timed in turns, each turn enqueued while the stream is held.
   Selection's kernels (R2, ``ops/kernels/select.py::select_candidates``)
   against their plain version (``ops/extrema.py::
   select_refine_candidates_reference``) on each octave's packed plane and
   DoG of both batches: every ``Extrema`` field and both counters bit for
   bit; timed the same way.
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
    of each other (phase 15 (c)'s bars). Last, on the card only, its first
    80 frames with ``--blur separable --match-gate 30 --reassoc 2
    --max-tracks 65536``: launches 0/10/0 and a finite trajectory of 80
    rows; landmarks, ATE, RPE and RRE are readings (both packages lose the
    dolly there; ``tools/torch_dolly_parity.py`` reads the CPU and the JAX
    package beside it).

17. sharding over ``torch.distributed`` (``_phase_sharding``): (a) world 1
    on NCCL in this process, the data-parallel frontend, keyframe-sharded
    matching, the sharded BA and composed SLAM and streaming with a mesh,
    each equal to its unsharded run; (b) two gloo ranks spawned on the card
    (``_shard_rank``, held by ``_shard_bars`` as phase 20's ranks are): the
    frontend bit-equal to each 32-frame share's single-device run, 4/2/0 a
    rank, K1/K2 equal to their plain versions; the BA on phase 14's dense
    problem, ranks and reruns bit-equal, within 1e-3 of world 1; config[3]'s
    orbit with every BA sharded, at phase 15's bars.
18. the blur-by-blur frontend and the pooled refinement
    (``_phase_blur_paths``), every part's three counts zeroed before it and
    read after it. (a) ``detect_batched(blur="cuda")`` on the 64-frame batch
    at 4 octaves × 5 scales: K1/K2/K3 0/0/29, every field and each octave's
    per-trio ``Extrema`` equal to ``blur="separable"`` on the card, the first
    8 frames against ``device="cpu"`` (slot agreement >= 0.999, p99 <= 0.1
    px); ms, frames/s, peak memory and synchronised stages. (b)
    ``detect_and_describe_batched(blur="cuda")``: 0/2/29, equal to
    ``"separable"``, phase 6's bars against the CPU, K2 against its plain
    version on this path's slots. (e) the data-parallel frontend with
    ``blur="cuda"`` at world 1 on NCCL, equal to (b). (g) ``detect_batched``
    with ``unified_refine`` and then ``refine_tail_pool``: card against CPU,
    bit-equal reruns, the slots whose fate the pool moved. (c)
    ``run_slam_from_images(blur="cuda")`` on phase 15's gated sequence:
    0/6/48 (3 chunks × 16 blurs), bit-equal to ``"separable"``, phase 15
    (c)'s bars on ``run_slam`` card against CPU. (d) ``SlamSession(blur=
    "cuda")`` bit-equal to (c). (f) ``evaluate --blur pallas`` on phase 16's
    40-frame TUM cut: equal to ``--blur cuda``, card against ``--device cpu
    --blur separable`` at phase 16 (c)'s bars.
19. the JAX package's orbax checkpoints (``_phase_orbax``), read in this
    process by the port's own zstd, OCDBT and zarr readers (no orbax,
    tensorstore or zstandard exists here). (a) ``tests/fixtures/jax_orbax/``:
    config[3]'s SLAM state after frame 21 of a run the JAX package stopped,
    written by orbax, equal to its npz twin (keys, dtypes, shapes, bytes);
    its final ``BAState`` restored into a template on the card, equal to its
    npz twin; the bytes read, seconds and MB/s. (b) ``run_slam(resume=True)``
    on the card from copies of the orbax state and of its npz twin: the two
    trajectories bit-equal, more than 200 valid landmarks, ATE < 0.08 and
    within 0.02 of the JAX package's resumed ATE; K1/K2/K3 0/0/0 (tracks
    only); seconds and frames/s beside phase 15 (g)'s uninterrupted ATE.
    (c) Nothing is caught: an unreadable fixture ends the script; none of
    jax, orbax, tensorstore or zstandard was loaded, and the committed
    fixture's bytes are unchanged.
20. the sharded paths across cards (``_phase_multicard``), only where
    several cards are visible (on one it prints a line saying so; alone on
    four: ``tools/torch_multicard_phase.py``). min(4, cards) ranks started by
    ``python -m torch.distributed.run --standalone`` (``_shard_rank``),
    NCCL, rank r on ``cuda:r`` by ``LOCAL_RANK`` although each initialised
    CUDA first; the single-card references in this process on ``cuda:0``.
    (a) ``detect_and_describe_data_parallel`` on 4 × 64 × 480×640 frames
    with ``blur="fused"`` and ``"cuda"``: the gathered fields bit-equal to
    the shares' ``detect_and_describe_batched``, K1/K2/K3 4/2/0 and 0/2/29 a
    rank, each rank's outputs on its card before the gather, K1/K2 and K3
    equal to their plain versions on its share (max abs diff 0), no rank
    allocating on another's card; ms a step, frames/s, memory. (b)
    keyframe-sharded matching of 1,800 slots against 64 keyframes, bit-equal
    to the world-1 ``vmap(match_descriptors)``. (c) the sharded BA on phase
    14's two problems: cost within 1e-3 of world 1's, rms <= 1 px, ranks
    bit-equal. (d) phase 15's gated sequence through ``run_slam_from_images
    (mesh=...)`` at ``dist_ba_min_landmarks`` 4096 and 0 (sharded BAs > 0),
    ATE within 0.02 of the single card's, ranks bit-equal; ``SlamSession``
    within 0.02 of it; launches 3/2/0 a rank for each run and 24/16/0 for
    the session. (e) config[3]'s orbit at threshold 0: ATE < 0.08 and
    within 0.02 of the single card's. (f) ``tools/torch_dryrun_multichip.py
    --world 4``. (g) ``detect_and_describe_batched(device="cuda:3")`` in this
    process: bit-equal to ``cuda:0``'s, nothing allocated on card 0.
21. the card's probes (``_phase_probes``; K4-K7 of ``csrc/probes.cu``, which
    no other phase launches: their counts must be 0 here). (a) The entry
    points as a user runs them, every count zeroed before and read after:
    ``benchmarks.bw_probe --gb 1.0`` (write, copy and read of a 65,536 ×
    4,096 float32 buffer, and ``torch.full`` / ``x + 0.0``) and
    ``benchmarks.tap_probe`` at 256 and 8,192 rows; their JSON lines. (b)
    Each kernel against its plain version on the same CUDA tensors at the
    originals' shapes: write, copy, read and the f32 chain max abs diff 0;
    the bf16 chains within ``tap_tolerance`` (one bf16 rounding per
    product); the write and the copy also at their edges (4 elements, a
    stretch of 256 float4s and 16 bytes, a count of stretches that does not
    divide among the resident blocks, a view 16 bytes into its buffer),
    each of their outputs where a buffer of NaN was just freed. (c) Plain
    version, kernel and library call in one sequence of turns, each turn
    enqueued while the stream is held (for the write and the copy with the
    first design and a bulk-copy ring of ``tools/probe_designs.cu`` in the
    same turns); GB/s, ps/element·tap;
    the floating-point opcodes of the chain in ``cuobjdump -sass`` (f32:
    831 FADD, no FFMA; the compiler computes the 13 products once) and the
    float32 instructions/s they give. (d)
    K1's, K2's and K3's reach: each launch timed in phases 5 and 10, the larger
    of its bytes over the measured copy rate and its operations (taps,
    DoG differences, K1's scan) over the measured f32 chain's rate.
22. the port's measuring entry points (``_phase_benchmarks``; the modules
    of ``…_torch/benchmarks/``, each through its ``run`` at its script's
    full default width, every count zeroed before the phase): ``bench`` (64
    × 480×640, K1 only); ``frontend_bench --stages --describe`` with
    ``--blur fused`` (K1, and K2 in the describe) and ``--blur cuda`` (K3,
    and K2 in the describe), K1's reach at phase 21's ceilings;
    ``ba_bench --breakdown`` (dense, 50 × 4,096 × 512) and ``--large`` (CG,
    1,000 × 100,000 × 300), no kernel; ``slam_bench`` (40 × 640×480, the
    dolly), ``--streaming``, ``--suite --seeds 1`` over the four shapes,
    and the loop-closure regime of ``BASELINE.md`` (80 frames,
    ``--trajectory loop --final-rounds 0``) with ``--loop-stride 1
    --pose-graph`` and without closure, K2 only; ``descriptor_bench`` (the
    11 warps against OpenCV), K2 only. Every number of every output is
    finite; the JSON objects and the loop regime's ATEs beside the JAX
    package's TPU readings are printed.
23. the last three measuring scripts' counterparts (``_phase_scaling``):
    (a) ``benchmarks.scatter_probe`` at the script's size (O 25,600, L
    4,096, C 50) and at 16x its O and L (409,600, 65,536): every row
    finite, the sorted route (``sfm/ba.py``'s production reduction)
    bit-equal on a rerun and within 1e-4 of ``index_add_``'s sums; (b)
    ``benchmarks.scaling_bench --devices 1`` through its torchrun route on
    one NCCL rank: every reading finite, its ranks' bars held, K1 and K2
    launched by its frontend leg and K2 by its SLAM leg (their launches
    counted in the kernels' record); (c) a line naming
    ``tools/torch_multicard_phase.py``, which runs ``scaling_bench
    --devices 4`` and ``multihost_bench --nproc 2`` on four cards.

A kernel's ``bound_ms`` is the least time the card could take: the larger
of the bytes that must move (each input read once, each output written
once) over 3.35 TB/s and the float32 operations over 67 TFLOP/s.

The operation peak counts a fused multiply-add as two operations; the blur
kernels may not fuse (it would change the rounding), so for them half that
rate is the card's real ceiling. The bound keeps the published peak.

``reach_ms`` (K1, K2 and K3) is the same least time at the ceilings phase 21
measured on this card instead of the published ones, and ``reach_by`` says
which of the two sums is larger.

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

from sift_scale_space_extrema_detection_tpu_torch.benchmarks import (
    digest,
    host_ms,
    sync,
    torchrun_ranks,
)
from sift_scale_space_extrema_detection_tpu_torch.benchmarks.ba_bench import make_problem
from sift_scale_space_extrema_detection_tpu_torch.benchmarks.bench import make_batch as _make_batch
from sift_scale_space_extrema_detection_tpu_torch.benchmarks.frontend_bench import (
    PEAK_BYTES_PER_S,
    PEAK_FLOP_PER_S,
    blur_flop as _blur_flop,
    bound as _bound,
    octave_cost,
    octave_sigmas as _octave_sigmas,
    reach as _reach,
)
from sift_scale_space_extrema_detection_tpu_torch.benchmarks.slam_bench import (
    configs as slam_bench_configs,
    render_sequence,
    to_uint16,
)
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.refine import newton_ladder
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.select import select_candidates

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
# The card's published peaks (NVIDIA H100 SXM data sheet) are frontend_bench's.
SAMPLE_FLOP = 40  # per gradient sample: 8 differences, 8 halvings, 2 blends of 9, clamps
# Each kernel's time at these shapes before the octave and blur kernels
# became one launch on shared-memory tiles (NVIDIA H100 80GB HBM3, 700.00 W,
# this script), and ``detect_batched``'s peak device memory then.
PREV_MS = {"fused_octave": 17.59, "window_sample_pair": 0.71, "blur_fused": 14.77}
PREV_DETECT_PEAK_GIB = 7.76
# R1's least bytes a candidate slot: y, x, scale level and value read (16 B)
# and the valid flag (1 B); octave, s, m, n, reason written (20 B), abs_y,
# abs_x, abs_sigma, omega (16 B) and valid (1 B). The 19 DoG points a live
# slot gathers a step are left out: the least bytes read them at most once.
REFINE_SLOT_BYTES = 54
# R2's least bytes: the packed plane read once, and each slot's y, x, scale
# level, value (16 B) and valid flag (1 B) written once.
SELECT_SLOT_BYTES = 17


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
SHARD_BA = (50, 4096, 512)  # phase 14's dense problem: cameras, landmarks, observations a camera
BA_LARGE = (1000, 100_000, 300)  # phase 14's CG problem, through the sharded solver in phase 20
MULTICARD_WORLD = 4  # phase 20: at most four ranks, one a card
MULTICARD_KEYFRAMES = 64  # phase 20 (b): 1,800 query slots against 64 keyframes
MULTICARD_REPEATS = 5
MULTICARD_TIMEOUT_S = 900  # the ranks' whole run, and the dry run's
BA_ITERATIONS = 10
SURFACE_FRAMES = 200  # each on-disk rehearsal sequence
SURFACE_SOLVED_FRAMES = 40  # the rehearsal's solved variant, run on the card and on the CPU
SURFACE_LONG_FRAMES = 80  # the rehearsal's gated cut past the loss, on the card only
SURFACE_LONG_TRACKS = 65_536  # its track room (the port's evaluate --max-tracks)
KITTI_SIZE = (1241, 376)  # KITTI odometry's gray frames, width x height
KITTI_PADDED = (384, 1280)  # the KITTI cell's frames padded, height x width
MATMUL_ATOL = 1e-5
PER_TRIO_CPU_FRAMES = 8  # phase 18: the batch's frames also run with device="cpu"
ORBAX_FIXTURE = "tests/fixtures/jax_orbax"  # phase 19, beside this script
PROBE_GB = 1.0  # phase 21: bw_probe.py's buffer, 65,536 x 4,096 float32
TAP_LONG_ROWS = 8192  # phase 21: the tap chain also at 8,192 rows (one launch at 256 is ~launch-sized)
# Phase 21: the bf16 tap chains' per-element bound against their plain
# versions, in units of S = Σ|x_t·tap_t| (``tap_tolerance``): one bf16
# rounding (2^-8) per product, and per pair sum in bf16_pair.
BF16_BOUND = {"bf16_carry": 2.0**-8, "bf16_full": 2.0**-8, "bf16_pair": 2.0**-7}
SASS_OPS = ("FMUL", "FADD", "FFMA", "HMUL2", "HADD2", "HFMA2")


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _say(msg: str) -> None:
    print(msg, flush=True)


def _event_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls (the
    host clock where there is no card: a CPU rehearsal's reading)."""
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
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


# Clock cycles a sleeping kernel holds the stream while the host enqueues a
# turn: about 50 ms at the H100's 1.98 GHz, then four times that where the
# host took longer.
HOLD_CYCLES = (100_000_000, 400_000_000)


def _held_ms(torch, fn, reps: int) -> tuple[float, float, bool]:
    """``(device_ms, host_us, held)``: the mean device time of ``fn()`` over
    ``reps`` calls enqueued while a sleeping kernel holds the stream, so
    that no call waits for the host to launch it; the host's mean µs to
    enqueue one call; and whether the stream was still held when the last
    call was enqueued (not where the host stalled for longer than every
    hold, or a turn launches more kernels than the card queues)."""
    for cycles in HOLD_CYCLES:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_s = time.perf_counter() - t0
        held = not start.query()
        end.record()
        torch.cuda.synchronize()
        if held:
            break
    return start.elapsed_time(end) / reps, 1e6 * host_s / reps, held


def _turns_of(torch, fns: dict, reps: dict) -> dict:
    """Mean ms of each of ``fns`` (``name: fn``), each warmed up, then timed
    in one sequence of turns, the names in order and back (``a, b, c, c, b,
    a``), ``reps[name]`` calls a turn: so every pair is compared like with
    like. On the card each turn is enqueued while the stream is held
    (``_held_ms``), so the reading is the card's time alone and not the
    host's latency to launch a call (which differs from one wrapper to
    another: ctypes, a device guard, an allocation)."""
    for fn in fns.values():
        fn()
    names = list(fns)
    rounds = {name: [] for name in names}
    for name in names + names[::-1]:
        if torch.cuda.is_available():
            rounds[name].append(_held_ms(torch, fns[name], reps[name])[0])
        else:
            rounds[name].append(_event_ms(torch, fns[name], reps[name]))
    return {name: sum(r) / len(r) for name, r in rounds.items()}


def _on_poison(torch, n: int, dev, fn):
    """``fn()``, whose new ``n``-element float32 output must start where a
    buffer of NaN was just freed (on the card; on the CPU ``fn()`` alone):
    so an element its kernel did not write stays NaN and cannot pass for a
    written one, as the stale bytes of an earlier output could."""
    if dev.type != "cuda":
        return fn()
    poison = torch.full((n,), float("nan"), device=dev)
    at = poison.data_ptr()
    del poison
    out = fn()
    _require(out.data_ptr() == at, "a checked output did not take the poisoned block")
    return out


def _probe_designs():
    """``tools/torch_probe_designs.py``: the write's and the copy's other
    designs (``tools/probe_designs.cu``), built at first use."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "torch_probe_designs.py")
    spec = importlib.util.spec_from_file_location("torch_probe_designs", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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


def _blur_count(cfg) -> int:
    """Blurs ``build_scale_space`` runs per call: every scale of octave 0,
    every scale but the seed of each later octave."""
    return cfg.num_octaves * cfg.scales_per_octave_total - (cfg.num_octaves - 1)


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
    sync(dev)


def _host_ms(torch, fn, reps: int, dev=None) -> float:
    """``benchmarks.host_ms`` on the card, unless ``dev`` is another device."""
    return host_ms(fn, torch.device("cuda") if dev is None else dev, reps)


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
    newton_ladder.launches = select_candidates.launches = 0
    described = port.detect_and_describe_batched(frames, cfg)
    torch.cuda.synchronize()
    launches = (fused_octave.launches, window_sample_pair.launches, blur_fused.launches,
                newton_ladder.launches, select_candidates.launches)
    n_pairs = cfg.descriptor_pair_capacity()
    _require(launches == (cfg.num_octaves, 2, 0, cfg.num_octaves, cfg.num_octaves),
             f"the two-view path launched the octave, sampling, blur, refinement and "
             f"selection kernels {launches} times")
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
    from sift_scale_space_extrema_detection_tpu_torch.sfm.ba import bundle_adjust
    from sift_scale_space_extrema_detection_tpu_torch.sfm.pose_graph import (
        PoseGraphEdges,
        optimize_pose_graph,
        pose_graph_residuals,
    )

    sizes = {"dense": (50, 4096, 512), "cg": (1000, 100_000, 300)}
    iterations = 10
    for solver, (c, l, opc) in sizes.items():
        state, obs = make_problem(np.random.default_rng(0), c, l, opc,
                                  device=torch.device("cuda", 0))
        n_obs = c * opc

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


def _render_dolly(synthetic, rng, pts, k_mat, num_frames, size, step, keep=None):
    """Frames of a slow lateral dolly (centre ``step·f``, a slow rotation)
    past a textured blob field: the recipe of the JAX package's SLAM tests,
    with the rotation by Rodrigues in numpy. ``keep``: the frame indices
    rendered (default all; a frame does not depend on the others). Returns
    ``(frames, rotations, translations)``."""
    rpts, amps, sscales = synthetic.textured_blob_field(rng, pts)
    rots, ts, frames = [], [], []
    for f in range(num_frames) if keep is None else keep:
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


def slam_bench_recipe(port, frames: int = SLAM_FRAMES, width: int = WIDTH, height: int = HEIGHT):
    """Phase 15's full-width SLAM recipe, the default of the port's
    ``benchmarks.slam_bench`` (the JAX package's ``slam_bench.py``): its
    dolly, seed 0 (uint16, as the bench uploads it), the truth, the
    configurations and the association arguments. ``solved`` holds the
    association arguments of the variant SLAM solves (the match gate and
    the track room, see phase 15 (c)). Returns a dict."""
    images, gt_r, gt_t, k_mat = render_sequence(np.random.default_rng(0), frames, width, height)
    sift_cfg, slam_cfg = slam_bench_configs()
    return dict(
        images=to_uint16(images),
        gt_r=gt_r,
        gt_t=gt_t,
        k_mat=k_mat,
        sift_cfg=sift_cfg,
        slam_cfg=slam_cfg,
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
    refs)``; the launches are (K1, K2, K3, R1, R2) counts, ``refs`` the readings
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
        newton_ladder.launches = select_candidates.launches = 0

    def counts():
        return (fused_octave.launches, window_sample_pair.launches, blur_fused.launches,
                newton_ladder.launches, select_candidates.launches)

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
    _require(small_launches[0] > 0 and small_launches[3] > 0
             and small_launches[4] == small_launches[0],
             "the SLAM path did not launch the octave, refinement and selection kernels")
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
        f"K1/K2/K3/R1/R2 {launches} (expected "
        f"{(3 * chunks, 2 * chunks, 0, 3 * chunks, 3 * chunks)}), valid "
        f"landmarks "
        f"{n_landmarks} of {result.points.shape[0]} tracks, {result.num_observations} "
        f"observations, ATE {ate_batch:.4f} (a reading: the reference's spread 0.05-1.58), "
        f"second run bit-equal {same_bits}"
    )
    _require(launches == (3 * chunks, 2 * chunks, 0, 3 * chunks, 3 * chunks),
             f"the SLAM batch path launched K1/K2/K3/R1/R2 {launches} times")
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
        f"updates (expected {steps}), launches K1/K2/K3/R1/R2 {stream_launches} (expected "
        f"{(3 * calls, 2 * calls, 0, 3 * calls, 3 * calls)}), after finalize bit-equal to the "
        f"batch run "
        f"{stream_same}, "
        f"ATE {ate_stream:.4f} against batch {ate_batch:.4f} (bar: within {SLAM_ATE_GAP}); "
        f"mem:// store empty again {set(checkpoint._MEM_STORE) == stored}"
    )
    _require(len(step_ms) == steps, "SLAM streaming: wrong number of provisional updates")
    _require(stream_launches == (3 * calls, 2 * calls, 0, 3 * calls, 3 * calls),
             f"the streaming path launched K1/K2/K3/R1/R2 {stream_launches} times")
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
    stages = _stage_line(report)
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


def _phase_sharding(torch, port, smi, dev, refs, batch=BATCH, size=(WIDTH, HEIGHT),
                    ba_sizes=SHARD_BA, slam_frames=SLAM_FRAMES, orbit_frames=ORBIT_FRAMES,
                    world=SHARD_WORLD):
    """Phase 17: sharding over ``torch.distributed``. (a) World 1 in this
    process (NCCL on the card, over a file store): the data-parallel
    frontend, keyframe-sharded matching, the sharded BA, composed SLAM and
    the streaming session with a mesh. (b) World ``world`` on gloo, every
    rank spawned on the same ``dev``: the frontend, the BA and config[3]'s
    orbit (:func:`_shard_rank`, held by :func:`_shard_bars`, as phase 20's
    ranks are). ``refs``: phase 15's readings. Returns
    ``(launches, octave_err, sample_err)``: the (K1, K2, K3, R1, R2) launches of the
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
    from sift_scale_space_extrema_detection_tpu_torch.sfm.ba import bundle_adjust

    on_card = dev.type == "cuda"
    total = [0, 0, 0, 0, 0]

    def zero():
        fused_octave.launches = window_sample_pair.launches = blur_fused.launches = 0
        newton_ladder.launches = select_candidates.launches = 0

    def counts():
        got = (fused_octave.launches, window_sample_pair.launches, blur_fused.launches,
               newton_ladder.launches, select_candidates.launches)
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
            f"{batch}x{height}x{width}: launches K1/K2/K3/R1/R2 {launches} (expected "
            f"{(cfg.num_octaves, 2, 0, cfg.num_octaves, cfg.num_octaves)}), every field equal to "
            f"detect_and_describe_batched's "
            f"{same}; K1/K2 vs plain on its inputs: DoG and stacks max abs diff {octave_err:.3g}, "
            f"masks equal on {100 * masks_same:.4f} % of pixels, window samples {stage_shapes} "
            f"max abs diff {sample_err:.3g}, slot agreement {slots_same:.6f}, descriptors max abs "
            f"diff {described_err:.3g}; {dp_ms:.2f} ms a batch (detect_and_describe_batched "
            f"{plain_path_ms:.2f} ms, a reading) [{smi}]"
        )
        if on_card:
            _require(launches == (cfg.num_octaves, 2, 0, cfg.num_octaves, cfg.num_octaves),
                     f"the data-parallel frontend launched K1/K2/K3/R1/R2 {launches} times")
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
        state, obs = make_problem(np.random.default_rng(0), c, l, opc, device=dev)
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
        del state, obs, out, again, scatter

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
        want_slam, want_stream = _slam_launches(recipe, slam_frames, 1)
        _say(
            f"sharding (a): run_slam_from_images(mesh=...) on phase 15's gated sequence "
            f"({slam_frames} x {height}x{width}, {SLAM_MATCH_GATE_PX:g} px gate, "
            f"{SLAM_MAX_TRACKS} tracks), dist_ba_min_landmarks=0: launches K1/K2/K3/R1/R2 "
            f"{slam_launches} (expected {want_slam}), BAs single/sharded "
            f"{slam_bas} (the run without a mesh: {n_ba} BAs), valid landmarks "
            f"{int(sharded.landmark_valid.sum())}, ATE {ate:.4f} (bars: < {SLAM_REF_ATE}, within "
            f"{SLAM_ATE_GAP} of phase 15's {refs['solved_ate']:.4f}; without a mesh here "
            f"{ate_unsharded:.4f}); {1e3 * slam_seconds:.1f} ms, "
            f"{slam_frames / slam_seconds:.2f} frames/s, a reading [{smi}]"
        )
        if on_card:
            _require(slam_launches == want_slam,
                     f"the sharded SLAM path launched K1/K2/K3/R1/R2 {slam_launches} times")
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
        _say(
            f"sharding (a): SlamSession(mesh=...) over the same frames: launches K1/K2/K3/R1/R2 "
            f"{stream_launches} (expected {want_stream}), BAs single/sharded "
            f"{stream_bas}, bit-equal to the sharded batch run {stream_same}"
        )
        if on_card:
            _require(stream_launches == want_stream,
                     f"the sharded session launched K1/K2/K3/R1/R2 {stream_launches} times")
        _require(stream_bas[0] == 0 and stream_bas[1] > 0, "the session's BAs were not sharded")
        _require(stream_same, "the sharded session differs from the sharded batch run")
    finally:
        dist.destroy_process_group()

    # (b) world ``world`` on gloo, every rank on this device. The ranks need
    # the card's memory that this process's allocator still caches from the
    # phases before.
    del want
    share = batch // world
    ref = _share_references(torch, port, dev, images_cpu.numpy(), share, ("fused",))
    del ref["fused"]
    ref.update(ba={"dense": dict(cost=world1_cost, ms=ba_ms, peak=None)},
               orbit_ate=refs["orbit_ate"], orbit_bas=refs["orbit_bas"])
    spec = dict(world=world, device=dev.type,
                cards=[torch.cuda.current_device()] * world if on_card else None, share=share,
                height=height, width=width, blurs=["fused"], repeats=3, keyframes=0,
                ba=[["dense", *ba_sizes]], slam_frames=0, orbit_frames=orbit_frames)
    _write_spec(work, spec)
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.spawn(_shard_rank, args=(work,), nprocs=world)
    _say(f"sharding (b): {world} gloo ranks spawned on {dev}, ran in "
         f"{time.perf_counter() - t0:.1f} s")
    launches, rank_octave_err, rank_sample_err, _ = _shard_bars(
        torch, _read_ranks(work, world), spec, ref, smi, f"sharding (b), world {world}")
    for i, n in enumerate(launches):
        total[i] += n
    shutil.rmtree(work, ignore_errors=True)
    return tuple(total), max(octave_err, rank_octave_err), max(sample_err, rank_sample_err)


def _stage_line(report) -> str:
    return ", ".join(f"{name} {v['ms_per_call'] * v['calls']:.1f} ms/{v['calls']}"
                     for name, v in report["stages"].items())


def _shard_rank(rank, workdir: str) -> None:
    """One rank of phase 17 (b) or phase 20, as ``<workdir>/spec.json``
    says. Spawned by ``torch.multiprocessing.spawn``, which passes
    ``rank``, it joins ``spec["world"]`` gloo ranks over a file store in
    ``workdir``; started by ``torchrun`` (``rank`` is ``None``), it calls
    ``initialize_multihost()``, which reads the environment: NCCL with a
    card a rank, gloo on the CPU. On the card the rank initialises CUDA
    before the mesh (``get_device_name``, as every tool does first): the
    mesh must then move it to its card. The legs: (a) the data-parallel
    frontend with each blur of ``spec["blurs"]`` on ``spec["share"]`` frames
    a rank (launches, the device of the outputs before the gather, digests
    of the gathered fields, memory, times; K1 and K2 against their plain
    versions on this rank's share, K3 through the share's scale space
    against the tap loop); (b) keyframe-sharded matching of frame 0 against
    the next ``spec["keyframes"]`` frames (0: none); (c) the sharded BA on
    each problem of ``spec["ba"]``, twice; (d) with ``spec["slam_frames"]``
    (0: none), composed SLAM on phase 15's gated sequence at the reference's
    ``dist_ba_min_landmarks`` and at 0, its stages, and ``SlamSession`` at
    0; (e) config[3]'s orbit of ``spec["orbit_frames"]`` (0: none) at 0.
    Writes ``rank<r>.json``; :func:`_shard_bars` holds the bars. The kernels
    are loaded from the library the parent built: a rebuild fails the
    rank."""
    import dataclasses
    import datetime
    import os

    import torch
    import torch.distributed as dist

    import sift_scale_space_extrema_detection_tpu_torch as port
    from sift_scale_space_extrema_detection_tpu_torch.models import slam as slam_module
    from sift_scale_space_extrema_detection_tpu_torch.models.frontend import (
        _as_unit_float,
        build_scale_space,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import _build
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.blur import blur_fused
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.describe import window_sample_pair
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import fused_octave
    from sift_scale_space_extrema_detection_tpu_torch.parallel import distributed as distributed_module
    from sift_scale_space_extrema_detection_tpu_torch.parallel import (
        detect_and_describe_data_parallel,
        distributed_bundle_adjust,
        initialize_multihost,
        make_mesh,
        match_against_keyframes_sharded,
        put_global,
    )
    from sift_scale_space_extrema_detection_tpu_torch.parallel.multihost import mesh_device
    from sift_scale_space_extrema_detection_tpu_torch.utils import synthetic
    from sift_scale_space_extrema_detection_tpu_torch.utils.profile import StageProfile

    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    on_card = spec["device"] == "cuda"
    torch.set_num_threads(2)
    rec = {}
    if on_card:
        rec["name"] = torch.cuda.get_device_name()
        built = set(os.listdir(_build.BUILD_DIR))
    rec["cuda_initialized_before_mesh"] = torch.cuda.is_initialized()
    timeout = datetime.timedelta(seconds=SHARD_TIMEOUT_S)
    if rank is None:
        initialize_multihost(timeout=timeout)
    else:
        initialize_multihost(f"file://{os.path.join(workdir, 'store_ranks')}", spec["world"],
                             rank, backend="gloo", timeout=timeout)
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        mesh = make_mesh(world, device_type=spec["device"])
        dev = mesh_device(mesh)
        rec.update(rank=rank, local_rank=os.environ.get("LOCAL_RANK"), backend=dist.get_backend(),
                   device=str(dev), current_device=torch.cuda.current_device() if on_card else None)

        def zero():
            fused_octave.launches = window_sample_pair.launches = blur_fused.launches = 0
            newton_ladder.launches = select_candidates.launches = 0

        def counts():
            return [fused_octave.launches, window_sample_pair.launches, blur_fused.launches,
                    newton_ladder.launches, select_candidates.launches]

        def peak_gib():
            return torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None

        def reset_peak():
            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)

        def timed(fn, reps):
            out = []
            for _ in range(reps):
                _sync(torch, dev)
                t0 = time.perf_counter()
                fn()
                _sync(torch, dev)
                out.append(1e3 * (time.perf_counter() - t0))
            return out

        # (a) the data-parallel frontend.
        cfg = port.SiftConfig(num_octaves=4, scales_per_octave=5, max_keypoints_per_trio=512)
        share = spec["share"]
        images = _make_batch(world * share, spec["height"], spec["width"])
        mine = _as_unit_float(put_global(images, mesh))
        gather, seen, matching = distributed_module.all_gather_rows, [], None

        def watching(x, mesh):
            seen.append(str(x.device))
            return gather(x, mesh)

        for blur in spec["blurs"]:
            def run(blur=blur):
                return detect_and_describe_data_parallel(images, cfg, mesh, blur)

            run()  # warm-up
            _sync(torch, dev)
            before = torch.cuda.memory_allocated(dev) if on_card else 0
            reset_peak()
            zero()
            seen.clear()
            distributed_module.all_gather_rows = watching
            try:
                got = run()
                _sync(torch, dev)
            finally:
                distributed_module.all_gather_rows = gather
            leg = dict(launches=counts(), outputs_on=sorted(set(seen)),
                       peak_gib=peak_gib(),
                       peak_rise_bytes=torch.cuda.max_memory_allocated(dev) - before
                       if on_card else None,
                       digests={name: digest(t)
                                for name, t in _described_fields(got).items()},
                       ms=timed(run, spec["repeats"]))
            local = type(got)(**{k: v[rank * share:(rank + 1) * share]
                                 for k, v in _described_fields(got).items()})
            if blur == "fused":
                leg.update(zip(("octave_err", "masks_same", "sample_err", "stage_shapes",
                                "slots_same", "described_err"),
                               _kernels_vs_plain(torch, mine, cfg, local)))
                if spec["keyframes"]:
                    matching = (got.descriptor[0], got.valid[0],
                                got.descriptor[1:1 + spec["keyframes"]],
                                got.valid[1:1 + spec["keyframes"]])
            else:
                leg["blur_err"] = max(
                    (a - b).abs().max().item()
                    for a, b in zip(build_scale_space(mine, cfg, blur=blur, device=dev),
                                    build_scale_space(mine, cfg, blur="separable", device=dev)))
            rec[f"frontend_{blur}"] = leg
            del got, local
        del mine

        # (b) keyframe-sharded matching.
        if matching is not None:
            def match():
                return match_against_keyframes_sharded(*matching, mesh)

            got = match()
            rec["match"] = dict(digest=digest(*got), matches=int(got[2].sum()),
                                ms=timed(match, spec["repeats"]))
            del matching, got

        # (c) the sharded BA, twice on each problem.
        for name, c, l, opc in spec["ba"]:
            state, obs = make_problem(np.random.default_rng(0), c, l, opc, device=dev)
            reset_peak()
            out, cost = distributed_bundle_adjust(state, obs, mesh, num_iterations=BA_ITERATIONS)
            _sync(torch, dev)
            t0 = time.perf_counter()
            again, cost_again = distributed_bundle_adjust(state, obs, mesh,
                                                          num_iterations=BA_ITERATIONS)
            _sync(torch, dev)
            seconds = time.perf_counter() - t0
            rec[f"ba_{name}"] = dict(
                cost=cost.item(), rms=float(torch.sqrt(2.0 * cost / (c * opc))),
                digest=digest(out.rotations, out.translations, out.points, cost),
                rerun_equal=_same_solve(torch, out, again, cost, cost_again),
                rerun_max_diff=max((getattr(out, f) - getattr(again, f)).abs().max().item()
                                   for f in ("rotations", "translations", "points")),
                ms_per_iteration=1e3 * seconds / BA_ITERATIONS, peak_gib=peak_gib())
            del state, obs, out, again

        # (d) composed SLAM on phase 15's gated sequence.
        if spec["slam_frames"]:
            recipe = slam_bench_recipe(port, spec["slam_frames"], spec["width"], spec["height"])
            frames, gt_r, gt_t, k_mat = (recipe[k] for k in ("images", "gt_r", "gt_t", "k_mat"))
            track = dict(reassoc_window=recipe["reassoc_window"], **recipe["solved"])
            configs = {t: dataclasses.replace(recipe["slam_cfg"], dist_ba_min_landmarks=t)
                       for t in (recipe["slam_cfg"].dist_ba_min_landmarks, 0)}

            def slam(threshold, **kw):
                return port.run_slam_from_images(frames, k_mat, recipe["sift_cfg"],
                                                 configs[threshold], mesh=mesh,
                                                 frontend_chunk=SLAM_CHUNK, device=dev, **track,
                                                 **kw)

            reset_peak()
            for threshold in configs:
                read, restore = _count_bas(slam_module)
                zero()
                try:
                    _sync(torch, dev)
                    t0 = time.perf_counter()
                    result = slam(threshold)
                    _sync(torch, dev)
                    seconds = time.perf_counter() - t0
                finally:
                    bas = read()
                    restore()
                rec[f"slam_{threshold}"] = dict(
                    ate=port.evaluate_ate(result, gt_r, gt_t, device=dev), bas=list(bas),
                    launches=counts(), seconds=seconds,
                    landmarks=int(result.landmark_valid.sum()),
                    digest=digest(result.rotations, result.translations))
            prof = StageProfile()
            slam(0, profile=prof)
            rec["slam_0"]["stages"] = _stage_line(prof.report(total_frames=len(frames)))
            rec["slam_0"]["peak_gib"] = peak_gib()

            read, restore = _count_bas(slam_module)
            zero()
            steps = []
            try:
                sess = port.SlamSession(k_mat, recipe["sift_cfg"], configs[0], mesh=mesh,
                                        device=dev, **track)
                for image in frames:
                    t0 = time.perf_counter()
                    if sess.add_frame(image) is not None:
                        steps.append(1e3 * (time.perf_counter() - t0))
                streamed = sess.finalize()
            finally:
                bas = read()
                restore()
            rec["session"] = dict(
                ate=port.evaluate_ate(streamed, gt_r, gt_t, device=dev), bas=list(bas),
                launches=counts(), step_ms=steps,
                digest=digest(streamed.rotations, streamed.translations))

        # (e) config[3]'s orbit, every BA sharded.
        if spec["orbit_frames"]:
            seq = _orbit_sequence(synthetic, spec["orbit_frames"])
            read, restore = _count_bas(slam_module)
            try:
                _sync(torch, dev)
                t0 = time.perf_counter()
                orbit = port.run_slam(seq.pixels, seq.visible, seq.k_mat,
                                      port.SlamConfig(dist_ba_min_landmarks=0), mesh=mesh,
                                      device=dev)
                _sync(torch, dev)
                seconds = time.perf_counter() - t0
            finally:
                bas = read()
                restore()
            rec["orbit"] = dict(
                ate=port.evaluate_ate(orbit, seq.rotations, seq.translations, device=dev),
                bas=list(bas), seconds=seconds, landmarks=int(orbit.landmark_valid.sum()),
                digest=digest(orbit.rotations, orbit.translations))

        if on_card:
            # Memory this process ever allocated on each card: nothing but
            # on its own.
            rec["peak_gib_by_card"] = [torch.cuda.max_memory_allocated(c) / 2**30
                                       for c in range(torch.cuda.device_count())]
            rec["nccl"] = str(torch.cuda.nccl.version())
            rec["rebuilt"] = sorted(set(os.listdir(_build.BUILD_DIR)) - built)
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def _shard_torchrun_rank(workdir: str) -> None:
    """One rank of phase 20, started by ``torchrun`` (``torchrun_ranks``)."""
    _shard_rank(None, workdir)


def _write_spec(workdir: str, spec: dict) -> None:
    import os

    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(spec, f)


def _read_ranks(workdir, world: int) -> list:
    """The ``rank<r>.json`` records of :func:`_shard_rank`, in rank order."""
    import os

    ranks = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def _share_references(torch, port, dev, images, share: int, blurs) -> dict:
    """The single-device references of :func:`_shard_rank`'s frontend legs:
    ``detect_and_describe_batched`` of each ``share``-frame share of
    ``images`` on ``dev``, for each of ``blurs``. Returns a dict: ``cfg``;
    per blur the SHA-256 of each concatenated field (``digests``), the
    largest rise in device memory of one share's call (``share_rise``) and
    the bytes of one share's result (``share_bytes``); the first share's
    result (``first_share``) and the concatenated fields (``fused``) on the
    fused path."""
    cfg = port.SiftConfig(num_octaves=4, scales_per_octave=5, max_keypoints_per_trio=512)
    on_card = dev.type == "cuda"
    ref = dict(cfg=cfg, digests={}, share_rise={}, share_bytes={})
    for blur in blurs:
        parts, rise, n_bytes = [], 0, 0
        for r in range(len(images) // share):
            frames = torch.from_numpy(images[r * share:(r + 1) * share])
            port.detect_and_describe_batched(frames, cfg, blur, device=dev)  # warm-up
            _sync(torch, dev)
            if on_card:
                before = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            parts.append(port.detect_and_describe_batched(frames, cfg, blur, device=dev))
            _sync(torch, dev)
            if on_card:
                rise = max(rise, torch.cuda.max_memory_allocated(dev) - before)
            n_bytes = max(n_bytes, sum(t.numel() * t.element_size()
                                       for t in _described_fields(parts[-1]).values()))
        fields = {name: torch.cat([_described_fields(p)[name] for p in parts])
                  for name in _described_fields(parts[0])}
        ref["digests"][blur] = {name: digest(t) for name, t in fields.items()}
        ref["share_rise"][blur], ref["share_bytes"][blur] = rise, n_bytes
        if blur == "fused":
            ref["first_share"], ref["fused"] = parts[0], fields
        del parts, fields
    return ref


def _slam_launches(recipe, frames: int, world: int):
    """``((K1, K2, K3, R1, R2) of run_slam_from_images, (K1, K2, K3, R1, R2) of
    SlamSession)`` on ``frames`` frames of ``recipe`` with a mesh of
    ``world`` ranks, on each rank: one K1, one R1 and one R2 per octave and two K2
    per frontend chunk of ``SLAM_CHUNK`` frames a rank; the session
    describes each window it solves, once."""
    octaves = recipe["sift_cfg"].num_octaves
    chunks = -(-frames // (SLAM_CHUNK * world))
    start, win = 2, recipe["slam_cfg"].ba_interval
    calls = sum(1 for t in range(1, frames + 1) if t >= start + win and (t - start) % win == 0)
    calls += (frames - start) % win != 0
    return (octaves * chunks, 2 * chunks, 0, octaves * chunks, octaves * chunks), (
        octaves * calls, 2 * calls, 0, octaves * calls, octaves * calls)


def _shard_bars(torch, ranks, spec, ref, smi, label):
    """Print and hold the bars of :func:`_shard_rank`'s records ``ranks``
    (rank order) run by ``spec``, against the single-device references
    ``ref``: :func:`_share_references`'s dict, and for the legs that ran
    ``match_digest`` and ``match_ms``, ``ba`` (each problem's world-1
    ``cost``, ``ms`` and ``peak`` bytes or ``None``), ``slam_ate``,
    ``slam_launches`` (:func:`_slam_launches`), ``orbit_ate`` and
    ``orbit_bas`` (BAs without a mesh). Each line starts with ``label``.
    The sharded BA's reruns are held bit-equal on gloo and read on NCCL.
    Returns ``(launches, octave_err, sample_err, blur_err)``: the (K1, K2,
    K3, R1, R2) launches of every rank's main paths ((a), (d) and the session; (b),
    (c) and (e) launch none) and the kernels' largest differences from their
    plain versions there."""
    import os

    world, on_card, cfg = len(ranks), spec["device"] == "cuda", ref["cfg"]
    nccl = "nccl" in ranks[0]["backend"]

    def by_rank(fn):
        return [fn(r) for r in ranks]

    def spread(ms):
        return f"{np.median(ms):.2f} ms (min {min(ms):.2f}, max {max(ms):.2f})"

    def gib(n_gib):
        return f"{n_gib:.3f} GiB" if n_gib is not None else "not measured"

    def add(launches):
        for i, n in enumerate(launches):
            total[i] += n

    total, octave_err, sample_err, blur_err = [0, 0, 0, 0, 0], 0.0, 0.0, 0.0
    _say(
        f"{label}: {world} ranks, backend {ranks[0]['backend']}"
        f"{', NCCL ' + ranks[0]['nccl'] if on_card and nccl else ''}; by rank: LOCAL_RANK "
        f"{by_rank(lambda r: r['local_rank'])}, current device after make_mesh "
        f"{by_rank(lambda r: r['current_device'])} (CUDA initialised before the mesh "
        f"{by_rank(lambda r: r['cuda_initialized_before_mesh'])}), mesh device "
        f"{by_rank(lambda r: r['device'])} [{smi}]"
    )
    if on_card:
        _require(all(by_rank(lambda r: r["cuda_initialized_before_mesh"])),
                 "a rank had not initialised CUDA before the mesh: the card rule went untested")
        _require(by_rank(lambda r: r["current_device"]) == spec["cards"],
                 f"the ranks do not sit on cards {spec['cards']} in rank order")
        _require(all(not r["rebuilt"] for r in ranks), "a rank rebuilt the kernels")
        others = by_rank(lambda r: [g for c, g in enumerate(r["peak_gib_by_card"])
                                    if c != r["current_device"]])
        _require(all(g == 0 for o in others for g in o),
                 f"a rank allocated memory on another rank's card: {others}")

    expected = {"fused": [cfg.num_octaves, 2, 0, cfg.num_octaves, cfg.num_octaves],
                "cuda": [0, 2, _blur_count(cfg), cfg.num_octaves, 0]}
    for blur in spec["blurs"]:
        legs = by_rank(lambda r: r[f"frontend_{blur}"])
        want = ref["digests"][blur]
        same = all(leg["digests"] == want for leg in legs)
        differ = sorted({k for leg in legs for k, v in leg["digests"].items() if v != want[k]})
        ms = legs[0]["ms"]
        errs = ([max(leg["octave_err"], leg["sample_err"], leg["described_err"]) for leg in legs]
                if blur == "fused" else [leg["blur_err"] for leg in legs])
        _say(
            f"{label}, frontend, blur={blur!r}: detect_and_describe_data_parallel on "
            f"{world * spec['share']}x{spec['height']}x{spec['width']}, {spec['share']} a rank: "
            f"launches K1/K2/K3/R1/R2 by rank {[leg['launches'] for leg in legs]} (expected "
            f"{expected[blur]} each), outputs before the gather on "
            f"{[leg['outputs_on'] for leg in legs]}, every field of the gathered result "
            f"bit-equal to the single device's shares {same}"
            + (f" (differing: {differ})" if differ else "")
            + f"; {'K1/K2' if blur == 'fused' else 'K3'} vs plain on each rank's share, max abs "
            f"diff by rank {errs}"
            + (f", masks {min(leg['masks_same'] for leg in legs):.6f}, slots "
               f"{min(leg['slots_same'] for leg in legs):.6f}" if blur == "fused" else "")
            + f"; rank 0 {spread(ms)} a {world * spec['share']}-frame step over {len(ms)} "
            f"repeats, {world * spec['share'] / (np.median(ms) / 1e3):.1f} frames/s, slowest "
            f"rank's median {max(np.median(leg['ms']) for leg in legs):.2f} ms; peak device "
            f"memory by rank {[gib(leg['peak_gib']) for leg in legs]} [{smi}]"
        )
        _require(same, f"{label}: the frontend ({blur}) differs from the single device's")
        _require(max(errs) == 0.0, f"{label}: a kernel differs from its plain version ({blur})")
        if blur == "fused":
            _require(all(leg["masks_same"] == 1.0 and leg["slots_same"] == 1.0 for leg in legs),
                     f"{label}: masks or slots differ from the plain path's on a rank")
            octave_err = max(octave_err, *(leg["octave_err"] for leg in legs))
            sample_err = max(sample_err, *(leg["sample_err"] for leg in legs))
        else:
            blur_err = max(blur_err, *errs)
        if on_card:
            _require(all(leg["launches"] == expected[blur] for leg in legs),
                     f"{label}: a rank launched other counts than {expected[blur]} ({blur})")
            _require([leg["outputs_on"] for leg in legs] == [[f"cuda:{c}"] for c in spec["cards"]],
                     f"{label}: a rank's outputs before the gather are not on its card")
            # Rank 0 computed one share: its rise in memory is one share's,
            # plus the gathered result (every rank's parts and their
            # concatenation).
            rise = legs[0]["peak_rise_bytes"]
            limit = ref["share_rise"][blur] + 2 * world * ref["share_bytes"][blur]
            _require(rise <= limit, f"{label}: rank 0 rose by {rise} bytes on its card, one "
                     f"share by {ref['share_rise'][blur]}")
        for leg in legs:
            add(leg["launches"])

    if spec["keyframes"]:
        m = by_rank(lambda r: r["match"])
        _say(
            f"{label}, matching: match_against_keyframes_sharded, frame 0's slots against "
            f"{spec['keyframes']} keyframes, {-(-spec['keyframes'] // world)} a rank: "
            f"{m[0]['matches']} matches, index, distance and valid bit-equal to the world-1 "
            f"vmap(match_descriptors) by rank {[x['digest'] == ref['match_digest'] for x in m]}; "
            f"rank 0 {spread(m[0]['ms'])} (world 1: {ref['match_ms']:.2f} ms) [{smi}]"
        )
        _require(all(x["digest"] == ref["match_digest"] for x in m),
                 f"{label}: sharded matching differs from the world-1 vmap")

    for name, c, l, opc in spec["ba"]:
        b, want = by_rank(lambda r: r[f"ba_{name}"]), ref["ba"][name]
        rel = abs(b[0]["cost"] - want["cost"]) / want["cost"]
        same = all(x["digest"] == b[0]["digest"] for x in b)
        reruns = [x["rerun_equal"] for x in b]
        _say(
            f"{label}, BA: distributed_bundle_adjust, {c} cameras x {l} landmarks x {c * opc} "
            f"observations, {BA_ITERATIONS} LM iterations: cost {b[0]['cost']:.3f} against world "
            f"1's {want['cost']:.3f} ({rel:.3g} relative, bar {BA_SCATTER_RTOL}), rms "
            f"{b[0]['rms']:.3f} px, every rank bit-equal to rank 0 {same}, second run bit-equal "
            f"by rank {reruns}"
            + ("" if all(reruns) else
               f" (max abs diff {max(x['rerun_max_diff'] for x in b):.3g}; NCCL "
               f"{b[0].get('nccl')}, NCCL_ALGO {os.environ.get('NCCL_ALGO', 'unset: NCCL chose')})")
            + f"; ms per LM iteration by rank {[round(x['ms_per_iteration'], 2) for x in b]} "
            f"(world 1: {want['ms']:.2f}); peak device memory by rank "
            f"{[gib(x['peak_gib']) for x in b]} (world 1: "
            f"{gib(None if want['peak'] is None else want['peak'] / 2**30)}) [{smi}]"
        )
        _require(rel <= BA_SCATTER_RTOL, f"{label}: the BA ({name}) ends at another cost")
        _require(b[0]["rms"] <= BA_MAX_RMS_PX, f"{label}: the BA ({name}): rms above 1 px")
        _require(same, f"{label}: the ranks' BA results differ ({name})")
        if not nccl:
            _require(all(reruns), f"{label}: a rerun of the BA ({name}) differs")

    if spec["slam_frames"]:
        runs, session = ref["slam_launches"]
        for key in [k for k in ranks[0] if k.startswith("slam_")]:
            s = by_rank(lambda r: r[key])
            same = all(x["digest"] == s[0]["digest"] for x in s)
            _say(
                f"{label}, SLAM: run_slam_from_images(mesh=...) on phase 15's gated sequence "
                f"({spec['slam_frames']} x {spec['height']}x{spec['width']}), "
                f"dist_ba_min_landmarks={key[5:]}: BAs single/sharded {s[0]['bas']}, launches "
                f"K1/K2/K3/R1/R2 by rank {[x['launches'] for x in s]} (expected {list(runs)} "
                f"each), "
                f"valid landmarks {s[0]['landmarks']}, ATE {s[0]['ate']:.4f} (bar: within "
                f"{SLAM_ATE_GAP} of the single device's {ref['slam_ate']:.4f}), trajectories "
                f"bit-equal across ranks {same}; {1e3 * s[0]['seconds']:.1f} ms, "
                f"{spec['slam_frames'] / s[0]['seconds']:.2f} frames/s"
                + (f"; stages (profiled run) {s[0]['stages']}; peak device memory by rank "
                   f"{[gib(x['peak_gib']) for x in s]}" if key == "slam_0" else "")
                + f" [{smi}]"
            )
            _require(abs(s[0]["ate"] - ref["slam_ate"]) < SLAM_ATE_GAP,
                     f"{label}: SLAM ({key}): ATE far from the single device's")
            _require(same, f"{label}: SLAM ({key}): the ranks' trajectories differ")
            if on_card:
                _require(all(x["launches"] == list(runs) for x in s),
                         f"{label}: SLAM ({key}): a rank launched other counts than {runs}")
            for x in s:
                add(x["launches"])
        _require(ranks[0]["slam_0"]["bas"][0] == 0 and ranks[0]["slam_0"]["bas"][1] > 0,
                 f"{label}: at threshold 0 not every BA was sharded")
        sess = by_rank(lambda r: r["session"])
        steps = sess[0]["step_ms"]
        _say(
            f"{label}, session: SlamSession(mesh=...) at threshold 0 over the same frames: BAs "
            f"single/sharded {sess[0]['bas']}, launches K1/K2/K3/R1/R2 by rank "
            f"{[x['launches'] for x in sess]} (expected {list(session)} each), ATE "
            f"{sess[0]['ate']:.4f} (bar: within {SLAM_ATE_GAP} of the batch run's "
            f"{ranks[0]['slam_0']['ate']:.4f}), bit-equal to the batch run "
            f"{sess[0]['digest'] == ranks[0]['slam_0']['digest']}, ranks bit-equal "
            f"{all(x['digest'] == sess[0]['digest'] for x in sess)}; window step median "
            f"{np.median(steps):.1f} ms, max {max(steps):.1f} ms over {len(steps)} steps [{smi}]"
        )
        _require(all(x["digest"] == sess[0]["digest"] for x in sess),
                 f"{label}: the ranks' sessions differ")
        _require(abs(sess[0]["ate"] - ranks[0]["slam_0"]["ate"]) < SLAM_ATE_GAP,
                 f"{label}: the session's ATE is far from the batch run's")
        if on_card:
            _require(all(x["launches"] == list(session) for x in sess),
                     f"{label}: a rank's session launched other counts than {session}")
        for x in sess:
            add(x["launches"])

    if spec["orbit_frames"]:
        o = by_rank(lambda r: r["orbit"])
        _say(
            f"{label}, orbit: config[3]'s orbit ({spec['orbit_frames']} frames) through "
            f"run_slam(mesh=...), dist_ba_min_landmarks=0: BAs single/sharded {o[0]['bas']} "
            f"(without a mesh: {ref['orbit_bas']}), valid landmarks {o[0]['landmarks']} (bar > "
            f"{ORBIT_MIN_LANDMARKS}), ATE {o[0]['ate']:.4f} (bars: < {ORBIT_ATE}, within "
            f"{SLAM_ATE_GAP} of the single device's {ref['orbit_ate']:.4f}), trajectories "
            f"bit-equal across ranks {all(x['digest'] == o[0]['digest'] for x in o)}; seconds by "
            f"rank {[round(x['seconds'], 3) for x in o]} [{smi}]"
        )
        _require(o[0]["landmarks"] > ORBIT_MIN_LANDMARKS, f"{label}: config[3]: too few landmarks")
        _require(o[0]["ate"] < ORBIT_ATE and abs(o[0]["ate"] - ref["orbit_ate"]) < SLAM_ATE_GAP,
                 f"{label}: config[3]: ATE off its bars")
        _require(all(x["bas"] == [0, ref["orbit_bas"]] for x in o),
                 f"{label}: config[3]: not every BA was sharded")
        _require(all(x["digest"] == o[0]["digest"] for x in o),
                 f"{label}: config[3]: the ranks differ")
    return tuple(total), octave_err, sample_err, blur_err


def _phase_multicard(torch, port, smi, dev, world=None, batch=BATCH, size=(WIDTH, HEIGHT),
                     ba_sizes=(SHARD_BA, BA_LARGE), slam_frames=SLAM_FRAMES,
                     orbit_frames=ORBIT_FRAMES, keyframes=MULTICARD_KEYFRAMES,
                     repeats=MULTICARD_REPEATS, timeout=MULTICARD_TIMEOUT_S):
    """Phase 20: the sharded paths across cards, one rank a card. ``world``
    (default: min(4, cards)) ranks of :func:`_shard_rank`, started by
    ``python -m torch.distributed.run --standalone``: NCCL, rank r on
    ``cuda:r`` (on the CPU, for a rehearsal: gloo). The single-card
    references run in this process on ``dev`` first, from the same inputs:
    (a) ``detect_and_describe_batched`` of each ``batch``-frame share with
    ``blur="fused"`` and ``"cuda"``, (b) ``vmap(match_descriptors)`` over the
    keyframes, (c) ``distributed_bundle_adjust`` at world 1 on each problem
    of ``ba_sizes``, (d) ``run_slam_from_images`` on phase 15's gated
    sequence, (e) config[3]'s orbit. Then the ranks and their bars
    (:func:`_shard_bars`); then (f) the dry run
    ``tools/torch_dryrun_multichip.py --world <world>``; then, on the card,
    (g) ``detect_and_describe_batched(device="cuda:<last card>")`` in this
    process. Returns ``(launches, octave_err, sample_err, blur_err)``: the
    (K1, K2, K3, R1, R2) launches of the ranks' main paths ((a), (d) and the
    session, summed over the ranks) and of (g), and the kernels' largest
    differences from their plain versions there."""
    import datetime
    import os
    import shutil

    import torch.distributed as dist

    from sift_scale_space_extrema_detection_tpu_torch.models import slam as slam_module
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.blur import blur_fused
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.describe import window_sample_pair
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import fused_octave
    from sift_scale_space_extrema_detection_tpu_torch.parallel import (
        distributed_bundle_adjust,
        initialize_multihost,
        make_mesh,
    )
    from sift_scale_space_extrema_detection_tpu_torch.utils import synthetic

    on_card = dev.type == "cuda"
    cards = torch.cuda.device_count() if on_card else 0
    world = min(MULTICARD_WORLD, cards) if world is None else world
    if on_card:
        _require(2 <= world <= cards, f"phase 20 at world {world} needs as many cards, has {cards}")
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "chip_smoke_multicard")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    width, height = size
    keyframes = min(keyframes, world * batch - 1)

    def gib(n_bytes):
        return f"{n_bytes / 2**30:.3f} GiB" if n_bytes is not None else "not measured"

    # --- the single-card references, in this process on ``dev`` ---
    images = _make_batch(world * batch, height, width)
    ref = _share_references(torch, port, dev, images, batch, ("fused", "cuda"))
    fused = ref.pop("fused")
    q, qv = fused["descriptor"][0], fused["valid"][0]

    def one(d_b, v_b):
        m = port.match_descriptors(q, qv, d_b, v_b, device=dev)
        return m.index, m.distance, m.valid

    kd, kv = fused["descriptor"][1:1 + keyframes], fused["valid"][1:1 + keyframes]
    ref["match_digest"] = digest(*torch.func.vmap(one)(kd, kv))
    ref["match_ms"] = _host_ms(torch, lambda: torch.func.vmap(one)(kd, kv), repeats, dev)
    n_slots = q.shape[0]
    del fused, q, qv, kd, kv

    ref["ba"] = {}
    initialize_multihost(f"file://{os.path.join(work, 'store1')}", 1, 0,
                         backend="nccl" if on_card else "gloo",
                         timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        mesh = make_mesh(1, device_type=dev.type)
        for name, (c, l, opc) in zip(("dense", "large"), ba_sizes):
            state, obs = make_problem(np.random.default_rng(0), c, l, opc, device=dev)
            if name == "dense":
                distributed_bundle_adjust(state, obs, mesh, num_iterations=BA_ITERATIONS)
            _sync(torch, dev)
            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            _, cost = distributed_bundle_adjust(state, obs, mesh, num_iterations=BA_ITERATIONS)
            _sync(torch, dev)
            ref["ba"][name] = dict(
                cost=cost.item(), ms=1e3 * (time.perf_counter() - t0) / BA_ITERATIONS,
                peak=torch.cuda.max_memory_allocated(dev) if on_card else None)
            del state, obs
    finally:
        dist.destroy_process_group()

    recipe = slam_bench_recipe(port, slam_frames, width, height)
    track = dict(reassoc_window=recipe["reassoc_window"], **recipe["solved"])
    single = port.run_slam_from_images(recipe["images"], recipe["k_mat"], recipe["sift_cfg"],
                                       recipe["slam_cfg"], frontend_chunk=SLAM_CHUNK, device=dev,
                                       **track)
    ref["slam_ate"] = port.evaluate_ate(single, recipe["gt_r"], recipe["gt_t"], device=dev)
    ref["slam_launches"] = _slam_launches(recipe, slam_frames, world)
    seq = _orbit_sequence(synthetic, orbit_frames)
    read, restore = _count_bas(slam_module)
    try:
        orbit = port.run_slam(seq.pixels, seq.visible, seq.k_mat, port.SlamConfig(), device=dev)
    finally:
        ref["orbit_bas"] = read()[0]
        restore()
    ref["orbit_ate"] = port.evaluate_ate(orbit, seq.rotations, seq.translations, device=dev)
    del recipe, single, orbit
    _say(
        f"multicard: single-card references on {dev}: {world} shares of {batch}x{height}x{width} "
        f"through detect_and_describe_batched (one share's rise in device memory: fused "
        f"{gib(ref['share_rise']['fused'] if on_card else None)}, cuda "
        f"{gib(ref['share_rise']['cuda'] if on_card else None)}), vmap(match_descriptors) over "
        f"{keyframes} keyframes x {n_slots} slots {ref['match_ms']:.2f} ms, "
        f"distributed_bundle_adjust at world 1: "
        + ", ".join(f"{n} cost {v['cost']:.1f} {v['ms']:.2f} ms per LM iteration, peak "
                    f"{gib(v['peak'])}" for n, v in ref["ba"].items())
        + f"; gated SLAM ATE {ref['slam_ate']:.4f}, config[3] ATE {ref['orbit_ate']:.4f} with "
        f"{ref['orbit_bas']} BAs [{smi}]"
    )

    # --- the ranks ---
    spec = dict(device=dev.type,
                cards=list(range(world)) if on_card else None, share=batch, height=height,
                width=width, blurs=["fused", "cuda"], repeats=repeats, keyframes=keyframes,
                ba=[[n, *s] for n, s in zip(("dense", "large"), ba_sizes)],
                slam_frames=slam_frames, orbit_frames=orbit_frames)
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks, _ = torchrun_ranks("chip_smoke:_shard_torchrun_rank", spec, world, timeout)
    _say(f"multicard: {world} ranks by torchrun ran in {time.perf_counter() - t0:.1f} s")
    total, octave_err, sample_err, blur_err = _shard_bars(torch, ranks, spec, ref, smi,
                                                          "multicard")
    total = list(total)

    # (f) the JAX package's dry run, ported.
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "torch_dryrun_multichip.py"),
         "--world", str(world), "--device", dev.type],
        cwd=root, capture_output=True, text=True, timeout=timeout,
    )
    line = next((x for x in proc.stdout.splitlines() if x.startswith("dryrun_multichip:")), "")
    _say(f"multicard (f): tools/torch_dryrun_multichip.py --world {world} --device {dev.type}: "
         f"exit {proc.returncode}; {line}")
    if proc.returncode != 0:
        print(proc.stdout[-4000:] + proc.stderr[-4000:], flush=True)
    _require(proc.returncode == 0 and "every rank's trajectory bit-equal True" in line,
             "the dry run failed")

    # (g) one process on a card other than 0.
    if on_card:
        cfg, first_share = ref["cfg"], ref.pop("first_share")
        other = torch.device("cuda", cards - 1)
        frames = torch.from_numpy(images[:batch])
        torch.cuda.synchronize(0)
        held = torch.cuda.memory_allocated(0)
        torch.cuda.reset_peak_memory_stats(0)
        torch.cuda.reset_peak_memory_stats(other)
        fused_octave.launches = window_sample_pair.launches = blur_fused.launches = 0
        newton_ladder.launches = select_candidates.launches = 0
        got = port.detect_and_describe_batched(frames, cfg, device=f"cuda:{other.index}")
        torch.cuda.synchronize(other)
        launches = (fused_octave.launches, window_sample_pair.launches, blur_fused.launches,
                    newton_ladder.launches, select_candidates.launches)
        total = [a + b for a, b in zip(total, launches)]
        fields = _described_fields(got)
        on_other = all(t.device == other for t in fields.values())
        same = all(torch.equal(t.cpu(), getattr(first_share, name).cpu())
                   for name, t in fields.items())
        card0_peak = torch.cuda.max_memory_allocated(0)
        _say(
            f"multicard (g): detect_and_describe_batched(device='{other}') on {batch}x{height}x"
            f"{width} in this process after the runs on cuda:0: launches K1/K2/K3/R1/R2 "
            f"{launches}, "
            f"outputs on {other} {on_other}, bit-equal to cuda:0's {same}; card 0 allocated "
            f"{held} bytes before and at most {card0_peak} during the call, card "
            f"{other.index} peaked at {gib(torch.cuda.max_memory_allocated(other))}; current "
            f"device {torch.cuda.current_device()} [{smi}]"
        )
        _require(launches == (cfg.num_octaves, 2, 0, cfg.num_octaves, cfg.num_octaves),
                 f"cuda:{other.index}: launches {launches}")
        _require(on_other and same, f"the run on {other} differs from cuda:0's")
        _require(card0_peak == held, f"the run on {other} allocated on card 0")
        _require(torch.cuda.max_memory_allocated(other) > 0, f"nothing ran on {other}")
        del got, fields, first_share
    else:
        _say("multicard (g): a card other than 0 needs the card; not run on the CPU")
    shutil.rmtree(work, ignore_errors=True)
    return tuple(total), octave_err, sample_err, blur_err


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
    """Phase 16's on-disk rehearsal sequence: ``frames`` frames of the port's
    ``benchmarks.slam_bench.render_sequence`` (the bench's dolly, seed 0) at
    ``size`` (width, height), written under ``work`` by the port's writers
    in the TUM (``fmt="tum"``) or KITTI (``"kitti"``, sequence 00) layout.
    Returns ``(argv, pixels, paths)``: ``evaluate``'s positional arguments,
    the 8-bit pixels written and the frames' files."""
    import os

    from sift_scale_space_extrema_detection_tpu_torch.data import (
        write_kitti_sequence,
        write_tum_sequence,
    )

    images, rots, ts, k_mat = render_sequence(np.random.default_rng(0), frames, *size)
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
                    kitti_size=KITTI_SIZE, solved_frames=SURFACE_SOLVED_FRAMES,
                    long_frames=SURFACE_LONG_FRAMES):
    """Phase 16: the user surfaces, ``cli.main`` and ``evaluate.main``,
    in-process on ``dev``. Returns ``(launches, octave_err)``: the (K1, K2,
    K3, R1) launches of the paths driven here, and the octave kernel's largest
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
    total = [0, 0, 0, 0, 0]

    def zero():
        fused_octave.launches = window_sample_pair.launches = blur_fused.launches = 0
        fused_octave.clamped_launches = newton_ladder.launches = select_candidates.launches = 0

    def counts():
        got = (fused_octave.launches, window_sample_pair.launches, blur_fused.launches,
               newton_ladder.launches, select_candidates.launches)
        for i, n in enumerate(got):
            total[i] += n
        return got

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_surfaces")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = port.SiftConfig()  # the CLI's: 5 octaves x 3 scales, capacity 1024
    n_blurs = _blur_count(cfg)

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
            f"cli {name} {' '.join(flags)}: launches K1/K2/K3/R1/R2 {launches} (expected "
            f"{expected}), "
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
    octaves = cfg.num_octaves  # each refined on its own, by R1, and selected by R2
    clamped, _ = cli_pair(path, "fused", desc, (octaves, 2 * octaves, 0, octaves, octaves))
    if on_card:
        _require(clamped == 1, "cli: the deepest octave did not take the clamped mode")
    _, cuda_records = cli_pair(path, "cuda", desc + ["--blur", "cuda"],
                               (0, 2 * octaves, n_blurs, octaves, 0))
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
        f"cli --blur matmul: exit code {rc}, launches K1/K2/K3/R1/R2 {matmul_launches}, against "
        f"the "
        f"--blur cuda run: slot agreement {matched:.6f}, p99 {p99:.3g} px (readings); its scale space "
        f"against the tap loop's on the card: max abs diff {matmul_err:.3g} (bar {MATMUL_ATOL}); "
        f"with TF32 on: refused {refused}"
    )
    _require(rc == 0 and matmul_launches == (0, 0, 0, octaves if on_card else 0, 0),
             "cli --blur matmul launched a kernel of the fused or blur paths, or refined plainly")
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
        cli_pair(path, name, desc, (octaves, 2 * octaves, 0, octaves, octaves))
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
        eval_octaves = args[1].num_octaves
        expected = (eval_octaves * chunks, 2 * chunks, 0, eval_octaves * chunks,
                    eval_octaves * chunks)
        _say(
            f"evaluate {fmt}: {loaded.strip()}; natively decoded {native} "
            f"of {frames} frames, equal to the written pixels / 255 {decoded_ok}; frames handed to "
            f"SLAM {tuple(images.shape)} equal to the decoded and padded frames {same_frames}; "
            f"trajectory bit-equal to run_slam_from_images in this process {same_bits}; "
            f"{rows} rows read back; launches K1/K2/K3/R1/R2 {launches} (expected {expected})"
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
    expected = (4 * chunks, 2 * chunks, 0, 4 * chunks, 4 * chunks)  # evaluate's 4 octaves
    _say(
        f"evaluate tum {' '.join(solved)}: launches K1/K2/K3/R1/R2 {launches} (expected "
        f"{expected}); "
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

    # (c) continued: the gated TUM cut past the frames SLAM solves, with the
    # per-trio frontend and room for 65,536 tracks, on the card only. Both
    # packages lose the dolly there (tools/torch_dolly_parity.py), so it is
    # read, not held to a solve; the CPU's and the JAX package's readings come
    # from that tool.
    flags = ["--max-frames", str(long_frames), "--blur", "separable", "--match-gate",
             f"{SLAM_MATCH_GATE_PX:g}", "--reassoc", "2", "--max-tracks", str(SURFACE_LONG_TRACKS)]
    traj = os.path.join(work, "tum_long_traj.txt")
    zero()
    t0 = time.perf_counter()
    rc, text = _quiet(evaluate.main, seqs["tum"][0] + flags + ["--out-traj", traj, *card])
    seconds = time.perf_counter() - t0
    launches = counts()
    _require(rc == 0, f"evaluate {' '.join(flags)}: exit code {rc}")
    metrics = json.loads(text.strip().splitlines()[-1])
    _, rots, trans = read_tum_trajectory(traj)
    long_chunks = -(-long_frames // SLAM_CHUNK)
    expected = (0, 2 * long_chunks, 0, 4 * long_chunks, 0)  # K2 twice, R1 4 times a chunk
    _say(
        f"evaluate tum {' '.join(flags)}: launches K1/K2/K3/R1/R2 {launches} (expected "
        f"{expected}); "
        f"{metrics['landmarks']} landmarks, ATE {metrics['ate_rmse']}, RPE "
        f"{metrics['rpe_trans_rmse']}, RRE {metrics['rpe_rot_rmse_deg']} deg (readings), SLAM "
        f"{metrics['slam_frames_per_s']} frames/s, {seconds:.2f} s for the whole command [{smi}]"
    )
    _require(metrics["frames"] == long_frames and len(rots) == long_frames,
             f"evaluate, {long_frames}-frame cut: {metrics['frames']} frames, {len(rots)} rows")
    _require(np.isfinite(rots).all() and np.isfinite(trans).all(),
             f"evaluate, {long_frames}-frame cut: the trajectory is not finite")
    if on_card:
        _require(launches == expected, f"evaluate, {long_frames}-frame cut: launches {launches}")
    shutil.rmtree(work, ignore_errors=True)
    return tuple(total), octave_err


def _phase_blur_paths(torch, port, smi, dev, batch=BATCH, size=(WIDTH, HEIGHT),
                      cpu_frames=PER_TRIO_CPU_FRAMES, slam_frames=SLAM_FRAMES,
                      surface_frames=SURFACE_FRAMES, solved_frames=SURFACE_SOLVED_FRAMES):
    """Phase 18: the blur-by-blur frontend (``blur="cuda"``: K3 once per
    blurred scale, each trio capped on its own) on the detect, describe,
    SLAM, streaming, sharded and ``evaluate`` paths, and the pooled
    refinement flags on the fused path, on ``dev``. Each part's K1/K2/K3/R1/R2
    launches are counted from zero. ``blur="cuda"`` is held equal to
    ``blur="separable"`` on the same device (K3 is bit-equal to its plain
    version), and the card against ``device="cpu"`` on the batch's first
    ``cpu_frames`` frames (an image is detected on its own). Returns
    ``(launches, sample_err)``: the (K1, K2, K3, R1, R2) launches of the paths
    driven here and K2's largest difference from its plain version on this path's
    slots."""
    import dataclasses
    import datetime
    import os
    import shutil

    import torch.distributed as dist

    from sift_scale_space_extrema_detection_tpu_torch import evaluate
    from sift_scale_space_extrema_detection_tpu_torch.data import read_tum_trajectory
    from sift_scale_space_extrema_detection_tpu_torch.models import frontend
    from sift_scale_space_extrema_detection_tpu_torch.ops.descriptor import describe_compact
    from sift_scale_space_extrema_detection_tpu_torch.ops.extrema import (
        compact_extrema,
        find_extrema,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.blur import blur_fused
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.describe import (
        window_sample_pair,
        window_sample_pair_reference,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import fused_octave
    from sift_scale_space_extrema_detection_tpu_torch.ops.refine import refine_keypoints
    from sift_scale_space_extrema_detection_tpu_torch.parallel import (
        detect_and_describe_data_parallel,
        initialize_multihost,
        make_mesh,
    )

    on_card = dev.type == "cuda"
    total = [0, 0, 0, 0, 0]

    def zero():
        fused_octave.launches = window_sample_pair.launches = blur_fused.launches = 0
        newton_ladder.launches = select_candidates.launches = 0

    def counts():
        got = (fused_octave.launches, window_sample_pair.launches, blur_fused.launches,
               newton_ladder.launches, select_candidates.launches)
        for i, n in enumerate(got):
            total[i] += n
        return got

    def reset_peak():
        _sync(torch, dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")

    def fields_equal(a, b):
        return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))

    def head(result):
        """The first ``cpu_frames`` rows of a batched result, on the CPU."""
        return type(result)(**{k: v[:cpu_frames].cpu() for k, v in vars(result).items()})

    def against_cpu(got, want):
        """Slot agreement and p99 position delta of ``got``'s first rows
        against the CPU's ``want``; also the slots valid in both."""
        got = head(got)
        both = got.valid & want.valid
        delta = torch.hypot(got.abs_x[both] - want.abs_x[both], got.abs_y[both] - want.abs_y[both])
        p99 = torch.quantile(delta.double(), 0.99).item() if delta.numel() else float("nan")
        return _slot_agreement(got, want), p99, got, both

    width, height = size
    cfg = port.SiftConfig(num_octaves=4, scales_per_octave=5, max_keypoints_per_trio=512)
    n_blurs, octaves = _blur_count(cfg), cfg.num_octaves
    images_cpu = torch.from_numpy(_make_batch(batch, height, width))
    images = images_cpu.to(dev)
    first = images_cpu[:cpu_frames]
    shape = f"{batch}x{height}x{width}"

    # (a) the per-trio detect path.
    port.detect_batched(images[:4], cfg, "cuda", device=dev)  # warm-up
    reset_peak()
    zero()
    keypoints, extrema = port.detect_batched(images, cfg, "cuda", device=dev)
    _sync(torch, dev)
    launches = counts()
    detect_peak = peak_gib()
    separable, sep_extrema = port.detect_batched(images, cfg, "separable", device=dev)
    same = fields_equal(keypoints, separable) and all(
        fields_equal(a, b) for a, b in zip(extrema, sep_extrema)
    )
    fused, _ = port.detect_batched(images, cfg, device=dev)
    cpu_keypoints, _ = port.detect_batched(first, cfg, "separable", device="cpu")
    agreement, p99, _, _ = against_cpu(keypoints, cpu_keypoints)
    detect_ms = _host_ms(torch, lambda: port.detect_batched(images, cfg, "cuda", device=dev), 3,
                         dev)
    fused_ms = _host_ms(torch, lambda: port.detect_batched(images, cfg, device=dev), 3, dev)
    del separable, sep_extrema
    # Synchronised stages: scale space, DoG, scan + compaction per octave, refinement.
    stage = {"scale space": 0.0, "DoG": 0.0, "refinement": 0.0}
    scan = [0.0] * cfg.num_octaves
    iters = 3
    for _ in range(iters):
        _sync(torch, dev)
        t0 = time.perf_counter()
        stacks = frontend.build_scale_space(images, cfg, "cuda", device=dev)
        _sync(torch, dev)
        t1 = time.perf_counter()
        dogs = frontend.build_dog(stacks)
        _sync(torch, dev)
        t2 = time.perf_counter()
        stage["scale space"] += t1 - t0
        stage["DoG"] += t2 - t1
        del stacks
        selected = []
        for octave, d in enumerate(dogs):
            t0 = time.perf_counter()
            e = find_extrema(d, cfg, cfg.keypoints_per_trio(octave))
            selected.append(compact_extrema(e, cfg.refine_capacity(octave)))
            _sync(torch, dev)
            scan[octave] += time.perf_counter() - t0
        t0 = time.perf_counter()
        for octave, (d, sel) in enumerate(zip(dogs, selected)):
            refine_keypoints(d, sel, octave, cfg)
        _sync(torch, dev)
        stage["refinement"] += time.perf_counter() - t0
        del dogs, selected
    stages = ", ".join(
        [f"{k} {1e3 * v / iters:.2f} ms" for k, v in list(stage.items())[:2]]
        + [f"scan + compaction octave {o} {1e3 * v / iters:.2f} ms" for o, v in enumerate(scan)]
        + [f"refinement {1e3 * stage['refinement'] / iters:.2f} ms"]
    )
    counters = [e.num_candidates.sum().item() for e in extrema]
    _say(
        f"per-trio detect (a): detect_batched(blur='cuda') {shape}, {cfg.num_octaves} octaves x "
        f"{cfg.scales_per_octave} scales, {cfg.max_keypoints_per_trio} slots a trio at octave 0: "
        f"launches K1/K2/K3/R1/R2 {launches} (expected {(0, 0, n_blurs, octaves, 0)}); every field "
        f"and every "
        f"octave's per-trio Extrema equal to blur='separable' on the same device {same}; valid "
        f"keypoints {int(keypoints.valid.sum())} (fused path {int(fused.valid.sum())}), "
        f"candidates per octave {counters}; against device='cpu' on the first {cpu_frames} "
        f"frames: slot agreement {agreement:.6f}, p99 position delta {p99:.3g} px"
    )
    _say(
        f"timing per-trio detect (a): {detect_ms:.2f} ms per {batch}-frame batch, "
        f"{1e3 * batch / detect_ms:.1f} frames/s (fused path here {fused_ms:.2f} ms, "
        f"{1e3 * batch / fused_ms:.1f} frames/s), peak device memory {detect_peak:.2f} GiB; "
        f"synchronised stages: {stages} [{smi}]"
    )
    if on_card:
        _require(launches == (0, 0, n_blurs, octaves, 0), f"per-trio detect: launches {launches}")
    _require(same, "per-trio detect: blur='cuda' differs from blur='separable'")
    _require(int(keypoints.valid.sum()) > 0, "per-trio detect: no valid keypoints")
    _require(all(bool(torch.isfinite(getattr(keypoints, f)[keypoints.valid]).all())
                 for f in ("abs_x", "abs_y", "abs_sigma", "value")),
             "per-trio detect: keypoints not finite")
    _require(agreement >= SLOT_AGREEMENT and p99 <= P99_PX,
             "per-trio detect: the card disagrees with the CPU")
    del keypoints, extrema, cpu_keypoints

    # (b) the per-trio describe path.
    port.detect_and_describe_batched(images[:4], cfg, "cuda", device=dev)  # warm-up
    reset_peak()
    zero()
    described = port.detect_and_describe_batched(images, cfg, "cuda", device=dev)
    _sync(torch, dev)
    describe_launches = counts()
    describe_peak = peak_gib()
    same = fields_equal(described, port.detect_and_describe_batched(images, cfg, "separable",
                                                                    device=dev))
    cpu_described = port.detect_and_describe_batched(first, cfg, "separable", device="cpu")
    agreement, _, got, both = against_cpu(described, cpu_described)
    dtheta = (got.theta[both] - cpu_described.theta[both]).abs()
    dtheta = torch.minimum(dtheta, 6.2831855 - dtheta)
    p99_theta = torch.quantile(dtheta.double(), 0.99).item()
    close = dtheta <= P99_THETA
    cosine = (got.descriptor[both][close] * cpu_described.descriptor[both][close]).sum(-1)
    stacks = frontend.build_scale_space(images, cfg, "cuda", device=dev)
    dogs = frontend.build_dog(stacks)
    _, selected = frontend._select_candidates(dogs, cfg, None)
    keypoints_list = frontend._refine_per_octave(dogs, selected, cfg)
    del dogs, selected
    recorded = []

    def recording(stacks, table, ys, xs):
        recorded.append((table, ys, xs))
        return window_sample_pair(stacks, table, ys, xs)

    describe_compact(stacks, keypoints_list, cfg, sample_fn=recording)
    _require(len(recorded) == 2, f"per-trio describe: {len(recorded)} stages sampled")
    sample_err = 0.0
    for table, ys, xs in recorded:
        got_s = window_sample_pair(stacks, table, ys, xs)
        want_s = window_sample_pair_reference(stacks, table, ys, xs)
        sample_err = max(sample_err, *((g - w).abs().max().item() for g, w in zip(got_s, want_s)))
    shapes = [tuple(r[1].shape) for r in recorded]
    del stacks, keypoints_list, recorded
    describe_ms = _host_ms(
        torch, lambda: port.detect_and_describe_batched(images, cfg, "cuda", device=dev), 3, dev
    )
    _say(
        f"per-trio describe (b): detect_and_describe_batched(blur='cuda') {shape}: launches "
        f"K1/K2/K3/R1/R2 {describe_launches} (expected {(0, 2, n_blurs, octaves, 0)}); every field "
        f"equal to "
        f"blur='separable' on the same device {same}; valid descriptors "
        f"{int(described.valid.sum())}; against device='cpu' on the first {cpu_frames} frames: "
        f"slot agreement {agreement:.6f}, theta diff p99 {p99_theta:.3g} rad, min cosine "
        f"{cosine.min().item():.7f}; K2 vs plain on this path's slots {shapes}: max abs diff "
        f"{sample_err:.3g}"
    )
    _say(
        f"timing per-trio describe (b): {describe_ms:.2f} ms per {batch}-frame batch, "
        f"{1e3 * batch / describe_ms:.1f} frames/s, peak device memory {describe_peak:.2f} GiB "
        f"[{smi}]"
    )
    if on_card:
        _require(describe_launches == (0, 2, n_blurs, octaves, 0),
                 f"per-trio describe: launches {describe_launches}")
    _require(same, "per-trio describe: blur='cuda' differs from blur='separable'")
    _require(int(described.valid.sum()) > 0, "per-trio describe: no valid descriptors")
    _require(bool(torch.isfinite(described.descriptor).all()), "per-trio describe: not finite")
    _require(agreement >= SLOT_AGREEMENT and p99_theta <= P99_THETA
             and cosine.min().item() >= MIN_COSINE,
             "per-trio describe: the card disagrees with the CPU")
    _require(sample_err <= MAX_ABS_ERR, "per-trio describe: K2 differs from its plain version")
    del cpu_described, got

    # (e) the data-parallel frontend at world 1, on the same batch.
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_blur")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    initialize_multihost(f"file://{os.path.join(work, 'store')}", 1, 0,
                         backend="nccl" if on_card else "gloo",
                         timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        mesh = make_mesh(1, device_type=dev.type)
        detect_and_describe_data_parallel(images_cpu[:4], cfg, mesh, blur="cuda")  # warm-up
        _sync(torch, dev)
        zero()
        sharded = detect_and_describe_data_parallel(images_cpu, cfg, mesh, blur="cuda")
        _sync(torch, dev)
        shard_launches = counts()
        shard_same = fields_equal(sharded, described)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    _say(
        f"per-trio sharded (e): detect_and_describe_data_parallel(blur='cuda') at world 1 "
        f"({backend}) on {shape}: launches K1/K2/K3/R1/R2 {shard_launches} (expected "
        f"{(0, 2, n_blurs, octaves, 0)}); every field equal to (b) {shard_same}"
    )
    if on_card:
        _require(shard_launches == (0, 2, n_blurs, octaves, 0),
                 f"per-trio sharded: launches {shard_launches}")
    _require(shard_same, "per-trio sharded: the data-parallel frontend differs from (b)")
    del sharded, described

    # (g) the pooled refinement flags on the fused path.
    for flag, pools in (("unified_refine", 1), ("refine_tail_pool", 2)):
        flagged = dataclasses.replace(cfg, **{flag: True})
        expected = (octaves, 0, 0, pools, octaves)  # R1 once a pool: all, or octave 0 and the rest
        zero()
        pooled, _ = port.detect_batched(images, flagged, device=dev)
        _sync(torch, dev)
        pool_launches = counts()
        again, _ = port.detect_batched(images, flagged, device=dev)
        rerun_same = fields_equal(pooled, again)
        moved = int((pooled.reject_reason != fused.reject_reason).sum())
        cpu_pooled, _ = port.detect_batched(first, flagged, device="cpu")
        agreement, p99, _, _ = against_cpu(pooled, cpu_pooled)
        pool_ms = _host_ms(torch, lambda: port.detect_batched(images, flagged, device=dev), 3, dev)
        _say(
            f"pooled refinement (g), {flag}: detect_batched {shape} (fused): launches "
            f"K1/K2/K3/R1/R2 {pool_launches} (expected {expected}); valid "
            f"{int(pooled.valid.sum())} (per octave {int(fused.valid.sum())}), reject_reason "
            f"differs from the per-octave path on {moved} slots; rerun bit-equal {rerun_same}; "
            f"against device='cpu' on the first {cpu_frames} frames: slot agreement "
            f"{agreement:.6f}, p99 position delta {p99:.3g} px; {pool_ms:.2f} ms per batch "
            f"(per octave {fused_ms:.2f} ms) [{smi}]"
        )
        if on_card:
            _require(pool_launches == expected, f"{flag}: launches {pool_launches}")
        _require(rerun_same, f"{flag}: two runs differ")
        _require(agreement >= SLOT_AGREEMENT and p99 <= P99_PX,
                 f"{flag}: the card disagrees with the CPU")
        del pooled, again, cpu_pooled
    del fused, images

    # (c) SLAM on phase 15's gated sequence, blur by blur.
    recipe = slam_bench_recipe(port, slam_frames, width, height)
    frames, gt_r, gt_t, k_mat = (recipe[k] for k in ("images", "gt_r", "gt_t", "k_mat"))
    sift_cfg, slam_cfg = recipe["sift_cfg"], recipe["slam_cfg"]
    track = dict(reassoc_window=recipe["reassoc_window"], frontend_chunk=SLAM_CHUNK,
                 **recipe["solved"])
    per_chunk = _blur_count(sift_cfg)
    chunks = -(-slam_frames // SLAM_CHUNK)

    def slam(blur):
        return port.run_slam_from_images(frames, k_mat, sift_cfg, slam_cfg, blur=blur,
                                         device=dev, **track)

    slam("cuda")  # warm-up
    _sync(torch, dev)
    zero()
    t0 = time.perf_counter()
    result = slam("cuda")
    seconds = time.perf_counter() - t0  # the result is host numpy: synchronised
    slam_launches = counts()
    sep = slam("separable")
    slam_same = (np.array_equal(result.rotations, sep.rotations)
                 and np.array_equal(result.translations, sep.translations))
    ate = port.evaluate_ate(result, gt_r, gt_t, device=dev)
    pixels, visible, _ = port.build_tracks_from_images(frames, sift_cfg, k_mat, blur="cuda",
                                                       device=dev, **track)
    ate_card = port.evaluate_ate(port.run_slam(pixels, visible, k_mat, slam_cfg, device=dev),
                                 gt_r, gt_t, device=dev)
    ate_cpu = port.evaluate_ate(port.run_slam(pixels, visible, k_mat, slam_cfg, device="cpu"),
                                gt_r, gt_t, device="cpu")
    expected = (0, 2 * chunks, per_chunk * chunks, sift_cfg.num_octaves * chunks, 0)
    _say(
        f"per-trio SLAM (c): run_slam_from_images(blur='cuda') on phase 15's {slam_frames} x "
        f"{height}x{width} sequence, {SLAM_MATCH_GATE_PX:g} px gate, {SLAM_MAX_TRACKS} tracks: "
        f"launches K1/K2/K3/R1/R2 {slam_launches} (expected {expected}: {chunks} chunks x "
        f"{per_chunk} blurs), trajectory bit-equal to blur='separable' {slam_same}, valid "
        f"landmarks {int(result.landmark_valid.sum())} of {visible.shape[1]} tracks, ATE "
        f"{ate:.4f}; run_slam on these tracks: ATE {ate_card:.4f} on the card, {ate_cpu:.4f} "
        f"with device='cpu' (bars: < {SLAM_REF_ATE} and within {SLAM_ATE_GAP}); "
        f"{1e3 * seconds:.1f} ms, {slam_frames / seconds:.2f} frames/s [{smi}]"
    )
    if on_card:
        _require(slam_launches == expected, f"per-trio SLAM: launches {slam_launches}")
    _require(slam_same, "per-trio SLAM: blur='cuda' differs from blur='separable'")
    _require(bool(np.isfinite(result.rotations).all() & np.isfinite(result.translations).all()),
             "per-trio SLAM: the trajectory is not finite")
    _require(max(ate_card, ate_cpu) < SLAM_REF_ATE and abs(ate_card - ate_cpu) < SLAM_ATE_GAP,
             "per-trio SLAM: the gated sequence is not solved on the card and the CPU alike")

    # (d) streaming over the same frames.
    sess = port.SlamSession(k_mat, sift_cfg, slam_cfg, blur="cuda",
                            reassoc_window=recipe["reassoc_window"], device=dev,
                            **recipe["solved"])
    zero()
    for image in frames:
        sess.add_frame(image)
    streamed = sess.finalize()
    stream_launches = counts()
    stream_same = (np.array_equal(streamed.rotations, result.rotations)
                   and np.array_equal(streamed.translations, result.translations))
    start, win = 2, slam_cfg.ba_interval
    steps = sum(1 for t in range(1, slam_frames + 1) if t >= start + win and (t - start) % win == 0)
    calls = steps + ((slam_frames - start) % win != 0)
    expected = (0, 2 * calls, per_chunk * calls, sift_cfg.num_octaves * calls, 0)
    _say(
        f"per-trio streaming (d): SlamSession(blur='cuda') over the same frames: launches "
        f"K1/K2/K3/R1/R2 {stream_launches} (expected {expected}), bit-equal to (c) {stream_same}"
    )
    if on_card:
        _require(stream_launches == expected, f"per-trio streaming: launches {stream_launches}")
    _require(stream_same, "per-trio streaming: the result differs from the batch run's")
    del frames, pixels, visible

    # (f) evaluate --blur pallas on phase 16's 40-frame TUM cut.
    argv, _, _ = write_rehearsal_sequence("tum", work, surface_frames, size)
    solved = ["--max-frames", str(solved_frames), "--match-gate", f"{SLAM_MATCH_GATE_PX:g}",
              "--reassoc", "2", "--max-tracks", str(SLAM_MAX_TRACKS)]
    card = [] if on_card else ["--device", "cpu"]
    runs = {}
    for name, flags in (("pallas", ["--blur", "pallas", *card]),
                        ("cuda", ["--blur", "cuda", *card]),
                        ("cpu", ["--blur", "separable", "--device", "cpu"])):
        traj = os.path.join(work, f"{name}.txt")
        zero()
        rc, text = _quiet(evaluate.main, argv + solved + flags + ["--out-traj", traj])
        _require(rc == 0, f"evaluate --blur {name}: exit code {rc}")
        metrics = json.loads(text.strip().splitlines()[-1])
        runs[name] = (counts(), metrics, read_tum_trajectory(traj))
    eval_launches, metrics, traj_pallas = runs["pallas"]
    traj_same = all(np.array_equal(a, b) for a, b in zip(traj_pallas, runs["cuda"][2]))
    cpu_metrics = runs["cpu"][1]
    eval_chunks = -(-solved_frames // SLAM_CHUNK)
    eval_blurs = _blur_count(port.SiftConfig(num_octaves=4))  # evaluate's 4 octaves x 3 scales
    expected = (0, 2 * eval_chunks, eval_blurs * eval_chunks, 4 * eval_chunks, 0)
    _say(
        f"per-trio evaluate (f): evaluate --blur pallas {' '.join(solved)} on the TUM rehearsal: "
        f"launches K1/K2/K3/R1/R2 {eval_launches} (expected {expected}); trajectory equal to "
        f"--blur "
        f"cuda {traj_same}; {metrics['landmarks']} landmarks, ATE {metrics['ate_rmse']}, SLAM "
        f"{metrics['slam_frames_per_s']} frames/s; --device cpu --blur separable: "
        f"{cpu_metrics['landmarks']} landmarks, ATE {cpu_metrics['ate_rmse']} (bars: < "
        f"{SLAM_REF_ATE} and within {SLAM_ATE_GAP}) [{smi}]"
    )
    if on_card:
        _require(eval_launches == expected, f"per-trio evaluate: launches {eval_launches}")
    _require(traj_same, "per-trio evaluate: --blur pallas differs from --blur cuda")
    _require(metrics["frames"] == cpu_metrics["frames"] == solved_frames,
             "per-trio evaluate: frame counts differ")
    _require(max(metrics["ate_rmse"], cpu_metrics["ate_rmse"]) < SLAM_REF_ATE
             and abs(metrics["ate_rmse"] - cpu_metrics["ate_rmse"]) < SLAM_ATE_GAP,
             "per-trio evaluate: the card and the CPU do not both solve the cut")
    shutil.rmtree(work, ignore_errors=True)
    return tuple(total), sample_err


def _tree_digest(root: str) -> str:
    """SHA-256 over every file's relative path and bytes under ``root``."""
    import hashlib
    import os

    digest = hashlib.sha256()
    for directory, dirs, files in os.walk(root):
        dirs.sort()
        for name in sorted(files):
            path = os.path.join(directory, name)
            digest.update(os.path.relpath(path, root).encode())
            with open(path, "rb") as f:
                digest.update(f.read())
    return digest.hexdigest()


def _phase_orbax(torch, port, smi, dev, orbit_ate):
    """Phase 19: the JAX package's orbax checkpoints (``tests/fixtures/
    jax_orbax/``, written by ``tools/torch_make_orbax_fixture.py``) read by
    the port's own zstd, OCDBT and zarr readers in this process, where no
    orbax, tensorstore or zstandard exists, and BASELINE config[3] resumed
    from one on ``dev``. ``orbit_ate``: phase 15 (g)'s uninterrupted ATE,
    printed beside the resumed one. Nothing here is caught: an unreadable
    fixture ends the script. Returns the (K1, K2, K3, R1, R2) launches of the
    resume (none: ``run_slam`` on tracks runs no frontend)."""
    import os
    import shutil
    import tempfile

    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.blur import blur_fused
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.describe import (
        window_sample_pair,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import fused_octave
    from sift_scale_space_extrema_detection_tpu_torch.sfm.ba import BAState
    from sift_scale_space_extrema_detection_tpu_torch.utils import checkpoint, synthetic

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), ORBAX_FIXTURE)
    fixture_digest = _tree_digest(fixture)
    with open(os.path.join(fixture, "fixture.json")) as f:
        record = json.load(f)

    # (a) the reader on the card's host.
    state = os.path.join(fixture, "slam", "state")
    compressed = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(state)
                     for n in ns)
    seconds = []
    for _ in range(3):
        t0 = time.perf_counter()
        flat = checkpoint.restore_checkpoint_flat(state)
        seconds.append(time.perf_counter() - t0)
    twin = checkpoint.restore_checkpoint_flat(os.path.join(fixture, "slam_npz", "state"))
    _require(sorted(flat) == sorted(twin) and all(
        flat[k].dtype == twin[k].dtype and flat[k].shape == twin[k].shape
        and flat[k].tobytes() == twin[k].tobytes() for k in twin
    ), "orbax: the SLAM state differs from its npz twin")
    decoded = sum(v.nbytes for v in flat.values())
    ba_dir = os.path.join(fixture, "ba", "state")
    shapes = {k: v.shape for k, v in checkpoint.restore_checkpoint_flat(ba_dir).items()}
    like = BAState(**{k: torch.zeros(sh, device=dev) for k, sh in shapes.items()})
    ba = checkpoint.restore_checkpoint(ba_dir, like)
    ba_twin = checkpoint.restore_checkpoint(os.path.join(fixture, "ba_npz", "state"), like)
    _require(all(getattr(ba, k).device == dev and torch.equal(getattr(ba, k), getattr(ba_twin, k))
                 for k in shapes), "orbax: the BAState is not its npz twin on the card")
    median = float(np.median(seconds))
    _say(
        f"orbax reader on the host: config[3]'s SLAM state after frame {int(flat['frame'])} "
        f"({len(flat)} arrays), {compressed} bytes on disk decoded to {decoded} bytes in "
        f"{1e3 * median:.1f} ms (median of {', '.join(f'{1e3 * t:.1f}' for t in seconds)} ms), "
        f"{compressed / median / 1e6:.2f} MB/s read, {decoded / median / 1e6:.2f} MB/s decoded; "
        f"equal to the npz twin (keys, dtypes, shapes, bytes); BAState {shapes} restored onto "
        f"{dev}, equal to its npz twin [{smi}]"
    )

    # (b) the resume, from copies: the resumed run's npz save removes the
    # orbax directory it resumed from.
    recipe = record["recipe"]
    seq = synthetic.orbit_sequence(
        np.random.default_rng(recipe["seed"]), num_frames=recipe["num_frames"],
        num_landmarks=recipe["num_landmarks"], noise_px=recipe["noise_px"],
        outlier_frac=recipe["outlier_frac"],
    )
    cfg = port.SlamConfig()
    fused_octave.launches = window_sample_pair.launches = blur_fused.launches = 0
    newton_ladder.launches = select_candidates.launches = 0
    results, run_s = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("slam", "slam_npz"):
            work = os.path.join(tmp, name)
            shutil.copytree(os.path.join(fixture, name), work)
            _sync(torch, dev)
            t0 = time.perf_counter()
            results[name] = port.run_slam(seq.pixels, seq.visible, seq.k_mat, cfg,
                                          checkpoint_dir=work, resume=True, device=dev)
            _sync(torch, dev)
            run_s[name] = time.perf_counter() - t0
    launches = (fused_octave.launches, window_sample_pair.launches, blur_fused.launches,
                newton_ladder.launches, select_candidates.launches)
    got, npz = results["slam"], results["slam_npz"]
    same = (np.array_equal(got.rotations, npz.rotations)
            and np.array_equal(got.translations, npz.translations))
    ate = port.evaluate_ate(got, seq.rotations, seq.translations, device=dev)
    landmarks = int(got.landmark_valid.sum())
    frames = recipe["num_frames"] - int(flat["frame"]) - 1
    _say(
        f"orbax resume of BASELINE config[3] on {dev} from the JAX package's checkpoint after "
        f"frame {int(flat['frame'])} (jax {record['versions']['jax']}, orbax "
        f"{record['versions']['orbax-checkpoint']}): {frames} frames in "
        f"{1e3 * run_s['slam']:.1f} ms, restore included ({frames / run_s['slam']:.2f} frames/s; "
        f"from the npz twin {1e3 * run_s['slam_npz']:.1f} ms), bit-equal to the npz resume "
        f"{same}, valid landmarks {landmarks} (bar > {ORBIT_MIN_LANDMARKS}), ATE {ate:.6f} (bars: "
        f"< {ORBIT_ATE}, within {SLAM_ATE_GAP} of the JAX package's resumed "
        f"{record['jax_resumed_ate']:.6f}); phase 15 (g)'s uninterrupted ATE {orbit_ate:.6f}; "
        f"K1/K2/K3/R1/R2 {launches} [{smi}]"
    )
    _require(same, "orbax: the resume differs from the npz twin's")
    _require(landmarks > ORBIT_MIN_LANDMARKS, "orbax resume: too few landmarks")
    _require(ate < ORBIT_ATE, "orbax resume: ATE above the reference's bar")
    _require(abs(ate - record["jax_resumed_ate"]) < SLAM_ATE_GAP,
             "orbax resume: ATE far from the JAX package's")
    _require(launches == (0, 0, 0, 0, 0), "orbax resume: a kernel launched on a tracks-only path")

    # (c) no way round the reader.
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "orbax", "tensorstore", "zstandard"))
    _require(not loaded, f"orbax: {loaded} loaded in this process")
    _require(_tree_digest(fixture) == fixture_digest, "orbax: the committed fixture changed")
    return launches


def tap_tolerance(torch, x, taps, mode):
    """Per-element bound on |kernel - plain| of the tap chain ``mode`` on
    ``x`` with ``taps``: 0 for ``f32``. In the bf16 modes both round every
    bf16 product and sum once (the ``_rn`` intrinsics; PyTorch computes a
    bf16 operation in float32 and rounds it, which is the same for one
    product or sum), so they agree in principle; the bound is that of one
    bf16 rounding per product (and per pair sum in ``bf16_pair``) taken
    otherwise: ``BF16_BOUND[mode]·S`` with S = Σ|x_t·tap_t| over the
    element's 832 products, plus the float32 sums' rounding on either side."""
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.probes import NTAPS, REPS

    rows = x.shape[0] - NTAPS
    if mode == "f32":
        return torch.zeros((rows, x.shape[1]), dtype=torch.float64, device=x.device)
    xb, tb = x.to(torch.bfloat16).double(), taps.to(torch.bfloat16).double()
    s = REPS * sum((xb[t : t + rows] * tb[t]).abs() for t in range(NTAPS))
    return (BF16_BOUND[mode] + 2 * (REPS * NTAPS - 1) * 2.0**-24) * s


def sass_mix(lib_path: str) -> dict:
    """Floating-point opcodes of the tap-chain kernels in the built library,
    counted in ``cuobjdump -sass``: ``{mode: {opcode: count}}``. The chain is
    unrolled, so each count is what one thread executes."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump"
    )
    return sass_counts(subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                                      timeout=300, check=True).stdout)


def sass_counts(text: str) -> dict:
    """:func:`sass_mix` of ``cuobjdump -sass``'s ``text``."""
    import re

    kernels = {"tap_f32_kernel": "f32", "tap_bf16_kernelILi1E": "bf16_carry",
               "tap_bf16_kernelILi2E": "bf16_full", "tap_bf16_kernelILi3E": "bf16_pair"}
    opcode = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)")
    mix, mode = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1]
            mode = next((m for k, m in kernels.items() if k in name), None)
            if mode:
                mix[mode] = dict.fromkeys(SASS_OPS, 0)
            continue
        found = opcode.search(line) if mode else None
        if found and found.group(1) in SASS_OPS:
            mix[mode][found.group(1)] += 1
    return mix


def _phase_probes(torch, smi, dev, octave_work=None, blur_work=None, sample_work=None,
                  gb=PROBE_GB, long_rows=TAP_LONG_ROWS):
    """Phase 21: the card's probes (K4-K7, ``csrc/probes.cu``) and the
    ceilings they measure. ``octave_work``, ``blur_work`` and
    ``sample_work``: the (bytes, operations) of each K1, K3 and K2 launch
    timed in phases 5 and 10 (None: no reach). Returns ``(records,
    reach)``: the four kernels' entries of the ``kernels`` line and
    ``{"fused_octave": (reach_ms, by), "blur_fused": (...),
    "window_sample_pair": (...), "ceilings": (copy bytes/s, float32
    operations/s)}`` or None."""
    from sift_scale_space_extrema_detection_tpu_torch.benchmarks import bw_probe, tap_probe
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import _build, probes

    earlier = {p.__name__: p.launches for p in probes.PROBES}
    _require(not any(earlier.values()), f"a probe kernel was launched in phases 1-20: {earlier}")
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()

    # (a) The entry points as a user runs them, every count zeroed before.
    for p in probes.PROBES:
        p.launches = 0
    for name, main, argv in (
        ("bw_probe", bw_probe.main, ["--gb", str(gb), "--device", dev.type]),
        ("tap_probe", tap_probe.main, ["--device", dev.type]),
        ("tap_probe", tap_probe.main, ["--rows", str(long_rows), "--iters", "10", "--device", dev.type]),
    ):
        rc, text = _quiet(main, argv)
        _require(rc == 0, f"{name} {argv} exited with {rc}")
        _say(f"probes (a): python -m ...benchmarks.{name} {' '.join(argv)}: {text.strip()}")
    launches = {p.__name__: p.launches for p in probes.PROBES}
    _say(f"probes (a): launches of the entry points {launches}")
    if dev.type == "cuda":  # the launch bar is the card's only
        _require(all(launches.values()), f"an entry point did not launch its kernel: {launches}")

    # (b) Each kernel against its plain version on the same tensors, at the
    # originals' shapes (and the chain also at ``long_rows``).
    rows, cols = probes.probe_rows(gb), probes.LANE_W
    nbytes = 4 * rows * cols
    x = torch.randn((rows, cols), generator=torch.Generator(device=dev).manual_seed(0), device=dev)

    def diff(a, b):
        return (a - b).abs().max().item()

    write_err = diff(_on_poison(torch, x.numel(), dev, lambda: probes.probe_write(rows, cols, dev)),
                     probes.probe_write_reference(rows, cols, dev))
    copy_err = diff(_on_poison(torch, x.numel(), dev, lambda: probes.probe_copy(x)),
                    probes.probe_copy_reference(x))
    # The write's and the copy's edges (a block a stretch of 256 float4s):
    # 4 elements, a stretch and 16 bytes, a count of stretches that does not
    # divide among the multiprocessors' resident blocks, a view 16 bytes in.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 132
    stretch = 256 * 4
    ragged = (sms * 8 * 3 + 5) * stretch + 4
    base = torch.randn(ragged + 4, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    edges = {"4": base[:4], "stretch+16B": base[: stretch + 4], "ragged": base[:ragged],
             "view+16B": base[4 : 4 + 4096]}
    for label, xe in edges.items():
        n = xe.numel()
        edge = (diff(_on_poison(torch, n, dev, lambda: probes.probe_write(1, n, dev)),
                     probes.probe_write_reference(1, n, dev)),
                diff(_on_poison(torch, n, dev, lambda: probes.probe_copy(xe)),
                     probes.probe_copy_reference(xe)))
        _require(edge == (0, 0), f"write or copy differs from its plain version at {label} ({n} elements)")
    _say(f"probes (b): write and copy equal fill_ and clone at the edges "
         f"{ {label: xe.numel() for label, xe in edges.items()} } elements")
    read = probes.probe_read(x)
    read_err = diff(read, probes.probe_read_reference(x))

    def library_read():
        return x.view(rows // 8, 8, cols // 128, 128).sum((0, 2))

    read_library_err = diff(read, library_read())
    read_abs = x.abs().view(rows // 8, 8, cols // 128, 128).sum((0, 2))
    terms = rows * cols // (8 * 128)
    _say(
        f"probes (b), {rows} x {cols} float32 ({nbytes / 2**30:.3f} GiB): write max abs diff "
        f"{write_err:.3g}, copy {copy_err:.3g}, read {read_err:.3g} (against torch's sum in its "
        f"own order {read_library_err:.3g}, {read_library_err / read_abs.max().item():.3g} of "
        f"the largest Σ|x|; two orders may differ by 2·{terms - 1}·2^-24 of it)"
    )
    _require(write_err == 0 and copy_err == 0 and read_err == 0,
             "write, copy or read differs from its plain version")
    _require(bool(torch.isfinite(read).all()), "the read's sums are not finite")
    taps = probes.probe_taps().to(dev)
    tap_err, tap_inputs = 0.0, {}
    for n in (probes.ROWS, long_rows):
        xt = tap_probe.probe_input(n, probes.W).to(dev)
        tap_inputs[n] = xt
        for mode in probes.TAP_MODES:
            got = probes.tap_chain(xt, taps, mode)
            err = (got.double() - probes.tap_chain_reference(xt, taps, mode).double()).abs()
            ok = bool((err <= tap_tolerance(torch, xt, taps, mode)).all())
            _say(f"probes (b), tap chain {mode} {tuple(got.shape)}: max abs diff "
                 f"{err.max().item():.3g}, within its tolerance {ok}")
            _require(ok and bool(torch.isfinite(got).all()),
                     f"the {mode} tap chain differs from its plain version")
            tap_err = max(tap_err, err.max().item())

    # (c) Times in one sequence of turns: the plain version, the kernel and
    # the library's call; for the write and the copy on the card also the
    # first design and a bulk-copy ring (tools/probe_designs.cu).
    write_fns = {"plain": lambda: probes.probe_write_reference(rows, cols, dev),
                 "kernel": lambda: probes.probe_write(rows, cols, dev),
                 "library": lambda: torch.full((rows, cols), probes.WRITE_VALUE, device=dev)}
    copy_fns = {"plain": lambda: probes.probe_copy_reference(x), "kernel": lambda: probes.probe_copy(x),
                "library": lambda: x + 0.0}
    if dev.type == "cuda":
        other = _probe_designs().yardsticks(x)
        write_fns |= other["write"]
        copy_fns |= other["copy"]
    w = _turns_of(torch, write_fns, dict.fromkeys(write_fns, 20))
    c = _turns_of(torch, copy_fns, dict.fromkeys(copy_fns, 20))
    r = _turns_of(torch, {"plain": lambda: probes.probe_read_reference(x),
                          "kernel": lambda: probes.probe_read(x), "library": library_read},
                  {"plain": 2, "kernel": 20, "library": 20})
    w_ms, w_plain, w_lib = w["kernel"], w["plain"], w["library"]
    c_ms, c_plain, c_lib = c["kernel"], c["plain"], c["library"]
    r_ms, r_plain, r_lib = r["kernel"], r["plain"], r["library"]
    xt, xl = tap_inputs[probes.ROWS], tap_inputs[long_rows]
    t_ms, t_plain, _ = _in_turns(torch, lambda: probes.tap_chain(xt, taps, "f32"),
                                 lambda: probes.tap_chain_reference(xt, taps, "f32"), 50, 2)
    tl_ms, tl_plain, _ = _in_turns(torch, lambda: probes.tap_chain(xl, taps, "f32"),
                                   lambda: probes.tap_chain_reference(xl, taps, "f32"), 20, 1)
    gbs = {name: k * nbytes / ms / 1e6 for name, k, ms in
           (("write", 1, w_ms), ("copy", 2, c_ms), ("read", 1, r_ms))}

    def rates(times, k, names):
        return ", ".join(f"{label} {times[key]:.4f} ms ({k * nbytes / times[key] / 1e6:.1f} GB/s)"
                         for key, label in names.items() if key in times)

    _say(
        f"probes (c), {nbytes / 1e9:.3f} GB, one sequence of turns each: write kernel "
        + rates(w, 1, {"kernel": "", "plain": "fill_", "library": "torch.full", "first": "first design",
                       "bulk": "bulk design"}).lstrip()
        + "; copy kernel "
        + rates(c, 2, {"kernel": "", "plain": "clone", "library": "x + 0.0", "first": "first design",
                       "bulk": "bulk design"}).lstrip()
        + " (read + written); read kernel "
        + rates(r, 1, {"kernel": "", "plain": "plain", "library": "torch sum"}).lstrip()
        + f"; published peak {PEAK_BYTES_PER_S / 1e9:.0f} GB/s [{smi}]"
    )
    per_tap = probes.REPS * probes.NTAPS
    # The float32 instructions an element of the chain executes: counted in
    # the SASS (the compiler computes the 13 products once, csrc/probes.cu),
    # or in a rehearsal on the CPU the source's 13 products and 831 sums.
    ops_per_el = probes.NTAPS + per_tap - 1
    if dev.type == "cuda":
        mix = sass_mix(_build.load_kernels()._name)
        _say(f"probes (c), cuobjdump -sass of the tap-chain kernels (opcodes a thread executes): {mix}")
        f32 = mix.get("f32", {})
        _require(f32.get("FFMA", 1) == 0, "the f32 tap chain holds a fused multiply-add")
        _require(f32.get("FADD") == per_tap - 1 and probes.NTAPS <= f32["FMUL"] <= per_tap,
                 f"the f32 tap chain does not run its {per_tap - 1} sums and 13 to {per_tap} products")
        ops_per_el = f32["FMUL"] + f32["FADD"]
    tap_rate = long_rows * probes.W * ops_per_el / (tl_ms * 1e-3)
    mode_line = []
    for mode in probes.TAP_MODES:
        ms_short = _event_ms(torch, lambda: probes.tap_chain(xt, taps, mode), 50)
        ms_long = _event_ms(torch, lambda: probes.tap_chain(xl, taps, mode), 20)
        mode_line.append(
            f"{mode} {ms_short:.4f} ms at {probes.ROWS} rows, {ms_long:.4f} ms at {long_rows} "
            f"({ms_long * 1e9 / (long_rows * probes.W * per_tap):.4f} ps/element·tap)"
        )
    _say(
        f"probes (c), tap chain {probes.ROWS} x {probes.W}: f32 kernel {t_ms:.4f} ms, plain "
        f"{t_plain:.3f}; {long_rows} x {probes.W}: kernel {tl_ms:.4f} ms, plain {tl_plain:.3f}: "
        f"{tl_ms * 1e9 / (long_rows * probes.W * per_tap):.4f} ps/element·tap, {ops_per_el} "
        f"float32 instructions an element, {tap_rate / 1e12:.2f} T of them a second (the "
        f"published {PEAK_FLOP_PER_S / 1e12:.0f} TFLOP/s counts a fused multiply-add as two: "
        f"{PEAK_FLOP_PER_S / 2e12:.1f} T instructions/s); by mode: "
        + "; ".join(mode_line) + f" [{smi}]"
    )

    # (d) K1 and K3 against the ceilings just measured: each launch's bytes
    # over the copy rate, or its operations over the chain's rate.
    copy_bps = gbs["copy"] * 1e9
    if octave_work is None:
        _say(f"probes (d): no K1/K3 launches given, no reach; phase 21 took "
             f"{time.perf_counter() - t_phase:.1f} s [{smi}]")
        reaches = None
    else:
        reaches = {"fused_octave": _reach(octave_work, copy_bps, tap_rate),
                   "blur_fused": _reach(blur_work, copy_bps, tap_rate),
                   "window_sample_pair": _reach(sample_work or [], copy_bps, tap_rate),
                   "ceilings": (copy_bps, tap_rate)}
        _say(
            f"probes (d), reach at the measured ceilings ({gbs['copy']:.1f} GB/s copy, "
            f"{tap_rate / 1e12:.2f} T float32 operations/s): fused_octave "
            f"{reaches['fused_octave'][0]:.4f} ms by {reaches['fused_octave'][1]}, blur_fused "
            f"{reaches['blur_fused'][0]:.4f} ms by {reaches['blur_fused'][1]}, "
            f"window_sample_pair {reaches['window_sample_pair'][0]:.4f} ms by "
            f"{reaches['window_sample_pair'][1]}; phase 21 took "
            f"{time.perf_counter() - t_phase:.1f} s [{smi}]"
        )
    tap_bytes = 4 * (probes.ROWS + probes.NTAPS) * probes.W + 4 * probes.ROWS * probes.W
    work = {
        "probe_write": ("bw_probe.py:97", write_err, w_ms, w_plain, _bound(nbytes, 0), w_lib),
        "probe_copy": ("bw_probe.py:106", copy_err, c_ms, c_plain, _bound(2 * nbytes, 0), c_lib),
        "probe_read": ("bw_probe.py:116", read_err, r_ms, r_plain,
                       _bound(nbytes + 4 * 8 * 128, rows * cols), r_lib),
        "tap_chain": ("tap_probe.py:121", tap_err, t_ms, t_plain,
                      _bound(tap_bytes, probes.ROWS * probes.W * (probes.NTAPS + per_tap - 1)),
                      None),
    }
    records = [
        {
            "name": name,
            "route": "cuda",
            "source": CSRC + "probes.cu",
            "replaces": "benchmarks/" + where,
            "launches": launches[name],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": bound[0],
            "bound_by": bound[1],
            "library_ms": library,
        }
        for name, (where, err, ms, plain, bound, library) in work.items()
    ]
    return records, reaches


# Phase 22: the loop-closure regime of BASELINE.md:400-421 and the JAX
# package's TPU readings of it there (ATE without closure, with closure and
# the pose graph). Readings to print beside the port's, not targets.
LOOP_REGIME_FRAMES = 80
LOOP_REGIME_TPU_ATE = {"no closure": 0.440, "closure + pose graph": 0.198}


def _finite_numbers(value, path="") -> list:
    """The paths of the numbers in a benchmark's JSON object that are not
    finite (``None`` is a field with no reading, as on the CPU)."""
    if isinstance(value, dict):
        return [p for k, v in value.items() for p in _finite_numbers(v, f"{path}.{k}")]
    if isinstance(value, (list, tuple)):
        return [p for i, v in enumerate(value) for p in _finite_numbers(v, f"{path}[{i}]")]
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return [] if np.isfinite(value) else [path]
    return []


def _phase_benchmarks(torch, smi, dev, ceilings=None, suite_seeds=1, slam_frames=SLAM_FRAMES,
                      size=(WIDTH, HEIGHT), loop_frames=LOOP_REGIME_FRAMES, batch=BATCH,
                      ba_sizes=None, warps=None):
    """Phase 22: the port's measuring entry points (``…_torch/benchmarks/``)
    through their ``run``, at the scripts' full default widths: ``bench``;
    ``frontend_bench --stages --describe`` with ``--blur fused`` and
    ``cuda``; ``ba_bench`` dense (50 × 4,096 × 512, ``--breakdown``) and
    ``--large``; ``slam_bench``'s headline run, ``--streaming``, ``--suite``
    over the four shapes at ``suite_seeds`` seeds, and the loop-closure regime
    (80 frames, ``--final-rounds 0``) with ``--loop-stride 1 --pose-graph``
    and without closure; ``descriptor_bench``. ``ceilings``: phase 21's
    measured (copy bytes/s, float32 operations/s) for K1's reach. Every
    number of every output is finite, and each path launches the kernels it
    runs: K1 in ``bench`` and ``--blur fused``, K3 with ``--blur cuda``, K2
    in every describe, every SLAM mode and ``descriptor_bench`` (the modules
    raise where a kernel of their path was launched no time), and no other.
    Every count is zeroed before the phase; returns its (K1, K2, K3, R1, R2)
    launches (R1, refinement, and R2, selection, counted over the phase: on
    the card every script here but ``ba_bench`` refines, and every fused
    frontend selects on R2). The other arguments cut it for a CPU
    rehearsal."""
    import tempfile

    from sift_scale_space_extrema_detection_tpu_torch.benchmarks import (
        ba_bench,
        bench,
        descriptor_bench,
        frontend_bench,
        kernel_counts,
        slam_bench,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.blur import blur_fused
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.describe import (
        window_sample_pair,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import fused_octave

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    fused_octave.launches = window_sample_pair.launches = blur_fused.launches = 0
    newton_ladder.launches = select_candidates.launches = 0
    t_phase = time.perf_counter()
    outputs = {}

    def check(name, out, want):
        """``out`` finite; on the card the kernels ``want`` names launched
        (``{kernel: True}``) or not (``False``) in every launch record."""
        bad = _finite_numbers(out)
        _require(not bad, f"benchmarks: {name} has non-finite readings at {bad}")
        records = [out["launches"]] if "fused_octave" in out["launches"] else list(
            out["launches"].values())
        if on_card:
            for rec in records:
                for kernel, launched in want.items():
                    _require(bool(rec[kernel]) == launched,
                             f"benchmarks: {name} launched {kernel} {rec[kernel]} times")
        outputs[name] = out
        _say(f"benchmarks {name}: {json.dumps(out)} [{smi}]")

    k1, k2, k3 = "fused_octave", "window_sample_pair", "blur_fused"
    device = str(dev)
    check("bench", bench.run(batch=batch, height=size[1], width=size[0], device=device),
          {k1: True, k2: False, k3: False})
    for blur, want in (("fused", {k1: True, k3: False}), ("cuda", {k1: False, k3: True})):
        out = frontend_bench.run(batch=batch, blur=blur, stages=True, describe=True,
                                 height=size[1], width=size[0], device=device,
                                 **({} if ceilings is None else dict(
                                     copy_bytes_per_s=ceilings[0], ops_per_s=ceilings[1])))
        _require(out["launches"]["describe"][k2] > 0 and out["launches"]["detect"][k2] == 0
                 or not on_card, f"benchmarks: frontend_bench --blur {blur} K2 launches")
        check(f"frontend_bench --blur {blur}", out, want)
    none = {k1: False, k2: False, k3: False}
    dense, large = ba_sizes or (SHARD_BA, None)
    check("ba_bench --breakdown", ba_bench.run(*dense, breakdown=True, device=device), none)
    check("ba_bench --large", ba_bench.run(large=True, device=device) if large is None
          else ba_bench.run(*large, solver="cg", device=device), none)
    slam_want = {k1: False, k2: True, k3: False}
    slam = dict(frames=slam_frames, size=f"{size[0]}x{size[1]}", device=device)
    with tempfile.TemporaryDirectory() as cache:
        slam["render_cache"] = cache
        check("slam_bench", slam_bench.run(**slam), slam_want)
        check("slam_bench --streaming", slam_bench.run(**slam, streaming=True), slam_want)
        suite = slam_bench.run(**slam, suite=True, seeds=suite_seeds)
        _require(len(suite["rows"]) == 4 * suite_seeds, "benchmarks: the suite's rows")
        check(f"slam_bench --suite --seeds {suite_seeds}", suite, slam_want)
        loop = dict(slam, frames=loop_frames, trajectory="loop", final_rounds=0)
        closed = slam_bench.run(**loop, loop_stride=1, pose_graph=True)
        check("slam_bench --trajectory loop --loop-stride 1 --pose-graph", closed, slam_want)
        opened = slam_bench.run(**loop)
        check("slam_bench --trajectory loop", opened, slam_want)
    _say(f"benchmarks, the loop-closure regime ({loop_frames} frames, --final-rounds 0): ATE "
         f"{opened['ate']} without closure, {closed['ate']} with --loop-stride 1 "
         f"--pose-graph; the JAX package's TPU readings (BASELINE.md, not targets): "
         f"{LOOP_REGIME_TPU_ATE} [{smi}]")
    check("descriptor_bench", descriptor_bench.run(device=device, warps=warps),
          {k1: False, k2: True, k3: False})
    launches = dict(kernel_counts(), newton_ladder=newton_ladder.launches,
                    select_candidates=select_candidates.launches)
    _say(f"benchmarks: phase 22 launched {launches} and took "
         f"{time.perf_counter() - t_phase:.1f} s [{smi}]")
    if on_card:
        _require(launches["newton_ladder"] > 0, "benchmarks: refinement never took its kernel")
        _require(launches["select_candidates"] > 0, "benchmarks: selection never took its kernels")
    return tuple(launches[k] for k in (k1, k2, k3, "newton_ladder", "select_candidates")), outputs


# Phase 23: scatter_probe also at 16x the script's observations and landmarks
# (O 409,600, L 65,536, C unchanged): at the script's size every row is a few
# microseconds, the size of a launch.
SCATTER_SCALE = 16
SORTED_ABS_ERR = 1e-4  # the sorted route against index_add_: float32 sums of <= 16 N(0, 1) rows


def _phase_scaling(torch, smi, dev, scatter_scales=(1, SCATTER_SCALE), scaling=None):
    """Phase 23: the last three measuring scripts' counterparts on one
    card. (a) ``benchmarks.scatter_probe`` at the script's size and at each
    of ``scatter_scales`` times its O and L; (b) ``benchmarks.scaling_bench
    --devices 1`` through its ``torchrun`` route on one NCCL rank
    (``scaling``: ``run`` arguments that cut it for a CPU rehearsal); (c)
    the line naming the four-card tool. Every number finite; the sorted
    route's reruns bit-equal and within ``SORTED_ABS_ERR`` of
    ``index_add_``'s sums; the module's own bars (ranks, worlds, BA against
    ``bundle_adjust``, K1 and K2 launched on the card). Returns the (K1,
    K2, K3) launches of (b)'s ranks."""
    from sift_scale_space_extrema_detection_tpu_torch.benchmarks import (
        scaling_bench,
        scatter_probe,
    )

    t_phase = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for scale in scatter_scales:
        o, l = scatter_probe.O * scale, scatter_probe.L * scale
        out = scatter_probe.run(o=o, l=l, device=str(dev))
        bad = _finite_numbers(out)
        _require(not bad, f"scaling (a): scatter_probe at {scale}x has non-finite readings {bad}")
        row = out["A_sorted_segment_sum_12w"]
        scatter = out["A_segment_sum_12w"]
        _say(f"scaling (a): scatter_probe, O {o}, L {l}, C {scatter_probe.C}: index_add_ "
             f"{scatter['ms']:.4f} ms (reruns {scatter['rerun_max_diff']} apart), sorted "
             f"{row['ms']:.4f} ms ({row['ms_tables_prebuilt']:.4f} with the tables prebuilt), "
             f"pair scatter {out['A_pair_scatter_18w']['ms']:.4f}, one-hot "
             f"{out['C_w_onehot_18w']['ms']:.4f}; {json.dumps(out)} [{smi}]")
        _require(row["rerun_max_diff"] == 0.0, "scaling (a): the sorted route differs on a rerun")
        _require(row["abs_err_vs_A"] <= SORTED_ABS_ERR,
                 f"scaling (a): the sorted route parts from index_add_ by {row['abs_err_vs_A']}")
    out = scaling_bench.run(devices=1, device=str(dev), **(scaling or {}))
    bad = _finite_numbers(out)
    _require(not bad, f"scaling (b): scaling_bench has non-finite readings {bad}")
    launches = [sum(leg[k] for leg in out["launches"].values())
                for k in ("fused_octave", "window_sample_pair", "blur_fused")]
    _say(f"scaling (b): scaling_bench --devices 1, one rank by torchrun: {json.dumps(out)} "
         f"[{smi}]")
    _say("scaling (c): scaling_bench --devices 4 (--batch-per-device 2 and 64) and "
         "multihost_bench --nproc 2 need four cards: tools/torch_multicard_phase.py runs them "
         "on four, after phase 20")
    _say(f"scaling: phase 23 took {time.perf_counter() - t_phase:.1f} s; its ranks launched "
         f"K1/K2/K3 {launches} [{smi}]")
    return tuple(launches)


def main() -> int:
    import dataclasses

    import torch

    # --- 1. device ------------------------------------------------------
    _require(torch.cuda.is_available(), "no CUDA device")
    smi_lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    smi = smi_lines[0]
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
        _select_candidates,
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
    from sift_scale_space_extrema_detection_tpu_torch.ops.extrema import (
        select_refine_candidates_reference,
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
    from sift_scale_space_extrema_detection_tpu_torch.ops.refine import (
        _kernel_caps,
        _octave_geometry,
        newton_ladder_reference,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.resize import (
        downsample2x_nn,
        upsample2x_nn,
    )
    from sift_scale_space_extrema_detection_tpu_torch.utils.profile import tracing

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
    fused_octave.launches = newton_ladder.launches = select_candidates.launches = 0
    keypoints, extrema = detect_batched(images, cfg)
    torch.cuda.synchronize()
    launches, detect_r1, detect_r2 = (fused_octave.launches, newton_ladder.launches,
                                      select_candidates.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_slots = sum(cfg.refine_capacity(o) for o in range(cfg.num_octaves))
    valid = keypoints.valid
    n_valid = int(valid.sum())
    _say(
        f"main path: detect_batched {BATCH}x{HEIGHT}x{WIDTH}, "
        f"{cfg.num_octaves} octaves x {spo} scales: kernel launches {launches}, R1 {detect_r1}, "
        f"R2 {detect_r2}, "
        f"valid keypoints {n_valid} of {BATCH * n_slots} slots, peak device "
        f"memory {peak_gib:.2f} GiB (with the three-pass kernel and its scratch: "
        f"{PREV_DETECT_PEAK_GIB} GiB), reject counts "
        f"{keypoints.reject_counts().sum(0).tolist()}"
    )
    _require(launches >= cfg.num_octaves, "the main path did not launch the kernel per octave")
    _require(detect_r1 == cfg.num_octaves, "the main path did not refine once an octave on R1")
    _require(detect_r2 == cfg.num_octaves, "the main path did not select once an octave on R2")
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
    octave_work = []  # (bytes, operations) of each octave, for phase 21's reach
    for octave, base in enumerate(bases):
        args = (base, _octave_sigmas(cfg, octave), spo, thr)
        up2 = octave == 0
        # Least work: read the base; write DoG, seed and 2-byte masks.
        octave_bytes, octave_flop, scan = octave_cost(base.numel(), args[1], up2)
        octave_bounds.append(_bound(octave_bytes, octave_flop))
        octave_work.append((octave_bytes, octave_flop + scan))

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

    # R1 against its plain version on the batch's DoGs and candidates, and
    # on a batch of the KITTI cell's shape.
    kitti_cfg = SiftConfig(num_octaves=4, scales_per_octave=3, max_keypoints_per_trio=512)
    kitti_dogs, kitti_masks = build_pyramid_fused(
        torch.from_numpy(_make_batch(BATCH, *KITTI_PADDED)).to(device), kitti_cfg
    )
    refine_ms = refine_plain_ms = refine_bound_ms = 0.0
    refine_checked = 0
    for name, run_cfg, run_dogs, run_masks in (("tum", cfg, dogs, masks),
                                               ("kitti", kitti_cfg, kitti_dogs, kitti_masks)):
        _, selected = _select_candidates(run_dogs, run_cfg, run_masks)
        for octave, (dog, cands) in enumerate(zip(run_dogs, selected)):
            caps = _kernel_caps(run_cfg, cands.capacity, None)
            geometry = [_octave_geometry(octave, run_cfg)]

            def kernel(dog=dog, cands=cands, octave=octave, run_cfg=run_cfg, caps=caps,
                       geometry=geometry):
                return newton_ladder([dog], [cands], octave, run_cfg, caps, geometry)

            def plain(dog=dog, cands=cands, octave=octave, run_cfg=run_cfg):
                return newton_ladder_reference([dog], [cands], octave, run_cfg)

            got, live = kernel()
            with tracing(spans=False, counters=True) as session:
                want = plain()
            torch.cuda.synchronize()
            equal = [f.name for f in dataclasses.fields(want)
                     if not torch.equal(getattr(got, f.name), getattr(want, f.name))]
            want_live = [int(session.counters[f"refine.slots_live.o{octave}.s{i + 1}"])
                         for i in range(len(caps))]
            live_per_step = live.sum(0).tolist()
            turns = _turns_of(torch, {"plain": plain, "kernel": kernel},
                              {"plain": 1, "kernel": 20})
            slots = cands.valid.numel()
            bound = _bound(REFINE_SLOT_BYTES * slots, 0)
            refine_ms += turns["kernel"]
            refine_plain_ms += turns["plain"]
            refine_bound_ms += bound[0]
            refine_checked += 1
            _say(
                f"R1 vs plain, {name} octave {octave} DoG {tuple(dog.shape)}, {slots} slots: "
                f"fields differing {equal}, live slots a step {live_per_step} (plain "
                f"{want_live}); kernel {turns['kernel']:.4f} ms, plain {turns['plain']:.3f} ms "
                f"(held turns), plain/kernel {turns['plain'] / turns['kernel']:.1f}x, bound "
                f"{bound[0]:.4f} ms by {bound[1]} [{smi}]"
            )
            _require(not equal, f"R1 differs from its plain version in {equal} ({name} {octave})")
            _require(live_per_step == want_live,
                     f"R1's live slots differ from the plain version's ({name} {octave})")
            del got, live, want
    _say(
        f"timing R1, the {refine_checked} octaves of both batches: kernel {refine_ms:.4f} ms, "
        f"plain {refine_plain_ms:.3f} ms, bound {refine_bound_ms:.4f} ms "
        f"({REFINE_SLOT_BYTES} B a slot) [{smi}]"
    )

    # R2 against its plain version on every octave's packed plane and DoG
    # of both batches.
    select_ms = select_plain_ms = select_bound_ms = 0.0
    select_checked = 0
    for name, run_cfg, run_dogs, run_masks in (("tum", cfg, dogs, masks),
                                               ("kitti", kitti_cfg, kitti_dogs, kitti_masks)):
        for octave, (dog, packed) in enumerate(zip(run_dogs, run_masks)):
            capacity = run_cfg.refine_capacity(octave)

            def kernel(dog=dog, packed=packed, capacity=capacity):
                return select_candidates(packed, dog, capacity)

            def plain(dog=dog, packed=packed, capacity=capacity, run_cfg=run_cfg):
                return select_refine_candidates_reference(packed, dog, run_cfg, capacity)

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            equal = [f.name for f in dataclasses.fields(want)
                     if not torch.equal(getattr(got, f.name), getattr(want, f.name))]
            turns = _turns_of(torch, {"plain": plain, "kernel": kernel},
                              {"plain": 1, "kernel": 20})
            bound = _bound(packed.numel() * packed.element_size()
                           + SELECT_SLOT_BYTES * want.valid.numel(), 0)
            select_ms += turns["kernel"]
            select_plain_ms += turns["plain"]
            select_bound_ms += bound[0]
            select_checked += 1
            _say(
                f"R2 vs plain, {name} octave {octave} plane {tuple(packed.shape)} "
                f"{packed.dtype}, capacity {capacity}, candidates an image up to "
                f"{int(want.num_candidates.sum(-1).max())}: fields differing {equal}; kernel "
                f"{turns['kernel']:.4f} ms, plain {turns['plain']:.3f} ms (held turns), "
                f"plain/kernel {turns['plain'] / turns['kernel']:.1f}x, bound {bound[0]:.4f} ms "
                f"by {bound[1]} [{smi}]"
            )
            _require(not equal, f"R2 differs from its plain version in {equal} ({name} {octave})")
            del got, want
    _say(
        f"timing R2, the {select_checked} octaves of both batches: kernel {select_ms:.4f} ms, "
        f"plain {select_plain_ms:.3f} ms, bound {select_bound_ms:.4f} ms (the plane read once, "
        f"{SELECT_SLOT_BYTES} B a slot written) [{smi}]"
    )
    del kitti_dogs, kitti_masks, selected

    del dogs, masks

    # --- 6. the describe path ----------------------------------------------
    warm = detect_and_describe_batched(images_cpu, cfg)  # warm-up, from a CPU tensor
    torch.cuda.synchronize()
    _require(warm.valid.is_cuda and warm.descriptor.is_cuda,
             "detect_and_describe_batched of a CPU tensor did not run on the card")
    del warm
    torch.cuda.reset_peak_memory_stats()
    fused_octave.launches = window_sample_pair.launches = blur_fused.launches = 0
    newton_ladder.launches = select_candidates.launches = 0
    described = detect_and_describe_batched(images, cfg)
    torch.cuda.synchronize()
    describe_launches = {
        "fused_octave": fused_octave.launches,
        "window_sample_pair": window_sample_pair.launches,
        "blur_fused": blur_fused.launches,
        "newton_ladder": newton_ladder.launches,
        "select_candidates": select_candidates.launches,
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
    _require(describe_launches["newton_ladder"] == cfg.num_octaves,
             "the describe path did not refine once an octave on R1")
    _require(describe_launches["select_candidates"] == cfg.num_octaves,
             "the describe path did not select once an octave on R2")
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
    sample_work = []  # (bytes, operations) of each stage: its bound, phase 21's reach
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
    window_sample_pair.launches = newton_ladder.launches = select_candidates.launches = 0
    per_octave = detect_and_describe_batched(images, per_octave_cfg)
    torch.cuda.synchronize()
    per_octave_launches, per_octave_r1, per_octave_r2 = (
        window_sample_pair.launches, newton_ladder.launches, select_candidates.launches)
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
        f"launches {per_octave_launches}, R1 {per_octave_r1}, R2 {per_octave_r2}, over "
        f"{tuple(per_octave.valid.shape)} pair slots, "
        f"valid {int(per_octave.valid.sum())} (compacting path {n_described}); against the "
        f"plain sampler: slots equal {per_octave_same}, descriptor and theta max abs diff "
        f"{per_octave_err:.3g}"
    )
    _require(per_octave_launches == 2 * cfg.num_octaves,
             "the per-octave describe did not launch the sampling kernel twice per octave")
    _require(per_octave_r1 == cfg.num_octaves, "the per-octave describe did not refine on R1")
    _require(per_octave_r2 == cfg.num_octaves, "the per-octave describe did not select on R2")
    _require(per_octave_same, "per-octave describe: slots differ from the plain sampler's")
    _require(per_octave_err <= MAX_ABS_ERR, "per-octave describe differs from the plain sampler's")
    _require(int(per_octave.valid.sum()) >= n_described,
             "the per-octave describe holds fewer descriptors than the compacting one")
    sample_err = max(sample_err, per_octave_err)
    del per_octave, per_octave_plain

    # --- 8. the scale-space path -----------------------------------------------
    n_blurs = _blur_count(cfg)
    build_scale_space(images[:4], cfg, blur="cuda")  # warm-up
    fused_octave.launches = window_sample_pair.launches = blur_fused.launches = 0
    newton_ladder.launches = select_candidates.launches = 0
    scale_space = build_scale_space(images, cfg, blur="cuda")
    torch.cuda.synchronize()
    blur_launches = blur_fused.launches
    _require(newton_ladder.launches == select_candidates.launches == 0,
             "the scale-space path launched R1 or R2")
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
        sample_work.append((_window_bytes(torch, stacks, table, ys, xs),
                            SAMPLE_FLOP * n_valid * ys.shape[1]))
        bound = _bound(*sample_work[-1])
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
    blur_work = []  # (bytes, operations) of each blur: its bound, phase 21's reach
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
            blur_work.append((8 * base.numel(), _blur_flop(base.numel(), radius)))
            bound = _bound(*blur_work[-1])
            blur_ms += k_ms
            blur_plain_ms += p_ms
            blur_library_ms += l_ms
            _say(
                f"timing blur octave {octave} scale {scale} {tuple(base.shape)} sigma "
                f"{sigma:.4f} radius {radius}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, two "
                f"conv2d {l_ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]} [{smi}]"
            )
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    blur_bound = sum(_bound(*w)[0] for w in blur_work)
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
    newton_ladder.launches = select_candidates.launches = 0
    deep_keypoints, _ = detect_batched(images, deep_cfg)
    torch.cuda.synchronize()
    deep_launches = fused_octave.launches, fused_octave.clamped_launches
    deep_r1, deep_r2 = newton_ladder.launches, select_candidates.launches
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
        f"of them clamped {deep_launches[1]}, R1 {deep_r1}, R2 {deep_r2}; valid "
        f"{int(deep_keypoints.valid.sum())} vs plain "
        f"{int(deep_plain.valid.sum())} ({from_deep} from octave {deep}), slot agreement "
        f"{agreement:.6f}, p99 position delta {p99:.3g} px"
    )
    _require(deep_launches == (deep_cfg.num_octaves, 1),
             "the 5-octave path did not launch the clamped octave kernel once")
    _require(deep_r1 == deep_cfg.num_octaves, "the 5-octave path did not refine on R1")
    _require(deep_r2 == deep_cfg.num_octaves, "the 5-octave path did not select on R2")
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
    octave_bound = _bound(*octave_cost(base.numel(), sigmas, False)[:2])
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
    blur_path_launches, blur_path_sample_err = _phase_blur_paths(torch, port, smi, device)
    sample_err = max(sample_err, blur_path_sample_err)
    orbax_launches = _phase_orbax(torch, port, smi, device, slam_refs["orbit_ate"])
    if torch.cuda.device_count() >= 2:
        multi_launches, multi_octave_err, multi_sample_err, multi_blur_err = _phase_multicard(
            torch, port, "; ".join(smi_lines), device
        )
        max_err, sample_err = max(max_err, multi_octave_err), max(sample_err, multi_sample_err)
        blur_err = max(blur_err, multi_blur_err)
    else:
        multi_launches = (0, 0, 0, 0, 0)
        _say("phase 20 (the sharded paths across cards, one NCCL rank a card) needs several "
             "cards and is not run on one: tools/torch_multicard_phase.py runs it on four")
    probe_records, reach = _phase_probes(torch, smi, device, octave_work, blur_work, sample_work)
    bench_launches, _ = _phase_benchmarks(torch, smi, device, reach["ceilings"])
    scaling_launches = _phase_scaling(torch, smi, device)

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
                + stream_launches[0] + surface_launches[0] + shard_launches[0]
                + blur_path_launches[0] + orbax_launches[0] + multi_launches[0]
                + bench_launches[0] + scaling_launches[0],
                "max_abs_err": max_err,
                "ms": sum(kernel_ms),
                "plain_ms": sum(plain_ms),
                "bound_ms": octave_bound_ms,
                "bound_by": max(octave_bounds)[1],
                "library_ms": None,
                "reach_ms": reach["fused_octave"][0],
                "reach_by": reach["fused_octave"][1],
            },
            {
                "name": "window_sample_pair",
                "route": "cuda",
                "source": CSRC + "describe.cu",
                "replaces": PALLAS + "describe.py:288",
                "launches": describe_launches["window_sample_pair"] + slam_launches[1]
                + stream_launches[1] + surface_launches[1] + shard_launches[1]
                + blur_path_launches[1] + orbax_launches[1] + multi_launches[1]
                + bench_launches[1] + scaling_launches[1],
                "max_abs_err": sample_err,
                "ms": sum(sample_ms),
                "plain_ms": sum(sample_plain_ms),
                "bound_ms": sample_bound_ms,
                "bound_by": max(sample_bounds)[1],
                "library_ms": None,
                "reach_ms": reach["window_sample_pair"][0],
                "reach_by": reach["window_sample_pair"][1],
            },
            {
                "name": "blur_fused",
                "route": "cuda",
                "source": CSRC + "blur.cu",
                "replaces": PALLAS + "blur.py:98",
                "launches": blur_launches + slam_launches[2] + stream_launches[2]
                + surface_launches[2] + shard_launches[2] + blur_path_launches[2]
                + orbax_launches[2] + multi_launches[2] + bench_launches[2]
                + scaling_launches[2],
                "max_abs_err": blur_err,
                "ms": blur_ms,
                "plain_ms": blur_plain_ms,
                "bound_ms": blur_bound,
                "bound_by": _bound(*map(sum, zip(*blur_work)))[1],
                "library_ms": blur_library_ms,
                "reach_ms": reach["blur_fused"][0],
                "reach_by": reach["blur_fused"][1],
            },
            {
                "name": "select_candidates",
                "route": "cuda",
                "source": CSRC + "select.cu",
                "replaces": None,
                "launches": detect_r2 + describe_launches["select_candidates"] + per_octave_r2
                + deep_r2 + slam_launches[4] + stream_launches[4]
                + surface_launches[4] + shard_launches[4] + blur_path_launches[4]
                + orbax_launches[4] + multi_launches[4] + bench_launches[4],
                "max_abs_err": 0.0,
                "ms": select_ms,
                "plain_ms": select_plain_ms,
                "bound_ms": select_bound_ms,
                "bound_by": "bytes",
                "library_ms": None,
                "reach_ms": None,
                "reach_by": None,
            },
            {
                "name": "newton_ladder",
                "route": "cuda",
                "source": CSRC + "refine.cu",
                "replaces": None,
                "launches": detect_r1 + describe_launches["newton_ladder"] + per_octave_r1
                + deep_r1 + slam_launches[3] + stream_launches[3]
                + surface_launches[3] + shard_launches[3] + blur_path_launches[3]
                + orbax_launches[3] + multi_launches[3] + bench_launches[3],
                "max_abs_err": 0.0,
                "ms": refine_ms,
                "plain_ms": refine_plain_ms,
                "bound_ms": refine_bound_ms,
                "bound_by": "bytes",
                "library_ms": None,
                "reach_ms": None,
                "reach_by": None,
            },
            *probe_records,
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
