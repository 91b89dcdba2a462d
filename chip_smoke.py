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

    octave_bound_ms = sum(b[0] for b in octave_bounds)
    sample_bound_ms = sum(b[0] for b in sample_bounds)
    record = {
        "kernels": [
            {
                "name": "fused_octave",
                "route": "cuda",
                "source": CSRC + "octave.cu",
                "replaces": PALLAS + "octave.py:437",
                "launches": describe_launches["fused_octave"],
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
                "launches": describe_launches["window_sample_pair"],
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
                "launches": blur_launches,
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
