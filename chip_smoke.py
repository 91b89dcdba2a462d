#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's detect path once on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and ``nvcc``, and imports nothing of JAX.

Phases (any failure exits non-zero and prints no result):

1. device — CUDA present; the card's name and power limit; the TF32
   settings (nothing on the path multiplies matrices or convolves).
2. build — the CUDA kernels are built from the checkout's sources.
3. kernel vs plain — at every octave geometry of the main path, on a few
   full-size images, the fused octave kernel against its plain PyTorch
   version on the same CUDA tensors: DoG and seed max abs diff <= 1e-6,
   masks equal on >= 99.99 % of pixels.
4. main path — ``detect_batched`` on 64 × 480×640 frames (the bench
   recipe) at 4 octaves × 5 scales: each octave launches the kernel, valid
   keypoints exist and are finite, and the same batch through the plain
   version agrees (slot agreement >= 0.999, p99 position delta <= 0.1 px).
5. timings — per octave at batch 64, kernel against plain (CUDA events,
   in turns plain/kernel/kernel/plain), and the whole ``detect_batched``
   in frames/s (host clock around synchronised runs).

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the kernels' JSON record.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

BATCH, HEIGHT, WIDTH = 64, 480, 640
KERNEL_SOURCE = "sift_scale_space_extrema_detection_tpu_torch/ops/kernels/csrc/octave.cu"
REPLACES = "sift_scale_space_extrema_detection_tpu/ops/pallas/octave.py:437"
MAX_ABS_ERR = 1e-6
MASK_AGREEMENT = 0.9999
SLOT_AGREEMENT = 0.999
P99_PX = 0.1


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


def main() -> int:
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
        f"{torch.backends.cudnn.allow_tf32} (neither is used on the path)"
    )

    from sift_scale_space_extrema_detection_tpu_torch import SiftConfig
    from sift_scale_space_extrema_detection_tpu_torch.models.frontend import (
        build_pyramid_fused,
        detect_batched,
        detect_from_dog,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import _build
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import (
        fused_octave,
        fused_octave_reference,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.resize import downsample2x_nn

    # --- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_kernels()
    _say(f"build: kernels built and loaded in {time.perf_counter() - t0:.2f} s")

    cfg = SiftConfig(num_octaves=4, scales_per_octave=5, max_keypoints_per_trio=512)
    spo, thr = cfg.scales_per_octave, cfg.contrast_prefilter_threshold
    images = torch.from_numpy(_make_batch(BATCH, HEIGHT, WIDTH)).to(device)

    # --- 3. kernel vs plain at every octave geometry ----------------------
    max_err = 0.0
    base = images[:4].contiguous()
    for octave in range(cfg.num_octaves):
        sigmas = _octave_sigmas(cfg, octave)
        up2 = octave == 0
        got = fused_octave(base, sigmas, spo, thr, upsample2x=up2)
        want = fused_octave_reference(base, sigmas, spo, thr, upsample2x=up2)
        torch.cuda.synchronize()
        dog_err = (got[0] - want[0]).abs().max().item()
        seed_err = (got[1] - want[1]).abs().max().item()
        same = (got[2] == want[2]).float().mean().item()
        _require(got[2].dtype == want[2].dtype, f"octave {octave} mask dtype")
        _say(
            f"kernel vs plain, octave {octave} {tuple(got[0].shape)}: dog max "
            f"abs diff {dog_err:.3g}, seed {seed_err:.3g}, masks equal on "
            f"{100 * same:.4f} % of pixels"
        )
        _require(dog_err <= MAX_ABS_ERR and seed_err <= MAX_ABS_ERR,
                 f"octave {octave} DoG/seed differ by more than {MAX_ABS_ERR}")
        _require(same >= MASK_AGREEMENT, f"octave {octave} masks disagree")
        max_err = max(max_err, dog_err, seed_err)
        base = downsample2x_nn(want[1]).contiguous()

    # --- 4. the main path ------------------------------------------------
    detect_batched(images, cfg)  # warm-up: allocator and first launches
    torch.cuda.synchronize()
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
        f"memory {peak_gib:.2f} GiB, reject counts "
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

    dogs, masks = build_pyramid_fused(images, cfg, octave_fn=fused_octave_reference)
    plain, plain_extrema = detect_from_dog(dogs, cfg, masks)
    torch.cuda.synchronize()
    slot_eq = (keypoints.valid == plain.valid) & (
        ~keypoints.valid
        | ((keypoints.octave == plain.octave) & (keypoints.scale_level == plain.scale_level))
    )
    agreement = slot_eq.float().mean().item()
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

    # --- 5. timings ------------------------------------------------------
    bases, base = [], images
    for octave in range(cfg.num_octaves):
        bases.append(base)
        _, seed, _ = fused_octave(base, _octave_sigmas(cfg, octave), spo, thr, upsample2x=octave == 0)
        base = downsample2x_nn(seed).contiguous()
    kernel_ms, plain_ms = [], []
    for octave, base in enumerate(bases):
        args = (base, _octave_sigmas(cfg, octave), spo, thr)
        up2 = octave == 0

        def kernel(args=args, up2=up2):
            return fused_octave(*args, upsample2x=up2)

        def reference(args=args, up2=up2):
            return fused_octave_reference(*args, upsample2x=up2)

        kernel()
        reference()
        rounds = [
            _event_ms(torch, reference, 3),
            _event_ms(torch, kernel, 10),
            _event_ms(torch, kernel, 10),
            _event_ms(torch, reference, 3),
        ]
        k_ms, p_ms = (rounds[1] + rounds[2]) / 2, (rounds[0] + rounds[3]) / 2
        kernel_ms.append(k_ms)
        plain_ms.append(p_ms)
        _say(
            f"timing octave {octave} {tuple(base.shape)}{' (upsampled 2x)' if up2 else ''}: "
            f"kernel {k_ms:.3f} ms (rounds {rounds[1]:.3f}, {rounds[2]:.3f}), plain "
            f"{p_ms:.3f} ms (rounds {rounds[0]:.3f}, {rounds[3]:.3f}), plain/kernel "
            f"{p_ms / k_ms:.2f}x [{smi}]"
        )

    iters = 5
    t_pyr = t_tail = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dogs, masks = build_pyramid_fused(images, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        detect_from_dog(dogs, cfg, masks)
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

    record = {
        "kernels": [
            {
                "name": "fused_octave",
                "route": "cuda",
                "source": KERNEL_SOURCE,
                "replaces": REPLACES,
                "launches": launches,
                "max_abs_err": max_err,
                "ms": sum(kernel_ms),
                "plain_ms": sum(plain_ms),
            }
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
