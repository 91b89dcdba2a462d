"""The port's frontend stage by stage, and the fused octave kernel against its bound.

The port of the JAX package's ``benchmarks/frontend_bench.py``. On the bench
configuration (``--batch`` × 480×640 float32 frames, ``--octaves`` × 5
scales, 512 keypoints a trio) it measures:

1. the pyramid alone (DoG and extrema masks; with ``--blur fused`` the fused
   octave kernel K1 once per octave, else the scale space blur by blur and
   the DoG), against the least work of its outputs;
2. the whole ``detect_batched``, and the detection tail by subtraction;
3. with ``--stages``, candidate selection and refinement, each timed on the
   pyramid made once;
4. with ``--describe``, ``detect_and_describe_batched``, and its orientation
   and descriptor stages (a synchronise between stages);
5. frames/s, keypoints/s and peak device memory.

The least work of the pyramid is K1's, counted from the shapes
(:func:`k1_work`): each octave reads its base once and writes its DoG
planes, its seed and its 2-byte masks once, and runs its blurs (two passes
of ``2r+1`` products and ``2r`` sums a pixel), its DoG differences and its
26-neighbour scan. ``ideal_roofline_ms`` is that work at the card's
published peaks (3.35 TB/s, 67 TFLOP/s float32, the larger of the two
times an octave), ``measured_bw_floor_ms`` at the ceilings the port's
probes measured on the card (:func:`reach`; ``run``'s ``copy_bytes_per_s``
and ``ops_per_s``, by default the readings of an H100 at 700 W). The
original's traffic model of the TPU kernel (its stripe halo and 128-lane
mask packing) is not the port's and is not kept.

Timing on the card: host clock around work that ends in
``torch.cuda.synchronize()``, after warm-up calls; K1's own ``ms`` is CUDA
events around each octave's launch (``time_ms``). ``--profile DIR`` writes a
``torch.profiler`` Chrome trace of one detect call to ``DIR`` and reports
the share of its wall time the card was busy.

Run: ``python -m sift_scale_space_extrema_detection_tpu_torch.benchmarks.frontend_bench
[--batch 64] [--iters 3] [--blur fused|separable|matmul|cuda|pallas] [--stages]
[--unified] [--describe] [--octaves 4] [--profile DIR] [--device cuda|cpu]``.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from ..config import SiftConfig
from ..models.frontend import (
    _pyramid,
    _refine_per_octave,
    _select_candidates,
    detect_and_describe_batched,
    detect_batched,
    detect_octaves,
)
from ..ops.descriptor import describe_compact
from ..ops.gaussian import kernel_radius
from ..ops.kernels.octave import fused_octave
from ..ops.resize import downsample2x_nn
from . import (
    describe_stage_calls,
    device_entry,
    host_ms,
    launch_counts,
    path_kernels,
    path_launches,
    peak_gib,
    probe_device,
    require_launches,
    sync,
    time_ms,
)
from .bench import BLURS, HEIGHT, WIDTH, make_batch

# The card's published peaks (NVIDIA H100 SXM): memory 3.35 TB/s, float32
# outside the tensor cores 67 TFLOP/s (a fused multiply-add counted as two).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12
# The ceilings the port's probes measured on an NVIDIA H100 80GB HBM3 at
# 700 W (chip_smoke.py phase 21, PERF.md): the copy's combined read and
# write rate and the unfused float32 tap chain's operations. Re-measure with
# benchmarks/bw_probe.py and tap_probe.py on another card and pass them in.
MEASURED_COPY_BYTES_PER_S = 3046.7e9
MEASURED_F32_OPS_PER_S = 28.23e12


def bound(n_bytes: float, flop: float) -> tuple[float, str]:
    """``(bound_ms, bound_by)`` of work that moves ``n_bytes`` and does
    ``flop`` float32 operations, at the published peaks."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
    by_flop = 1e3 * flop / PEAK_FLOP_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_flop else (by_flop, "operations")


def reach(work, copy_bytes_per_s: float = MEASURED_COPY_BYTES_PER_S,
          ops_per_s: float = MEASURED_F32_OPS_PER_S) -> tuple[float, str]:
    """``(reach_ms, reach_by)`` of launches ``work = [(bytes, operations)]``
    at measured ceilings: each launch's bytes over the copy rate or its
    operations over the operation rate, the larger, summed."""
    by_bytes = sum(b / copy_bytes_per_s for b, _ in work)
    by_ops = sum(o / ops_per_s for _, o in work)
    ms = 1e3 * sum(max(b / copy_bytes_per_s, o / ops_per_s) for b, o in work)
    return ms, "bytes" if by_bytes >= by_ops else "operations"


def blur_flop(pixels: int, radius: int) -> int:
    """Two passes of ``2r+1`` products and ``2r`` sums per pixel."""
    return 2 * (2 * (2 * radius + 1) - 1) * pixels


def scan_ops(pixels: int, n_dog: int) -> int:
    """The octave kernel's 26-neighbour scan in operations: per DoG plane and
    pixel 14 minima and maxima (its 3×3 neighbourhood, shared row by row),
    per trio plane 4 more and 3 comparisons (``csrc/octave.cu``)."""
    return pixels * (14 * n_dog + 7 * max(n_dog - 2, 0))


def octave_sigmas(cfg: SiftConfig, octave: int) -> list:
    """The sigmas one octave's launch blurs, ``None`` for the unblurred seed
    scale of an octave past the first (``build_pyramid_fused``)."""
    return [
        None if (octave > 0 and s == 0) else cfg.offset_sigma(octave, s)
        for s in range(cfg.scales_per_octave_total)
    ]


def octave_cost(base_numel: int, sigmas, upsample2x: bool) -> tuple[int, int, int]:
    """``(bytes, operations, scan operations)`` of one K1 launch on a base of
    ``base_numel`` pixels: read the base; write the DoG planes, the seed and
    the 2-byte masks of its plane (twice the base's sides with
    ``upsample2x``); the blurs and DoG differences; the scan."""
    pixels = base_numel * (4 if upsample2x else 1)
    n_scales = len(sigmas)
    radii = [0 if sg is None else kernel_radius(sg) for sg in sigmas]
    n_bytes = 4 * base_numel + pixels * (4 * (n_scales - 1) + 4 + 2)
    flop = sum(blur_flop(pixels, r) for r in radii) + pixels * (n_scales - 1)
    return n_bytes, flop, scan_ops(pixels, n_scales - 1)


def k1_work(cfg: SiftConfig, batch: int, height: int, width: int) -> list[tuple[int, int, int]]:
    """:func:`octave_cost` of each octave of ``build_pyramid_fused`` on
    ``batch`` frames of ``height`` × ``width`` (octave 0 upsampled 2×, each
    later base the previous seed decimated 2×)."""
    work, h, w = [], height, width
    for octave in range(cfg.num_octaves):
        work.append(octave_cost(batch * h * w, octave_sigmas(cfg, octave), octave == 0))
        if octave == 0:
            h, w = 2 * h, 2 * w
        h, w = -(-h // 2), -(-w // 2)
    return work


def _k1_kernel_ms(images, cfg, iters: int, dev) -> float:
    """Each octave's K1 launch timed alone (``time_ms``), summed."""
    base, total = images.contiguous(), 0.0
    for octave in range(cfg.num_octaves):
        args = (base, octave_sigmas(cfg, octave), cfg.scales_per_octave,
                cfg.contrast_prefilter_threshold)
        total += time_ms(lambda: fused_octave(*args, upsample2x=octave == 0), iters, dev)
        _, seed, _ = fused_octave(*args, upsample2x=octave == 0)
        base = downsample2x_nn(seed).contiguous()
    return total


def _profile(fn, dev, out_dir: str) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the Chrome trace in
    ``out_dir``, the call's wall ms and the card's busy ms and share in it
    (the profiler adds host time, so the share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, "frontend_bench_trace.json")
    prof.export_chrome_trace(trace)
    out = {"trace": trace, "wall_ms": round(wall_ms, 3), "device_busy_ms": None,
           "device_busy_share": None}
    if dev.type == "cuda":
        busy = sum(e.device_time for e in prof.events() if e.device_type.name == "CUDA") / 1e3
        out.update(device_busy_ms=round(busy, 3), device_busy_share=round(busy / wall_ms, 4))
    return out


def run(batch: int = 64, iters: int = 3, blur: str = "fused", stages: bool = False,
        unified: bool = False, describe: bool = False, octaves: int = 4, profile: str | None = None,
        device="cuda", height: int = HEIGHT, width: int = WIDTH,
        copy_bytes_per_s: float = MEASURED_COPY_BYTES_PER_S,
        ops_per_s: float = MEASURED_F32_OPS_PER_S) -> dict:
    """The benchmark's JSON object (see the module)."""
    dev = probe_device(str(device))
    if blur not in BLURS:
        raise ValueError(f"frontend_bench: unknown blur {blur!r}: one of {list(BLURS)}")
    cfg = SiftConfig(num_octaves=octaves, scales_per_octave=5, max_keypoints_per_trio=512)
    if unified:
        cfg = dataclasses.replace(cfg, unified_refine=True)
    images = torch.from_numpy(make_batch(batch, height, width)).to(dev)
    launches = {}

    # --- the whole detect (measured first, as in the original) -------------
    def full():
        return detect_batched(images, cfg, blur, device=dev)

    before = launch_counts()
    (keypoints, _), detect_peak = peak_gib(full, dev)
    launches["detect"] = path_launches(before)
    require_launches(dev, launches["detect"], path_kernels(blur, False), f"detect --blur {blur}")
    n_kp = int(keypoints.valid.sum())
    del keypoints
    profiled = _profile(full, dev, profile) if profile else None
    if profiled:
        print(f"profiler trace -> {profiled['trace']}", file=sys.stderr)
    total_ms = host_ms(full, dev, iters, warmup=1)

    # --- the pyramid alone (DoG + masks) ----------------------------------
    def pyramid():
        return _pyramid(images, cfg, blur, emit_scales=False)

    pyr_ms = host_ms(pyramid, dev, iters, warmup=1)

    # --- selection vs refinement on one pyramid ----------------------------
    sel_ms = ref_ms = None
    if stages:
        dogs, masks, _ = pyramid()
        sel_ms = host_ms(lambda: _select_candidates(dogs, cfg, masks), dev, iters, warmup=1)
        ref_ms = host_ms(lambda: detect_octaves(dogs, cfg, masks), dev, iters, warmup=1) - sel_ms
        del dogs, masks

    # --- detect + describe (config[2]'s throughput leg) ---------------------
    described_out = {}
    if describe:
        def full_describe():
            return detect_and_describe_batched(images, cfg, blur, device=dev)

        before = launch_counts()
        described, describe_peak = peak_gib(full_describe, dev)
        launches["describe"] = path_launches(before)
        require_launches(dev, launches["describe"], path_kernels(blur, True),
                         f"describe --blur {blur}")
        n_desc = int(described.valid.sum())
        del described
        desc_ms = host_ms(full_describe, dev, iters, warmup=1)
        stage_ms = _describe_stages(images, cfg, blur, iters, dev)
        described_out = {
            "describe_total_ms": round(desc_ms, 2),
            "describe_frames_per_s": round(batch / (desc_ms / 1e3), 1),
            "described_keypoints_per_s": round(n_desc / (desc_ms / 1e3), 1),
            "described_keypoints_per_image": round(n_desc / batch, 1),
            "describe_peak_gib": describe_peak,
            "describe_stages_ms": stage_ms,
        }

    # --- the pyramid's least work (K1's) against the measured time -------------
    work = k1_work(cfg, batch, height, width)
    bytes_total = sum(b for b, _, _ in work)
    ideal_ms = sum(bound(b, f)[0] for b, f, _ in work)
    ideal_by = bound(bytes_total, sum(f for _, f, _ in work))[1]
    floor_ms, floor_by = reach([(b, f + s) for b, f, s in work], copy_bytes_per_s, ops_per_s)
    achieved = bytes_total / (pyr_ms / 1e3) / 1e9
    out = {
        "batch": batch,
        "blur": blur,
        "pyramid_dog_masks_ms": round(pyr_ms, 2),
        "ideal_roofline_ms": round(ideal_ms, 4),
        "ideal_roofline_by": ideal_by,
        "measured_bw_floor_ms": round(floor_ms, 4),
        "measured_bw_floor_by": floor_by,
        "achieved_gb_s": round(achieved, 1),
        "peak_gb_s": PEAK_BYTES_PER_S / 1e9,
        "roofline_fraction": round(ideal_ms / pyr_ms, 3),
        "detection_tail_ms": round(total_ms - pyr_ms, 2),
        "total_ms": round(total_ms, 2),
        "frames_per_s": round(batch / (total_ms / 1e3), 1),
        "keypoints_per_image": round(n_kp / batch, 1),
        "keypoints_per_s": round(n_kp / (total_ms / 1e3), 1),
        "detect_peak_gib": detect_peak,
        "octaves": octaves,
        "unified": unified,
        "image": f"{width}x{height}",
        "launches": launches,
    }
    if blur == "fused":
        out["fused_octave"] = {
            "launches": launches["detect"]["fused_octave"],
            "ms": round(_k1_kernel_ms(images, cfg, max(iters, 3), dev), 4),
            "bound_ms": round(ideal_ms, 4),
            "bound_by": ideal_by,
            "reach_ms": round(floor_ms, 4),
            "reach_by": floor_by,
        }
    if sel_ms is not None:
        out["selection_ms"] = round(sel_ms, 2)
        out["refinement_ms"] = round(ref_ms, 2)
    out.update(described_out)
    if profiled:
        out["profile"] = profiled
    out["device"] = device_entry(dev)
    return out


def _describe_stages(images, cfg, blur, iters, dev) -> dict:
    """The describe path's stages with a synchronise between them, mean ms
    over ``iters`` runs after one warm-up: the pyramid with its Gaussian
    stacks, selection + refinement, compaction + orientation, descriptors.
    The route is the path's own (the kernels on the card): the descriptor
    stage is marked where ``describe_compact`` enters it
    (:func:`describe_stage_calls`)."""
    marks, totals = [], [0.0] * 4

    def mark(name):
        if name == "descriptor":
            sync(dev)
            marks.append(time.perf_counter())

    with describe_stage_calls(mark):
        for i in range(iters + 1):
            marks.clear()
            sync(dev)
            t0 = time.perf_counter()
            dogs, masks, stacks = _pyramid(images, cfg, blur, emit_scales=True)
            sync(dev)
            t1 = time.perf_counter()
            _, selected = _select_candidates(dogs, cfg, masks)
            keypoints = _refine_per_octave(dogs, selected, cfg)
            sync(dev)
            t2 = time.perf_counter()
            describe_compact(stacks, keypoints, cfg)
            sync(dev)
            t3 = time.perf_counter()
            if i:
                for k, dt in enumerate((t1 - t0, t2 - t1, marks[0] - t2, t3 - marks[0])):
                    totals[k] += dt
    names = ("pyramid_with_stacks", "selection_refinement", "orientation", "descriptor")
    return {n: round(1e3 * t / iters, 2) for n, t in zip(names, totals)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--blur", default="fused", choices=list(BLURS),
                    help="pyramid strategy (fused = the octave kernel K1; cuda/pallas = the "
                    "blur kernel K3 once per blurred scale; separable/matmul = plain PyTorch)")
    ap.add_argument("--stages", action="store_true",
                    help="also time candidate selection and refinement separately")
    ap.add_argument("--unified", action="store_true",
                    help="one cross-octave refinement pass (cfg.unified_refine)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of one detect call to DIR")
    ap.add_argument("--describe", action="store_true",
                    help="also time the detect+describe path (orientations + 128-D "
                    "descriptors), BASELINE config[2]'s throughput leg")
    ap.add_argument("--octaves", type=int, default=4, help="num_octaves (bench default 4)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    probe_device(args.device)
    out = run(batch=args.batch, iters=args.iters, blur=args.blur, stages=args.stages,
              unified=args.unified, describe=args.describe, octaves=args.octaves,
              profile=args.profile, device=args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
