"""Frames/s of the port's batched SIFT frontend on one card (BASELINE.json config[1]).

The port of the JAX package's root ``bench.py``: steady-state throughput of
``detect_batched`` (Gaussian pyramid → DoG → extrema → refinement) on 64 ×
480×640 float32 frames at 4 octaves × 5 scales,
``max_keypoints_per_trio=512``, through the fused octave kernel (K1,
``--blur fused``, the default) or another frontend path (``--blur``).

Timing: two warm-up calls, then six calls back to back, timed by the
host clock up to a ``torch.cuda.synchronize()`` (nothing is subtracted:
there is no dispatch tunnel to discount).

``vs_baseline`` is the frames/s over the original's baseline, 0.0945
frames/s: the float64 oracle (``utils/oracle.py``) on one 640×480 frame at
the same configuration, measured on one host CPU core. It is a CPU figure,
not a card's.

Run: ``python -m sift_scale_space_extrema_detection_tpu_torch.benchmarks.bench
[--blur fused] [--device cuda|cpu]``.
Prints one JSON line: ``metric``, ``value``, ``unit``, ``vs_baseline``,
``keypoints_per_s``, the kernels' ``launches`` in one call and ``device``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..config import SiftConfig
from ..models.frontend import detect_batched
from . import (
    device_entry,
    host_ms,
    launch_counts,
    path_kernels,
    path_launches,
    probe_device,
    require_launches,
)

# The original's baseline (bench.py:28): utils/oracle.py on one 640x480
# frame at 4 octaves x 5 scales, 10.58 s a frame on one host CPU core.
ORACLE_BASELINE_FPS = 0.0945
BATCH, HEIGHT, WIDTH = 64, 480, 640
ITERS = 6
BLURS = ("fused", "separable", "matmul", "cuda", "pallas")


def make_batch(batch: int, h: int, w: int) -> np.ndarray:
    """The benchmark's frames: a smooth pattern with four blobs plus noise,
    quantised to 8-bit levels (``bench.py::_make_batch``,
    ``benchmarks/frontend_bench.py::make_batch``)."""
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


def bench_config() -> SiftConfig:
    """The bench's configuration: 4 octaves × 5 scales, 512 keypoints a trio."""
    return SiftConfig(num_octaves=4, scales_per_octave=5, max_keypoints_per_trio=512)


def run(batch: int = BATCH, height: int = HEIGHT, width: int = WIDTH, iters: int = ITERS,
        blur: str = "fused", device="cuda") -> dict:
    """The benchmark's JSON object (see the module)."""
    dev = probe_device(str(device))
    cfg = bench_config()
    images = torch.from_numpy(make_batch(batch, height, width)).to(dev)

    def call():
        return detect_batched(images, cfg, blur, device=dev)

    before = launch_counts()
    keypoints, _ = call()
    launches = path_launches(before)
    require_launches(dev, launches, path_kernels(blur, False), f"bench --blur {blur}")
    ms = host_ms(call, dev, iters, warmup=1)  # the call above and this one warm up
    fps = batch / (ms / 1e3)
    n_kp = int(keypoints.valid.sum())
    return {
        "metric": "sift_frontend_frames_per_s_per_chip",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / ORACLE_BASELINE_FPS, 2),
        "keypoints_per_s": round(fps * n_kp / batch, 1),
        "baseline": "0.0945 frames/s: utils/oracle.py in float64 on one host CPU core (not a card)",
        "blur": blur,
        "batch": batch,
        "image": f"{width}x{height}",
        "launches": launches,
        "device": device_entry(dev),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blur", default="fused", choices=BLURS,
                    help="frontend path (fused = the octave kernel K1; cuda/pallas = the blur "
                    "kernel K3)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    probe_device(args.device)
    out = run(blur=args.blur, device=args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
