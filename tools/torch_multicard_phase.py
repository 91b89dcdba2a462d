#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 20 alone: the port's sharded paths on four
cards of one host, over NCCL, one rank a card (``chip_smoke._phase_multicard``
with its own single-card references on ``cuda:0``); then the scaling runs
that need the four cards: ``benchmarks.scaling_bench --devices 4`` at the
script's ``--batch-per-device 2`` and at 64 (bench's 64 frames a card), and
``benchmarks.multihost_bench --nproc 2`` (the four ranks as one host, then
as two of two), each line its JSON object.

Run from the repository root on a machine with four NVIDIA GPUs:
``python3 tools/torch_multicard_phase.py``. It prints each card's name and
power limit, builds the kernels once (the ranks load the built library),
then the phase's lines, and exits non-zero on any failure and where fewer
than four cards are visible.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    import sift_scale_space_extrema_detection_tpu_torch as port
    from sift_scale_space_extrema_detection_tpu_torch.benchmarks import (
        multihost_bench,
        scaling_bench,
    )
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import _build

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chip_smoke.MULTICARD_WORLD:
        print(f"phase 20 needs {chip_smoke.MULTICARD_WORLD} CUDA devices, {cards} visible",
              file=sys.stderr)
        return 1
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    for card, line in enumerate(lines):
        print(f"card {card}: {line}", flush=True)
    smi = "; ".join(lines)
    t0 = time.perf_counter()
    _build.load_kernels()
    print(f"build: kernels built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    launches, octave_err, sample_err, blur_err = chip_smoke._phase_multicard(
        torch, port, smi, torch.device("cuda", 0))
    print(f"phase 20 {time.perf_counter() - t0:.1f} s on {cards} cards: the ranks' main paths "
          f"launched K1/K2/K3/R1/R2 {launches}; largest kernel vs plain differences K1 "
          f"{octave_err}, K2 {sample_err}, K3 {blur_err}", flush=True)

    world = chip_smoke.MULTICARD_WORLD
    runs = [(f"scaling_bench --devices {world} --batch-per-device {bpd}",
             lambda bpd=bpd: scaling_bench.run(devices=world, batch_per_device=bpd))
            for bpd in (2, 64)]
    runs.append(("multihost_bench --nproc 2", lambda: multihost_bench.run(nproc=2, world=world)))
    for name, fn in runs:
        t0 = time.perf_counter()
        out = fn()
        print(f"{name} ({time.perf_counter() - t0:.1f} s) [{smi}]: {json.dumps(out)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
