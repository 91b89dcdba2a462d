#!/usr/bin/env python3
"""``chip_smoke.py``'s phases 15 and 17 alone, on one GPU: SLAM (whose
readings phase 17 is held against) and sharding, without the rest of the
script (about two and a half minutes on one H100 against four).

Run from the repository root: ``python3 tools/torch_sharding_phases.py``.
It builds the kernels, prints the card's name and power limit, then each
phase's lines as ``chip_smoke.py`` prints them, and exits non-zero on any
failure or where there is no CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    import sift_scale_space_extrema_detection_tpu_torch as port
    from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.load_kernels()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    refs = chip_smoke._phase_slam(torch, port, smi, dev)[4]
    t1 = time.perf_counter()
    launches, _, _ = chip_smoke._phase_sharding(torch, port, smi, dev, refs)
    print(f"phase 15 {t1 - t0:.1f} s, phase 17 {time.perf_counter() - t1:.1f} s, phase 17's "
          f"launches K1/K2/K3/R1/R2 {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
