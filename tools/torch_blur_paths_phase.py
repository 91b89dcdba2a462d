#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 18 alone, on one GPU: the blur-by-blur
frontend (``blur="cuda"``) on the detect, describe, sharded, SLAM, streaming
and ``evaluate`` paths, and the pooled refinement flags, without the rest of
the script.

Run from the repository root: ``python3 tools/torch_blur_paths_phase.py``.
It builds the kernels, prints the card's name and power limit, then the
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
    t0 = time.perf_counter()
    launches, sample_err = chip_smoke._phase_blur_paths(torch, port, smi, torch.device("cuda", 0))
    print(f"phase 18 {time.perf_counter() - t0:.1f} s, launches K1/K2/K3/R1/R2 {launches}, "
          f"K2 against its plain version {sample_err:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
