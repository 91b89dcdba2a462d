#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 23 alone on one card: ``benchmarks.scatter_probe``
at the script's size and at 16x its observations and landmarks, and
``benchmarks.scaling_bench --devices 1`` through its torchrun route on one
NCCL rank (each leg's path kernels launched by its ranks). Builds the kernels first, so
that the rank loads them.

Run from the repository root: ``python3 tools/torch_scaling_phase.py``
(exits 1 without a card).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sift_scale_space_extrema_detection_tpu_torch.benchmarks import card_smi  # noqa: E402
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import _build  # noqa: E402


def main() -> int:
    chip_smoke._require(torch.cuda.is_available(), "no CUDA device")
    smi = card_smi()
    chip_smoke._say(smi)
    _build.load_kernels()
    chip_smoke._phase_scaling(torch, smi, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
