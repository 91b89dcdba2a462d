#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 21 alone on one card: the probes' entry
points (``benchmarks.bw_probe``, ``benchmarks.tap_probe``), K4-K7 against
their plain versions at the originals' shapes, their times in turns beside
the library's, and the tap chain's opcodes in ``cuobjdump -sass``.

K1's and K3's reach needs their launches from phases 5 and 10, so only the
whole ``chip_smoke.py`` prints it. Builds the kernels at first use.

Run from the repository root: ``python3 tools/torch_probes_phase.py``
(exits 1 without a card).
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sift_scale_space_extrema_detection_tpu_torch.benchmarks import card_smi  # noqa: E402


def main() -> int:
    chip_smoke._require(torch.cuda.is_available(), "no CUDA device")
    smi = card_smi()
    chip_smoke._say(smi)
    records, _ = chip_smoke._phase_probes(torch, smi, torch.device("cuda", 0))
    print(json.dumps({"kernels": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
