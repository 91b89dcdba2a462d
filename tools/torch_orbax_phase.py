#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 19 alone, on one GPU: the JAX package's orbax
checkpoints (``tests/fixtures/jax_orbax/``) read by the port's own zstd,
OCDBT and zarr readers, and BASELINE config[3] resumed from one on the card.

Run from the repository root: ``python3 tools/torch_orbax_phase.py``. It
prints the card's name and power limit, runs config[3] uninterrupted on the
card for the ATE phase 15 (g) would print, then the phase's lines as
``chip_smoke.py`` prints them; it exits non-zero on any failure or where
there is no CUDA device. No kernel is built: the phase launches none.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    import sift_scale_space_extrema_detection_tpu_torch as port
    from sift_scale_space_extrema_detection_tpu_torch.utils import synthetic

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    seq = chip_smoke._orbit_sequence(synthetic)
    orbit = port.run_slam(seq.pixels, seq.visible, seq.k_mat, port.SlamConfig(), device=device)
    orbit_ate = port.evaluate_ate(orbit, seq.rotations, seq.translations, device=device)
    print(f"config[3] uninterrupted on the card: ATE {orbit_ate:.6f}, valid landmarks "
          f"{int(np.sum(orbit.landmark_valid))}", flush=True)
    t0 = time.perf_counter()
    launches = chip_smoke._phase_orbax(torch, port, smi, device, orbit_ate)
    print(f"phase 19 {time.perf_counter() - t0:.1f} s, launches {dict(launches)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
