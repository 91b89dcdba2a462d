"""The card's rate of shifted products and sums: the blur passes' arithmetic.

The port of the JAX package's ``benchmarks/tap_probe.py``: a ``(rows, W)``
float32 output (256 × 1024 by default) from a ``(rows + 13, W)`` float32
input of standard normals (seed 0), through 64 repetitions of 13 taps (a
Gaussian of sigma 2, normalised): 832 products and 831 sums an element, in
four precisions (``ops/kernels/probes.py::tap_chain``):

- ``f32`` — float32 products and sums, none fused (the octave and blur
  kernels' arithmetic);
- ``bf16_carry`` — bf16 products, float32 sums;
- ``bf16_full`` — bf16 products and sums;
- ``bf16_pair`` — bf16 products summed in bf16 two by two, the pairs in
  float32.

Each mode is timed over ``--iters`` back-to-back calls with CUDA events
(nothing subtracted, see ``bw_probe.py``). ``ps_per_el_tap`` is the time
over rows × W × 832; ``speedup`` is the ``f32`` time over the mode's;
``max_rel_err`` is the mode's largest difference from the ``f32`` output
over the largest ``|f32 output|``.

Run: ``python -m sift_scale_space_extrema_detection_tpu_torch.benchmarks.tap_probe
[--rows 256] [--width 1024] [--iters 60] [--device cuda|cpu]``. Prints one
JSON line: the four modes' readings, the shape, the device and the card's
``nvidia-smi`` name and power limit (``smi``). ``--device cpu`` runs the
plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops.kernels.probes import NTAPS, REPS, ROWS, TAP_MODES, W, probe_taps, tap_chain
from . import card_smi, probe_device, time_ms

ITERS = 60


def probe_input(rows: int = ROWS, width: int = W, seed: int = 0) -> torch.Tensor:
    """The original's input: ``(rows + 13, width)`` float32 standard normals
    from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((rows + NTAPS, width)).astype(np.float32))


def measure(rows: int = ROWS, width: int = W, iters: int = ITERS, device="cuda") -> dict:
    """Each mode's ``ms``, ``ps_per_el_tap`` and (beside ``f32``) ``speedup``
    and ``max_rel_err``, on ``device``."""
    dev = torch.device(device)
    x = probe_input(rows, width).to(dev)
    taps = probe_taps().to(dev)
    res = {}
    base = ref = None
    for mode in TAP_MODES:
        t = time_ms(lambda: tap_chain(x, taps, mode), iters, dev)
        out = tap_chain(x, taps, mode)
        res[mode] = {"ms": round(t, 4), "ps_per_el_tap": round(t * 1e9 / (rows * width * REPS * NTAPS), 4)}
        if mode == "f32":
            base, ref = t, out
        else:
            res[mode]["speedup"] = round(base / t, 3)
            res[mode]["max_rel_err"] = float(
                (out - ref).abs().max() / (ref.abs().max() + 1e-9)
            )
    res.update(
        rows=rows,
        width=width,
        iters=iters,
        platform="gpu" if dev.type == "cuda" else "cpu",
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        smi=card_smi() if dev.type == "cuda" else None,
    )
    return res


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = probe_device(args.device)
    print(json.dumps(measure(args.rows, args.width, args.iters, device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
