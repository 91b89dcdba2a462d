#!/usr/bin/env python3
"""Whether ``evaluate`` solves ``chip_smoke.py`` phase 16's on-disk rehearsal
sequences, in the port and in the JAX package, and under which flags.

Run from the repository root, for example:

    python3 tools/torch_evaluate_rehearsal.py --format tum --device cpu \\
        --max-frames 40 --jax --variant "" --variant "--match-gate 30"

It writes one rehearsal sequence once (``chip_smoke.write_rehearsal_sequence``:
``--frames`` frames of ``benchmarks/slam_bench.py``'s dolly, seed 0, at
640×480 in the TUM layout or 1241×376 in the KITTI layout, by the port's
writers) under ``build/``, then for each ``--variant`` (a string of
``evaluate`` flags, ``""`` for its defaults) runs:

- the port's ``evaluate.main`` in-process with ``--device`` (``cuda`` or
  ``cpu``; with ``--cpu-too`` also with ``--device cpu``);
- with ``--jax``, the JAX package's evaluator as a subprocess on the CPU
  (``JAX_PLATFORMS=cpu``; the port never imports that package, and the card's
  machine has no jax).

``--max-frames`` cuts every run to the sequence's first frames. Each run
prints one JSON line: the package, the device, the flags, its wall seconds,
and ``evaluate``'s own metrics (frames, SLAM frames/s, landmarks, ATE, RPE,
RRE), or, where the JAX evaluator fails, its exit code and last error
lines. The JAX evaluator has no ``--max-tracks``: leave it out of a variant
run with ``--jax``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shlex
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--format", choices=["tum", "kitti"], default="tum")
    ap.add_argument("--frames", type=int, default=chip_smoke.SURFACE_FRAMES,
                    help="frames written")
    ap.add_argument("--max-frames", type=int, default=None, help="frames each run reads")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--cpu-too", action="store_true", help="also run the port with --device cpu")
    ap.add_argument("--jax", action="store_true", help="also run the JAX package's evaluator")
    ap.add_argument("--variant", action="append", default=None,
                    help="evaluate flags, quoted; repeat for several (default: one, no flags)")
    ap.add_argument("--threads", type=int, default=4, help="CPU threads of the port's CPU runs")
    args = ap.parse_args()

    import torch

    from sift_scale_space_extrema_detection_tpu_torch import evaluate

    torch.set_num_threads(args.threads)
    size = (chip_smoke.WIDTH, chip_smoke.HEIGHT) if args.format == "tum" else chip_smoke.KITTI_SIZE
    work = os.path.join(ROOT, "build", f"evaluate_rehearsal_{args.format}")
    t0 = time.perf_counter()
    argv, _, _ = chip_smoke.write_rehearsal_sequence(args.format, work, args.frames, size)
    print(json.dumps({"wrote": args.format, "frames": args.frames, "size": list(size),
                      "seconds": round(time.perf_counter() - t0, 2)}), flush=True)
    cut = [] if args.max_frames is None else ["--max-frames", str(args.max_frames)]
    devices = [args.device] + (["cpu"] if args.cpu_too and args.device != "cpu" else [])

    def report(package, device, flags, seconds, text):
        metrics = json.loads(text.strip().splitlines()[-1])
        print(json.dumps({"package": package, "device": device, "flags": flags,
                          "seconds": round(seconds, 2), **metrics}), flush=True)

    for variant in args.variant or [""]:
        flags = shlex.split(variant)
        for device in devices:
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = evaluate.main(argv + cut + flags + ["--device", device])
            if rc != 0:
                raise SystemExit(f"the port's evaluate {variant!r} on {device}: exit code {rc}")
            report("torch", device, variant, time.perf_counter() - t0, out.getvalue())
        if args.jax:
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-m", "sift_scale_space_extrema_detection_tpu.evaluate",
                 *argv, *cut, *flags],
                cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu"},
                capture_output=True, text=True,
            )
            if run.returncode == 0:
                report("jax", "cpu", variant, time.perf_counter() - t0, run.stdout)
            else:  # a fault of the reference is a finding, not the end of the run
                error = [ln for ln in run.stderr.splitlines() if ln.strip()][-3:]
                print(json.dumps({"package": "jax", "device": "cpu", "flags": variant,
                                  "exit_code": run.returncode, "error": error}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
