"""``control.py`` for the photo-collection cells (``runners/photos.py``):
the readings that their limits of ``checks`` are set from, on many seeds
in one process.

    python3 port_bench/photos_control.py --workload <name> --seeds 11 12 13 ... [--batches 4]

For each seed, as ``control.py`` does it: the cell's frames, the entry
warmed up, ``--batches`` batches run as the benchmark runs them, the same
sample of them drawn from the seed, and each sampled batch held to the
budgeted plain reference twice: the program's output (the lower reading)
and the control's, the reference computed with its float32 matrix
products in TF32 (the upper reading). One JSON line a seed, then one with
the largest lower and the smallest upper reading of each number. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def readings(cell: dict, seed: int, batches: int, device) -> dict:
    """``{"program": worst gaps, "control": worst gaps}`` of one seed."""
    import torch

    from port_bench import compare
    from port_bench.runners import frontend, photos

    traffic = cell["traffic"]
    fr = photos.Photos(cell["config"], traffic, seed, device)
    for _ in range(traffic["warmup_batches"]):
        fr.call(fr.next_frames()[1])
    sample = frontend.Sample(traffic["check_batches"], seed)
    for _ in range(batches):
        offset, images = fr.next_frames()
        sample.offer(offset, fr.call(images))
    fr.program_ring = None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    return {"program": compare.worst(photos.check(fr, sample)),
            "control": compare.worst(photos.check(fr, sample, control=True))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--batches", type=int, default=4)
    args = ap.parse_args(argv)
    import torch

    from port_bench import compare, spec

    if not torch.cuda.is_available():
        print("photos_control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.cell(spec.load_benchmark(), args.workload)
    device = torch.device("cuda", 0)
    lower, upper = {}, {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(cell, seed, args.batches, device)
        for n in compare.NAMES:
            if n in r["program"]:
                lower[n] = max(lower.get(n, 0.0), r["program"][n])
                upper[n] = min(upper.get(n, float("inf")), r["control"][n])
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0, **r}), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
