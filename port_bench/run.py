"""Run one cell of the port's benchmark and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the port (``sift_scale_space_extrema_detection_tpu_torch``). The cell
(``BENCHMARK.json``'s ``workloads``) names its configuration and traffic
files; its runner makes the inputs from ``--seed`` on the card, warms up,
measures for ``--seconds`` (``--trace 0``: the end-to-end metrics) or
traces (``--trace 1``: the per-layer metrics), then holds a sample of the
window's outputs to the plain reference under ``reference/``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), then ``checks``, each compared number beside its limit,
which also end standard error. No result, and a non-zero exit, where
there is no CUDA device or fewer than the cell asks for, or where JAX or
the JAX package was loaded into the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Import this folder as the package ``port_bench`` from the checkout's root
# (the script's own folder first on the path would shadow standard modules).
sys.path[0] = str(ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "sift_scale_space_extrema_detection_tpu")
CACHE = ROOT / "port_bench" / ".cache"


def forbidden_modules() -> list[str]:
    """Modules whose top-level name, compared whole, is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernels build into ``ops/kernels/build/`` there too)."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))


def measure(cell: dict, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> dict:
    """One run of ``cell`` on ``device``: its runner's window, then the
    output check once the window has closed and the program's frames are
    freed. Returns the result line (see the module)."""
    import torch

    from port_bench import compare, spec

    runner = spec.runner(cell["traffic"]["runner"])
    out = runner.run(cell, seed, seconds, trace, device, t_start)
    out["frontend"].program_ring = None  # the program's state; the frames as made stay
    if device.type == "cuda":
        torch.cuda.empty_cache()
    per_batch = runner.check(out["frontend"], out["sample"])
    limits = cell["config"]["checks"]
    correct, checks = compare.verdict(compare.worst(per_batch), limits)
    summary = out["summary"]
    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        value = m["read"](summary)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    if trace:
        dev.update(busy_s=summary["loop"]["busy_s"], window_s=summary["loop"]["window_s"])
    line = {"correct": correct, "attempted": summary["batches"],
            "failed": sum(not compare.verdict(g, limits)[0] for g in per_batch),
            "metrics": metrics, "device": dev}
    if trace:
        line["breakdown"] = out["breakdown"]
    line["readings"] = summary["readings"]
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _environment()
    import torch

    from port_bench import spec

    cell = spec.cell(spec.load_benchmark(), args.workload)
    chips = cell["workload"]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"port_bench: the cell asks for {chips} CUDA device(s), {found} found",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                   T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"port_bench: the process loaded {loaded}; the benchmark runs without JAX",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
