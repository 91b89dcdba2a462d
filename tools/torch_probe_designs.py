#!/usr/bin/env python3
"""Time the probes' streaming write and copy (K4, K5) on one card against
their other designs and PyTorch's own calls, timed two ways.

The other designs are in ``tools/probe_designs.cu`` (built here with the
port's nvcc flags): the port's first design (``first``, a grid-stride loop)
and a Hopper bulk-copy ring (``bulk``). ``chip_smoke.py``'s phase 21 times
them beside the port's kernels through :func:`yardsticks`.

First both designs and the port's wrappers are held bit for bit against
``clone`` / ``fill_`` at the edge sizes (4 elements, a stretch of 256
float4s and 16 bytes, a 32 KiB chunk and 16 bytes, a count of chunks and of
stretches that does not divide among the blocks, the whole buffer, a view
16 bytes into its buffer), each output NaN before the call. Then, for
``--rounds`` rounds, every function is timed on a ``--gb`` GiB buffer
(65,536 × 4,096 float32 at 1.0) in one sequence of turns (in order and
back, ``--reps`` calls a turn; the copy also as the port's kernel launched
straight into one kept output, without the wrapper), each turn two ways:

- ``held_ms``: the calls enqueued while a sleeping kernel holds the stream
  (``chip_smoke._held_ms``, as phase 21 times), so the reading is the
  card's time alone; ``host_us``, the host's µs to enqueue one call;
- ``ahead_ms``: the calls enqueued behind one untimed call, so the card
  waits wherever the host takes longer to launch a call than the card
  takes to run the one before.

Then the copy's time as it depends on its buffers: from each of SOURCES
sources into each of DESTINATIONS destinations (``--pairs``, 3 × 4 by
default; allocations of their own, all alive at once, the first source the
timed buffer and the first destination the block the wrapper's outputs
took) the port's kernel,
the first design, the bulk ring and ``copy_`` (the kernel ``clone`` runs)
in turns, held, for each pair.

Run from the repository root: ``python3 tools/torch_probe_designs.py [--gb
1.0] [--reps 20] [--rounds 3] [--pairs 3 4] [--sass FILE]`` (exits 1
without a card; ``--sass`` writes ``cuobjdump -sass`` of the designs).
Prints the card's ``nvidia-smi`` name and power limit, one JSON line a
function a round, one a pair, and each design's least and greatest ratio to
``copy_`` over the pairs.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sift_scale_space_extrema_detection_tpu_torch.benchmarks import card_smi, time_ms  # noqa: E402
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import _build, probes  # noqa: E402

SOURCE = REPO / "tools" / "probe_designs.cu"
CHUNK = 32 * 1024 // 4  # float32 elements in a bulk copy's 32 KiB chunk
STRETCH = 256 * 4  # float32 elements in a block's stretch of the port's kernels

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "designs_error_string": ([_I], ctypes.c_char_p),
    "designs_first_write": ([_P, _LL, _F, _P], _I),
    "designs_first_copy": ([_P, _P, _LL, _P], _I),
    "designs_bulk_write": ([_P, _LL, _F, _P], _I),
    "designs_bulk_copy": ([_P, _P, _LL, _P], _I),
}


@functools.cache
def load_designs() -> ctypes.CDLL:
    """Build (once per source version) and load ``probe_designs.cu``."""
    lib = ctypes.CDLL(str(_build.build_library([SOURCE], "probe_designs", [])))
    for name, (argtypes, restype) in _SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    return lib


def _launch(name: str, *args) -> None:
    lib = load_designs()
    rc = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed: CUDA error {rc} "
                           f"({lib.designs_error_string(rc).decode()})")


def yardsticks(x: torch.Tensor, out: torch.Tensor | None = None) -> dict:
    """``{"copy": {"first": fn, "bulk": fn}, "write": {...}}``: the first
    design and the bulk ring, copying ``x`` (a CUDA float32 tensor, 16-byte
    aligned, a multiple of 4 elements) into, or writing 1.25 into, ``out``
    (by default a new tensor of NaN of ``x``'s shape), which every ``fn()``
    returns (the closures hold it, so it lives as long as they do)."""
    out = torch.full_like(x, float("nan")) if out is None else out
    n, s, d, v = x.numel(), x.data_ptr(), out.data_ptr(), probes.WRITE_VALUE

    def call(name, *args):
        _launch(name, *args)
        return out

    return {
        "copy": {"first": functools.partial(call, "designs_first_copy", s, d, n),
                 "bulk": functools.partial(call, "designs_bulk_copy", s, d, n)},
        "write": {"first": functools.partial(call, "designs_first_write", d, n, v),
                  "bulk": functools.partial(call, "designs_bulk_write", d, n, v)},
    }


def edge_sizes(sms: int, gb: float) -> dict:
    """Element counts at the designs' edges on a card of ``sms``
    multiprocessors: 4; a stretch and 16 bytes; a chunk and 16 bytes; a
    count of chunks one more than a multiple of the bulk ring's blocks (one
    a multiprocessor) whose last chunk is short, which is also a count of
    stretches that does not divide among 8 resident blocks a
    multiprocessor; the whole ``gb`` GiB buffer."""
    return {"4": 4, "stretch+16B": STRETCH + 4, "chunk+16B": CHUNK + 4,
            "ragged": (8 * sms * 3 + 1) * CHUNK - 4 * 5,
            "buffer": probes.probe_rows(gb) * probes.LANE_W}


def check(dev: torch.device, gb: float) -> dict:
    """Both designs and the port's wrappers against ``clone`` / ``fill_`` bit
    for bit at :func:`edge_sizes` and on a view 16 bytes into its buffer;
    exits on a difference. Returns ``{size: elements}``."""
    sizes = edge_sizes(torch.cuda.get_device_properties(dev).multi_processor_count, gb)
    gen = torch.Generator(device=dev).manual_seed(1)
    for label, n in [*sizes.items(), ("view+16B", 4096)]:
        base = torch.randn(n + 8, generator=gen, device=dev)
        x = base[4 : 4 + n] if label == "view+16B" else base[:n]
        fill = torch.empty_like(x).fill_(probes.WRITE_VALUE)
        for kind, fns in yardsticks(x).items():
            for name, fn in fns.items():
                got = fn()
                if not torch.equal(got, x if kind == "copy" else fill):
                    raise SystemExit(f"{kind} design {name} differs from its plain version at "
                                     f"{label} ({n} elements)")
                got.fill_(float("nan"))
        landed = {"probe_copy": (lambda: probes.probe_copy(x), x),
                  "probe_write": (lambda: probes.probe_write(1, n, dev).view(-1), fill)}
        for name, (fn, want) in landed.items():
            if not torch.equal(chip_smoke._on_poison(torch, n, dev, fn), want):
                raise SystemExit(f"{name} differs from its plain version at {label} ({n} elements)")
    torch.cuda.synchronize()
    return sizes


def turns(fns: dict, reps: int) -> dict:
    """Each of ``fns`` warmed up, then in one sequence of turns, the names
    in order and back, each turn held and then ahead: ``{name: {"held_ms",
    "ahead_ms", "host_us", "held"}}``, the means of its two turns (``held``:
    whether every held turn was enqueued before its hold ended)."""
    for fn in fns.values():
        fn()
    got = {name: [] for name in fns}
    for name in [*fns, *reversed(fns)]:
        held_ms, host_us, held = chip_smoke._held_ms(torch, fns[name], reps)
        ahead_ms = time_ms(fns[name], reps, torch.device("cuda"))
        got[name].append((held_ms, ahead_ms, host_us, held))
    return {name: {"held_ms": sum(t[0] for t in r) / 2, "ahead_ms": sum(t[1] for t in r) / 2,
                   "host_us": sum(t[2] for t in r) / 2, "held": all(t[3] for t in r)}
            for name, r in got.items()}


def copy_into(src: torch.Tensor, dst: torch.Tensor):
    """``fn()``: the port's copy kernel launched straight from ``src`` into
    ``dst`` (no wrapper: nothing allocated; counted as ``probe_copy``);
    returns ``dst``."""
    lib = _build.load_kernels()

    def fn():
        rc = lib.sift_probe_copy(src.data_ptr(), dst.data_ptr(), src.numel(),
                                 torch.cuda.current_stream().cuda_stream)
        _build.check_launch(lib, rc, "probe_copy")
        return dst

    return fn


def pairs(x: torch.Tensor, n_src: int, n_dst: int, reps: int, smi: str) -> list:
    """The copy from each of ``n_src`` sources into each of ``n_dst``
    destinations, all allocations of ``x``'s shape alive at once: the port's
    kernel (launched into the destination), the first design, the bulk ring
    and ``copy_`` (the kernel ``clone`` runs) in one sequence of turns for
    each pair, each copy checked once. The first source is ``x`` and the
    first destination the block that ``probe_copy(x)``'s outputs take. One
    JSON line a pair."""
    wrapper_block = probes.probe_copy(x).data_ptr()
    dsts = [torch.empty_like(x) for _ in range(n_dst)]
    gen = torch.Generator(device=x.device).manual_seed(2)
    srcs = [x] + [torch.randn(x.shape, generator=gen, device=x.device) for _ in range(n_src - 1)]
    rows = []
    for i, src in enumerate(srcs):
        for j, dst in enumerate(dsts):
            fns = {"copy_": functools.partial(dst.copy_, src), "probe_copy": copy_into(src, dst),
                   **yardsticks(src, dst)["copy"]}
            for name, fn in fns.items():
                dst.fill_(float("nan"))
                if not torch.equal(fn(), src):
                    raise SystemExit(f"copy {name} differs from its source at pair {i}, {j}")
            times = turns(fns, reps)
            rows.append({"src": i, "dst": j, "wrapper_block": dst.data_ptr() == wrapper_block,
                         "gib_apart": (dst.data_ptr() - src.data_ptr()) / 2**30,
                         **{name: t["held_ms"] for name, t in times.items()},
                         **{f"{name}_vs_copy_": t["held_ms"] / times["copy_"]["held_ms"]
                            for name, t in times.items() if name != "copy_"}, "smi": smi})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gb", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--pairs", type=int, nargs=2, default=(3, 4), metavar=("SOURCES", "DESTINATIONS"))
    ap.add_argument("--sass", help="write cuobjdump -sass of the designs to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the designs run on the card only", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = card_smi()
    print(smi, flush=True)
    print(json.dumps({"bit_equal": check(dev, args.gb)}), flush=True)
    rows = probes.probe_rows(args.gb)
    x = torch.randn((rows, probes.LANE_W), generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    nbytes = x.numel() * 4
    other = yardsticks(x)
    kinds = {
        "copy": (2, {"clone": x.clone, "x + 0.0": lambda: x + 0.0, **other["copy"],
                     "probe_copy": lambda: probes.probe_copy(x),
                     "kernel into one output": copy_into(x, other["copy"]["first"]())}),
        "write": (1, {"fill_": lambda: torch.empty_like(x).fill_(probes.WRITE_VALUE),
                      "torch.full": lambda: torch.full_like(x, probes.WRITE_VALUE),
                      **other["write"], "probe_write": lambda: probes.probe_write(rows, probes.LANE_W, dev)}),
    }
    for r in range(args.rounds):
        for kind, (k, fns) in kinds.items():
            times = turns(fns, args.reps)
            library = times[next(iter(fns))]
            for name, t in times.items():
                print(json.dumps({"round": r, "kind": kind, "design": name, **t,
                                  "held_gb_s": k * nbytes / t["held_ms"] / 1e6,
                                  "held_vs_library": t["held_ms"] / library["held_ms"],
                                  "ahead_vs_library": t["ahead_ms"] / library["ahead_ms"],
                                  "smi": smi}), flush=True)
    copies = pairs(x, *args.pairs, args.reps, smi)
    for name in ("probe_copy", "first", "bulk"):
        ratios = [r[f"{name}_vs_copy_"] for r in copies]
        print(json.dumps({"pairs": len(ratios), "design": name, "min_vs_copy_": min(ratios),
                          "max_vs_copy_": max(ratios), "over_copy_": sum(q > 1 for q in ratios)}), flush=True)
    if args.sass:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        text = subprocess.run([tool, "-sass", load_designs()._name], capture_output=True,
                              text=True, check=True).stdout
        Path(args.sass).parent.mkdir(parents=True, exist_ok=True)
        Path(args.sass).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
