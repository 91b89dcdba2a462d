"""What a boundary between hosts costs the landmark-sharded BA: one host
against ``--nproc``, on the same world.

The port of the JAX package's ``benchmarks/multihost_bench.py``. The script
ran the same 8-device mesh owned by one process, then split across
processes joined by gloo (its stand-in for the network between hosts). The
port runs the same world of ranks, one a card (every visible card), twice
on ``ba_bench.make_problem(default_rng(0), 48, 32768, 512)``: 5 LM
iterations of ``distributed_bundle_adjust`` (landmarks sharded, the
camera side replicated), one warm-up and 3 timed repeats, rank 0's host
clock from a synchronise plus a barrier to the next:

- one host: NCCL's own transports between the cards (P2P over NVLink);
- ``--nproc`` hosts: the ranks split into ``--nproc`` groups of equal size,
  each group given a host identity of its own (``NCCL_HOSTID``), so that
  NCCL carries the traffic between groups over its network transport. A
  leg in which NCCL opened no new ``NET`` transport (it ignored the host
  identities) is an error, never a reading.

``transport`` holds each leg's transports as NCCL names them under
``NCCL_DEBUG=INFO`` (``via P2P/CUMEM``, ``via NET/Socket/0``, ...). Both
legs must reach the same cost within 1e-3 (the script's assertion, here a
``RuntimeError``). The card rule of ``parallel/multihost.py`` reads the
socket's host name, not NCCL's, so it holds in both legs.

With ``--device cpu`` both legs are gloo ranks on the host (world
``--nproc``, ``transport`` "gloo"): the path, not a measurement of a
boundary. Fewer than two cards exits non-zero; so does a world that does
not split into ``--nproc`` groups. Other sizes go through :func:`run`.

Run: ``python -m sift_scale_space_extrema_detection_tpu_torch.benchmarks.multihost_bench
[--nproc 2] [--device cuda|cpu]``. Prints one JSON line: the script's keys
with 8 replaced by the world, ``transport`` and ``device``.
"""

from __future__ import annotations

import argparse
import json
import os
import re

import torch
import torch.distributed as dist

from ..ops.kernels import _build
from ..parallel.multihost import mesh_device
from . import device_entry, probe_device, torchrun_ranks
from .scaling_bench import (
    BA_SIZE,
    COST_RTOL,
    RANKS_TIMEOUT_S,
    REPEATS,
    ba_leg,
    finish_rank,
    join_ranks,
)


def world_and_hosts(nproc: int, dev: torch.device, world=None) -> int:
    """The world (every visible card; ``nproc`` gloo ranks on the CPU) after
    checking that it splits into ``nproc`` hosts; ``SystemExit`` otherwise."""
    if nproc < 2:
        raise SystemExit(f"--nproc {nproc}: a boundary between hosts needs two of them")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if cards < 2:
            raise SystemExit(f"multihost_bench needs at least two CUDA devices, {cards} visible")
        world = cards if world is None else world
        if world > cards:
            raise SystemExit(f"a world of {world} ranks: {cards} CUDA devices are visible")
    else:
        world = nproc if world is None else world
    if world % nproc:
        raise SystemExit(f"a world of {world} ranks does not split into {nproc} hosts")
    return world


def host_id(rank: int, world: int, hosts: int) -> str:
    """The host identity of ``rank`` where ``world`` ranks form ``hosts``
    groups of consecutive ranks."""
    return f"sift-host-{rank // (world // hosts)}"


def rank_main(workdir: str) -> None:
    """One rank of a leg, started by ``torchrun`` (:func:`run`): its host
    identity set before NCCL reads it, then the BA leg."""
    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    on_card = spec["device"] == "cuda"
    if on_card and spec["hosts"] > 1:
        os.environ["NCCL_HOSTID"] = host_id(int(os.environ["RANK"]), spec["world"],
                                            spec["hosts"])
    mesh, built = join_ranks(spec)
    try:
        finish_rank(workdir, ba_leg(mesh, mesh_device(mesh), spec["ba"], spec["repeats"]), built,
                    on_card)
    finally:
        dist.destroy_process_group()


def transports(log: str) -> list[str]:
    """The transports NCCL names in a log (``... via <transport>``)."""
    return sorted(set(re.findall(r"\bvia (\S+)", log)))


def run_leg(spec: dict, hosts: int) -> dict:
    """One leg: the world of ``spec`` as ``hosts`` hosts. Returns rank 0's
    iterations/s and cost, and the leg's transports."""
    ranks, log = torchrun_ranks(f"{__spec__.name}:rank_main", dict(spec, hosts=hosts),
                                spec["world"], RANKS_TIMEOUT_S, dict(NCCL_DEBUG="INFO"))
    if len({r["digest"] for r in ranks}) != 1 or not ranks[0]["reruns_equal"]:
        raise RuntimeError(f"multihost_bench: the ranks' solves differ at {hosts} hosts")
    if any(r.get("rebuilt") for r in ranks):
        raise RuntimeError("multihost_bench: a rank built the kernels")
    return dict(iters_per_s=round(ranks[0]["iterations"] / ranks[0]["seconds"], 3),
                cost=ranks[0]["cost"],
                transport=transports(log) if spec["device"] == "cuda" else ["gloo"])


def run(nproc: int = 2, device="cuda", *, world=None, ba_size=BA_SIZE,
        repeats: int = REPEATS) -> dict:
    """The benchmark's JSON object (see the module)."""
    dev = probe_device(str(device))
    world = world_and_hosts(nproc, dev, world)
    spec = dict(device=dev.type, world=world, ba=list(ba_size), repeats=repeats)
    note = (f"the same {world}-rank world, one rank a card; the {nproc}-host leg gives each "
            f"group of {world // nproc} ranks its own NCCL_HOSTID, so NCCL crosses the groups "
            "over its network transport")
    if dev.type == "cuda":
        _build.load_kernels()  # the ranks load this build
        torch.cuda.empty_cache()
    else:
        note = f"gloo ranks on the host, {world} in both legs: the path, not a boundary"
    one = run_leg(spec, 1)
    multi = run_leg(spec, nproc)
    if dev.type == "cuda" and not any(t.startswith("NET") and t not in one["transport"]
                                      for t in multi["transport"]):
        raise RuntimeError(f"multihost_bench: NCCL kept {multi['transport']} between the groups "
                           f"of the {nproc}-host leg under NCCL_HOSTID: no process boundary to "
                           "report")
    # Identical optimisation in both legs (the same world, the same problem).
    if abs(one["cost"] - multi["cost"]) > COST_RTOL * max(1.0, one["cost"]):
        raise RuntimeError(f"multihost_bench: the legs end at costs {one['cost']} and "
                           f"{multi['cost']}, more than {COST_RTOL} apart")
    return {
        f"ba_iters_per_s_1proc_{world}dev": one["iters_per_s"],
        f"ba_iters_per_s_{nproc}proc_{world}dev": multi["iters_per_s"],
        "process_boundary_retention": round(multi["iters_per_s"] / one["iters_per_s"], 3),
        "note": note,
        "transport": {"1proc": one["transport"], f"{nproc}proc": multi["transport"]},
        "device": device_entry(dev),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    probe_device(args.device)
    print(json.dumps(run(nproc=args.nproc, device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
