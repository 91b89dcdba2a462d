"""The port's measuring entry points, named after the JAX package's scripts:
the card's probes (``bw_probe``, ``tap_probe``, ``scatter_probe``), the
benchmarks (``bench``, ``frontend_bench``, ``ba_bench``, ``slam_bench``,
``descriptor_bench``) and the scaling runs across ranks (``scaling_bench``,
``multihost_bench``), with the helpers they share.

Each runs as ``python -m sift_scale_space_extrema_detection_tpu_torch.benchmarks.<name>``,
on the card unless ``--device cpu`` is given; without a card it exits with a
message and never carries on on the CPU by itself. A benchmark's ``run(**kw)``
returns the JSON object that its ``main(argv)`` prints as its last line.

Timing on the card: a whole call is timed by the host clock around work that
ends in ``torch.cuda.synchronize()``, after a warm-up pass (:func:`host_ms`,
:func:`median_ms`); a stage with a synchronise between stages; peak memory
is ``max_memory_allocated`` after ``reset_peak_memory_stats``
(:func:`peak_gib`).

Launches: a script takes ``launch_counts()`` before its work and reports
each path kernel's launches since (:func:`path_launches`); on the card a
path kernel its path did not launch is a failure (:func:`require_launches`).

Runs across ranks (:func:`torchrun_ranks`): each world is started by
``python -m torch.distributed.run --standalone`` in a session of its own,
one rank a card, and each rank writes a JSON record; rank 0's host clock
times the work from a synchronise plus a barrier to the next
(:func:`rank_clock`).
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import math
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..ops.kernels import launch_counts, launches_since


def probe_device(name: str) -> torch.device:
    """The device a probe runs on, or ``SystemExit`` with a message."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device: this probe measures the card; pass --device cpu "
            "for the plain versions on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device must be cuda or cpu, got {name}")
    return device


def card_smi() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them
    (``name, power.limit``), or None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def time_ms(fn, iters: int, device: torch.device) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` back-to-back calls after
    one warm-up call: CUDA events around the calls on the card (nothing
    subtracted: there is no dispatch tunnel to discount), the host clock on
    the CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters


def sync(device: torch.device) -> None:
    """Wait for the card's work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_ms(fn, device: torch.device, reps: int = 1, warmup: int = 1) -> float:
    """Mean host-clock milliseconds of ``fn()`` over ``reps`` back-to-back
    calls, after ``warmup`` calls, synchronised before and after."""
    for _ in range(warmup):
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return 1e3 * (time.perf_counter() - t0) / reps


def median_ms(fn, device: torch.device, repeats: int, warmup: int = 1) -> tuple[float, list[float]]:
    """The median of ``repeats`` synchronised host-clock times of one call of
    ``fn()`` after ``warmup`` calls, and the times themselves."""
    times = [host_ms(fn, device, 1, warmup if i == 0 else 0) for i in range(repeats)]
    return statistics.median(times), times


def peak_gib(fn, device: torch.device):
    """``(fn(), peak GiB)``: the card's largest allocation during the call
    (None on the CPU)."""
    if device.type != "cuda":
        return fn(), None
    sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    sync(device)
    return out, torch.cuda.max_memory_allocated(device) / 2**30


def device_entry(device: torch.device):
    """The ``device`` entry of a benchmark's JSON object: the card's name and
    power limit (``card_smi``; the name from torch where there is no
    ``nvidia-smi``), or ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    smi = card_smi()
    name, _, limit = (smi or "").partition(", ")
    return {"name": name or torch.cuda.get_device_name(device), "power_limit": limit or None}


# The kernels of the frontend's paths: K1 (the fused octave), K3 (the blur),
# R2 (selection), R1 (refinement), R3 and R4 (the describe stages), and K2
# (window sampling), which the describe stages launch only for a caller's
# own sampler: 0 on the paths.
PATH_KERNELS = ("fused_octave", "blur_fused", "select_candidates", "newton_ladder",
                "orient_slots", "describe_pairs", "window_sample_pair")


def path_launches(before: collections.Counter) -> collections.Counter:
    """Each path kernel's launches since ``before = launch_counts()``, every
    one named (0 where it did not launch)."""
    since = launches_since(before)
    return collections.Counter({k: since[k] for k in PATH_KERNELS})


def path_kernels(blur: str, describe: bool, upright: bool = False) -> tuple[str, ...]:
    """The kernels a frontend path launches on the card: K1 and R2 (which
    selects from K1's packed plane) on ``blur="fused"``, K3 on
    ``"cuda"``/``"pallas"``, R1 (which refines float32 DoGs) on every blur
    but the float64 oracle's ``"exact"``, R4 wherever it describes and R3
    wherever it also orients (not ``upright``)."""
    used = {"fused_octave": blur == "fused", "blur_fused": blur in ("cuda", "pallas"),
            "select_candidates": blur == "fused", "newton_ladder": blur != "exact",
            "orient_slots": describe and not upright, "describe_pairs": describe,
            "window_sample_pair": False}
    return tuple(k for k in PATH_KERNELS if used[k])


def require_launches(device: torch.device, launches: dict, kernels, what: str) -> None:
    """On the card, a path that should launch one of ``kernels`` and launched
    it no time is a failure (``RuntimeError``), not a reading."""
    if device.type != "cuda":
        return
    missing = [k for k in kernels if not launches.get(k)]
    if missing:
        raise RuntimeError(f"{what}: launched {missing} no time on the card ({launches})")


@contextlib.contextmanager
def describe_stage_calls(on_stage=None):
    """Within the block, each call of the describe layer's two stages
    (``ops/descriptor.py::_orientation_stage``, ``_descriptor_stage``) is
    recorded as ``(name, args)``, ``name`` ``"orientation"`` or
    ``"descriptor"``, after ``on_stage(name)`` when given (a synchronise and
    a mark); yields the list. The stages run as they would, on their own
    route."""
    from ..ops import descriptor

    attrs = {"orientation": "_orientation_stage", "descriptor": "_descriptor_stage"}
    stages = {name: getattr(descriptor, attr) for name, attr in attrs.items()}
    calls = []

    def recorded(name):
        def stage(*args):
            if on_stage is not None:
                on_stage(name)
            calls.append((name, args))
            return stages[name](*args)

        return stage

    for name, attr in attrs.items():
        setattr(descriptor, attr, recorded(name))
    try:
        yield calls
    finally:
        for name, attr in attrs.items():
            setattr(descriptor, attr, stages[name])


def describe_stage_gaps(calls) -> dict:
    """Each recorded stage call (:func:`describe_stage_calls`) run again on
    both routes, the kernels (R3, R4; twice) and the tensor code with K2, on
    the same slots (the descriptor stage on the same θ): the slots and
    valid entries, the entries whose validity differs (near ties at the
    peak ratio or between two bins), the circular θ gaps (median, largest)
    over entries valid on both, the largest L2 gap of a descriptor, whether
    the kernels give θ 0 where invalid and zero descriptors on invalid
    slots, and whether their rerun is bit-equal."""
    from ..ops import descriptor
    from ..ops.kernels.describe import window_sample_pair

    out = dict(orient_slots=0, orient_valid=0, orient_valid_differ=0, pair_slots=0,
               pairs=0, desc_l2_max=0.0, invalid_zero=True, rerun_equal=True)
    gaps = []
    for name, args in calls:
        if name == "orientation":
            slots, cfg, _ = args
            (tk, vk), (tk2, vk2) = (descriptor._orientation_stage(slots, cfg, None)
                                    for _ in range(2))
            tp, vp = descriptor._orientation_stage(slots, cfg, window_sample_pair)
            gap = (tk - tp).abs()[vk & vp].double()
            gaps.append(torch.minimum(gap, 2 * math.pi - gap))
            out["orient_slots"] += slots.table.shape[0]
            out["orient_valid"] += int(vp.sum())
            out["orient_valid_differ"] += int((vk != vp).sum())
            out["invalid_zero"] &= not bool(tk[~vk].any())
            out["rerun_equal"] &= torch.equal(tk, tk2) and torch.equal(vk, vk2)
        else:
            slots, theta, cfg, _ = args
            dk, dk2 = (descriptor._descriptor_stage(slots, theta, cfg, None) for _ in range(2))
            dp = descriptor._descriptor_stage(slots, theta, cfg, window_sample_pair)
            valid = slots.table[:, 3] != 0
            out["pair_slots"] += slots.table.shape[0]
            out["pairs"] += int(valid.sum())
            if dk.shape[0]:
                out["desc_l2_max"] = max(out["desc_l2_max"],
                                         float((dk - dp).norm(dim=-1).max()))
            out["invalid_zero"] &= not bool(dk[~valid].any())
            out["rerun_equal"] &= torch.equal(dk, dk2)
    gap = torch.cat(gaps) if gaps else torch.zeros(0, dtype=torch.float64)
    out["theta_median"] = float(gap.median()) if gap.numel() else 0.0
    out["theta_max"] = float(gap.max()) if gap.numel() else 0.0
    return out


def digest(*tensors) -> str:
    """SHA-256 of tensors' (or arrays') dtypes, shapes and bytes, on the
    host: equal digests are the same bits."""
    h = hashlib.sha256()
    for t in tensors:
        a = (t.detach().cpu().contiguous().numpy() if isinstance(t, torch.Tensor)
             else np.ascontiguousarray(t))
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def run_ranks(cmd, cwd, log_path, timeout, env=None) -> int:
    """Run ``cmd`` in a session of its own (two torch threads a process,
    ``env`` added to the environment), its output into ``log_path``; past
    ``timeout`` seconds kill the whole session (the launcher and every rank)
    and return 124. Returns the exit code."""
    with open(log_path, "w") as log:
        env = dict(os.environ, OMP_NUM_THREADS="2", **(env or {}))
        proc = subprocess.Popen(cmd, cwd=cwd, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True, env=env)
        try:
            return proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            return 124
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()


def torchrun_ranks(target: str, spec: dict, world: int, timeout: float, env=None):
    """``world`` ranks of ``target`` (``"module:function"``, called with a
    work directory that holds ``spec.json``), started by ``python -m
    torch.distributed.run --standalone --nproc_per_node <world>`` from the
    repository root through :func:`run_ranks`. Each rank writes
    ``rank<r>.json``. Returns ``(the records in rank order, the ranks' log)``;
    raises ``RuntimeError`` with the log's end where the ranks fail or
    outlive ``timeout`` seconds."""
    module, function = target.split(":")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory(prefix="sift_ranks_") as work:
        with open(os.path.join(work, "spec.json"), "w") as f:
            json.dump(spec, f)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(world), "--no-python", sys.executable, "-c",
               f"from {module} import {function}; {function}({work!r})"]
        log_path = os.path.join(work, "ranks.log")
        rc = run_ranks(cmd, root, log_path, timeout, env)
        with open(log_path) as f:
            log = f.read()
        if rc != 0:
            raise RuntimeError(f"{world} ranks of {target} exited {rc}:\n{log[-8000:]}")
        records = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                records.append(json.load(f))
    return records, log


def rank_clock(dev: torch.device) -> float:
    """The host clock once this rank's device work is done and every rank of
    the default group has reached this point (a synchronise, then a
    barrier)."""
    import torch.distributed as dist

    sync(dev)
    dist.barrier(**({"device_ids": [dev.index]} if dev.type == "cuda" else {}))
    return time.perf_counter()
