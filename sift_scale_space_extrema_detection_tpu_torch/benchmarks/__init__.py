"""The port's probes of the card (``bw_probe``, ``tap_probe``), named after
the JAX package's ``benchmarks/`` scripts, with the helpers they share.

Each runs on the card unless ``--device cpu`` is given; without a card it
exits with a message and never carries on on the CPU by itself.
"""

from __future__ import annotations

import subprocess
import time

import torch


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
