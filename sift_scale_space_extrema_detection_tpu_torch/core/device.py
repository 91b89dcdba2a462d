"""The device rule of the entry points, and the full-float32 guard.

Every entry point of the port (the frontend's and the solvers') takes
``device=None``: a CUDA input stays on its card, a CPU tensor is moved to
``torch.device("cuda")``, and without a CUDA device the call raises.
``device="cpu"`` asks for the CPU. The functions beneath the entry points
work on the device of their tensors. No code carries on on the CPU because
it found no GPU.
"""

from __future__ import annotations

import dataclasses

import torch

Device = torch.device | str | None


def resolve_device(like: torch.Tensor, device: Device) -> torch.device:
    """The device an entry point works on: ``device`` if given, else the
    card ``like`` lies on, else the default card."""
    if device is not None:
        return torch.device(device)
    if like.device.type == "cuda":
        return like.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the entry points run on the card; pass "
            'device="cpu" for the plain PyTorch versions on the CPU'
        )
    return torch.device("cuda")


def on_device(value, device: Device):
    """``value`` on the device an entry point works on (see the module).

    ``value`` is a tensor or a dataclass of tensors; ``device=None`` is
    resolved from the tensor, or from the dataclass's first field."""
    if isinstance(value, torch.Tensor):
        return value.to(resolve_device(value, device))
    fields = dataclasses.fields(value)
    target = resolve_device(getattr(value, fields[0].name), device)
    return type(value)(**{f.name: getattr(value, f.name).to(target) for f in fields})


def require_full_float32_matmul(device: torch.device) -> None:
    """Raise where a float32 matrix product on ``device`` would run in TF32.

    The histograms of the describe stages' tensor code (their plain route),
    the descriptor distances and the Schur products are float32 matrix
    products whose results feed comparisons (a ratio test, an accept test);
    TF32 keeps about three decimal digits."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "this path computes float32 matrix products in full precision: "
            "set torch.backends.cuda.matmul.allow_tf32 = False"
        )
