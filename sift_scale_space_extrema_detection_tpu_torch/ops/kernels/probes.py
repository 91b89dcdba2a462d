"""The card's probes: streaming write, copy and read, and the tap chain.

Wrappers of the hand-written CUDA kernels in ``csrc/probes.cu`` that
replace the JAX package's last four Pallas TPU kernels, the probes of
``benchmarks/``:

- :func:`probe_write` — ``bw_probe.py``'s ``pl_write``: a ``(rows, cols)``
  float32 array of 1.25 (nothing read);
- :func:`probe_copy` — ``pl_copy``: ``out = x``;
- :func:`probe_read` — ``pl_read``: the ``(8, 128)`` sum of ``x`` over rows
  ``≡ a (mod 8)`` and columns ``≡ b (mod 128)`` (nothing but 4 KiB
  written);
- :func:`tap_chain` — ``tap_probe.py``'s ``make(mode).run``: 64 repetitions
  of a 13-tap row filter summed into one ``(rows, W)`` float32 output, in
  one of four precisions (:data:`TAP_MODES`).

Each has its plain PyTorch version here (``*_reference``), which the
wrapper runs for a tensor on the CPU (for :func:`probe_write`, with
``device="cpu"``). On the card a wrapper launches its kernel or raises; it
never falls back. No detect, describe or SLAM path runs them: they measure
the ceilings the octave and blur kernels are held to
(``benchmarks/bw_probe.py``, ``benchmarks/tap_probe.py`` in this package).

The read's sums are taken in one fixed order, which its plain version
follows: block ``k`` of 128 rows sums its rows one after another and,
within a row, its 128-column groups one after another; then the blocks'
``(8, 128)`` partial sums are added in block order. So kernel and plain
version agree bit for bit, as write, copy and the float32 chain do. The
bf16 modes round the data and the taps to bf16 once and every bf16 product
and sum once, as PyTorch's bf16 operations do.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import check_launch, load_kernels

# The originals' shapes: bw_probe.py's blocks and tap_probe.py's constants.
LANE_W = 4096  # bw_probe.py: columns
BLOCK_ROWS = 128  # bw_probe.py: rows a grid step (the read's block of rows)
WRITE_VALUE = 1.25
READ_TILE = (8, 128)
ROWS = 256  # tap_probe.py
W = 1024
NTAPS = 13
REPS = 64
TAP_SIGMA = 2.0
TAP_MODES = ("f32", "bf16_carry", "bf16_full", "bf16_pair")


def probe_rows(gb: float) -> int:
    """``bw_probe.py``'s row count for a ``gb`` GiB buffer of ``LANE_W``
    float32 columns: a whole number of ``BLOCK_ROWS`` blocks."""
    rows = int(gb * (1 << 30) / (4 * LANE_W))
    return (rows // BLOCK_ROWS) * BLOCK_ROWS


def probe_taps() -> torch.Tensor:
    """``tap_probe.py``'s 13 taps: a Gaussian of sigma 2, normalised in
    float64 by numpy, then rounded to float32."""
    taps = np.exp(-0.5 * ((np.arange(NTAPS) - NTAPS // 2) / TAP_SIGMA) ** 2)
    return torch.from_numpy((taps / taps.sum()).astype(np.float32))


def _device_kind(what: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"{what}: no kernel for device {t.device}; pass a CUDA tensor, "
            "or a CPU tensor for the plain version"
        )
    return t.device.type


def _check_float32(what: str, name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")


def _check_aligned(what: str, name: str, t: torch.Tensor, nbytes: int) -> None:
    """The kernels access ``t`` ``nbytes`` at a time: a view that starts
    between two such accesses (``x[1:]``) would fault on the card, and the
    fault ends the process. Refused on every device alike."""
    if t.data_ptr() % nbytes:
        raise ValueError(
            f"{what}: {name} must start at an address that is a multiple of {nbytes} bytes, "
            f"got one {t.data_ptr() % nbytes} bytes past it (a view at an element offset?)"
        )


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# --- write -----------------------------------------------------------------


def probe_write_reference(rows: int, cols: int, device) -> torch.Tensor:
    """Plain version of :func:`probe_write`."""
    return torch.empty((rows, cols), dtype=torch.float32, device=device).fill_(WRITE_VALUE)


def probe_write(rows: int, cols: int = LANE_W, device="cuda") -> torch.Tensor:
    """A ``(rows, cols)`` float32 array of ``WRITE_VALUE`` (1.25), written by
    the kernel on a CUDA ``device`` (counted as ``probe_write``),
    by the plain version with ``device="cpu"``."""
    dev = torch.device(device)
    if rows < 1 or cols < 1 or (rows * cols) % 4:
        raise ValueError(
            f"probe_write: rows x cols must be positive and a multiple of 4, got {rows} x {cols}"
        )
    if dev.type == "cpu":
        return probe_write_reference(rows, cols, dev)
    if dev.type != "cuda":
        raise ValueError(f"probe_write: no kernel for device {dev}")
    out = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    lib = load_kernels()
    with torch.cuda.device(out.device):
        rc = lib.sift_probe_write(out.data_ptr(), out.numel(), WRITE_VALUE, _stream(out.device))
    check_launch(lib, rc, "probe_write")
    return out


# --- copy ------------------------------------------------------------------


def probe_copy_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`probe_copy`."""
    return x.clone()


def probe_copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` (float32, contiguous, a multiple of 4 elements):
    through the kernel on the card (counted as ``probe_copy``), the plain
    version on the CPU."""
    _check_float32("probe_copy", "x", x)
    if x.numel() % 4 or x.numel() == 0:
        raise ValueError(f"probe_copy: x must hold a positive multiple of 4 elements, got {x.numel()}")
    _check_aligned("probe_copy", "x", x, 16)
    if _device_kind("probe_copy", x) == "cpu":
        return probe_copy_reference(x)
    out = torch.empty_like(x)
    lib = load_kernels()
    with torch.cuda.device(x.device):
        rc = lib.sift_probe_copy(x.data_ptr(), out.data_ptr(), x.numel(), _stream(x.device))
    check_launch(lib, rc, "probe_copy")
    return out


# --- read ------------------------------------------------------------------


def _check_read(x: torch.Tensor) -> None:
    _check_float32("probe_read", "x", x)
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[0] % BLOCK_ROWS or x.shape[1] < 1 or x.shape[1] % READ_TILE[1]:
        raise ValueError(
            f"probe_read: x must be (rows, cols) with rows a multiple of {BLOCK_ROWS} and cols "
            f"of {READ_TILE[1]}, got {tuple(x.shape)}"
        )
    _check_aligned("probe_read", "x", x, 16)


def probe_read_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`probe_read`, in the kernel's order of sums."""
    _check_read(x)
    rows, cols = x.shape
    a, b = READ_TILE
    v = x.view(rows // BLOCK_ROWS, BLOCK_ROWS // a, a, cols // b, b)
    partial = torch.zeros((rows // BLOCK_ROWS, a, b), dtype=x.dtype, device=x.device)
    for rr in range(v.shape[1]):
        for j in range(v.shape[3]):
            partial = partial + v[:, rr, :, j, :]
    total = torch.zeros((a, b), dtype=x.dtype, device=x.device)
    for k in range(partial.shape[0]):
        total = total + partial[k]
    return total


def probe_read(x: torch.Tensor) -> torch.Tensor:
    """The ``(8, 128)`` sum of ``x`` ``(rows, cols)`` float32 (rows a
    multiple of 128, cols of 128): the kernel on the card
    (counted as ``probe_read``, two launches counted as one), the plain
    version on the CPU."""
    _check_read(x)
    if _device_kind("probe_read", x) == "cpu":
        return probe_read_reference(x)
    rows, cols = x.shape
    partial = torch.empty((rows // BLOCK_ROWS, *READ_TILE), dtype=x.dtype, device=x.device)
    out = torch.empty(READ_TILE, dtype=x.dtype, device=x.device)
    lib = load_kernels()
    with torch.cuda.device(x.device):
        rc = lib.sift_probe_read(
            x.data_ptr(), rows, cols, partial.data_ptr(), out.data_ptr(), _stream(x.device)
        )
    check_launch(lib, rc, "probe_read")
    return out


# --- the tap chain ---------------------------------------------------------


def _check_taps(x: torch.Tensor, taps: torch.Tensor, mode: str) -> int:
    """Raise on what the kernel does not take; return the output's rows."""
    if mode not in TAP_MODES:
        raise ValueError(f"tap_chain: mode must be one of {TAP_MODES}, got {mode!r}")
    _check_float32("tap_chain", "x", x)
    _check_float32("tap_chain", "taps", taps)
    if tuple(taps.shape) != (NTAPS,):
        raise ValueError(f"tap_chain: taps must be ({NTAPS},), got {tuple(taps.shape)}")
    if taps.device != x.device:
        raise ValueError(f"tap_chain: taps are on {taps.device}, x on {x.device}")
    if x.dim() != 2 or x.shape[0] < NTAPS or x.shape[1] < 1:
        raise ValueError(
            f"tap_chain: x must be (rows + {NTAPS}, W) with rows >= 1, got {tuple(x.shape)}"
        )
    if mode != "f32" and x.shape[1] % 2:
        raise ValueError(f"tap_chain: the bf16 modes pair columns and need an even W, got {x.shape[1]}")
    if mode != "f32":
        _check_aligned("tap_chain", "x", x, 8)
    return x.shape[0] - NTAPS


def tap_chain_reference(
    x: torch.Tensor, taps: torch.Tensor, mode: str = "f32", reps: int = REPS
) -> torch.Tensor:
    """Plain version of :func:`tap_chain` (``reps`` repetitions; the kernel
    runs ``REPS``), operation by operation in the kernel's order."""
    rows = _check_taps(x, taps, mode)
    if mode == "f32":
        acc = x[0:rows] * taps[0]
        for rep in range(reps):
            for t in range(1 if rep == 0 else 0, NTAPS):
                acc = acc + x[t : t + rows] * taps[t]
        return acc
    xb, tb = x.to(torch.bfloat16), taps.to(torch.bfloat16)

    def prod(t):
        return xb[t : t + rows] * tb[t]

    if mode == "bf16_full":
        acc = prod(0)
        for rep in range(reps):
            for t in range(1 if rep == 0 else 0, NTAPS):
                acc = acc + prod(t)
        return acc.to(torch.float32)
    acc = prod(0).to(torch.float32)
    for rep in range(reps):
        ts = list(range(1 if rep == 0 else 0, NTAPS))
        if mode == "bf16_carry":
            for t in ts:
                acc = acc + prod(t).to(torch.float32)
            continue
        for k in range(0, len(ts) - 1, 2):
            acc = acc + (prod(ts[k]) + prod(ts[k + 1])).to(torch.float32)
        if len(ts) % 2:
            acc = acc + prod(ts[-1]).to(torch.float32)
    return acc


def tap_chain(x: torch.Tensor, taps: torch.Tensor, mode: str = "f32") -> torch.Tensor:
    """``tap_probe.py``'s chain on ``x`` ``(rows + 13, W)`` float32 with the 13
    float32 ``taps``: ``(rows, W)`` float32. ``acc = x[0:rows]·t0``, then 64
    repetitions of ``acc + x[t:t+rows]·t_t`` over the taps (the first from
    tap 1): 832 products and 831 sums an element. ``mode``: ``"f32"``;
    ``"bf16_carry"`` (bf16 products, float32 sums); ``"bf16_full"`` (bf16
    products and sums); ``"bf16_pair"`` (bf16 products summed in bf16 two
    by two, the pairs summed in float32). The kernel on the card
    (counted as ``tap_chain``), the plain version on the CPU."""
    rows = _check_taps(x, taps, mode)
    if _device_kind("tap_chain", x) == "cpu":
        return tap_chain_reference(x, taps, mode)
    if rows > 65535:
        raise ValueError(f"tap_chain: at most 65535 output rows, got {rows}")
    width = x.shape[1]
    out = torch.empty((rows, width), dtype=torch.float32, device=x.device)
    lib = load_kernels()
    with torch.cuda.device(x.device):
        rc = lib.sift_probe_taps(
            x.data_ptr(), rows, width, taps.data_ptr(), TAP_MODES.index(mode), out.data_ptr(),
            _stream(x.device),
        )
    check_launch(lib, rc, "tap_chain")
    return out


PROBES = (probe_write, probe_copy, probe_read, tap_chain)
