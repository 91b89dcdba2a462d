"""Build the port's CUDA kernels with ``nvcc`` at first use; load them with ctypes.

The sources in ``csrc/`` have a plain C interface (no PyTorch headers), so
one ``nvcc`` call (its ``--threads`` compiles the files side by side) builds
them in seconds into ``build/`` beside this file (listed in ``.gitignore``).
The library is named by a hash of the sources, headers and flags, so an
edited source is rebuilt and a finished build is reused.
``-fmad=false`` keeps every product and sum separately rounded, which is
what makes the kernels agree bit for bit with their plain PyTorch versions.

There is no fallback: without ``nvcc`` or on a failed build,
:func:`load_kernels` raises.

:data:`LOAD_TIMES` says, once the process has loaded the kernels, what
that took on the host clock: whether ``nvcc`` ran, the seconds of the
build step (hashing the sources, and ``nvcc`` when it ran) and of loading
the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "--threads",  # compile the source files side by side,
    "0",  # with as many jobs as there are cores
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

# Filled by the process's first load_kernels(): nvcc_ran, build_s, load_s.
LOAD_TIMES: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)  # host int array
_PP = ctypes.POINTER(ctypes.c_void_p)  # host array of device pointers
_FP = ctypes.POINTER(ctypes.c_float)  # host float array
_SIGNATURES = {  # name: (argtypes, restype)
    # base, batch, h, w, upsample2x, taps, tap_offsets, radii, n_scales,
    # spo, contrast_thr, tile_h, tile_w, clamped, shared_bytes, stack (or
    # null), dog, seed, masks, mask16, stream
    "sift_fused_octave": (
        [_P, _I, _I, _I, _I, _P, _IP, _IP, _I, _I, ctypes.c_float,
         _I, _I, _I, _I, _P, _P, _P, _P, _I, _P],
        _I,
    ),
    # src, batch, h, w, taps, radius, tile_h, tile_w, clamped, shared_bytes,
    # dst, stream
    "sift_blur": ([_P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P], _I),
    # stacks, heights, widths, n_octaves, batch, n_scales, slots, ys, xs,
    # gy, gx, n_slots, n_samples, stream
    "sift_window_sample_pair": (
        [_PP, _IP, _IP, _I, _I, _I, _P, _P, _P, _P, _P, ctypes.c_longlong,
         _I, _P],
        _I,
    ),
    # dogs, fields, dims, geometry, n_octaves, batch, depth, n_slots, caps,
    # n_steps, limits, ints, floats, valid, live, stream
    "sift_newton_ladder": (
        [_PP, _PP, _IP, _FP, _I, _I, _I, _I, _IP, _I, _FP, _P, _P, _P, _P, _P],
        _I,
    ),
    # packed, word_bytes, dog, batch, depth, h, w, capacity, n_tiles,
    # scratch, y, x, s, value, valid, n_cand, n_low, stream
    "sift_select_candidates": (
        [_P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
        _I,
    ),
    # out, n, value, stream
    "sift_probe_write": ([_P, ctypes.c_longlong, ctypes.c_float, _P], _I),
    # src, dst, n, stream
    "sift_probe_copy": ([_P, _P, ctypes.c_longlong, _P], _I),
    # x, rows, cols, partial, out, stream
    "sift_probe_read": ([_P, _I, _I, _P, _P, _P], _I),
    # x, rows, width, taps, mode, out, stream
    "sift_probe_taps": ([_P, _I, _I, _P, _I, _P, _P], _I),
    "sift_cuda_error_string": ([_I], ctypes.c_char_p),
}


def _find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``). Raises ``RuntimeError`` when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = cuda_home / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME: the CUDA kernels in "
        f"{CSRC_DIR} are built with nvcc for sm_90a and have no fallback"
    )


def build_library(sources, stem: str, headers, built: dict | None = None) -> Path:
    """Build ``sources`` into ``build/lib<stem>_<hash>.so`` once per version
    of the sources and the ``headers`` they include; its path. ``built``,
    when given, gets ``nvcc_ran``: whether this call ran ``nvcc``."""
    nvcc = _find_nvcc()
    digest = hashlib.sha256(
        b"".join(Path(p).read_bytes() for p in [*sources, *headers])
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{stem}_{digest}.so"
    if built is not None:
        built["nvcc_ran"] = not lib_path.exists()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{lib_path.stem}.tmp{os.getpid()}.so"
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib_path)  # atomic: concurrent builds race benignly
    return lib_path


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library;
    the times in :data:`LOAD_TIMES`."""
    t0 = time.perf_counter()
    built: dict = {}
    lib_path = build_library(
        sorted(CSRC_DIR.glob("*.cu")), "sift_kernels", sorted(CSRC_DIR.glob("*.cuh")), built
    )
    t1 = time.perf_counter()
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    LOAD_TIMES.update(nvcc_ran=built["nvcc_ran"], build_s=t1 - t0,
                      load_s=time.perf_counter() - t1)
    return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise ``RuntimeError`` when an entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.sift_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: kernel launch failed: CUDA error {rc} ({msg})")
