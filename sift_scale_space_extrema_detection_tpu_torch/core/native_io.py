"""ctypes bindings for the native batch image loader (native/sift_io.cpp).

The JAX package's ``core/native_io.py``, copied: decodes PNG/PGM/PPM/BMP
and converts to [0,1] float32 grayscale with the exact reference weights
across a pthread pool — the host-side frame ingest path for sequence
processing. The repository's ``native/sift_io.cpp`` is compiled unedited,
with the JAX package's ``g++`` line, on first use into
``native/build/torch/`` (the JAX package builds into ``native/build/``; two
libraries keep each package's stale-build check from rebuilding the
other's). A file it refuses goes through :func:`.image.load_image_gray`
when ``fallback`` is on, which tries PIL and raises, naming the file and
format, where PIL is missing. Unlike the JAX package's, a library that
fails to build or load raises, with the compiler's output: nothing decodes
through PIL in its place.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "torch", "libsift_io.so")
_lib = None


class NativeIOError(RuntimeError):
    pass


def _build_library():
    src = os.path.join(_NATIVE_DIR, "sift_io.cpp")
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [
                "g++", "-O3", "-shared", "-fPIC", "-pthread",
                "-o", tmp, src, "-lz",
            ],
            check=True,
            capture_output=True,
            text=True,
        )
    except subprocess.CalledProcessError as err:
        raise RuntimeError(f"building {src} failed:\n{err.stderr}") from err
    os.replace(tmp, _LIB_PATH)


def _load_library():
    global _lib
    if _lib is not None:
        return _lib
    if os.path.exists(_LIB_PATH) and os.path.getmtime(
        _LIB_PATH
    ) < os.path.getmtime(os.path.join(_NATIVE_DIR, "sift_io.cpp")):
        _build_library()  # stale build: source is newer than the .so
    if not os.path.exists(_LIB_PATH):
        # Link to a process-unique temp path and rename into place:
        # rename is atomic on the same filesystem, so a concurrent
        # process (test workers build side by side) can never dlopen a
        # partially written library.
        _build_library()
    lib = ctypes.CDLL(_LIB_PATH)
    lib.sift_io_probe.restype = ctypes.c_int
    lib.sift_io_probe.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.sift_io_stream_open.restype = ctypes.c_void_p
    lib.sift_io_stream_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.sift_io_stream_next.restype = ctypes.c_int
    lib.sift_io_stream_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
    ]
    lib.sift_io_stream_close.restype = None
    lib.sift_io_stream_close.argtypes = [ctypes.c_void_p]
    lib.sift_io_load_batch_gray.restype = ctypes.c_int
    lib.sift_io_load_batch_gray.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int),
    ]
    _lib = lib
    return lib


class SequencePrefetcher:
    """Ordered, prefetching frame iterator over an image sequence.

    Wraps the native pthread ring-buffer stream
    (``sift_io_stream_open/next/close``): ``depth`` frames are decoded
    ahead of the consumer, so disk decode overlaps the device work of an
    online consumer (e.g. ``SlamSession.add_frame``). Falls back to
    synchronous single-image loads when the native library is
    unavailable. Iterate to get ``(H, W)`` float32 frames in [0, 1];
    use as a context manager (or let iteration exhaust) to release the
    native stream.
    """

    def __init__(self, paths, threads: int = 4, depth: int = 8):
        self.paths = list(paths)
        self._handle = None
        if not self.paths:
            return
        try:
            lib = _load_library()
            w, h = probe(self.paths[0])
            self._w, self._h = w, h
            c_paths = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths]
            )
            handle = lib.sift_io_stream_open(
                c_paths, len(self.paths), w, h, threads, depth
            )
            if not handle:
                raise NativeIOError("stream_open failed")
            self._handle = ctypes.c_void_p(handle)
        except Exception:
            self._handle = None

    def __iter__(self):
        if self._handle is None:
            from .image import load_image_gray

            for p in self.paths:
                yield load_image_gray(p, dtype=np.float32)
            return
        lib = _load_library()
        out = np.empty((self._h, self._w), np.float32)
        try:
            while True:
                rc = lib.sift_io_stream_next(
                    self._handle,
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                )
                if rc == -1:
                    break
                if rc < -1:
                    raise NativeIOError(
                        f"frame decode failed with code {rc}"
                    )
                yield out.copy()
        finally:
            self.close()

    def close(self):
        if self._handle is not None:
            _load_library().sift_io_stream_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def native_available() -> bool:
    try:
        _load_library()
        return True
    except Exception:
        return False


def probe(path: str) -> tuple[int, int]:
    """(width, height) of a PNG/PGM/PPM/BMP image."""
    lib = _load_library()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.sift_io_probe(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise NativeIOError(f"probe({path}) failed with code {rc}")
    return w.value, h.value


def load_batch_gray(
    paths: list[str], threads: int = 8, fallback: bool = True
) -> np.ndarray:
    """Load same-sized images → ``(N, H, W)`` float32 grayscale in [0,1].

    Uses the native multithreaded decoder for PNG/PGM/PPM/BMP, and counts
    the frames it decoded in ``load_batch_gray.native_frames``; with
    ``fallback=True`` a refused file (unsupported format, a size mismatch)
    routes the batch through :func:`.image.load_image_gray` instead. A
    library that fails to build or load raises.
    """
    if not paths:
        return np.zeros((0, 0, 0), np.float32)
    try:
        lib = _load_library()
        w, h = probe(paths[0])
        out = np.empty((len(paths), h, w), np.float32)
        statuses = np.zeros(len(paths), np.int32)
        c_paths = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths]
        )
        rc = lib.sift_io_load_batch_gray(
            c_paths,
            len(paths),
            w,
            h,
            threads,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        if rc != 0:
            raise NativeIOError(
                f"native batch load failed: per-image codes {statuses.tolist()}"
            )
        load_batch_gray.native_frames += len(paths)
        return out
    except NativeIOError:
        if not fallback:
            raise
        from .image import load_image_gray

        return np.stack(
            [load_image_gray(p, dtype=np.float32) for p in paths]
        )


load_batch_gray.native_frames = 0
