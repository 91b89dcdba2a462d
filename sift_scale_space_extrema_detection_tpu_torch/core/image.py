"""Image loading, colour conversion, padding and a PNG writer.

``GRAY_WEIGHTS``, :func:`rgb_to_gray` and :func:`pad_to_tpu_friendly` are
verbatim copies of the JAX package's ``core/image.py`` (the port cannot
import that package without jax); ``tests/test_torch_io.py`` pins them equal.

:func:`load_image_gray` decodes through the native loader
(``core/native_io.py``), and :func:`write_png` encodes with the standard
library (``zlib`` + ``struct``): neither needs PIL. PIL is only the fallback
for a file the native decoder refuses; where PIL is missing too, the load
raises and names the file and its format.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def rgb_to_gray(rgb: np.ndarray, dtype=np.float64) -> np.ndarray:
    """uint8 RGB(A) ``(..., H, W, C)`` → grayscale ``(..., H, W)`` in [0,1].

    Exact reference expression per pixel:
    ``((r*0.299) + (g*0.587) + (b*0.114)) / 255`` with r,g,b the integer
    byte values (reference/src/image-utils.js:107-114).
    """
    rgb = np.asarray(rgb)
    if rgb.ndim < 3 or rgb.shape[-1] < 3:
        raise ValueError(f"expected (..., H, W, C>=3) array, got {rgb.shape}")
    r = rgb[..., 0].astype(dtype)
    g = rgb[..., 1].astype(dtype)
    b = rgb[..., 2].astype(dtype)
    return ((r * dtype(0.299)) + (g * dtype(0.587)) + (b * dtype(0.114))) / dtype(255.0)


def pad_to_tpu_friendly(
    images: np.ndarray, h_multiple: int = 32, w_multiple: int = 64
) -> np.ndarray:
    """Edge-pad ``(..., H, W)`` images bottom/right to TPU-friendly dims.

    Real dataset frames (KITTI is 1241×376) hit none of the aligned fast
    paths: the fused octave kernel wants lane-aligned planes and the
    packed candidate selection wants every octave plane size divisible
    by 128 (ops/extrema.py::select_refine_candidates). Padding H to a
    multiple of 32 and W to a multiple of 64 guarantees
    ``(2H/2^o)·(2W/2^o) % 128 == 0`` for the first four octaves.

    Edge replication is semantically transparent to the pipeline's blur:
    the reference's border rule is clamp-to-edge sampling
    (reference/src/sift.js:116-119), so blurred values over the original
    image area are unchanged. The only behavioral delta is at the old
    bottom/right border rows/cols, which become interior to the extrema
    scan (flat replicated texture there produces near-zero DoG, so the
    contrast gate rejects it). Intrinsics are unaffected (no shift of
    the principal point — padding is bottom/right only).
    """
    h, w = images.shape[-2], images.shape[-1]
    ph = (-h) % h_multiple
    pw = (-w) % w_multiple
    if not ph and not pw:
        return images
    pad = [(0, 0)] * (images.ndim - 2) + [(0, ph), (0, pw)]
    return np.pad(images, pad, mode="edge")


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _file_format(path: str) -> str:
    """A short name of the file's format from its first bytes."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(_PNG_SIGNATURE):
        return "PNG"
    if head[:2] in (b"P5", b"P6"):
        return "PNM"
    if head.startswith(b"BM"):
        return "BMP"
    if head.startswith(b"\xff\xd8"):
        return "JPEG"
    return f"unknown (first bytes {head!r})"


def _one_8bit_channel(path: str) -> bool:
    """Whether the file holds a single channel of 8-bit samples: an 8-bit
    gray (or gray + alpha) PNG, or a binary PGM."""
    with open(path, "rb") as f:
        head = f.read(26)
    if head.startswith(_PNG_SIGNATURE):
        return len(head) == 26 and head[24] == 8 and head[25] in (0, 4)
    return head.startswith(b"P5")


def load_image_gray(path: str, dtype=np.float64) -> np.ndarray:
    """Decode an image file → grayscale ``(H, W)`` in [0, 1], as ``dtype``.

    Decoded by the native loader. For a file of one 8-bit channel (gray
    PNG, PGM) the bytes are recovered from the loader's exact ``v/255`` and
    converted by :func:`rgb_to_gray` in ``dtype``, which is what the JAX
    package's PIL path computes (PIL widens gray to RGB); for RGB files the
    loader's value (the reference expression in double, rounded to float32)
    is returned as ``dtype``. A file the native decoder refuses goes through
    PIL; where PIL is missing, ``NativeIOError`` names the file and format.
    A native library that fails to build or load raises: PIL is no stand-in
    for it.
    """
    from .native_io import NativeIOError, load_batch_gray

    try:
        gray = load_batch_gray([path], threads=1, fallback=False)[0]
    except NativeIOError as native_error:  # the decoder refused the file
        try:
            from PIL import Image
        except ImportError:
            raise NativeIOError(
                f"{path}: the native decoder refused this {_file_format(path)} file "
                f"({native_error}) and PIL, the fallback, is not installed"
            ) from native_error
        with Image.open(path) as img:
            rgb = np.asarray(img.convert("RGB"))
        return rgb_to_gray(rgb, dtype=dtype)
    if _one_8bit_channel(path):
        samples = np.rint(gray.astype(np.float64) * 255.0)
        if np.array_equal((samples / 255.0).astype(np.float32), gray):
            return rgb_to_gray(np.repeat(samples.astype(np.uint8)[..., None], 3, -1), dtype)
    return gray.astype(dtype)


def write_png(path: str, image: np.ndarray) -> None:
    """Write a uint8 image, ``(H, W)`` gray or ``(H, W, 3)`` RGB, as a PNG:
    8-bit samples, no interlace, filter type 0 on every row, zlib's
    default compression."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or not (
        image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)
    ):
        raise ValueError(
            f"write_png takes uint8 (H, W) or (H, W, 3), got {image.dtype} {image.shape}"
        )
    h, w = image.shape[:2]
    colour_type = 0 if image.ndim == 2 else 2
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), image.reshape(h, -1)], axis=1
    )

    def chunk(kind: bytes, payload: bytes) -> bytes:
        crc = zlib.crc32(kind + payload) & 0xFFFFFFFF
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", crc)

    header = struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"".join([
            _PNG_SIGNATURE,
            chunk(b"IHDR", header),
            chunk(b"IDAT", zlib.compress(rows.tobytes())),
            chunk(b"IEND", b""),
        ]))
