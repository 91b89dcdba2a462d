"""Visualization: gallery dumps and keypoint overlays.

The JAX package's ``utils/visualize.py``, copied, with two changes: PNGs are
written by ``core/image.py::write_png`` (the standard library, no PIL), and
the functions take torch tensors, on the card or not, copying each input to
the host once.

Replaces the reference's canvas UI (L4: reference/main.js,
reference/index.html — SURVEY.md §1) with file outputs:

- Gaussian-stack and DoG galleries as PNG grids per octave, using the
  reference's display normalizations — sigmoid with coefficient 5 for
  DoG (reference/background.js:303-307, matrix2d.js:151-158) and
  min-max ``sampledNormalize`` for full images (matrix2d.js:169-192).
- Keypoint overlay: translucent markers at candidate positions and
  σ-radius circles for refined keypoints, colored like the reference UI
  (red ``#f003`` low-contrast candidates, yellow accepted candidates,
  circles for final keypoints — main.js:315-319, main.js:338-369).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.image import write_png


def _host(x) -> np.ndarray:
    """``x`` as a numpy array: a tensor is copied to the host (once)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def sigmoid_normalize(x: np.ndarray, coefficient: float = 5.0) -> np.ndarray:
    """Reference display transform: 1/(1+e^(-c·x)) (matrix2d.js:151-158)."""
    return 1.0 / (1.0 + np.exp(-coefficient * x))


def minmax_normalize(x: np.ndarray) -> np.ndarray:
    """Reference ``sampledNormalize`` (matrix2d.js:169-192)."""
    lo, hi = float(np.min(x)), float(np.max(x))
    if hi - lo < 1e-12:
        return np.zeros_like(x)
    return (x - lo) / (hi - lo)


def to_u8(gray01: np.ndarray) -> np.ndarray:
    return np.clip(np.round(gray01 * 255.0), 0, 255).astype(np.uint8)


def gallery_image(stack, pad: int = 2, normalize: str = "none") -> np.ndarray:
    """Horizontally tile a ``(S, H, W)`` stack into one grayscale image."""
    stack = _host(stack)
    s, h, w = stack.shape
    norm = {
        "none": lambda a: a,
        "minmax": minmax_normalize,
        "sigmoid": sigmoid_normalize,
    }[normalize]
    out = np.ones((h, s * (w + pad) - pad), dtype=np.float64)
    for i in range(s):
        out[:, i * (w + pad) : i * (w + pad) + w] = norm(stack[i])
    return to_u8(out)


def save_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 ``(H, W)`` gray or ``(H, W, 3)`` RGB image as PNG."""
    write_png(path, _host(img))


def draw_candidate_markers(
    gray01,
    candidates: list[tuple[int, int, bool]],
) -> np.ndarray:
    """RGB octave image with the reference's candidate markers.

    ``candidates``: ``(y, x, low_contrast)`` in octave-local pixels.
    3×3 rects, translucent red for low-contrast pre-filter rejects and
    yellow for accepted candidates (reference/main.js:315-319 paints
    ``#f003`` / yellow onto the octave base image).
    """
    gray01 = _host(gray01)
    h, w = gray01.shape
    rgb = np.stack([to_u8(gray01)] * 3, axis=-1).astype(np.int32)
    for cy, cx, low in candidates:
        y, x = int(cy), int(cx)
        y0, y1 = max(0, y - 1), min(h, y + 2)
        x0, x1 = max(0, x - 1), min(w, x + 2)
        color = (255, 0, 0) if low else (255, 255, 0)
        rgb[y0:y1, x0:x1] = (rgb[y0:y1, x0:x1] * 2 + np.array(color)) // 3
    return rgb.astype(np.uint8)


def draw_keypoints(
    gray01,
    keypoints,
    candidates: list[tuple[float, float, bool]] | None = None,
) -> np.ndarray:
    """RGB overlay: σ-circles for refined keypoints (+candidate markers).

    ``keypoints``: a ``DescribedKeypoints``/``Keypoints`` of one image
    (absolute coordinates in input-image pixels), tensors on any device:
    its valid slots' positions and sigmas cross to the host in one copy.
    ``candidates``: optional ``(abs_y, abs_x, low_contrast)`` triples drawn
    as 3×3 rects colored red (low-contrast) / yellow like the reference
    markers (reference/main.js:315-319).
    """
    gray01 = _host(gray01)
    h, w = gray01.shape
    rgb = np.stack([to_u8(gray01)] * 3, axis=-1).astype(np.int32)

    if candidates:
        for cy, cx, low in candidates:
            y, x = int(round(cy)), int(round(cx))
            y0, y1 = max(0, y - 1), min(h, y + 2)
            x0, x1 = max(0, x - 1), min(w, x + 2)
            color = (255, 0, 0) if low else (255, 255, 0)
            # Translucent blend like the reference's #f003 alpha markers.
            rgb[y0:y1, x0:x1] = (rgb[y0:y1, x0:x1] * 2 + np.array(color)) // 3

    fields = torch.stack(
        [torch.as_tensor(keypoints.abs_y), torch.as_tensor(keypoints.abs_x),
         torch.as_tensor(keypoints.abs_sigma)]
    )
    ys, xs, sig = _host(fields[:, torch.as_tensor(keypoints.valid)])
    for cy, cx, r in zip(ys, xs, sig):
        # Circle of radius absoluteSigma (reference/main.js:338-369).
        n = max(12, int(2 * np.pi * max(r, 1.0)))
        ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
        py = np.round(cy + r * np.sin(ang)).astype(int)
        px = np.round(cx + r * np.cos(ang)).astype(int)
        # Drop out-of-image samples (clipping smeared partial circles
        # into streaks along the borders).
        ok = (py >= 0) & (py < h) & (px >= 0) & (px < w)
        rgb[py[ok], px[ok]] = (0, 255, 0)
    return rgb.astype(np.uint8)
