"""A frozen copy of the port's ``ops/sampling.py`` (see ``reference/__init__.py``).

Scale-space gradients and bilinear sampling, the describe stages' primitives.

Ports of the JAX package's ``ops/sampling.py``: central differences on the
Gaussian scale-space images (IPOL Anatomy of SIFT; the reference's own
gradient operator, reference/src/sift.js:333-353) and a bilinear sampler
that clamps to the image border (reference/src/sift.js:116-119). Together
they are the plain version of the window-sampling kernel
(``ops/kernels/describe.py``).

Not ported: ``pack_gradients_flat`` and ``bilinear_sample_pair_flat``.
They interleave all octaves' gradients in one flat buffer so that the
TPU's gather engine fetches four values per request; a CUDA thread reads
the corners it needs straight from the Gaussian planes.
"""

from __future__ import annotations

import torch


def scale_space_gradients(stack: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients ``(gy, gx)`` of ``(..., H, W)`` planes.

    Same shape as ``stack``; border rows of ``gy`` and border columns of
    ``gx`` are exactly zero.
    """
    gy = torch.zeros_like(stack)
    gx = torch.zeros_like(stack)
    gy[..., 1:-1, :] = (stack[..., 2:, :] - stack[..., :-2, :]) / 2.0
    gx[..., 1:-1] = (stack[..., 2:] - stack[..., :-2]) / 2.0
    return gy, gx


def bilinear_sample(
    image: torch.Tensor,
    ys: torch.Tensor,
    xs: torch.Tensor,
    plane: torch.Tensor | None = None,
) -> torch.Tensor:
    """Bilinear samples of ``image`` at float positions ``(ys, xs)``.

    ``image`` is one plane ``(H, W)``, or with ``plane`` a stack
    ``(P, H, W)`` of which ``plane`` (an integer tensor broadcastable to
    the positions) picks each sample's plane. ``ys``/``xs`` have any
    common shape, which is the result's. Positions outside the plane are
    clamped to its border; the coordinates are clamped before the
    fractional part is taken, so a negative position returns the border
    value and does not blend.
    """
    h, w = image.shape[-2], image.shape[-1]
    ys = ys.clamp(0.0, h - 1.0)
    xs = xs.clamp(0.0, w - 1.0)
    y0 = ys.floor()
    x0 = xs.floor()
    fy = ys - y0
    fx = xs - x0
    y0i = y0.long().clamp(0, h - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    x0i = x0.long().clamp(0, w - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    flat = image.reshape(-1)
    top_row = y0i * w
    bot_row = y1i * w
    if plane is not None:
        base = plane.long() * (h * w)
        top_row = top_row + base
        bot_row = bot_row + base
    v00 = flat[top_row + x0i]
    v01 = flat[top_row + x1i]
    v10 = flat[bot_row + x0i]
    v11 = flat[bot_row + x1i]
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy


def window_sample_pair(
    stacks: list[torch.Tensor],
    slots: torch.Tensor,
    ys: torch.Tensor,
    xs: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The window-sampling kernel's plain version
    (``ops/kernels/describe.py::window_sample_pair_reference``): the
    gradients of every whole stack, each octave's sampled for all slots,
    each slot keeping its own; an invalid slot gives zeros."""
    batch, n_scales = stacks[0].shape[:2]
    b, octave, scale, valid = slots.unbind(dim=1)
    plane = (b.clamp(0, batch - 1) * n_scales + scale.clamp(0, n_scales - 1))[:, None]
    gy_out = torch.zeros_like(ys)
    gx_out = torch.zeros_like(xs)
    for o, stack in enumerate(stacks):
        own = ((octave == o) & (valid != 0))[:, None]
        gy, gx = scale_space_gradients(stack)
        h, w = stack.shape[-2:]
        gy_out = torch.where(
            own, bilinear_sample(gy.reshape(-1, h, w), ys, xs, plane), gy_out
        )
        gx_out = torch.where(
            own, bilinear_sample(gx.reshape(-1, h, w), ys, xs, plane), gx_out
        )
        del gy, gx
    return gy_out, gx_out
