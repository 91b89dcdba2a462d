"""Numerical-safety checks.

Port of the JAX package's ``utils/debug.py``:

- :func:`checked` — wrap a function so that a non-finite floating output
  raises instead of propagating.
- :func:`assert_finite` — eager guard for host-side pipeline stages.

These are debugging tools, not production defaults: each check reads every
output back to the host. The production code handles its own edge cases in
band (reject-on-singular in refinement, damped LM solves, masked buffers).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .checkpoint import flatten_with_paths


def assert_finite(tree, name: str = "value") -> None:
    """Raise ``FloatingPointError`` if any floating leaf (tensor, array or
    Python float) of ``tree`` holds a NaN or an Inf."""
    for where, leaf in zip(*flatten_with_paths(tree)):
        # Convert first: a bare Python float('nan') has no dtype and must not
        # slip through the floating-point check.
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        arr = np.asarray(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        if not np.isfinite(arr).all():
            n_bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"{name}{'/' + where if where else ''}: {n_bad} non-finite "
                f"element(s) of {arr.size}"
            )


def checked(fn):
    """Wrap ``fn`` so that a NaN or Inf in any floating output raises
    ``FloatingPointError``.

    PyTorch has no counterpart of ``jax.experimental.checkify``, which
    weaves the checks into a compiled program: the check here runs on the
    outputs after the call (:func:`assert_finite`). Indexing out of range
    needs no wrapper, since eager PyTorch raises on it (an ``IndexError`` on
    the CPU, a device-side assert on the card).
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_finite(out, name=getattr(fn, "__name__", "output"))
        return out

    return wrapper
