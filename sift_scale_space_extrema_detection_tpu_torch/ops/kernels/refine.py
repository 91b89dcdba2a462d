"""Newton refinement of the candidates and its compaction ladder, in one launch.

:func:`newton_ladder` is the wrapper of the hand-written CUDA kernel
(``csrc/refine.cu``). It replaces no TPU kernel: the JAX package refines
with plain array code, as the port's ``ops/refine.py`` does in its tensor
code, which stays the kernel's plain version
(``ops/refine.py::newton_ladder_reference``). ``ops/refine.py`` owns the
route: it sends float32 DoGs on a CUDA device here, with the ladder's caps
and each octave's geometry, and refines every other input with its tensor
code. The wrapper takes CUDA tensors alone: it launches the kernel or
raises, and never falls back.

Contract (``ops/refine.py::_iterate`` and ``_step``, bit for bit):

- ``dogs[i]``: octave ``first_octave + i``'s DoG ``(B, D, H_i, W_i)``
  float32, contiguous, one B and D for all; at most :data:`MAX_OCTAVES`.
- ``extrema_list[i]``: its candidates, fields ``(B, n_i)`` on the DoGs'
  device: ``y``, ``x``, ``scale_level`` int32, ``value`` float32,
  ``valid`` bool.
- ``geometry[i]``: octave ``first_octave + i``'s ``(delta, sigma_coeff)``.
- A row is one image's slots, octave after octave (``n = Σ n_i``). Newton
  step ``k`` admits the first ``caps[k - 1]`` slots of a row that are
  still running: before step 1 the valid ones, before each later step
  those the step before admitted and that moved (``ops/refine.py::
  _kernel_caps``: the pool's cap, or ``n``, then the ladder's).
- Returns ``(keypoints, live)``: ``Keypoints`` ``(B, n)`` as
  ``refine_keypoints_multi`` gives them (``refine_keypoints`` for one
  octave and no pool cap), and ``live`` ``(B, steps)`` int32, each row's
  count of the slots each step admitted.
"""

from __future__ import annotations

import ctypes

import torch

from ...config import SiftConfig
from ...core.types import Extrema, Keypoints, exact_scalar
from ._build import check_launch, load_kernels

MAX_OCTAVES = 8  # the kernel's octave table (kMaxOctaves in csrc/refine.cu)
MAX_STEPS = 32  # its caps (kMaxSteps)
_INT_FIELDS = ("y", "x", "scale_level")
_FIELDS = (*_INT_FIELDS, "value", "valid")  # the kernel's order


def _check(dogs, extrema_list) -> None:
    """Raise on what the kernel does not take (count, device, type, shape,
    layout)."""
    if not 1 <= len(dogs) <= MAX_OCTAVES or len(extrema_list) != len(dogs):
        raise ValueError(
            f"newton_ladder: 1 to {MAX_OCTAVES} octaves, one Extrema each; got "
            f"{len(dogs)} DoGs and {len(extrema_list)} Extrema"
        )
    dev, dtype = dogs[0].device, dogs[0].dtype
    lead = dogs[0].shape[:2]
    for o, (d, e) in enumerate(zip(dogs, extrema_list)):
        if d.dim() != 4 or d.shape[:2] != lead or d.dtype != dtype or min(d.shape[1:]) < 3:
            raise ValueError(
                f"newton_ladder: dogs[{o}] must be (B, D, H, W) with (B, D) = "
                f"{tuple(lead)}, D, H, W >= 3 and dtype {dtype}; got "
                f"{tuple(d.shape)} {d.dtype}"
            )
        if not d.is_contiguous():
            raise ValueError(f"newton_ladder: dogs[{o}] must be contiguous")
        n = e.y.shape[-1]
        for name in _FIELDS:
            t = getattr(e, name)
            want = torch.int32 if name in _INT_FIELDS else (
                dtype if name == "value" else torch.bool)
            if t.device != dev:
                raise ValueError(
                    f"newton_ladder: extrema[{o}].{name} is on {t.device}, the DoGs on {dev}"
                )
            if t.dtype != want or tuple(t.shape) != (lead[0], n):
                raise ValueError(
                    f"newton_ladder: extrema[{o}].{name} must be {want} of shape "
                    f"{(lead[0], n)}; got {t.dtype} {tuple(t.shape)}"
                )


def newton_ladder(
    dogs: list[torch.Tensor],
    extrema_list: list[Extrema],
    first_octave: int,
    cfg: SiftConfig,
    caps: list[int],
    geometry: list[tuple[float, float]],
) -> tuple[Keypoints, torch.Tensor]:
    """``(keypoints, live)`` of every candidate slot (see the module),
    through the hand-written kernel, counted in ``newton_ladder.launches``.
    Raises for tensors off a CUDA device and for DoGs not float32."""
    _check(dogs, extrema_list)
    dev = dogs[0].device
    if dev.type != "cuda":
        raise ValueError(
            f"newton_ladder: no kernel for device {dev}; "
            "ops/refine.py refines tensors off a CUDA device with its tensor code"
        )
    if dogs[0].dtype != torch.float32:
        raise TypeError(
            f"newton_ladder: the kernel takes float32 DoGs, got {dogs[0].dtype}; "
            "ops/refine.py refines other dtypes with its tensor code"
        )
    if len(geometry) != len(dogs):
        raise ValueError(f"newton_ladder: {len(geometry)} geometries for {len(dogs)} octaves")
    if not 1 <= len(caps) <= MAX_STEPS:
        raise ValueError(
            f"newton_ladder: {len(caps)} Newton steps, the kernel takes 1 to {MAX_STEPS}"
        )
    b, depth = dogs[0].shape[:2]
    sizes = [e.y.shape[-1] for e in extrema_list]
    n_slots = sum(sizes)
    n_oct = len(dogs)
    # Contiguous copies where a field is not (kept alive to the launch).
    fields = [getattr(e, k).contiguous() for e in extrema_list for k in _FIELDS]
    dims, scalars = [], []
    for i, (d, (delta, sigc)) in enumerate(zip(dogs, geometry)):
        dims += [d.shape[2], d.shape[3], sizes[i], sum(sizes[:i]), first_octave + i]
        scalars += [exact_scalar(delta, torch.float32), exact_scalar(sigc, torch.float32)]
    limits = [
        exact_scalar(v, torch.float32)
        for v in (cfg.convergence_threshold, cfg.contrast_threshold_scaled,
                  cfg.edge_threshold, float(cfg.scales_per_octave))
    ]
    ints = torch.empty((5, b, n_slots), dtype=torch.int32, device=dev)
    floats = torch.empty((4, b, n_slots), dtype=torch.float32, device=dev)
    valid = torch.empty((b, n_slots), dtype=torch.bool, device=dev)
    live = torch.empty((b, len(caps)), dtype=torch.int32, device=dev)
    # The tables go to the kernel by value: host arrays, no copy.
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.sift_newton_ladder(
            (ctypes.c_void_p * n_oct)(*(d.data_ptr() for d in dogs)),
            (ctypes.c_void_p * len(fields))(*(t.data_ptr() for t in fields)),
            (ctypes.c_int * len(dims))(*dims),
            (ctypes.c_float * len(scalars))(*scalars),
            n_oct, b, depth, n_slots,
            (ctypes.c_int * len(caps))(*caps), len(caps),
            (ctypes.c_float * 4)(*limits),
            ints.data_ptr(), floats.data_ptr(), valid.data_ptr(), live.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(lib, rc, "newton_ladder")
    newton_ladder.launches += 1
    octave, s, m, n, reason = ints.unbind(0)
    abs_y, abs_x, abs_sigma, omega = floats.unbind(0)
    keypoints = Keypoints(
        octave=octave, scale_level=s, local_y=m, local_x=n, abs_y=abs_y, abs_x=abs_x,
        abs_sigma=abs_sigma, value=omega, valid=valid, reject_reason=reason,
    )
    return keypoints, live


newton_ladder.launches = 0
