"""Refinement's two routes on the CPU: the tensor code that CPU tensors
take, the refusals of the kernel's wrapper (``ops/kernels/refine.py``),
the caps ``ops/refine.py`` hands the kernel, and the route it takes by
dtype and device. The kernel itself is held to the tensor code on the
card (``test_torch_cuda.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.core.types import Extrema
from sift_scale_space_extrema_detection_tpu_torch.models import frontend as fe
from sift_scale_space_extrema_detection_tpu_torch.ops import refine
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import launch_counts, launches_since
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import refine as refine_kernel
from sift_scale_space_extrema_detection_tpu_torch.utils.profile import tracing
from tests.torch_port_helpers import textured_images

torch.set_num_threads(2)

CFG = port.SiftConfig(num_octaves=3, max_keypoints_per_trio=64)


def _selected(cfg=CFG, b=3):
    """DoGs and refinement candidates of ``b`` textured 64x96 frames."""
    images = torch.from_numpy(textured_images(4, b, 64, 96))
    dogs, masks, _ = fe._pyramid(images, cfg, "fused", emit_scales=False)
    _, selected = fe._select_candidates(dogs, cfg, masks)
    return dogs, selected


def _overflow_case(b=2, n=1000, seed=1):
    """A DoG ``(b, 7, 24, 32)`` of ``1e3 e^(-0.7 x)`` times a bowl in scale
    and row, with ``n`` candidates an image near the bowl's floor, 90 %
    valid: every Newton step moves a slot one column and none converges or
    leaves, so every cap of the ladder fills."""
    rng = np.random.default_rng(seed)
    ss, yy, xx = np.mgrid[0:7, 0:24, 0:32]
    dog = 1e3 * np.exp(-0.7 * xx) * (1 + 0.3 * (ss - 3) ** 2 + 0.3 * (yy - 12) ** 2)
    dog = (dog * (1 + 1e-3 * rng.standard_normal((b, 7, 24, 32)))).astype(np.float32)
    s = rng.integers(2, 5, (b, n)).astype(np.int32)
    y = rng.integers(9, 16, (b, n)).astype(np.int32)
    x = rng.integers(1, 13, (b, n)).astype(np.int32)
    counts = np.zeros((b, 5), np.int32)
    fields = dict(y=y, x=x, scale_level=s, value=dog[np.arange(b)[:, None], s, y, x],
                  valid=rng.random((b, n)) < 0.9, num_candidates=counts,
                  num_low_contrast=counts)
    return torch.from_numpy(dog), Extrema(**{k: torch.from_numpy(v) for k, v in fields.items()})


def _equal(a, b):
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


@pytest.mark.parametrize("route", ["octave", "pool", "tail_pool", "overflow"])
def test_cpu_tensors_take_the_tensor_code_and_count_its_steps(route):
    """On the CPU refine_keypoints(_multi) run the tensor code, count one
    plain call, launch nothing, and count each step's live slots within
    the caps the kernel would be handed."""
    if route == "overflow":
        dog, extrema = _overflow_case()
        dogs, selected, first = [dog], [extrema], 1
    else:
        dogs, selected = _selected()
        first = 0 if route == "pool" else 1  # octave 0 of these frames holds no candidate
        dogs, selected = (dogs[1:2], selected[1:2]) if route == "octave" else (
            dogs[first:], selected[first:])
    pooled = route in ("pool", "tail_pool")
    n = sum(e.y.shape[-1] for e in selected)
    pool_cap = refine._pool_cap(CFG, n) if pooled else None
    before = launch_counts()
    with tracing(spans=False, counters=True) as session:
        if pooled:
            got = refine.refine_keypoints_multi(dogs, selected, CFG, octave_offset=first)
        else:
            got = refine.refine_keypoints(dogs[0], selected[0], first, CFG)
    assert launches_since(before)["newton_ladder"] == 0
    _equal(got, refine.newton_ladder_reference(dogs, selected, first, CFG, pool_cap))
    c = session.counters
    assert c["refine.route.plain"] == 1 and "refine.route.kernel" not in c
    tag = f"o{first}" if len(dogs) == 1 else f"o{first}-{first + len(dogs) - 1}"
    steps = range(1, CFG.max_refine_iterations + 1)
    live = torch.tensor([int(c[f"refine.slots_live.{tag}.s{i}"]) for i in steps])
    caps = torch.tensor(refine._kernel_caps(CFG, n, pool_cap)) * dogs[0].shape[0]
    assert live[0] > 0 and (live <= caps).all() and (live[1:] <= live[:-1]).all()
    if route == "overflow":  # every cap of the ladder fills
        assert (live[1:] == caps[1:]).all()


@pytest.mark.parametrize("n_slots", [64, 300, 1050, 2560, 4864])
@pytest.mark.parametrize("schedule", [(0.35, 0.15, 0.08), (), (0.5,)])
def test_the_caps_handed_to_the_kernel_are_the_ladders_and_the_pools(n_slots, schedule):
    cfg = dataclasses.replace(CFG, refine_compaction_schedule=schedule)
    ladder = refine._ladder_caps(cfg, n_slots)
    assert refine._kernel_caps(cfg, n_slots, None) == [n_slots, *ladder]
    # refine_keypoints_multi's pool: the first min(n, max(256, int(0.7 n)))
    pool = min(n_slots, max(256, int(n_slots * cfg.refine_pool_compaction)))
    assert refine._pool_cap(cfg, n_slots) == pool
    assert refine._kernel_caps(cfg, n_slots, pool) == [pool, *ladder]
    assert len(ladder) == cfg.max_refine_iterations - 1


def _non_contiguous(dogs, selected):
    return [dogs[0].transpose(2, 3).contiguous().transpose(2, 3)], selected[:1]


def _mixed_device(dogs, selected):
    e = selected[0]
    return dogs[:1], [dataclasses.replace(e, valid=e.valid.to("meta"))]


def _nine_octaves(dogs, selected):
    return dogs[:1] * 9, selected[:1] * 9


def _int64_positions(dogs, selected):
    e = selected[0]
    return dogs[:1], [dataclasses.replace(e, y=e.y.long())]


def _cpu_tensors(dogs, selected):
    return dogs[:1], selected[:1]


@pytest.mark.parametrize("bad, message", [
    (_non_contiguous, "dogs\\[0\\] must be contiguous"),
    (_mixed_device, "valid is on meta, the DoGs on cpu"),
    (_nine_octaves, "1 to 8 octaves"),
    (_int64_positions, "y must be torch.int32"),
    (_cpu_tensors, "no kernel for device cpu"),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad, message):
    """The wrapper takes CUDA tensors of the kernel's types alone;
    ops/refine.py casts the candidates and routes the rest."""
    dogs, selected = bad(*_selected(b=2))
    n = sum(e.y.shape[-1] for e in selected)
    geometry = [refine._octave_geometry(o, CFG) for o in range(len(dogs))]
    with pytest.raises(ValueError, match=message):
        refine_kernel.newton_ladder(dogs, selected, 0, CFG, refine._kernel_caps(CFG, n, None),
                                    geometry)


def test_the_route_depends_on_dtype_and_device_alone():
    """float32 on a CUDA device takes the kernel; the float64 oracle leg
    and the CPU keep the tensor code (and count as the plain route)."""
    cuda = torch.device("cuda", 0)
    assert refine.takes_kernel(torch.float32, cuda)
    assert not refine.takes_kernel(torch.float64, cuda)
    assert not refine.takes_kernel(torch.float32, torch.device("cpu"))
    assert not refine.takes_kernel(torch.float64, torch.device("cpu"))
    dogs, selected = _selected(b=1)
    dogs64 = [d.double() for d in dogs]
    sel64 = [dataclasses.replace(e, value=e.value.double()) for e in selected]
    before = launch_counts()
    with tracing(spans=False, counters=True) as session:
        got = [refine.refine_keypoints(d, e, o, CFG) for o, (d, e) in enumerate(zip(dogs64, sel64))]
    assert launches_since(before)["newton_ladder"] == 0
    assert session.counters["refine.route.plain"] == CFG.num_octaves
    assert "refine.route.kernel" not in session.counters
    assert got[0].abs_x.dtype == torch.float64 and any(k.valid.any() for k in got)
