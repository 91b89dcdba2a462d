"""Selection's two routes on the CPU: the tensor code that CPU tensors and
float64 DoGs take, the refusals of the kernels' wrapper
(``ops/kernels/select.py``), its tile plan at the benchmark cells' shapes,
and the tensor code held to the frozen copy of the code it was before the
kernels came. The kernels themselves are held to the tensor code on the
card (``test_torch_cuda.py``)."""

import dataclasses
import types

import pytest
import torch

import sift_scale_space_extrema_detection_tpu_torch as port
from port_bench.reference import extrema as frozen
from sift_scale_space_extrema_detection_tpu_torch.models import frontend as fe
from sift_scale_space_extrema_detection_tpu_torch.ops import extrema
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import launch_counts, launches_since
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import select as select_kernel
from sift_scale_space_extrema_detection_tpu_torch.utils.profile import tracing
from tests.torch_port_helpers import textured_images

torch.set_num_threads(2)

CFG = port.SiftConfig(num_octaves=3, max_keypoints_per_trio=64)


def _planes(cfg=CFG, b=3):
    """DoGs and packed planes of ``b`` textured 64x96 frames."""
    images = torch.from_numpy(textured_images(4, b, 64, 96))
    return fe._pyramid(images, cfg, "fused", emit_scales=False)[:2]


def _equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        assert torch.equal(x, y), f.name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_and_float64_take_the_tensor_code_and_launch_nothing(dtype):
    dogs, masks = _planes()
    dogs = [d.to(dtype) for d in dogs]
    before = launch_counts()
    with tracing(spans=False, counters=True) as session:
        got = [extrema.select_refine_candidates(m, d, CFG, CFG.refine_capacity(o))
               for o, (d, m) in enumerate(zip(dogs, masks))]
    assert launches_since(before)["select_candidates"] == 0
    assert session.counters["select.route.plain"] == CFG.num_octaves
    assert "select.route.kernel" not in session.counters
    for o, (d, m) in enumerate(zip(dogs, masks)):
        want = extrema.select_refine_candidates_reference(m, d, CFG, CFG.refine_capacity(o))
        _equal(got[o], want)
    assert got[0].value.dtype == dtype and any(bool(e.valid.any()) for e in got)


def test_the_route_depends_on_device_and_dtype_alone():
    """A packed plane on a CUDA device with a float32 DoG on that device
    takes the kernels; the CPU, float64 and a DoG elsewhere keep the
    tensor code."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")

    def on(dev, dtype=torch.int16):
        return types.SimpleNamespace(device=dev, dtype=dtype)

    assert extrema.takes_kernel(on(cuda), on(cuda, torch.float32))
    assert not extrema.takes_kernel(on(cuda), on(cuda, torch.float64))
    assert not extrema.takes_kernel(on(cuda), on(torch.device("cuda", 1), torch.float32))
    assert not extrema.takes_kernel(on(cpu), on(cpu, torch.float32))
    assert not extrema.takes_kernel(on(cpu), on(cpu, torch.float64))


def _plane(b=2, t=3, h=6, w=9, dtype=torch.int16):
    return torch.zeros((b, h, w), dtype=dtype), torch.zeros((b, t + 2, h, w))


def _cpu_tensors():
    return _plane()


def _mixed_device():
    packed, dog = _plane()
    return packed, dog.to("meta")


def _float64_dog():
    packed, dog = _plane()
    return packed, dog.double()


def _non_contiguous_plane():
    packed, dog = _plane(h=9, w=6)
    return packed.transpose(1, 2), dog.transpose(2, 3).contiguous()


def _seventeen_trios():
    return _plane(t=17, dtype=torch.int32)


def _nine_trios_in_int16():
    return _plane(t=9)


def _one_by_one():
    return _plane(h=1, w=1)


@pytest.mark.parametrize("bad, error, message", [
    (_cpu_tensors, ValueError, "no kernel for device cpu"),
    (_mixed_device, ValueError, "the DoG is on meta, the plane on cpu"),
    (_float64_dog, TypeError, "float32 DoG, got torch.float64"),
    (_non_contiguous_plane, ValueError, "must be contiguous"),
    (_seventeen_trios, ValueError, "17 trios; an torch.int32 plane holds 1 to 16"),
    (_nine_trios_in_int16, ValueError, "9 trios; an torch.int16 plane holds 1 to 8"),
    (_one_by_one, ValueError, "a 1x1 plane has no pixel"),
])
def test_the_wrapper_refuses_what_the_kernels_do_not_take(bad, error, message):
    """The wrapper takes CUDA tensors of the kernels' types alone;
    ops/extrema.py routes the rest to the tensor code."""
    packed, dog = bad()
    before = launch_counts()
    with pytest.raises(error, match=message):
        select_kernel.select_candidates(packed, dog, 16)
    assert launches_since(before)["select_candidates"] == 0


# (batch, DoG planes, h, w, word bytes) -> (tile, tiles an image): every
# octave of the benchmark's cells (tum 4 x 5 scales from 960x1280, kitti
# 4 x 3 from 768x2560, the photo cell 4 x 3 from 4266x6400, its odd sides),
# and an int32 plane of 9 trios.
PLANS = [
    ((64, 7, 960, 1280, 2), (8192, 150)),
    ((64, 7, 120, 160, 2), (8192, 3)),
    ((64, 5, 768, 2560, 2), (8192, 240)),
    ((64, 5, 96, 320, 2), (8192, 4)),
    ((16, 5, 4266, 6400, 2), (8192, 3333)),
    ((16, 5, 2133, 3200, 2), (8192, 834)),
    ((16, 5, 1067, 1600, 2), (8192, 209)),
    ((16, 5, 534, 800, 2), (8192, 53)),
    ((2, 11, 33, 47, 4), (4096, 1)),
    ((1, 3, 2, 2, 2), (8192, 1)),
]


@pytest.mark.parametrize("shape, want", PLANS)
def test_the_tile_plan_follows_from_the_shapes(shape, want):
    b, depth, h, w, word_bytes = shape
    plan = select_kernel.select_tile_plan(b, depth, h, w, word_bytes)
    assert (plan.tile, plan.n_tiles) == want
    assert plan.tile * word_bytes == select_kernel.TILE_BYTES
    assert (plan.n_tiles - 1) * plan.tile < h * w <= plan.n_tiles * plan.tile
    assert plan.scratch == 3 * b * (depth - 2) * plan.n_tiles
    assert plan.dog_elements == b * depth * h * w


def test_the_photo_batch_dog_is_addressed_past_int32():
    """The photo cell's octave-0 DoG, 16 x 5 x 4266 x 6400 float32, holds
    2.18 G elements: the kernels' 64-bit offsets are needed there, and
    nowhere in the VGA and KITTI cells."""
    photo = select_kernel.select_tile_plan(16, 5, 4266, 6400, 2)
    assert photo.dog_elements == 2_184_192_000 > 2**31
    # its plane's counts stay within int32: 3 x 27.3 M codes an image
    assert 3 * 4266 * 6400 < 2**31
    for shape, _ in PLANS[:4]:
        assert select_kernel.select_tile_plan(*shape).dog_elements < 2**31


@pytest.mark.parametrize("where", ["below", "at", "above"])
def test_cpu_selection_equals_the_code_before_the_kernels(where):
    """select_refine_candidates on the CPU gives what the frozen copy of
    its tensor code gives (port_bench/reference/extrema.py), with the
    capacity below, at and above each image's total: slots, parking and
    the uncapped counters."""
    dogs, masks = _planes(b=4)
    for dog, packed in zip(dogs, masks):
        totals = extrema.unpack_mask_codes(packed, CFG.dog_per_octave - 2).eq(1).sum((1, 2, 3))
        if int(totals.max()) == 0:
            continue
        capacity = {"below": max(1, int(totals.min()) // 2), "at": int(totals.max()),
                    "above": 2 * int(totals.max()) + 7}[where]
        got = extrema.select_refine_candidates(packed, dog, CFG, capacity)
        _equal(got, frozen.select_refine_candidates(packed, dog, CFG, capacity))
        kept = got.valid.sum(-1)
        assert torch.equal(kept, totals.clamp(max=capacity).to(kept.dtype))
        assert torch.equal(got.num_candidates.sum(-1), totals.to(torch.int32))
