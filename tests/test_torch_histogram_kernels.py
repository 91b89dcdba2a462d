"""The describe stages' two routes on the CPU: the tensor code that CPU
tensors and a caller's own sampler take, counted by route; the refusals of
R3's and R4's wrappers (``ops/kernels/histograms.py``); and the per-cell
sample lists R4 sums over. The kernels themselves are held to the tensor
code on the card (``test_torch_cuda.py``)."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.models import frontend as fe
from sift_scale_space_extrema_detection_tpu_torch.ops import descriptor
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import launch_counts, launches_since
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import histograms
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.describe import (
    window_sample_pair_reference,
)
from sift_scale_space_extrema_detection_tpu_torch.utils.profile import tracing
from tests.torch_port_helpers import textured_images

torch.set_num_threads(2)

CFG = port.SiftConfig(num_octaves=2, max_keypoints_per_trio=32)
KERNELS = ("orient_slots", "describe_pairs", "window_sample_pair")


@pytest.fixture(scope="module")
def detected():
    """Gaussian stacks and refined keypoints of two textured 48x64 frames."""
    images = torch.from_numpy(textured_images(8, 2, 48, 64))
    dogs, masks, stacks = fe._pyramid(images, CFG, "fused", emit_scales=True)
    _, selected = fe._select_candidates(dogs, CFG, masks)
    return stacks, fe._refine_per_octave(dogs, selected, CFG)


def _routes(run):
    """``run()``'s route counters and its launches of the describe kernels."""
    before = launch_counts()
    with tracing(spans=False, counters=True) as session:
        run()
    since = launches_since(before)
    routes = {k: v for k, v in session.counters.items() if k.startswith("describe.route.")}
    return routes, {k: since[k] for k in KERNELS}


@pytest.mark.parametrize("upright, sampler, stages", [
    (False, None, 2),
    (True, None, 1),
    (False, window_sample_pair_reference, 2),
])
def test_cpu_tensors_take_the_tensor_code_and_count_each_stage(detected, upright, sampler, stages):
    """On the CPU, and with a caller's own sampler, each stage runs the
    tensor code and adds 1 to describe.route.plain; nothing launches."""
    stacks, keypoints = detected
    cfg = dataclasses.replace(CFG, upright=upright)
    out = []
    routes, launched = _routes(lambda: out.append(
        descriptor.describe_compact(stacks, keypoints, cfg, sample_fn=sampler)))
    assert routes == {"describe.route.plain": stages}
    assert launched == dict.fromkeys(KERNELS, 0)
    assert int(out[0].valid.sum()) > 0


def test_the_per_octave_describe_counts_two_plain_stages_an_octave(detected):
    stacks, keypoints = detected
    routes, launched = _routes(lambda: [
        descriptor.describe_octave(s, k, o, CFG)
        for o, (s, k) in enumerate(zip(stacks, keypoints))])
    assert routes == {"describe.route.plain": 2 * CFG.num_octaves}
    assert launched == dict.fromkeys(KERNELS, 0)


def test_the_route_depends_on_the_sampler_dtype_and_device_alone():
    """float32 stacks and fields on one CUDA device, and no sampler of the
    caller's, take the kernels; anything else keeps the tensor code."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")

    def t(dev=cuda, dtype=torch.float32):
        return types.SimpleNamespace(device=dev, dtype=dtype)

    def slots(stack=None, field=None):
        stack, field = stack or t(), field or t()
        return types.SimpleNamespace(stacks=[stack, t()], y_loc=field, x_loc=t(),
                                     sigma_loc=t())

    assert descriptor.takes_kernel(slots(), None)
    assert descriptor.takes_kernel(slots(), None, t())
    assert not descriptor.takes_kernel(slots(), window_sample_pair_reference)
    assert not descriptor.takes_kernel(slots(), None, t(dtype=torch.float64))
    assert not descriptor.takes_kernel(slots(stack=t(cpu)), None)
    assert not descriptor.takes_kernel(slots(stack=t(dtype=torch.float64)), None)
    assert not descriptor.takes_kernel(slots(field=t(torch.device("cuda", 1))), None)


def _stage_args(m=6, n=16, device="cpu"):
    """The orientation wrapper's arguments for ``m`` slots on two stacks."""
    stacks = [torch.zeros((1, 4, 8, 8), device=device), torch.zeros((1, 4, 4, 4), device=device)]
    slots = torch.zeros((m, 4), dtype=torch.int32, device=device)
    fields = [torch.zeros(m, device=device) for _ in range(3)]
    grid = (torch.zeros(n, device=device), torch.zeros(n, device=device))
    return [stacks, slots, *fields, grid, CFG]


def _misaligned_slots(m=6):
    return torch.zeros(4 * m + 1, dtype=torch.int32)[1:].view(m, 4)


def _with(index, value):
    args = _stage_args()
    args[index] = value
    return args


@pytest.mark.parametrize("args, error, message", [
    (_stage_args(), ValueError, "no kernel for device cpu"),
    (_with(1, _misaligned_slots()), ValueError, "16-byte aligned"),
    (_with(2, torch.zeros(6, dtype=torch.float64)), TypeError, "y_loc must be torch.float32"),
    (_with(1, torch.zeros((6, 4), dtype=torch.int64)), TypeError, "slots must be torch.int32"),
    (_with(1, torch.zeros((6, 3), dtype=torch.int32)), ValueError, "slots must be"),
    (_with(3, torch.zeros(5)), ValueError, "x_loc must be"),
    (_with(4, torch.zeros(12)[::2]), ValueError, "sigma_loc must be contiguous"),
    (_with(2, torch.zeros(6, device="meta")), ValueError, "y_loc is on meta"),
    (_with(0, [torch.zeros((1, 4, 8, 8))] * 9), ValueError, "1 to 8 octave stacks"),
    (_with(0, [torch.zeros((1, 4, 8, 8)), torch.zeros((2, 4, 4, 4))]), ValueError, "(B, S)"),
    (_with(5, (torch.zeros(16), torch.zeros(15))), ValueError, "the grid must be"),
    (_with(5, (torch.zeros(1025), torch.zeros(1025))), ValueError, "the grid must be"),
    (_with(6, dataclasses.replace(CFG, n_orientation_bins=65)), ValueError, "3 to 64 bins"),
], ids=["cpu", "misaligned", "float64_field", "int64_slots", "slot_columns", "field_shape",
        "strided_field", "mixed_devices", "nine_octaves", "stack_batches", "grid_shapes",
        "grid_size", "bins"])
def test_orient_slots_refuses_what_the_kernel_does_not_take(args, error, message):
    before = launch_counts()
    with pytest.raises(error, match=message):
        histograms.orient_slots(*args)
    assert launches_since(before)["orient_slots"] == 0


def _pair_args(**change):
    stacks, slots, y, x, sigma, _, cfg = _stage_args()
    index, weight = descriptor._descriptor_cells(*descriptor._descriptor_key(CFG),
                                                 torch.device("cpu"))
    grid = descriptor._descriptor_grid(CFG, torch.device("cpu"))[:3]
    args = dict(stacks=stacks, slots=slots, y_loc=y, x_loc=x, sigma_loc=sigma,
                theta=torch.zeros(6), grid=grid, cells=(index, weight), cfg=cfg)
    return args | change


@pytest.mark.parametrize("change, error, message", [
    ({}, ValueError, "no kernel for device cpu"),
    (dict(theta=torch.zeros(6, dtype=torch.float64)), TypeError, "theta must be torch.float32"),
    (dict(theta=torch.zeros(7)), ValueError, "theta must be"),
    (dict(cells=(torch.zeros((16, 25), dtype=torch.int64), torch.zeros((16, 25)))), TypeError,
     "cell_index must be torch.int32"),
    (dict(cells=(torch.zeros((15, 25), dtype=torch.int32), torch.zeros((15, 25)))), ValueError,
     "the cell lists must be"),
    (dict(cfg=dataclasses.replace(CFG, descriptor_n_ori=17)), ValueError, "at most 256 bins"),
], ids=["cpu", "float64_theta", "theta_shape", "int64_cells", "cell_rows", "bins"])
def test_describe_pairs_refuses_what_the_kernel_does_not_take(change, error, message):
    before = launch_counts()
    with pytest.raises(error, match=message):
        histograms.describe_pairs(**_pair_args(**change))
    assert launches_since(before)["describe_pairs"] == 0


@pytest.mark.parametrize("g, nh, lam", [(16, 4, 6.0), (8, 4, 6.0), (12, 3, 4.5), (32, 4, 6.0)])
def test_the_cell_lists_are_the_nonzero_pattern_of_the_spatial_weights(g, nh, lam):
    """Row c lists, in ascending order, exactly the samples p with
    spatial[p, c] != 0, with those weights; then -1 and weight 0."""
    cpu = torch.device("cpu")
    spatial = descriptor._descriptor_constants(g, nh, lam, cpu)[3].numpy()
    index, weight = (t.numpy() for t in descriptor._descriptor_cells(g, nh, lam, cpu))
    assert index.shape == weight.shape and index.shape[0] == nh * nh
    for c in range(nh * nh):
        listed = index[c][index[c] >= 0]
        np.testing.assert_array_equal(listed, np.flatnonzero(spatial[:, c]))
        assert (np.diff(listed) > 0).all()
        np.testing.assert_array_equal(weight[c, : len(listed)], spatial[listed, c])
        assert (index[c, len(listed):] == -1).all() and not weight[c, len(listed):].any()
    assert (index >= 0).sum(axis=1).max() == index.shape[1]
