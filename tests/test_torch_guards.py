"""The port's rules: no JAX on its import path, no silent fallback from CUDA."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import _build
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.blur import blur_fused
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.describe import (
    window_sample_pair,
)
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import fused_octave

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def test_port_runs_without_importing_jax():
    # A fresh interpreter: this process has jax loaded by conftest.
    code = textwrap.dedent(
        """
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import sift_scale_space_extrema_detection_tpu_torch as port
        rng = np.random.default_rng(0)
        image = torch.from_numpy((rng.random((24, 32)) * 255).astype(np.uint8))
        kp, ex = port.detect(image, port.SiftConfig(num_octaves=2), device="cpu")
        assert kp.valid.shape == (kp.capacity,)
        described = port.detect_and_describe(
            image, port.SiftConfig(num_octaves=2), device="cpu"
        )
        assert described.descriptor.shape == (described.capacity, 128)
        port.build_scale_space(
            image.float(), port.SiftConfig(num_octaves=2), "cuda", device="cpu"
        )
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
        assert not leaked, leaked
        assert "sift_scale_space_extrema_detection_tpu" not in sys.modules
        print("ok", int(kp.valid.sum()))
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok ")


def test_load_kernels_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    _build.load_kernels.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load_kernels()
    finally:
        _build.load_kernels.cache_clear()


def test_fused_octave_has_no_fallback_for_other_devices():
    base = torch.empty((1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_octave(base, [0.8, 1.0, 1.2, 1.4], 1, 0.01)


@pytest.mark.parametrize(
    "base, error",
    [
        (torch.zeros((1, 8, 8), dtype=torch.float64), TypeError),
        (torch.zeros((8, 8)), ValueError),
        (torch.zeros((1, 8, 16))[..., ::2], ValueError),
    ],
    ids=["float64", "2d", "strided"],
)
def test_fused_octave_checks_its_input(base, error):
    with pytest.raises(error):
        fused_octave(base, [0.8, 1.0, 1.2, 1.4], 1, 0.01)


def test_octave_smaller_than_two_pixels_raises():
    # 8x8 input: octave 0 is 16x16, octave 4 is 1x1.
    with pytest.raises(ValueError, match="fewer octaves"):
        port.detect(torch.rand(8, 8), port.SiftConfig(num_octaves=5), device="cpu")


def test_blur_fused_has_no_fallback_for_other_devices():
    with pytest.raises(ValueError, match="no kernel for device"):
        blur_fused(torch.empty((1, 8, 8), device="meta"), 1.2)


@pytest.mark.parametrize(
    "image, error",
    [
        (torch.zeros((1, 8, 8), dtype=torch.float64), TypeError),
        (torch.zeros((8,)), ValueError),
        (torch.zeros((1, 8, 16))[..., ::2], ValueError),
    ],
    ids=["float64", "1d", "strided"],
)
def test_blur_fused_checks_its_input(image, error):
    with pytest.raises(error):
        blur_fused(image, 1.2)


def _sample_args(device="cpu"):
    stacks = [torch.zeros((1, 4, 8, 8), device=device), torch.zeros((1, 4, 4, 4), device=device)]
    slots = torch.zeros((3, 4), dtype=torch.int32, device=device)
    coords = torch.zeros((3, 5), device=device)
    return stacks, slots, coords, coords.clone()


def test_window_sample_pair_has_no_fallback_for_other_devices():
    with pytest.raises(ValueError, match="no kernel for device"):
        window_sample_pair(*_sample_args("meta"))


def _with(index, value):
    args = list(_sample_args())
    args[index] = value
    return args


@pytest.mark.parametrize(
    "args, error",
    [
        (_with(2, torch.zeros((3, 5), dtype=torch.float64)), TypeError),
        (_with(1, torch.zeros((3, 4), dtype=torch.int64)), TypeError),
        (_with(0, [torch.zeros((1, 4, 8, 8), dtype=torch.float16)]), TypeError),
        (_with(3, torch.zeros((3, 10))[:, ::2]), ValueError),
        (_with(0, [torch.zeros((1, 4, 8, 16))[..., ::2]]), ValueError),
        (_with(1, torch.zeros((3, 5), dtype=torch.int32)), ValueError),
        (_with(3, torch.zeros((3, 6))), ValueError),
        (_with(0, [torch.zeros((1, 4, 8, 8)), torch.zeros((2, 4, 4, 4))]), ValueError),
        (_with(0, []), ValueError),
        (_with(1, torch.zeros((3, 4), dtype=torch.int32, device="meta")), ValueError),
    ],
    ids=[
        "float64_coords", "int64_slots", "float16_stack", "strided_coords",
        "strided_stack", "slot_columns", "coords_shapes", "stack_batches",
        "no_stack", "mixed_devices",
    ],
)
def test_window_sample_pair_checks_its_input(args, error):
    with pytest.raises(error):
        window_sample_pair(*args)


def test_unknown_blur_strategy_raises():
    with pytest.raises(KeyError):
        port.build_scale_space(
            torch.rand(1, 8, 8), port.SiftConfig(num_octaves=1), "matmul", device="cpu"
        )


_CFG = port.SiftConfig(num_octaves=2)
ENTRY_POINTS = {
    "detect": lambda **kw: port.detect(torch.rand(16, 20), _CFG, **kw),
    "detect_batched": lambda **kw: port.detect_batched(torch.rand(1, 16, 20), _CFG, **kw),
    "detect_and_describe": lambda **kw: port.detect_and_describe(
        torch.rand(16, 20), _CFG, **kw
    ),
    "detect_and_describe_batched": lambda **kw: port.detect_and_describe_batched(
        torch.rand(1, 16, 20), _CFG, **kw
    ),
    "build_pyramid_fused": lambda **kw: port.build_pyramid_fused(
        torch.rand(1, 16, 20), _CFG, **kw
    ),
    "build_scale_space": lambda **kw: port.build_scale_space(
        torch.rand(1, 16, 20), _CFG, **kw
    ),
}


def _tensors(result):
    """Every tensor of an entry point's result (dataclasses, lists, tuples)."""
    if isinstance(result, torch.Tensor):
        return [result]
    if isinstance(result, (list, tuple)):
        return [t for item in result for t in _tensors(item)]
    return [t for value in vars(result).values() for t in _tensors(value)]


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_card_unless_asked_for_the_cpu(name, monkeypatch):
    # Without a CUDA device the default raises and names the way out; it
    # never carries on on the CPU by itself.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()
    tensors = _tensors(ENTRY_POINTS[name](device="cpu"))
    assert tensors and all(t.device.type == "cpu" for t in tensors)
