"""The port's rules: no JAX on its import path, no silent fallback from CUDA."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import _build
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
        kp, ex = port.detect(image, port.SiftConfig(num_octaves=2))
        assert kp.valid.shape == (kp.capacity,)
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
        port.detect(torch.rand(8, 8), port.SiftConfig(num_octaves=5))
