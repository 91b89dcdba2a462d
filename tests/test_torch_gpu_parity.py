"""``tools/torch_gpu_parity.py``: its pinned frames and comparison against
``benchmarks/tpu_parity.py``'s (taken out of the source with ``ast``; the
file is not imported), and both steps end to end at a toy size, the card
step on the CPU's plain versions."""

import ast
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "benchmarks" / "tpu_parity.py"

spec = importlib.util.spec_from_file_location("torch_gpu_parity", REPO / "tools" / "torch_gpu_parity.py")
gpu_parity = importlib.util.module_from_spec(spec)
spec.loader.exec_module(gpu_parity)


def _original():
    """``tpu_parity.py``'s ``textured_batch``, thresholds and the statements of
    ``main`` that compare its two runs (``tpu`` against ``cpu``)."""
    tree = ast.parse(SOURCE.read_text(), filename=str(SOURCE))
    ns = {"np": np}
    top = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "textured_batch"]
    top += [n for n in tree.body if isinstance(n, ast.Assign)]
    exec(compile(ast.Module(body=top, type_ignores=[]), str(SOURCE), "exec"), ns)
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    names = [getattr(n.targets[0], "id", None) if isinstance(n, ast.Assign) else None
             for n in main.body]
    first, last = names.index("slot_eq"), names.index("min_cos")
    compare = ast.Module(body=main.body[first : last + 1], type_ignores=[])
    return ns, compile(compare, str(SOURCE), "exec")


def test_frames_and_thresholds_are_the_originals():
    ns, _ = _original()
    for args in ((2, 48, 64), (3, 40, 56, 2)):
        got = gpu_parity.textured_batch(*args)
        np.testing.assert_array_equal(got, ns["textured_batch"](*args))
    assert (gpu_parity.THRESH_AGREEMENT, gpu_parity.THRESH_P99_PX, gpu_parity.THRESH_MIN_COS) == (
        ns["THRESH_AGREEMENT"], ns["THRESH_P99_PX"], ns["THRESH_MIN_COS"])
    assert "textured_batch(16, 480, 640)" in SOURCE.read_text()
    assert gpu_parity.SHAPE == (16, 480, 640)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_comparison_is_the_originals(seed):
    rng = np.random.default_rng(seed)
    b, n = 3, 50
    want = {
        "valid": rng.random((b, n)) < 0.6,
        "octave": rng.integers(0, 3, (b, n)),
        "scale_level": rng.integers(1, 4, (b, n)),
        "abs_x": rng.random((b, n)) * 100,
        "abs_y": rng.random((b, n)) * 100,
        "descriptor": rng.random((b, n, 128)).astype(np.float32),
    }
    got = {k: v.copy() for k, v in want.items()}
    got["valid"][0, :5] = ~got["valid"][0, :5]
    got["octave"][1, 3] += 1
    got["abs_x"] += rng.normal(0, 0.05, (b, n))
    got["descriptor"] += rng.normal(0, 0.01, (b, n, 128)).astype(np.float32)
    _, code = _original()
    ns = {"np": np, "tpu": got, "cpu": want}
    exec(code, ns)
    result = gpu_parity.parity(got, want)
    assert result["slot_agreement"] == ns["agreement"]
    assert result["p99_position_px"] == ns["p99"]
    assert result["descriptor_min_cos"] == ns["min_cos"]
    assert result["pass"] is False  # 5 flipped slots of 150


def test_both_steps_at_a_toy_size(tmp_path, capsys):
    npz, out = tmp_path / "parity.npz", tmp_path / "parity.json"
    shape = ["2", "96", "128"]
    assert gpu_parity.main(["--card", "--device", "cpu", "--shape", *shape, "--npz", str(npz)]) == 0
    assert gpu_parity.main(["--compare", "--shape", *shape, "--npz", str(npz), "--out", str(out),
                            "--chunk", "1"]) == 0
    result = json.loads(out.read_text())
    assert result["images"] == [2, 96, 128] and result["pass"]
    for blur in gpu_parity.BLURS:
        assert result[blur]["valid_port"] == result[blur]["valid_jax"] > 0
        assert result[blur]["slot_agreement"] == 1.0
    # Frames are independent: one frame a JAX call gives what two do.
    images = gpu_parity.textured_batch(2, 96, 128)
    one, two = gpu_parity.run_reference(images, 1), gpu_parity.run_reference(images, 2)
    for f in gpu_parity.FIELDS:
        np.testing.assert_array_equal(one[f], two[f])


def test_card_step_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        gpu_parity.main(["--card", "--shape", "1", "32", "32", "--npz", str(tmp_path / "x.npz")])
    assert not (tmp_path / "x.npz").exists()
