"""The port's CLI (``cli.py``) against the JAX package's on the same PNG.

``--float64 --blur exact`` is the bit-parity mode: both CLIs print the same
``--verbose`` lines and reject counts, write the same keypoint records and
the same galleries, and both are faithful to ``utils/oracle.py`` as the
repository's parity tests hold them (``tests/test_pipeline_parity.py``).
The one field that can differ is ``absoluteSigma``, in its last bits:
``σ_coeff · 2^((a₀+s)/spo)`` goes through XLA's ``exp2`` (``exp(x·ln 2)``
with XLA's own ``exp``) in one package and ``torch.exp2`` in the other,
neither of them correctly rounded; it is held within 1e-15 relative here.
In float32, ``--blur separable`` is held to the port's bars: slot agreement
≥ 0.999 and p99 position delta ≤ 0.1 px. Then mirrors of the JAX package's
CLI tests (``tests/test_utils_cli.py``) against the port."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu.cli import main as jax_main
from sift_scale_space_extrema_detection_tpu_torch.cli import main as port_main
from sift_scale_space_extrema_detection_tpu_torch.core.image import load_image_gray, write_png
from sift_scale_space_extrema_detection_tpu_torch.utils import oracle
from sift_scale_space_extrema_detection_tpu_torch.utils import visualize as vis

torch.set_num_threads(2)

SLOT_AGREEMENT = 0.999
P99_PX = 0.1
GALLERIES = [f"{kind}_octave{o}.png" for kind in ("gaussian", "dog", "candidates")
             for o in range(3)] + ["keypoints.png"]


def _image(seed: int, h: int = 96, w: int = 128) -> np.ndarray:
    """A smooth pattern with 150 Gaussian blobs and a little noise, uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 0.4 + 0.2 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    for _ in range(150):
        cy, cx = rng.uniform(5, h - 5), rng.uniform(5, w - 5)
        r, a = rng.uniform(1.5, 5.0), rng.uniform(-0.4, 0.4)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
    img = np.clip(img + 0.03 * rng.standard_normal((h, w)), 0.0, 1.0)
    return np.round(img * 255.0).astype(np.uint8)


@pytest.fixture
def image_path(tmp_path):
    path = str(tmp_path / "in.png")
    write_png(path, _image(1))
    return path


def _run(main, capsys, path, outdir, *flags):
    rc = main([path, "-o", outdir, "--octaves", "3", *flags])
    assert rc == 0
    return capsys.readouterr().out.splitlines()


def _records(outdir):
    with open(os.path.join(outdir, "keypoints.json")) as f:
        return json.load(f)


def _key(record):
    return (record["octave"], record["scaleLevel"], record["localY"], record["localX"])


def test_float64_exact_cli_is_the_references_and_the_oracles(image_path, tmp_path, capsys):
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    flags = ("--float64", "--blur", "exact", "--verbose")
    jax_lines = _run(jax_main, capsys, image_path, jout, *flags)
    port_lines = _run(port_main, capsys, image_path, pout, *flags)

    # Every printed line but the timing and the output directory.
    def same(lines):
        return [ln for ln in lines if not ln.startswith(("pipeline:", "galleries"))]

    assert same(port_lines) == same(jax_lines)
    assert sum(ln.startswith("  octave") for ln in port_lines) > 20
    got, want = _records(pout), _records(jout)
    assert got["rejectionCounts"] == want["rejectionCounts"]
    assert len(got["keypoints"]) == len(want["keypoints"]) > 5
    for g, w in zip(got["keypoints"], want["keypoints"]):
        assert {k: v for k, v in g.items() if k != "absoluteSigma"} == {
            k: v for k, v in w.items() if k != "absoluteSigma"
        }
        np.testing.assert_allclose(g["absoluteSigma"], w["absoluteSigma"], rtol=1e-15)
    for name in GALLERIES:
        with Image.open(os.path.join(jout, name)) as a, Image.open(os.path.join(pout, name)) as b:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=name)

    # Both against the oracle, at the bars of tests/test_pipeline_parity.py.
    ref = oracle.detect(load_image_gray(image_path), number_of_octaves=3)["refinedKeypoints"]
    assert sorted(map(_key, got["keypoints"])) == sorted(map(_key, ref))
    ours = {_key(r): r for r in got["keypoints"]}
    for kp in ref:
        r = ours[_key(kp)]
        for field in ("absoluteX", "absoluteY", "interpolatedValue"):
            np.testing.assert_allclose(r[field], kp[field], rtol=0, atol=1e-10)
        np.testing.assert_allclose(r["absoluteSigma"], kp["absoluteSigma"], rtol=1e-10)


def test_float32_separable_cli_agrees_with_the_reference(image_path, tmp_path, capsys):
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    _run(jax_main, capsys, image_path, jout, "--blur", "separable", "--no-galleries")
    _run(port_main, capsys, image_path, pout, "--blur", "separable", "--device", "cpu",
         "--no-galleries")
    got, want = _records(pout)["keypoints"], _records(jout)["keypoints"]
    matched, p99 = chip_smoke.record_agreement(got, want)
    assert len(want) > 10
    assert matched >= SLOT_AGREEMENT, (matched, len(got), len(want))
    assert p99 <= P99_PX


@pytest.mark.parametrize("blur", ["cuda", "separable", "matmul"])
def test_every_blur_agrees_with_the_fused_main_path(image_path, tmp_path, capsys, blur):
    # On the CPU each kernel strategy runs its plain version.
    _run(port_main, capsys, image_path, str(tmp_path / "fused"), "--device", "cpu",
         "--no-galleries")
    _run(port_main, capsys, image_path, str(tmp_path / blur), "--device", "cpu",
         "--no-galleries", "--blur", blur)
    got = _records(str(tmp_path / blur))["keypoints"]
    want = _records(str(tmp_path / "fused"))["keypoints"]
    matched, p99 = chip_smoke.record_agreement(got, want)
    assert len(want) > 10
    assert matched >= SLOT_AGREEMENT and p99 <= P99_PX, (matched, p99)


def test_descriptors_are_described_octave_by_octave(image_path, tmp_path, capsys):
    out = str(tmp_path / "out")
    lines = _run(port_main, capsys, image_path, out, "--device", "cpu", "--descriptors",
                 "--no-galleries")
    with np.load(os.path.join(out, "descriptors.npz")) as npz:
        d = dict(npz)
    assert sorted(d) == ["abs_sigma", "abs_x", "abs_y", "descriptor", "theta"]
    n = d["descriptor"].shape[0]
    assert n > 10
    assert f"descriptors: {n} → descriptors.npz" in lines
    np.testing.assert_allclose(np.linalg.norm(d["descriptor"], axis=1), 1.0, atol=1e-5)
    # The same keypoints through the library's per-octave describe.
    cfg = port.SiftConfig(num_octaves=3, compact_describe=False)
    image = torch.from_numpy(load_image_gray(image_path, np.float32))
    want = port.detect_and_describe(image, cfg, device="cpu")
    np.testing.assert_array_equal(d["descriptor"], want.descriptor[want.valid].numpy())
    np.testing.assert_array_equal(d["theta"], want.theta[want.valid].numpy())


@pytest.mark.parametrize("blur", ["fused", "cuda"])
def test_float64_refuses_the_kernels(image_path, tmp_path, blur):
    with pytest.raises(SystemExit, match="float32 only"):
        port_main([image_path, "-o", str(tmp_path), "--float64", "--blur", blur])


def test_float64_refuses_the_card(image_path, tmp_path):
    with pytest.raises(SystemExit, match="CPU"):
        port_main([image_path, "-o", str(tmp_path), "--float64", "--blur", "exact",
                   "--device", "cuda"])


# --- mirrors of tests/test_utils_cli.py -------------------------------------------


def test_gallery_and_overlay(test_image):
    stack = np.stack([test_image] * 3)
    img = vis.gallery_image(stack, normalize="sigmoid")
    assert img.dtype == np.uint8
    assert img.shape[0] == test_image.shape[0]

    cfg = port.SiftConfig(num_octaves=3, max_keypoints_per_trio=128)
    keypoints, _ = port.detect(torch.from_numpy(test_image.astype(np.float32)), cfg, device="cpu")
    rgb = vis.draw_keypoints(test_image, keypoints)
    assert rgb.shape == test_image.shape + (3,)
    # Some green circle pixels must exist.
    green = (rgb[..., 1] == 255) & (rgb[..., 0] == 0)
    assert green.sum() > 0


def test_cli_end_to_end(tmp_path, test_image):
    img_path = str(tmp_path / "in.png")
    Image.fromarray((test_image * 255).astype(np.uint8)).save(img_path)
    out = str(tmp_path / "out")
    rc = port_main([img_path, "-o", out, "--octaves", "3", "--capacity", "128", "--device", "cpu"])
    assert rc == 0
    data = _records(out)
    assert len(data["keypoints"]) > 0
    assert {"octave", "scaleLevel", "absoluteSigma", "absoluteX"} <= set(data["keypoints"][0])
    assert os.path.exists(os.path.join(out, "gaussian_octave0.png"))
    assert os.path.exists(os.path.join(out, "dog_octave2.png"))
    assert os.path.exists(os.path.join(out, "keypoints.png"))


def test_quality_preset_detects_denser():
    """``SiftConfig.quality()`` detects at least twice the keypoints of
    reference parity on the descriptor bench's textured image."""
    import sys as _sys

    _sys.path.insert(0, "benchmarks")
    import descriptor_bench as dbench

    img = torch.from_numpy(dbench.textured_image(np.random.default_rng(7)).astype(np.float32))
    kw = dict(num_octaves=3, max_keypoints_per_trio=256)
    n_parity = int(port.detect_and_describe(img, port.SiftConfig(**kw), device="cpu").valid.sum())
    n_quality = int(
        port.detect_and_describe(img, port.SiftConfig.quality(**kw), device="cpu").valid.sum()
    )
    assert n_quality >= 2 * n_parity, (n_parity, n_quality)
