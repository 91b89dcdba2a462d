"""The port's ``parallel/multihost.py`` across two processes on gloo, on the
CPU: the mirrors of ``tests/test_multihost.py`` (the landmark-sharded BA
on ``tests/ba_problem.py::make_problem`` with its inputs replicated by
``replicate_global``, and the data-parallel frontend against the
single-process result), ``put_global`` and ``replicate_global`` on their
own, and the port's dry run (``tools/torch_dryrun_multichip.py``) at world
size 2.

The ranks join through ``initialize_multihost`` with a file store; one run
of two ranks serves the module (``tests/torch_dist_ranks.py``).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.sfm.ba import (
    BAState,
    Observations,
    bundle_adjust,
)

from tests.ba_problem import make_problem
from tests.torch_dist_ranks import FRONTEND_CFG, REPO, WORLD, shared_run

torch.set_num_threads(2)

ITERATIONS = 8
ROWS = 6  # put_global's rows, 3 a rank


def frontend_images():
    """``tests/test_multihost.py``'s 8 frames of 96×128."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    imgs = []
    for k in range(8):
        img = 0.5 + 0.1 * np.sin(xx / 6.0 + k) * np.cos(yy / 8.0)
        for _ in range(30):
            cy, cx = rng.uniform(8, 88), rng.uniform(8, 120)
            r = rng.uniform(1.5, 4.0)
            img += rng.uniform(-0.3, 0.3) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        imgs.append(np.clip(img, 0.0, 1.0))
    return np.stack(imgs)


def _inputs():
    state, obs = make_problem()
    inputs = {f"bundle_adjust/problem.{k}": np.asarray(v) for k, v in {**state, **obs}.items()}
    inputs["bundle_adjust/problem.iterations"] = np.asarray(ITERATIONS)
    inputs["bundle_adjust/problem.huber"] = np.asarray(np.nan)
    inputs["frontend/images"] = frontend_images()
    inputs["multihost/rows"] = np.arange(ROWS * 2, dtype=np.float32).reshape(ROWS, 2)
    return inputs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return shared_run(tmp_path_factory, "multihost", ["bundle_adjust", "frontend", "multihost"],
                      _inputs)


def _out(ranks, prefix):
    outputs, _ = ranks
    return {k[len(prefix):]: v for k, v in outputs.items() if k.startswith(prefix)}


def test_two_process_distributed_ba_matches_single(ranks):
    state_np, obs_np = make_problem()
    state = BAState(*(torch.from_numpy(np.asarray(state_np[k]))
                      for k in ("rotations", "translations", "points", "k_mat")))
    obs = Observations(*(torch.from_numpy(np.asarray(obs_np[k]))
                         for k in ("camera", "landmark", "uv", "valid")))
    ref, ref_cost = bundle_adjust(state, obs, num_iterations=ITERATIONS, device="cpu")
    got = _out(ranks, "bundle_adjust/problem.")
    np.testing.assert_allclose(got["rotations"], ref.rotations.numpy(), atol=1e-6)
    np.testing.assert_allclose(got["translations"], ref.translations.numpy(), atol=1e-6)
    assert abs(float(got["cost"]) - float(ref_cost)) < 1e-3 * max(1.0, float(ref_cost))


def test_two_process_dp_frontend_matches_single(ranks):
    """The data-parallel frontend across two processes equals the batched
    frontend on the whole batch: the same keypoint slots, positions and
    descriptors within 1e-4."""
    images = frontend_images()
    ref = port.detect_and_describe_batched(torch.from_numpy(images),
                                           port.SiftConfig(**FRONTEND_CFG), device="cpu")
    got = _out(ranks, "frontend/")
    np.testing.assert_array_equal(got["valid"], ref.valid.numpy())
    v = ref.valid.numpy()
    assert v.sum() > 20, "degenerate test"
    for key in ("abs_x", "abs_y", "descriptor"):
        np.testing.assert_allclose(got[key][v], getattr(ref, key).numpy()[v], rtol=0, atol=1e-4)


def test_put_global_and_replicate_global(ranks):
    got = _out(ranks, "multihost/")
    rows = np.arange(ROWS * 2, dtype=np.float32).reshape(ROWS, 2)
    assert int(got["shard_rows"]) == ROWS // WORLD
    np.testing.assert_array_equal(got["gathered"], rows)
    np.testing.assert_array_equal(got["replicated"], np.full(3, 7.0, np.float32))  # rank 0's


def test_every_rank_returns_the_same_bits(ranks):
    _, digests = ranks
    assert len(digests) == WORLD
    assert all(d == digests[0] for d in digests)


def test_dryrun_multichip_at_world_2():
    proc = subprocess.run(
        [sys.executable, "tools/torch_dryrun_multichip.py", "--world", "2", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    line = next(l for l in proc.stdout.splitlines() if l.startswith("dryrun_multichip:"))
    assert "every rank's trajectory bit-equal True" in line, line
    sharded = int(line.split("sharded BAs ")[1].split(",")[0])
    assert sharded > 0, line
