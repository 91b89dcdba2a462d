"""The port's checkpoint, profiling, metrics and debug utilities, against
the JAX package's: checkpoints cross between the two packages bit for bit
(the npz + JSON format, both directions), ``keypoint_stats`` reads the same
counters from the same keypoints, and the mirrors of
``tests/test_utils_cli.py``'s checkpoint, timer and debug tests."""

import dataclasses
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sift_scale_space_extrema_detection_tpu.core import types as jtypes
from sift_scale_space_extrema_detection_tpu.sfm.ba import BAState as JBAState
from sift_scale_space_extrema_detection_tpu.utils import checkpoint as jckpt
from sift_scale_space_extrema_detection_tpu.utils import metrics as jmetrics
import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.sfm.ba import BAState
from sift_scale_space_extrema_detection_tpu_torch.utils import checkpoint as pckpt
from sift_scale_space_extrema_detection_tpu_torch.utils.debug import assert_finite, checked
from sift_scale_space_extrema_detection_tpu_torch.utils.metrics import (
    StageTimer,
    device_sync,
    keypoint_stats,
    trace,
)
from sift_scale_space_extrema_detection_tpu_torch.utils.profile import StageProfile

torch.set_num_threads(2)


def _slam_state(seed=0, frames=6, landmarks=40, n_obs=90):
    """A flat SLAM state of ``run_slam``'s keys and dtypes, from a seed."""
    rng = np.random.default_rng(seed)
    points = rng.normal(size=(landmarks, 3))
    points[::7] = np.nan
    return {
        "frame": np.asarray(frames - 1),
        "est_r": rng.normal(size=(frames, 3, 3)),
        "est_t": rng.normal(size=(frames, 3)),
        "points": points,
        "lm_valid": rng.random(landmarks) < 0.7,
        "first_seen_kf": rng.integers(-1, frames, landmarks),
        "obs_cam": rng.integers(0, frames, n_obs),
        "obs_lm": rng.integers(0, landmarks, n_obs),
        "obs_uv": rng.uniform(0, 640, size=(n_obs, 2)),
    }


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        got_k, want_k = np.asarray(got[key]), np.asarray(want[key])
        assert got_k.dtype == want_k.dtype and got_k.shape == want_k.shape, key
        np.testing.assert_array_equal(got_k, want_k, err_msg=key)


def _ba_state(module, cls):
    return cls(
        rotations=module.tile(module.eye(3), (4, 1, 1)),
        translations=module.arange(12.0).reshape(4, 3),
        points=module.arange(30.0).reshape(10, 3),
        k_mat=module.eye(3),
    )


def test_checkpoint_roundtrip(tmp_path):
    state = BAState(
        rotations=torch.eye(3).repeat(4, 1, 1),
        translations=torch.arange(12.0).reshape(4, 3),
        points=torch.arange(30.0).reshape(10, 3),
        k_mat=torch.eye(3),
    )
    path = pckpt.save_checkpoint(str(tmp_path / "ckpt"), state, step=7)
    assert path.endswith("step_7.npz")
    template = BAState(**{k: torch.zeros_like(v) for k, v in vars(state).items()})
    restored = pckpt.restore_checkpoint(path, template)
    for name, value in vars(state).items():
        assert torch.equal(getattr(restored, name), value), name
    assert pckpt.checkpoint_exists(path[: -len(".npz")])
    pckpt.remove_checkpoint(path[: -len(".npz")])
    assert not pckpt.checkpoint_exists(path[: -len(".npz")])


def test_flat_checkpoint_on_disk_and_in_memory(tmp_path):
    state = _slam_state()
    for root in (str(tmp_path / "slam"), "mem://test_torch_utils_flat"):
        written = pckpt.save_checkpoint(root, state)
        path = root.rstrip("/") + "/state"
        assert pckpt.checkpoint_exists(path)
        restored = pckpt.restore_checkpoint_flat(path)
        _assert_same_state(restored, state)
        # Copies on save and on restore: neither side aliases the store.
        restored["est_t"][:] = 0.0
        state_tensor = dict(state, est_t=torch.from_numpy(state["est_t"]))
        pckpt.save_checkpoint(root, state_tensor)
        _assert_same_state(pckpt.restore_checkpoint_flat(path), state)
        pckpt.remove_checkpoint(root if root.startswith("mem://") else path)
        assert not pckpt.checkpoint_exists(path), written


def test_mem_store_eviction_is_by_prefix():
    pckpt.save_checkpoint("mem://evict_a", {"x": np.ones(3)})
    pckpt.save_checkpoint("mem://evict_a", {"x": np.ones(3)}, step=2)
    pckpt.save_checkpoint("mem://evict_ab", {"x": np.ones(3)})
    pckpt.remove_checkpoint("mem://evict_a")
    assert not pckpt.checkpoint_exists("mem://evict_a/state")
    assert not pckpt.checkpoint_exists("mem://evict_a/step_2")
    assert pckpt.checkpoint_exists("mem://evict_ab/state")
    pckpt.remove_checkpoint("mem://evict_ab")
    assert not [k for k in pckpt._MEM_STORE if k.startswith("mem://evict_")]
    with pytest.raises(TypeError, match="flat dicts"):
        pckpt.save_checkpoint("mem://evict_c", BAState(*(torch.zeros(1),) * 4))


def test_the_port_reads_the_references_flat_slam_state(tmp_path, monkeypatch):
    monkeypatch.setattr(jckpt, "_orbax", lambda: None)
    state = _slam_state(1)
    written = jckpt.save_checkpoint(str(tmp_path / "ref"), state, step=None)
    assert written.endswith(".npz")
    _assert_same_state(pckpt.restore_checkpoint_flat(str(tmp_path / "ref" / "state")), state)


def test_the_reference_reads_the_ports_flat_slam_state(tmp_path):
    state = _slam_state(2)
    pckpt.save_checkpoint(str(tmp_path / "port"), state)
    restored = jckpt.restore_checkpoint_flat(str(tmp_path / "port" / "state"))
    _assert_same_state(restored, state)


def test_ba_state_checkpoints_cross_both_ways(tmp_path, monkeypatch):
    monkeypatch.setattr(jckpt, "_orbax", lambda: None)
    jstate = _ba_state(jnp, JBAState)
    path = jckpt.save_checkpoint(str(tmp_path / "ref"), jstate, step=3)
    template = BAState(*(torch.zeros(s) for s in ((4, 3, 3), (4, 3), (10, 3), (3, 3))))
    got = pckpt.restore_checkpoint(path, template)
    for name in ("rotations", "translations", "points", "k_mat"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(jstate, name)))

    pstate = _ba_state(torch, BAState)
    ppath = pckpt.save_checkpoint(str(tmp_path / "port"), pstate, step=3)
    with open(ppath[:-4] + ".json") as f:
        paths = json.load(f)["paths"]
    assert paths == [".rotations", ".translations", ".points", ".k_mat"]
    jtemplate = JBAState(*(jnp.zeros(np.shape(v)) for v in vars(pstate).values()))
    back = jckpt.restore_checkpoint(ppath, jtemplate)
    for name in ("rotations", "translations", "points", "k_mat"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)), getattr(pstate, name).numpy())


def test_an_orbax_checkpoint_is_refused(tmp_path):
    (tmp_path / "ck" / "state").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="orbax"):
        pckpt.restore_checkpoint_flat(str(tmp_path / "ck" / "state"))


def _to_jax(cls, value):
    return cls(**{f.name: jnp.asarray(getattr(value, f.name).numpy())
                  for f in dataclasses.fields(value)})


@pytest.mark.parametrize("with_extrema", [False, True])
def test_keypoint_stats_match_the_reference(test_image, with_extrema):
    cfg = port.SiftConfig(num_octaves=3, max_keypoints_per_trio=128)
    keypoints, extrema = port.detect(torch.from_numpy(test_image).float(), cfg, device="cpu")
    got = keypoint_stats(keypoints, extrema if with_extrema else None)
    want = jmetrics.keypoint_stats(
        _to_jax(jtypes.Keypoints, keypoints),
        [_to_jax(jtypes.Extrema, e) for e in extrema] if with_extrema else None,
    )
    assert got == want
    assert got["accepted"] > 0 and got["occupied"] <= got["capacity"]
    if with_extrema:
        assert got["candidates_found"] >= got["accepted"]
        assert got["candidates_overflowed"] == 0


def test_stage_timer():
    timer = StageTimer()
    with timer.stage("stage_a") as h:
        h["result"] = torch.ones(8)
    with timer.stage("stage_a", sync_tree={"x": torch.arange(3)}):
        pass
    assert timer.counts["stage_a"] == 2
    assert "stage_a" in timer.report()
    assert device_sync({"a": torch.ones(3), "b": [torch.arange(4)], "c": "text"}) == 9.0


def test_stage_profile():
    prof = StageProfile()
    with prof.stage("pnp"):
        prof.sync({"out": torch.ones(2)})
    with prof.stage("pnp"):
        prof.count(2)
    with prof.stage("ba"):
        pass
    report = prof.report(total_frames=4)
    assert report["device_round_trips"] == 3
    assert report["stages"]["pnp"]["calls"] == 2
    assert list(report["stages"])[0] == "pnp"
    assert set(report["ms_per_frame"]) == {"pnp", "ba"}


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(4).sum()
    with open(f"{log_dir}/trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_checked_catches_nan():
    f = checked(torch.log)
    np.testing.assert_allclose(f(torch.tensor(4.0)).item(), np.log(4.0), rtol=1e-6)
    with pytest.raises(FloatingPointError, match="non-finite"):
        f(torch.tensor(-1.0))
    # Indexing out of range raises in eager PyTorch without any wrapper.
    with pytest.raises(IndexError):
        checked(lambda x: x[5])(torch.zeros(3))


def test_assert_finite():
    assert_finite({"a": torch.ones(3), "b": torch.arange(4), "c": np.ones(2)})
    with pytest.raises(FloatingPointError, match="non-finite"):
        assert_finite({"a": torch.tensor([1.0, float("nan")])}, name="state")
    with pytest.raises(FloatingPointError, match="state/.points"):
        assert_finite(BAState(*(torch.zeros(1),) * 2, torch.tensor([np.inf]), torch.zeros(1)),
                      name="state")
    with pytest.raises(FloatingPointError):
        assert_finite([1.0, float("nan")])
