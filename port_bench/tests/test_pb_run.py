"""Whole runs of tiny cells on the CPU (the plain versions stand in for
the kernels): the result line, ``correct`` true on the program and false
on the faults a frontend batch can have, and the command's refusals."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from port_bench import compare
from port_bench.run import measure
from port_bench.runners import frontend as runner

from .cells import CELLS, tiny_cell

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent.parent


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_run_is_correct(workload, trace):
    line = measure(tiny_cell(workload), 2**31 + 101, 0.3, trace, CPU, time.perf_counter())
    assert line["correct"] is True and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(compare.NAMES)
    assert all(0.0 <= c["value"] <= c["limit"] for c in line["checks"].values())
    if trace:
        assert {"pyramid_ms", "select_ms", "refine_ms", "describe_ms"} <= set(line["metrics"])
        # no card, no device time: the shares say nothing rather than 0
        assert "pyramid_roofline_pct" not in line["metrics"]
        assert "device_idle_pct.frontend" not in line["metrics"]
        assert line["attempted"] == 4  # two traced loops of two batches
    else:
        m = line["metrics"]
        assert m["frames_per_s"]["value"] > 0 and m["batch_p95_ms"]["value"] > 0
        assert line["attempted"] >= 1


def _half_batch(result):
    """The first half of the frames described, the rest left out."""
    out = type(result)(**{k: v.clone() for k, v in vars(result).items()})
    out.valid[out.valid.shape[0] // 2:] = False
    return out


def _altered(result):
    """One answer altered where it is produced: a frame's keypoints moved
    a pixel."""
    out = type(result)(**{k: v.clone() for k, v in vars(result).items()})
    b = int(torch.nonzero(out.valid)[0, 0])
    out.abs_x[b] += 1.0
    return out


def _descriptor_altered(result):
    """A frame's descriptors altered where they are produced."""
    out = type(result)(**{k: v.clone() for k, v in vars(result).items()})
    b = int(torch.nonzero(out.valid)[0, 0])
    out.descriptor[b] = out.descriptor[b].roll(1, dims=-1)
    return out


@pytest.mark.parametrize("fault", [_half_batch, _altered, _descriptor_altered],
                         ids=["half_batch", "answer_altered", "descriptor_altered"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    call = runner.Frontend.call
    monkeypatch.setattr(runner.Frontend, "call", lambda self, images: fault(call(self, images)))
    cell = tiny_cell("tum-vga.describe-b64", batch=4)
    line = measure(cell, 2**31 + 7, 0.2, False, CPU, time.perf_counter())
    assert line["correct"] is False and line["failed"] >= 1


def test_limits_come_from_the_configuration():
    ok, checks = compare.verdict({"unmatched_share": 0.0, "position_opx": 0.5,
                                  "reference_slots": 10}, {"unmatched_share": 0.0,
                                                           "position_opx": 0.25})
    assert not ok and checks["position_opx"] == {"value": 0.5, "limit": 0.25}
    assert not compare.verdict({"unmatched_share": 0.0, "reference_slots": 0},
                               {"unmatched_share": 0.0})[0]


def _command(cwd, env=None):
    return subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                           "tum-vga.describe-b64", "--seed", "3", "--seconds", "1"],
                          cwd=cwd, capture_output=True, text=True, timeout=120,
                          env={**os.environ, **(env or {})})


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = _command(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    proc = _command(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_result_line_is_json_with_the_contracts_keys():
    line = measure(tiny_cell("kitti-odom.describe-b64"), 5, 0.2, False, CPU, time.perf_counter())
    text = json.dumps(line)
    assert list(json.loads(text)) == ["correct", "attempted", "failed", "metrics", "device",
                                      "readings", "checks"]
    assert line["readings"]["setup.warmup_s"] > 0
    assert {f"{k}.third{i}" for k in ("frames_per_s", "host_cores_busy", "preempted_per_s")
            for i in (1, 2, 3)} <= set(line["readings"])
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
