"""Cells, traffic mixes and metrics are files found by name: a new one is
a new file and a new entry, with no existing file edited."""

import json
import shutil
from pathlib import Path

import pytest

from port_bench import spec

BENCH = Path(__file__).resolve().parent.parent


def test_every_entry_has_its_files():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        assert cell["traffic"]["runner"] == "frontend"
        assert {m["name"] for m in cell["end_to_end"]} == {"frames_per_s", "batch_p95_ms",
                                                           "setup_s"}
        assert len(cell["per_layer"]) == 7
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert m["read"]({}) is None  # a reader with nothing to read returns nothing
    for c in bench["configs"]:
        config = json.loads((spec.ROOT / c["file"]).read_text())
        assert config["name"] == c["name"] and set(config["checks"]) == {
            "unmatched_share", "position_opx", "theta_rad", "descriptor_dist"}


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(BENCH, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    (tmp_path / "port_bench" / "traffic" / "detect-b64-zigzag.json").write_text(json.dumps(
        {**json.loads((BENCH / "traffic" / "describe-b64-zigzag.json").read_text()),
         "entry": "detect_batched"}))
    (tmp_path / "port_bench" / "metrics" / "keypoints_per_frame.detect.py").write_text(
        "def read(summary):\n    return summary.get('keypoints')\n")
    bench["workloads"].append({"name": "tum-vga.detect-b64", "config": "tum-vga",
                               "traffic": "detect-b64-zigzag", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "keypoints_per_frame.detect", "unit": "1",
                               "better": "higher", "source": "program_counter",
                               "layer": "refinement", "moves": "frames_per_s",
                               "workloads": ["tum-vga.detect-b64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell(spec.load_benchmark(tmp_path), "tum-vga.detect-b64", tmp_path)
    assert cell["traffic"]["entry"] == "detect_batched"
    names = [m["name"] for m in cell["per_layer"]]
    assert "keypoints_per_frame.detect" in names and "describe_ms" not in names
    reader = cell["per_layer"][names.index("keypoints_per_frame.detect")]["read"]
    assert reader({"keypoints": 812.5}) == 812.5
    with pytest.raises(KeyError):
        spec.cell(bench, "no-such.cell")
