"""The benchmark's files, found by name: ``BENCHMARK.json`` at the root of
the checkout, and under ``port_bench/`` one file for each configuration
(``configs/<name>.json``, named by the ``file`` of its entry), each
traffic mix (``traffic/<traffic>.json``, whose ``runner`` names a module
of ``runners/``) and each metric (``metrics/<metric>.py``, a function
``read(summary)`` that returns the number or ``None``).

A later cell, traffic mix or metric is a new file and a new entry in
``BENCHMARK.json``: nothing here lists them.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """Everything one cell runs on: its entry, its configuration's and its
    traffic's contents, and the end-to-end and per-layer metrics it
    reports (each ``{"name", "unit", "better", "read"}``)."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(entries)}")
    w = entries[workload]
    config_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / config_entry["file"]) as f:
        config = json.load(f)
    with open(root / "port_bench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)

    def metrics(kind):
        return [
            {**{k: m[k] for k in ("name", "unit", "better")},
             "read": reader(m["name"], root)}
            for m in bench[kind]
            if workload in m.get("workloads", [workload])
        ]

    return {"workload": w, "config": config, "traffic": traffic,
            "end_to_end": metrics("end_to_end"), "per_layer": metrics("per_layer")}


def reader(name: str, root: Path = ROOT):
    """``read`` of ``metrics/<name>.py`` (a name may hold dots, so the file
    is loaded by its path)."""
    path = root / "port_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def runner(name: str):
    """The module ``runners/<name>.py`` (its ``run``)."""
    return importlib.import_module(f"port_bench.runners.{name}")
