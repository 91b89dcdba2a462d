"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program; the run's own check of the
process's modules compares top-level names whole."""

import ast
import sys
from pathlib import Path

import pytest

from port_bench import run

BENCH = Path(__file__).resolve().parent.parent
JAX_NAMES = {"jax", "jaxlib", "flax", "sift_scale_space_extrema_detection_tpu"}
PORT = "sift_scale_space_extrema_detection_tpu_torch"


def imported(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports (relative imports
    resolve inside ``port_bench``), and the names passed to
    ``import_module``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("port_bench" if node.level else node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(
                node.func, "attr", None)) == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr):
                arg = arg.values[0]
                names.add((PORT if isinstance(arg, ast.FormattedValue) else arg.value)
                          .split(".")[0])
            elif isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & JAX_NAMES


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert PORT not in names
    assert names <= {"__future__", "contextlib", "dataclasses", "functools", "math", "numpy",
                     "torch", "port_bench"}


def test_the_runner_names_the_port_whole():
    names = imported(BENCH / "runners" / "frontend.py")
    assert PORT in names and not names & JAX_NAMES


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + "_probe", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert run.forbidden_modules() == [] or set(run.forbidden_modules()) <= JAX_NAMES
    before = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert set(run.forbidden_modules()) - before == {"flax"}
