"""The photo-collection cell's files import no JAX, and its reference
nothing of the program (the cases of ``test_pb_imports.py`` for the new
files, by name)."""

from .test_pb_imports import BENCH, JAX_NAMES, PORT, imported


def test_the_budget_reference_imports_nothing_of_the_program():
    names = imported(BENCH / "reference" / "budget.py")
    assert PORT not in names and not names & JAX_NAMES
    assert names <= {"__future__", "torch", "port_bench"}


def test_the_photo_runner_names_the_port_whole():
    names = imported(BENCH / "runners" / "photos.py")
    assert PORT in names and not names & JAX_NAMES
    assert names <= {"__future__", "time", "importlib", "torch", "port_bench", PORT}


def test_the_photo_control_and_metric_import_no_jax():
    for path in (BENCH / "photos_control.py", BENCH / "metrics" / "budget_ms.py"):
        assert not imported(path) & JAX_NAMES
