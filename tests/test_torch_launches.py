"""The port's one record of kernel launches: ``ops/kernels/_build.py``'s
``check_launch`` counts, ``launch_counts`` and ``launches_since`` read."""

import ast
from pathlib import Path

import pytest

from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import (
    _build,
    launch_counts,
    launches_since,
)

REPO = Path(__file__).resolve().parents[1]


class FakeLib:
    """The one entry point ``check_launch`` calls on an error."""

    @staticmethod
    def sift_cuda_error_string(rc):
        return f"error {rc}".encode()


def test_a_successful_launch_counts_its_name():
    before = launch_counts()
    _build.check_launch(FakeLib, 0, "test_kernel")
    _build.check_launch(FakeLib, 0, "test_kernel")
    since = launches_since(before)
    assert since == {"test_kernel": 2}
    assert launch_counts()["test_kernel"] == before["test_kernel"] + 2


@pytest.mark.parametrize("rc", [1, 700])
def test_a_failed_launch_raises_and_counts_nothing(rc):
    before = launch_counts()
    with pytest.raises(RuntimeError, match=f"test_kernel: kernel launch failed: CUDA error {rc}"):
        _build.check_launch(FakeLib, rc, "test_kernel", clamped=True)
    assert not launches_since(before)


def test_a_clamped_launch_counts_under_both_names():
    before = launch_counts()
    _build.check_launch(FakeLib, 0, "test_kernel", clamped=True)
    _build.check_launch(FakeLib, 0, "test_kernel", clamped=False)
    assert launches_since(before) == {"test_kernel": 2, "test_kernel.clamped": 1}


def test_names_never_launched_read_zero():
    before = launch_counts()
    assert before["never_launched"] == 0
    assert launches_since(before)["never_launched"] == 0
    _build.check_launch(FakeLib, 0, "test_kernel")
    assert launches_since(before)["never_launched"] == 0


def test_a_snapshot_is_not_changed_by_later_launches():
    before = launch_counts()
    n = before["test_kernel"]
    _build.check_launch(FakeLib, 0, "test_kernel")
    assert before["test_kernel"] == n


@pytest.mark.parametrize("root", ["sift_scale_space_extrema_detection_tpu_torch", "chip_smoke.py",
                                  "tools", "tests"])
def test_no_file_keeps_a_launch_attribute(root):
    """Counts live in the record alone: no ``<wrapper>.launches`` or
    ``.clamped_launches`` attribute is assigned or read."""
    path = REPO / root
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    assert files
    for file in files:
        found = [node.lineno for node in ast.walk(ast.parse(file.read_text()))
                 if isinstance(node, ast.Attribute)
                 and node.attr in ("launches", "clamped_launches")]
        assert not found, f"{file}: lines {found}"
