"""The control on the card: the reference computed one precision below
what the configuration states (float32 matrix products in TF32) has to
fail the comparison that the program passes. At the cells' frame sizes
with a batch of 8; the benchmark's measurements of it, at the cells' own
size on many seeds, are ``control.py``'s."""

import pytest
import torch

from port_bench import compare, control, spec

from .cells import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's TF32 products exist only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.cell(spec.load_benchmark(), workload)
    cell["traffic"].update(batch=8, ring_batches=2, warmup_batches=1, check_batches=2)
    limits = cell["config"]["checks"]
    for seed in (2**31 + 901, 2**31 + 902, 2**31 + 903):
        r = control.readings(cell, seed, 2, torch.device("cuda", 0))
        assert compare.verdict(r["program"], limits)[0], r
        assert not compare.verdict(r["control"], limits)[0], r
