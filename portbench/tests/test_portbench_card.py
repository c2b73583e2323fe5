"""On a card: a reduced cell through the whole run, traced, with the
port's CUDA kernels. Skips where there is no card (the check is made
inside the test)."""

import pytest
import torch

import pbtest

from portbench import check, spec
from portbench.run import execute, readings


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen3-14b.chat"])
def test_a_reduced_cell_runs_traced_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode here")
    cell = pbtest.smoke_cell(name)
    rec, peak, checks = execute(cell, 5, 2.0, True, torch.device("cuda"))
    assert check.passed(checks), checks
    assert peak > 0 and 0 < rec.trace.busy_s <= rec.trace.window_s
    assert rec.trace.markers_found >= 1
    got = readings(spec.cell(name), rec, trace=True)
    for metric in ("qgemm_roofline", "paged_attn_roofline", "mfu", "idle_share"):
        assert 0 < got[metric]["value"] <= 105, (metric, got[metric])
