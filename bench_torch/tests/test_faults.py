"""A run of each cell at a small size on the CPU, past the harness's look
for a card: sound, it is correct; with the timed path broken underneath
(a step that returns its state unchanged, half of the cells left
unstepped, one answer altered where it is produced) `correct` is false."""

from __future__ import annotations

import pytest
import torch

from bench_torch import harness
from bench_torch.tests.small import small

CELLS = ("pool_1m.sim", "flagship_3d.sim", "flagship_3d.frame1080", "pool_1m.frame360")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", (None,) + harness.FAULTS)
def test_fault_fails_correct(cell, fault):
    wl, cfg = small(cell)
    out = harness.run_cell(cell, 2**31 + 12345, 0.2, False, "cpu", fault=fault, wl=wl, cfg=cfg)
    assert out["attempted"] >= 1
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks"
