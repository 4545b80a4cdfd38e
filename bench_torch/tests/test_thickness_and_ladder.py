"""The two cells flagship_3d.frame1080_thickness and ladder_4m.sim at a
small size on the CPU (bench_torch/tests/small): each is correct, and not
correct with the timed path broken underneath (harness.FAULTS); the
control, the reference computed in bfloat16 in the program's place, fails
a limit of each while the program holds them all."""

from __future__ import annotations

import pytest
import torch

from bench_torch import calibrate, harness
from bench_torch.tests.small import small

CELLS = ("flagship_3d.frame1080_thickness", "ladder_4m.sim")


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


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    wl, cfg = small(cell)
    r = calibrate.readings(wl, cfg, 977, 0.2, "cpu")
    limits = wl["limits"]
    assert all(r["program"][k] <= limits[k] for k in limits), r
    assert any(r["control"][k] > limits[k] for k in r["control"]), r
