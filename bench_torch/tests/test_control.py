"""The control, the reference computed in bfloat16 in the program's place,
comes out not correct against each cell's limits (at a small size on the
CPU; PERF.md gives the readings at the cells' own sizes on the card), and
the program itself comes out within them."""

from __future__ import annotations

import pytest
import torch

from bench_torch import calibrate
from bench_torch.tests.small import small

CELLS = ("pool_1m.sim", "flagship_3d.sim", "flagship_3d.frame1080", "pool_1m.frame360")


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    wl, cfg = small(cell)
    r = calibrate.readings(wl, cfg, 977, 0.2, "cpu")
    limits = wl["limits"]
    assert all(r["program"][k] <= limits[k] for k in limits), r
    assert any(r["control"][k] > limits[k] for k in r["control"]), r
