"""The air window over a slab mesh (YWindow(mesh=...), ops/window.py) and
`run --shards` on the CPU: the sharded window against the unsharded one
(the pattern of tests/test_window.py:286-312), slot for slot."""

import torch

from mpm_tpu_torch.__main__ import main as cli_main
from mpm_tpu_torch.core.params import FluidParams, SimConfig
from mpm_tpu_torch.core.state import make_state
from mpm_tpu_torch.models.emitters import box_lattice
from mpm_tpu_torch.ops.window import YWindow
from mpm_tpu_torch.parallel import domain

torch.set_num_threads(2)

FIELDS = ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred", "ceiling")


def test_window_over_mesh_matches_unsharded_window():
    """tests/test_window.py:286-312: a collapsing column stepped by
    YWindow(mesh=...) on 3 slabs equals the unsharded YWindow: states slot
    for slot, counters, the wy schedule and interference, and the window
    shrank. (A smaller grid and gravity -2 than the JAX test's, so the
    plain engine shrinks the window within 4 chunks.)"""
    grid = (12, 40, 12)
    pos = box_lattice(grid, (4.0, 24.0, 4.0), 0.8, center=(6.0, 14.0, 6.0))
    config = SimConfig(grid_res=grid, num_particles=pos.shape[0], substeps=2, bin_capacity=8)
    fluid = FluidParams.create(dim=3, eos_stiffness=4.0, eos_power=4.0, gravity=-2.0)
    state = make_state(pos, "cpu")
    win1 = YWindow(config, mode="bucketed", substeps=4, quantum=4)
    win2 = YWindow(config, mode="bucketed", substeps=4, quantum=4,
                   mesh=domain.SlabMesh.on("cpu", 3))
    s1, s2 = win1.init(state), win2.init(state)
    assert win1.wy == win2.wy
    schedule = [win1.wy]
    for _ in range(4):
        s1 = win1.step(s1, fluid)
        s2 = win2.step(s2, fluid)
        assert win1.wy == win2.wy, "resize schedules diverged"
        schedule.append(win1.wy)
        g = domain.gather_bucket_state(s2)
        for f in FIELDS:
            assert torch.equal(getattr(g, f), getattr(s1, f)), f
    assert win2.resizes == win1.resizes >= 1 and min(schedule) < schedule[0]
    assert win1.interference == win2.interference == 0


def test_cli_run_shards(capsys):
    cli_main(["run", "fluid_3d_cpu", "--frames", "1", "--substeps", "1", "--device", "cpu",
              "--mode", "bucketed", "--shards", "2", "--window", "auto"])
    out = capsys.readouterr().out
    assert "mesh: 2 x-slab shard(s) over cpu devices" in out
    assert "air-window engine" in out and "\nlost: 0 " in out
