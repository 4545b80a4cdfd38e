"""The 1M dam-break's cell (dam_1m.sim) cut to a CPU test's size,
models/scenes.benchmark_dam_break(20_000) on 64 x 16 x 64 at the
configuration's K=8 and bf16 vel and C: the port's plain engine against the
benchmark's plain reference (bench_torch/reference/sim.py, which imports
nothing of the program), and the benchmark's replay driver
(bench_torch/drivers/replay.py) through harness.run_cell; then config 5
unsharded on one device (config5_16m.sim) cut by bench_torch/tests/small."""

from __future__ import annotations

import copy
import types

import pytest
import torch

from bench_torch import common, harness
from bench_torch.drivers import replay
from bench_torch.reference import compare, sim as ref
from bench_torch.tests.small import small
from mpm_tpu_torch.ops import bucketed
from mpm_tpu_torch.ops.step import make_step

N = 20_000
SEED = 2**31 + 4321
FIELDS = ("pos", "vel", "C", "mass", "ids")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _cut():
    """(workload, config) of dam_1m.sim at N particles: a substep a call, a
    replay of 2 calls from the jittered start."""
    wl = copy.deepcopy(common.load_json("workloads", "dam_1m.sim"))
    cfg = copy.deepcopy(common.load_json("configs", wl["config"]))
    cfg["scene"]["args"] = {"n_target": N}
    cfg["sim"].update(grid_res=[64, 16, 64], num_particles=N)
    cfg["settle_substeps"] = 0
    wl.update(substeps=1, replay_calls=2, trace_calls=2)
    return wl, cfg


def test_plain_engine_equals_the_reference_on_the_dam():
    wl, cfg = _cut()
    sc = common.make_scene(cfg, SEED, "cpu")  # the seeded jitter; the file's numbers checked
    s0 = bucketed.from_simstate(sc.state, sc.config)
    s1 = make_step(sc.config, mode="bucketed", substeps=2)(s0, sc.fluid)
    want = ref.run(ref.State(*(getattr(s0, f) for f in FIELDS)), ref.Params.from_config(cfg), 2)
    assert int(s1.lost) == want.lost == 0
    _, bad = compare.by_id(s1.pos, s1.ids, N)
    assert bad == 0
    gaps = compare.state_gaps(s1, want, N)
    assert all(gaps[k] <= wl["limits"][k] for k in gaps), gaps
    assert gaps == {"pos_gap": 0.0, "vel_gap": 0.0, "C_gap": 0.0}, gaps
    for f in FIELDS:  # slot for slot
        assert torch.equal(getattr(s1, f), getattr(want, f)), f


def _counted(k: int):
    return types.SimpleNamespace(k=k, deferred=torch.tensor(k), cfl_clamped=torch.tensor(0))


def test_every_replay_starts_from_the_kept_start():
    """A stand-in entry that records each call's input: after each replay's
    last call the next input is the start itself."""
    wl, cfg = _cut()
    drv = replay.Driver(wl, cfg, SEED, "cpu")
    inputs = []

    def entry(s):
        inputs.append(s)
        return _counted(s.k + 1)

    drv._entry, drv.start, drv.replay_calls = entry, _counted(0), 3
    win = drv.loop(count=7, sample=False)
    assert [s.k for s in inputs] == [0, 1, 2, 0, 1, 2, 0]
    assert all(inputs[i] is drv.start for i in (0, 3, 6))
    assert (win["calls"], win["replays"], drv.state.k) == (7, 2, 1)
    assert drv.counts(win) == {"deferred": 3, "cfl_clamped": 0}


@pytest.mark.parametrize("fault", (None, "altered"))
def test_replay_cell_on_the_cpu(fault):
    """Sound, two runs of a seed agree, the guarantees hold and `correct` is
    true; with one answer altered where it is produced, false."""
    wl, cfg = _cut()
    runs = [harness.run_cell("dam_1m.sim", SEED, 0.2, False, "cpu", fault=fault, wl=wl, cfg=cfg)
            for _ in range(1 if fault else 2)]
    out = runs[0]
    assert out["attempted"] >= 1
    assert out["correct"] is (fault is None), out["checks"]
    if fault:
        return
    assert all(out["checks"][k]["value"] == 0 for k in ("lost", "ids_bad", "nonfinite"))
    info = out["info"]
    assert info["replay_calls"] == 2 and info["substeps_per_call"] == 1
    assert info["replay_counts"]["setup"] is not None
    keep = ("replay_counts", "moved_per_substep", "calls")
    assert runs[1]["checks"] == out["checks"]
    assert {k: runs[1]["info"][k] for k in keep} == {k: info[k] for k in keep}


def test_config5_unsharded_cell_on_the_cpu():
    """The cut cell, its chunks cut to 2 substeps: the configuration's air
    window through the sim driver, the mesh left aside."""
    wl, cfg = small("config5_16m.sim")
    cfg["window"]["substeps"], cfg["settle_substeps"] = 2, 4
    out = harness.run_cell("config5_16m.sim", SEED, 0.2, False, "cpu", wl=wl, cfg=cfg)
    assert out["attempted"] >= 1
    assert out["correct"], out["checks"]
    assert out["checks"]["interference"]["value"] == 0
