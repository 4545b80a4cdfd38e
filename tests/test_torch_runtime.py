"""The CLI's run-time surface of the port (mpm_tpu_torch/__main__.py:
--fluid, --flip-gravity-at, --interact, --orbit-sphere; utils/metrics.py)
against the JAX package's (mpm_tpu/__main__.py:106-167,
mpm_tpu/utils/metrics.py), on the same argparse namespaces: equal fluid
and interaction arrays per frame, the port's cap on interactions, one
substep chain with a moving sphere and an overridden dt bit for bit
against the JAX XLA engine (tests/torch_xla_ref.py), and equal metrics
records."""

import argparse
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from mpm_tpu.__main__ import _apply_fluid_overrides as j_overrides
from mpm_tpu.__main__ import _parse_interactions as j_interactions
from mpm_tpu.core.params import FluidParams as JFluid
from mpm_tpu.core.params import SimConfig as JConfig
from mpm_tpu.utils.metrics import MetricsLogger as JMetrics
from mpm_tpu_torch.__main__ import _apply_fluid_overrides as t_overrides
from mpm_tpu_torch.__main__ import _parse_interactions as t_interactions
from mpm_tpu_torch.core.params import FluidParams as TFluid
from mpm_tpu_torch.core.params import SimConfig as TConfig
from mpm_tpu_torch.models.scenes import fluid_3d
from mpm_tpu_torch.ops import bucketed
from mpm_tpu_torch.utils.metrics import MetricsLogger as TMetrics
from torch_xla_ref import ORBIT_ARGS, SCENE, assert_equal_to_xla, state_arrays, xla_substeps

torch.set_num_threads(2)


def ns(**kw):
    base = dict(fluid=[], flip_gravity_at=0, interact=[], orbit_sphere=False)
    return argparse.Namespace(**{**base, **kw})


def assert_fluid_equal(j, t):
    for f in dataclasses.fields(t):
        a, b = np.asarray(getattr(j, f.name)), getattr(t, f.name)
        assert b.dtype == torch.float32 and b.device.type == "cpu", f.name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f.name)
        assert a.dtype == b.numpy().dtype and a.shape == b.numpy().shape, f.name


def assert_inters_equal(j, t):
    assert len(j) == len(t)
    for a, b in zip(j, t):
        for f in dataclasses.fields(b):
            np.testing.assert_array_equal(np.asarray(getattr(a, f.name)),
                                          getattr(b, f.name).numpy(), err_msg=f.name)


@pytest.mark.parametrize("dim, flags", [
    (3, dict(fluid=["dt=0.15", "gravity=0,-0.5,0"])),
    (3, dict(fluid=["dt=0.15", "gravity=0,-0.5,0"], flip_gravity_at=3)),
    (3, dict(fluid=["eos_power=3", "rest_density=5.5", "pressure_floor=-0.2"])),
    (2, dict(fluid=["gravity=0.0,0.3"], flip_gravity_at=1)),
    (2, dict()),
])
def test_fluid_overrides_match_jax(dim, flags):
    args = ns(**flags)
    j0, jfn = j_overrides(args, JFluid.create(dim=dim))
    t0, tfn = t_overrides(args, TFluid.create(dim=dim))
    assert_fluid_equal(j0, t0)
    for frame in range(6):
        assert_fluid_equal(jfn(frame), tfn(frame))
    if flags.get("flip_gravity_at"):
        k = flags["flip_gravity_at"]
        assert torch.equal(tfn(k).gravity, -tfn(k - 1).gravity)


@pytest.mark.parametrize("spec", ["viscosity=1", "gravity=0,1", "dt=1,2"])
def test_fluid_override_refusals(spec):
    with pytest.raises(SystemExit):
        t_overrides(ns(fluid=[spec]), TFluid.create(dim=3))


@pytest.mark.parametrize("grid, flags", [
    ((64, 64, 64), dict(interact=["sphere=32,10,32,6", "sphere=5,5,5,2,0.5"], orbit_sphere=True)),
    ((64, 64, 64), dict(interact=["sphere=32,10,32,6"])),
    ((48, 80, 32), dict(orbit_sphere=True)),
    ((64, 64), dict(interact=["sphere=32,20,6"], orbit_sphere=True)),
    ((64, 64), dict(interact=["sphere=10,10,3,0.25"])),
])
def test_interactions_match_jax(grid, flags):
    args = ns(**flags)
    j0, jfn = j_interactions(args, JConfig(grid_res=grid))
    t0, tfn = t_interactions(args, TConfig(grid_res=grid))
    assert_inters_equal(j0, t0)
    for frame in (0, 7, 119):
        assert_inters_equal(jfn(frame), tfn(frame))
    if flags.get("orbit_sphere"):
        assert not torch.equal(tfn(0)[-1].center, tfn(7)[-1].center)


@pytest.mark.parametrize("dim", [2, 3])
def test_ninth_interaction_refused(dim):
    """Neither package caps the spheres: kernel F and sim2d read them from a
    device array, so the port's CLI takes nine and more, the orbit sphere
    included, as the JAX CLI does, in the same order; a malformed sphere
    is refused."""
    grid = (32,) * dim
    sphere = "sphere=" + ",".join(["16"] * dim) + ",4"
    for kw in (dict(interact=[sphere] * 9), dict(interact=[sphere] * 12, orbit_sphere=True)):
        jfn = j_interactions(ns(**kw), JConfig(grid_res=grid))[1]
        tfn = t_interactions(ns(**kw), TConfig(grid_res=grid))[1]
        assert len(tfn(0)) == len(jfn(0)) == len(kw["interact"]) + int("orbit_sphere" in kw)
        assert_inters_equal(jfn(3), tfn(3))
    with pytest.raises(SystemExit, match="bad --interact"):
        t_interactions(ns(interact=["sphere=1,2"]), TConfig(grid_res=grid))


def test_moving_sphere_substeps_match_jax_xla():
    """Three plain substeps of the 16^3 K=8 scene, substep i taking frame
    i's fluid and interactions from the port's CLI functions (the orbit
    sphere moves every substep, dt 0.15, gravity flipped from frame 2),
    equal bit for bit, counters included, to the JAX XLA engine fed by the
    JAX CLI's functions on the same flags."""
    sc = fluid_3d(**SCENE, device="cpu")
    cfg = sc.config.replace(bin_capacity=8)
    args = argparse.Namespace(**ORBIT_ARGS)
    fluid_fn = t_overrides(args, sc.fluid)[1]
    inter_fn = t_interactions(args, cfg)[1]
    b = bucketed.from_simstate(sc.state, cfg)
    want = xla_substeps({"orbit": state_arrays(b)}, 3)["orbit"]
    for i in range(3):
        b = bucketed.substep(b, cfg, fluid_fn(i), inter_fn(i))
    assert_equal_to_xla(b, want)
    ref = bucketed.from_simstate(sc.state, cfg)
    for i in range(3):  # the sphere pushed: the trajectory is not the plain one
        ref = bucketed.substep(ref, cfg, fluid_fn(i))
    assert not torch.equal(ref.vel, b.vel)


def _records(logger_cls):
    buf = io.StringIO()
    m = logger_cls(stream=buf)
    m.log("compile", seconds=1.234, scene="fluid_3d", mode="cuda", n=157464)
    for i in range(3):
        m.log("frame", i=i, last_ms=round(2.5 + i, 3), dev_ms=1.5, host_ms=0.25)
    m.log("guard", failures=0, frames_lost=0, dt_scale=1.0)
    m.log("counters", lost=0, deferred=12, cfl_clamped=3, ceiling=0)
    m.log("summary", frames=3, fps=400.0, particle_steps_per_sec=1.25e8)
    text = buf.getvalue()
    m.close()
    m.log("frame", i=9)  # closed: a no-op
    return [json.loads(line) for line in text.splitlines()]


def test_metrics_records_match_jax():
    j, t = _records(JMetrics), _records(TMetrics)
    assert all(isinstance(r.pop("t"), float) for r in j + t)
    assert t == j and [r["event"] for r in t] == ["compile", "frame", "frame", "frame",
                                                  "guard", "counters", "summary"]
    TMetrics().log("frame", i=0)  # no path, no stream: nothing written


def test_metrics_file_appends(tmp_path):
    path = tmp_path / "m.jsonl"
    for _ in range(2):
        m = TMetrics(path=str(path))
        m.log("summary", frames=1)
        m.close()
    assert [json.loads(line)["event"] for line in path.read_text().splitlines()] == \
        ["summary", "summary"]


def test_run_trace_writes_the_spans(tmp_path):
    """`run --trace PATH` profiles the frames after the first and writes a
    chrome trace holding the program's spans: a frame's, and the P and F
    halves of each substep (the plain engine's on the CPU)."""
    from mpm_tpu_torch.__main__ import main

    path = tmp_path / "run.json"
    main(["run", "dam_break_2d", "--device", "cpu", "--mode", "bucketed", "--substeps", "1",
          "--frames", "2", "--trace", str(path)])
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") in ("cpu_op", "user_annotation") and e.get("ph") == "X"]
    assert [n for n in names if n.startswith("mpm.")].count("mpm.step.frame") == 2
    assert names.count("mpm.kernel.p2g") == 2 and names.count("mpm.kernel.g2p") == 2
