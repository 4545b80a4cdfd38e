"""The port's GuardedStep (mpm_tpu_torch/utils/guard.py) in sync mode on
the CPU.

Against the JAX package's GuardedStep (mpm_tpu/utils/guard.py), both fed
the same seeded state and the same NaN schedule: on a stand-in step that
both packages compute bit for bit, every call's returned state and
counters, the dt each wrapped step received and the last good snapshot
are equal; on the two packages' own engines a NaN position between
snapshots makes both roll back at the same call, to the same frame, with
the same dt schedule.

On its own: the three cases of tests/test_guard.py (a NaN between
snapshots rolls back to a verified snapshot with dt halved; a clean run
has no failure; a snapshot taken after the poison never becomes the
rollback target), a sharded state on 2 CPU slabs, a NaN velocity, and the
air window stepping a rollback snapshot of an earlier window height. The
port's engines clamp a NaN position into the domain, as the kernels do
(ops/bucketed._clip), so the rollbacks come from the NaN the next substep
leaves in vel."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpm_tpu import make_step as jmake_step
from mpm_tpu.models.scenes import fluid_3d as jfluid_3d
from mpm_tpu.ops import bucketed as jbucketed
from mpm_tpu.utils.guard import GuardedStep as JGuardedStep
from mpm_tpu_torch import convert
from mpm_tpu_torch.models.scenes import dam_break_2d, fluid_3d
from mpm_tpu_torch.ops import bucketed
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.ops.window import YWindow
from mpm_tpu_torch.parallel import domain
from mpm_tpu_torch.utils.guard import GuardedStep, state_is_finite

torch.set_num_threads(2)


def small_3d():
    sc = fluid_3d(grid_res=16, box=8.0, spacing=0.8, device="cpu")
    return sc, sc.config.replace(bin_capacity=8)


def poison(out):
    """NaN a LIVE slot's position (an empty slot is parked at its cell
    centre by the next substep); a sharded state's first slab."""
    if hasattr(out, "slabs"):
        return dataclasses.replace(out, slabs=[poison(out.slabs[0]), *out.slabs[1:]])
    k, c = np.unravel_index(int(torch.argmax(out.mass)), tuple(out.mass.shape))
    pos = out.pos.clone()
    pos[0, int(k), int(c)] = float("nan")
    return out.replace(pos=pos)


def flaky(base, at: int):
    calls = {"n": 0}

    def step(state, fluid, interactions=()):
        calls["n"] += 1
        out = base(state, fluid, interactions)
        return poison(out) if calls["n"] == at else out

    return step


def live(state) -> int:
    slabs = state.slabs if hasattr(state, "slabs") else [state]
    return sum(int((s.mass > 0).sum()) for s in slabs)


FIELDS = ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred", "ceiling")


def jpoison(out):
    """poison() on a JAX BucketState: the same slot (the first live one)."""
    k, c = np.unravel_index(int(np.argmax(np.asarray(out.mass))), out.mass.shape)
    return dataclasses.replace(out, pos=out.pos.at[0, int(k), int(c)].set(jnp.nan))


def arrays(state) -> dict:
    """A state's fields as numpy arrays (bf16 as float32)."""
    def np_(x):
        if torch.is_tensor(x):
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        return np.asarray(x)

    return {f: np_(getattr(state, f)) for f in FIELDS}


def drive(guard_cls, step, poison_fn, state, fluid, at, calls: int, dt_of, **kw):
    """`calls` calls of guard_cls(step with poison_fn at the step calls in
    `at`): (the guard, the dt each step call received, after each call the
    returned state's arrays and (failures, current_dt_scale, frames_lost),
    or the error that ended the run)."""
    n, seen = {"n": 0}, []

    def flaky_step(s, f, interactions=()):
        n["n"] += 1
        seen.append(dt_of(f))
        out = step(s, f, interactions)
        return poison_fn(out) if n["n"] in at else out

    g = guard_cls(flaky_step, sync=True, **kw)
    history = []
    for _ in range(calls):
        try:
            state = g(state, fluid, ())
        except RuntimeError as e:
            history.append(str(e))
            break
        history.append((arrays(state), (g.failures, g.current_dt_scale, g.frames_lost)))
    return g, seen, history


def jdt(f) -> np.float32:
    return np.float32(np.asarray(f.dt))


def tdt(f) -> np.float32:
    return np.float32(float(f.dt))


def standin_arrays(seed: int = 0, k: int = 4, c: int = 64) -> dict:
    """A small seeded bucket state: 3D, K slots of C cells, about 60% live."""
    rng = np.random.default_rng(seed)
    mass = (rng.random((k, c)) < 0.6).astype(np.float32)
    return dict(pos=rng.uniform(2.0, 6.0, (3, k, c)).astype(np.float32),
                vel=rng.standard_normal((3, k, c)).astype(np.float32),
                C=rng.standard_normal((3, 3, k, c)).astype(np.float32), mass=mass,
                ids=np.where(mass > 0, np.arange(k * c).reshape(k, c), -1).astype(np.int32),
                lost=np.int32(0), cfl_clamped=np.int32(0), deferred=np.int32(0),
                ceiling=np.int32(0))


def drift(state, fluid, interactions=()):
    """The stand-in step: pos + dt and vel - dt, one float32 addition each,
    equal bit for bit in both packages (dataclasses.replace serves both)."""
    return dataclasses.replace(state, pos=state.pos + fluid.dt, vel=state.vel - fluid.dt)


def assert_same_arrays(a: dict, b: dict, what: str) -> None:
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{what}: {f}")


def assert_same_run(jrun, trun) -> None:
    """Equal failures, dt scale and frames lost after every call, equal dt
    at every step call, equal states after every call (NaN where NaN)."""
    (jg, jseen, jhist), (tg, tseen, thist) = jrun, trun
    assert tseen == jseen
    assert len(thist) == len(jhist)
    for i, (j, t) in enumerate(zip(jhist, thist)):
        if isinstance(j, str):  # both gave up at this call
            assert t == j
            continue
        assert t[1] == j[1], f"call {i + 1}: (failures, dt scale, frames lost)"
        assert_same_arrays(j[0], t[0], f"call {i + 1}")


# name: (check_every, snapshot_every, poisoned step calls, guard calls, max_failures)
STANDIN_CASES = {
    "between_snapshots": (2, 4, (7,), 12, 8),   # tests/test_guard.py's first case
    "clean": (2, 4, (), 9, 8),                  # its second
    "candidate_after_poison": (4, 2, (3,), 6, 8),  # its third
    "at_a_check": (2, 4, (8,), 12, 8),
    "twice_unaligned": (3, 5, (4, 11), 20, 8),
    "gives_up": (1, 4, (2, 3, 4, 5), 6, 2),
}


@pytest.mark.parametrize("case", list(STANDIN_CASES))
def test_guard_matches_jax_on_a_standin_step(case):
    """Both GuardedSteps on the same seeded state and NaN schedule, with a
    step both packages compute bit for bit: the same calls fail, the same
    snapshot comes back, with the same dt, and the last good snapshot is
    the same frame and the same arrays."""
    check, snap, at, calls, max_failures = STANDIN_CASES[case]
    a = standin_arrays()
    jstate = jbucketed.BucketState(**{f: jnp.asarray(v) for f, v in a.items()})
    tstate = convert.bucket_state_from_numpy(*(a[f] for f in FIELDS), device="cpu")
    jfluid = jfluid_3d(grid_res=16, box=8.0, spacing=0.8).fluid
    tfluid = fluid_3d(grid_res=16, box=8.0, spacing=0.8, device="cpu").fluid
    kw = dict(check_every=check, snapshot_every=snap, max_failures=max_failures)
    jrun = drive(JGuardedStep, drift, jpoison, jstate, jfluid, at, calls, jdt, **kw)
    trun = drive(GuardedStep, drift, poison, tstate, tfluid, at, calls, tdt, **kw)
    assert_same_run(jrun, trun)
    jg, tg = jrun[0], trun[0]
    if case == "gives_up":
        assert trun[2][-1] == "simulation diverged 3 times; giving up"
        return
    assert tg.flush() == jg.flush()
    assert (tg.failures, tg.current_dt_scale, tg.frames_lost) == (
        jg.failures, jg.current_dt_scale, jg.frames_lost)
    assert tg._good[0] == jg._good[0]
    assert_same_arrays(arrays(jg.last_good()), arrays(tg.last_good()), "last good")
    assert tg.failures == len(at)


def test_guard_matches_jax_on_the_engines():
    """Each package's GuardedStep around its own bucket engine (16^3, K=8,
    one substep a call), a NaN position at step call 7, between the
    snapshots at 4 and 8, checks every 2: both roll back at call 8 to the
    frame-4 snapshot, halve dt from there, and end on the same frame. The
    JAX engine keeps the NaN in pos; the port's clamps it back and the
    next substep leaves it in vel, which the port's check reads. The last
    good snapshots hold the same particles in the same slots, pos, vel
    and C within 1e-5 of each other (two engines, 8 substeps: the JAX
    package's engine contracts to fused multiply-adds, the port's does
    not; the differences were below 1e-6)."""
    j = jfluid_3d(grid_res=16, box=8.0, spacing=0.8)
    jcfg = j.config.replace(bin_capacity=8)
    t = fluid_3d(grid_res=16, box=8.0, spacing=0.8, device="cpu")
    tcfg = t.config.replace(bin_capacity=8)
    jstate = jbucketed.from_simstate(j.state, jcfg)
    tstate = bucketed.from_simstate(t.state, tcfg)
    jstep = jmake_step(jcfg, mode="bucketed", substeps=1, donate=False)
    tstep = make_step(tcfg, mode="bucketed", substeps=1)
    kw = dict(check_every=2, snapshot_every=4, max_failures=8)
    jg, jseen, jhist = drive(JGuardedStep, jstep, jpoison, jstate, j.fluid, (7,), 12, jdt, **kw)
    tg, tseen, thist = drive(GuardedStep, tstep, poison, tstate, t.fluid, (7,), 12, tdt, **kw)
    jfail = [h[1] for h in jhist]
    assert jfail[6] == (0, 1.0, 0) and jfail[7] == (1, 0.5, 4)  # JAX fires at call 8
    assert [h[1] for h in thist] == jfail
    assert tseen == jseen
    assert tg.flush() and jg.flush()
    assert tg._good[0] == jg._good[0] == 8  # 4 + the 4 calls after the rollback
    ja, ta = arrays(jg.last_good()), arrays(tg.last_good())
    for f in ("ids", "mass", "lost", "cfl_clamped", "deferred", "ceiling"):
        np.testing.assert_array_equal(ta[f], ja[f], err_msg=f)
    for f in ("pos", "vel", "C"):
        np.testing.assert_allclose(ta[f], ja[f], rtol=0, atol=1e-5, err_msg=f)
    assert state_is_finite(tg.last_good())


@pytest.mark.parametrize("sharded", [False, True])
def test_guard_rolls_back_to_verified_snapshot(sharded):
    """NaN injected at call 7, between the snapshots at 4 and 8: the guard
    rolls back to the verified snapshot of frame 4 with dt halved, loses no
    particle, and the run continues finite."""
    sc, cfg = small_3d()
    b0 = bucketed.from_simstate(sc.state, cfg)
    if sharded:
        mesh = domain.SlabMesh.on("cpu", 2)
        base = domain.make_sharded_bucket_step(cfg, mesh, substeps=1, mode="bucketed")
        b0 = domain.shard_bucket_state(b0, cfg, mesh)
    else:
        base = make_step(cfg, mode="bucketed", substeps=1)
    n_live = live(b0)
    seen = []

    def recording(state, fluid, interactions=()):
        seen.append(float(fluid.dt))
        return base(state, fluid, interactions)

    g = GuardedStep(flaky(recording, 7), check_every=2, snapshot_every=4, sync=True)
    s = b0
    for _ in range(12):
        s = g(s, sc.fluid, ())
    assert g.flush()
    assert g.failures == 1 and g.current_dt_scale == 0.5
    assert g.frames_lost == 4  # detected at call 8, rolled back to frame 4
    assert seen[:8] == [np.float32(0.2)] * 8
    assert seen[8:] == [float(np.float32(0.2 * 0.5))] * 4
    assert state_is_finite(s) and state_is_finite(g.last_good())
    assert live(s) == n_live and int(s.lost) == 0
    assert type(s) is type(b0)


def test_guard_clean_run_has_no_failures():
    sc, cfg = small_3d()
    g = GuardedStep(make_step(cfg, mode="bucketed", substeps=1), check_every=2,
                    snapshot_every=4, sync=True)
    s = bucketed.from_simstate(sc.state, cfg)
    for _ in range(9):
        s = g(s, sc.fluid, ())
    assert g.flush()
    assert g.failures == 0 and g.frames_lost == 0 and g.current_dt_scale == 1.0
    assert state_is_finite(s) and g.last_good() is not s


def test_candidate_snapshot_never_promotes_past_poison():
    """snapshot_every=2 takes a candidate at frame 4, after the poison at
    frame 3, while the check of frame 4 is the one that fails: the
    rollback target is the frame-2 snapshot, finite."""
    sc = dam_break_2d(device="cpu")
    base = make_step(sc.config, mode="bucketed", substeps=1)
    g = GuardedStep(flaky(base, 3), check_every=4, snapshot_every=2, sync=True)
    s = bucketed.from_simstate(sc.state, sc.config)
    for _ in range(6):
        s = g(s, sc.fluid, ())
    if not g.flush():
        s = g.last_good()
    assert g.failures == 1 and g.frames_lost == 2
    assert state_is_finite(s) and state_is_finite(g.last_good())


def test_guard_gives_up_after_max_failures():
    sc, cfg = small_3d()
    base = make_step(cfg, mode="bucketed", substeps=1)

    def always(state, fluid, interactions=()):
        return poison(base(state, fluid, interactions))

    g = GuardedStep(always, check_every=1, snapshot_every=4, sync=True, max_failures=2)
    s = bucketed.from_simstate(sc.state, cfg)
    with pytest.raises(RuntimeError, match="diverged 3 times"):
        for _ in range(4):
            s = g(s, sc.fluid, ())


def test_nan_in_velocity_is_caught():
    """The port checks vel as well as pos (guard.CHECKED): a NaN velocity
    in a live slot rolls back at the call that made it."""
    sc, cfg = small_3d()
    base = make_step(cfg, mode="bucketed", substeps=1)

    def vel_nan(state, fluid, interactions=()):
        out = base(state, fluid, interactions)
        vel = out.vel.clone()
        vel[1, 0, int(torch.argmax(out.mass[0]))] = float("nan")
        return out.replace(vel=vel)

    g = GuardedStep(vel_nan, check_every=1, snapshot_every=1, sync=True, max_failures=1)
    s = bucketed.from_simstate(sc.state, cfg)
    s = g(s, sc.fluid, ())
    assert g.failures == 1 and g.frames_lost == 1 and state_is_finite(s)


def test_window_steps_a_state_of_an_earlier_height():
    """A guard's rollback hands YWindow a snapshot whose window may be of
    another height than the window's current one: the step takes the
    state's height and goes on from there."""
    sc = fluid_3d(grid_res=16, box=8.0, spacing=0.8, device="cpu")
    tall = sc.config.replace(bin_capacity=8, grid_res=(16, 32, 16), substeps=1)
    win = YWindow(tall, mode="bucketed", substeps=1, quantum=8)
    s0 = win.init(sc.state)
    wy0 = win.wy
    win.wy = wy0 + 8  # the window grew after the snapshot s0 was taken
    s1 = win.step(s0, sc.fluid)
    assert win.wy >= wy0 and s1.mass.shape[-1] == 16 * win.wy * 16
    assert int(s1.lost) == 0
