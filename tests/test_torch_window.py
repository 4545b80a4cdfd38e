"""The port's air-window engine (mpm_tpu_torch/ops/window.py): against the
JAX package's YWindow(mode="bucketed", sync_polls=True), and windowed ==
full grid inside the port (the pattern of tests/test_window.py)."""

import jax
import numpy as np
import torch

from mpm_tpu.core.params import FluidParams as JFluid
from mpm_tpu.core.params import SimConfig as JConfig
from mpm_tpu.core.state import make_state as jmake_state
from mpm_tpu.ops import bucketed as jb
from mpm_tpu.ops.window import YWindow as JYWindow
from mpm_tpu.ops.window import window_config as jwindow_config
from mpm_tpu_torch.core.params import FluidParams, SimConfig
from mpm_tpu_torch.core.state import make_state
from mpm_tpu_torch.models.emitters import box_lattice
from mpm_tpu_torch.ops import bucketed as tb
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.ops.window import YWindow, _resize, window_config

torch.set_num_threads(2)


def _pool(ny=32, gy=-0.3):
    """A low pool in a tall domain (tests/test_window.py): grid (16, ny, 16),
    particles y in about [3, 9]."""
    grid = (16, ny, 16)
    pos = box_lattice(grid, (10.0, 6.0, 10.0), 0.8, center=(8.0, 6.0, 8.0))
    kw = dict(grid_res=grid, num_particles=pos.shape[0], substeps=2, bin_capacity=8)
    return (SimConfig(**kw), FluidParams.create(dim=3, eos_stiffness=4.0,
                                                eos_power=4.0, gravity=gy),
            make_state(pos, "cpu"), JConfig(**kw),
            JFluid.create(dim=3, eos_stiffness=4.0, eos_power=4.0, gravity=gy),
            jmake_state(pos))


def _column():
    """A tall thin column that collapses: the window must shrink."""
    grid = (12, 32, 12)
    pos = box_lattice(grid, (4.0, 16.0, 4.0), 0.8, center=(6.0, 10.0, 6.0))
    config = SimConfig(grid_res=grid, num_particles=pos.shape[0], substeps=2,
                       bin_capacity=8)
    return config, FluidParams.create(dim=3, eos_stiffness=4.0, eos_power=4.0), \
        make_state(pos, "cpu")


def _linear(b):
    s = tb.to_simstate(b)
    return [x.float().numpy() for x in (s.pos, s.vel, s.C, s.mass)] + [s.ids.numpy()]


def test_window_matches_jax_window():
    tcfg, tfluid, tstate, jcfg, jfluid, jstate = _pool()
    jwin = JYWindow(jcfg, mode="bucketed", substeps=2, donate=False, sync_polls=True)
    twin = YWindow(tcfg, mode="bucketed", substeps=2)
    jb_ = jwin.init(jstate)
    tb_ = twin.init(tstate)
    assert twin.wy == jwin.wy < tcfg.grid_res[1]  # the air is windowed out
    for _ in range(2):
        jb_ = jwin.step(jb_, jfluid, ())
        tb_ = twin.step(tb_, tfluid, ())
        assert twin.wy == jwin.wy
        np.testing.assert_array_equal(np.asarray(jb_.ids), tb_.ids.numpy())
        np.testing.assert_allclose(np.asarray(jb_.pos), tb_.pos.numpy(), atol=1e-6)
        np.testing.assert_allclose(np.asarray(jb_.vel), tb_.vel.numpy(), atol=1e-5)
        np.testing.assert_allclose(np.asarray(jb_.C), tb_.C.numpy(), atol=1e-5)
    assert twin.interference == jwin.interference == 0
    assert int(tb_.ceiling) == int(jb_.ceiling) == 0
    assert int(tb_.lost) == 0


def test_windowed_matches_full_grid_exactly():
    config, fluid, state = _pool()[:3]
    full = make_step(config, mode="bucketed", substeps=2)
    s_full = tb.from_simstate(state, config)
    win = YWindow(config, mode="bucketed", substeps=2)
    s_win = win.init(state)
    assert win.wy < config.grid_res[1]
    for _ in range(2):
        s_full = full(s_full, fluid)
        s_win = win.step(s_win, fluid)
        for a, b in zip(_linear(s_full), _linear(s_win)):
            np.testing.assert_array_equal(a, b)
    assert win.interference == 0 and int(s_win.ceiling) == 0


def test_window_shrinks_as_column_collapses():
    """The surface falls, so the window shrinks (with hysteresis); the
    shrunk state keeps every particle and the invariant."""
    config, fluid, state = _column()
    win = YWindow(config, mode="bucketed", substeps=4, quantum=2)
    s_win = win.init(state)
    wy0 = win.wy
    for _ in range(6):
        s_win = win.step(s_win, fluid)
    assert win.wy < wy0 and win.resizes >= 1
    assert win.interference == 0 and int(s_win.lost) == 0
    assert int((s_win.mass > 0).sum()) == state.num_particles
    assert float(torch.floor(s_win.pos[1])[s_win.mass > 0].max()) <= win.wy - 4


def test_resize_preserves_particles_and_parking():
    config, _, state = _pool()[:3]
    win = YWindow(config, mode="bucketed", substeps=2)
    s = win.init(state)
    before = _linear(s)
    c0, c1 = window_config(config, win.wy), window_config(config, win.wy + 8)
    grown = _resize(s, c0, c1)
    back = _resize(grown, c1, c0)
    for a, b in zip(before, _linear(back)):
        np.testing.assert_array_equal(a, b)
    centers = tb.cell_coords(c1, "cpu") + 0.5
    empty = grown.mass == 0
    for d in range(3):
        assert torch.equal(grown.pos[d][empty], centers[d][None, :].expand_as(empty)[empty])


def test_ceiling_band_rejects_and_counts():
    """Particles in the window's last legal row moving up fast are rejected
    by the ceiling band: counted, nothing lost, nothing above the band."""
    wcfg = window_config(SimConfig(grid_res=(16, 32, 16), substeps=2,
                                   bin_capacity=8), 16)
    pos = np.stack(np.meshgrid(np.arange(5, 11) + 0.5, [12.9],
                               np.arange(5, 11) + 0.5, indexing="ij"),
                   -1).reshape(-1, 3).astype(np.float32)
    st = make_state(pos, "cpu")
    st.vel[1] = 5.0
    fluid = FluidParams.create(dim=3, gravity=0.0)
    s = tb.from_simstate(st, wcfg)
    ceil = []
    for _ in range(3):
        s = tb.substep(s, wcfg, fluid)
        ceil.append(int(s.ceiling))
    assert 0 < ceil[0] < ceil[-1]  # cumulative across substeps
    assert int(s.lost) == 0
    occ = s.mass > 0
    assert int(occ.sum()) == pos.shape[0]
    assert float(torch.floor(s.pos[1])[occ].max()) <= 16 - 4
    # the JAX engine rejects and counts the same moves
    jcfg = jwindow_config(JConfig(grid_res=(16, 32, 16), substeps=2, bin_capacity=8), 16)
    jst = jmake_state(pos)
    jst.vel = jst.vel.at[1].set(5.0)
    jstep = jax.jit(lambda b, f: jb.substep(b, jcfg, f, ()))
    b = jb.from_simstate(jst, jcfg)
    for _ in range(3):
        b = jstep(b, JFluid.create(dim=3, gravity=0.0))
    assert int(b.ceiling) == ceil[-1] and int(b.deferred) == int(s.deferred)
    np.testing.assert_array_equal(np.asarray(b.ids), s.ids.numpy())
