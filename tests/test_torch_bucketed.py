"""The port's plain bucket engine (mpm_tpu_torch/ops/bucketed.py), which is
also the plain version of kernels P and F, against the JAX package's
mpm_tpu.ops.bucketed on the small scene of tests/test_fused.py.

Bars are the JAX package's own (tests/test_fused.py): ids equal slot for
slot; float32 pos within 1e-6 and vel/C within 1e-5; bf16 vel/C within rtol
0.01, atol 1e-4; counters equal. Whole substeps are held bit for bit against
the JAX XLA engine run without fused multiply-adds (tests/torch_xla_ref.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpm_tpu.core.params import SimConfig as JConfig
from mpm_tpu.models.scenes import fluid_3d as jfluid_3d
from mpm_tpu.ops import bucketed as jb
from mpm_tpu.ops.grid import update_grid as jupdate_grid
from mpm_tpu.ops.interact import Interaction as JInteraction
from mpm_tpu.ops.window import window_config as jwindow_config
from mpm_tpu_torch import convert
from mpm_tpu_torch.core.params import SimConfig
from mpm_tpu_torch.core.state import Grid
from mpm_tpu_torch.models.scenes import benchmark_scene
from mpm_tpu_torch.models.scenes import fluid_3d as tfluid_3d
from mpm_tpu_torch.ops import bucketed as tb
from mpm_tpu_torch.ops.cuda import g2p_migrate as kf
from mpm_tpu_torch.ops.cuda import p2g_update as kp
from mpm_tpu_torch.ops.interact import Interaction as TInteraction
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.ops.window import window_config
from torch_xla_ref import assert_equal_to_xla, state_arrays, xla_substeps

torch.set_num_threads(2)

FIELDS = ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred",
          "ceiling")
COUNTERS = FIELDS[5:]

CASES = {
    "float32": dict(storage="float32"),
    "bfloat16": dict(storage="bfloat16"),
    "windowed": dict(storage="float32", windowed=True),
    "sphere": dict(storage="float32", sphere=True),
}


def _small(storage="float32", windowed=False, sphere=False):
    """(jax config, port config, jax scene, port scene, jax inters, port inters)."""
    j = jfluid_3d(grid_res=16, box=8.0, spacing=0.8)
    t = tfluid_3d(grid_res=16, box=8.0, spacing=0.8, device="cpu")
    jcfg = j.config.replace(bin_capacity=8, storage_dtype=storage)
    tcfg = t.config.replace(bin_capacity=8, storage_dtype=storage)
    if windowed:  # arrays cover y in [0, 16) of a (16, 32, 16) domain
        jcfg = jwindow_config(jcfg.replace(grid_res=(16, 32, 16)), 16)
        tcfg = window_config(tcfg.replace(grid_res=(16, 32, 16)), 16)
    ji, ti = (), ()
    if sphere:
        ji = (JInteraction.sphere((8.0, 8.0, 8.0), radius=4.0, strength=0.5),)
        ti = (TInteraction.sphere((8.0, 8.0, 8.0), radius=4.0, strength=0.5),)
    return jcfg, tcfg, j, t, ji, ti


@functools.lru_cache(maxsize=None)
def _jax_pieces(jcfg: JConfig):
    """Kernel P's and kernel F's plain halves in JAX, compiled once per
    config (and, for F, once per interaction count)."""
    p = jax.jit(lambda b, f: jupdate_grid(jb.p2g_bucketed(b, jcfg, f), jcfg, f))
    f = jax.jit(lambda b, g, fl, it=(): jb.migrate(jb.g2p_bucketed(b, g, jcfg, fl, it),
                                                   jcfg))
    return p, f


def _to_port(b) -> tb.BucketState:
    return convert.bucket_state_from_numpy(
        *(np.asarray(getattr(b, f)) for f in FIELDS), device="cpu")


def _np(x):
    return np.asarray(x).astype(np.float32)


def _tnp(t):
    return t.float().numpy()


def assert_matches(jstate, tstate, bf16=False):
    np.testing.assert_array_equal(np.asarray(jstate.ids), tstate.ids.numpy())
    np.testing.assert_allclose(_np(jstate.pos), _tnp(tstate.pos), atol=1e-6)
    for f in ("vel", "C"):
        if bf16:
            assert getattr(tstate, f).dtype == torch.bfloat16
            np.testing.assert_allclose(_np(getattr(jstate, f)), _tnp(getattr(tstate, f)),
                                       rtol=0.01, atol=1e-4)
        else:
            np.testing.assert_allclose(_np(getattr(jstate, f)), _tnp(getattr(tstate, f)),
                                       atol=1e-5)
    np.testing.assert_array_equal(_np(jstate.mass), _tnp(tstate.mass))
    for f in COUNTERS:
        assert int(getattr(jstate, f)) == int(getattr(tstate, f)), f


@pytest.mark.parametrize("case", list(CASES))
def test_from_simstate_slot_equal(case):
    jcfg, tcfg, j, t, _, _ = _small(**CASES[case])
    got = tb.from_simstate(t.state, tcfg)
    want = _to_port(jb.from_simstate(j.state, jcfg))
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    back = tb.to_simstate(got)
    jback = jb.to_simstate(jb.from_simstate(j.state, jcfg), jcfg.num_particles)
    for f in ("pos", "vel", "C", "mass", "ids"):
        np.testing.assert_array_equal(_np(getattr(jback, f)), _tnp(getattr(back, f)))


@functools.lru_cache(maxsize=None)
def _warm_pair():
    """The f32 small scene after two JAX substeps, in both packages; shared
    by the tests, which do not modify it."""
    jcfg, tcfg, j, t, _, _ = _small()
    jp, jf = _jax_pieces(jcfg)
    b = jb.from_simstate(j.state, jcfg)
    for _ in range(2):
        b = jf(b, jp(b, j.fluid), j.fluid)
    return jcfg, tcfg, j, t, b, _to_port(b)


def test_kernel_p_plain_matches_jax():
    jcfg, tcfg, j, t, jstate, tstate = _warm_pair()
    jp, _ = _jax_pieces(jcfg)
    jg = jp(jstate, j.fluid)
    tg = kp.p2g_update_plain(tstate, tcfg, t.fluid)
    assert float(np.abs(np.asarray(jg.mom)).max()) > 0
    np.testing.assert_allclose(np.asarray(jg.mom), tg.mom.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jg.mass), tg.mass.numpy(), rtol=1e-6, atol=1e-6)


def test_kernel_f_plain_matches_jax():
    jcfg, tcfg, j, t, jstate, tstate = _warm_pair()
    jp, jf = _jax_pieces(jcfg)
    jg = jp(jstate, j.fluid)
    tg = Grid(mom=torch.from_numpy(np.array(jg.mom)), mass=torch.from_numpy(np.array(jg.mass)))
    assert_matches(jf(jstate, jg, j.fluid),
                   kf.g2p_migrate_plain(tstate, tg, tcfg, t.fluid))


XLA_CASE = {"float32": "f32", "bfloat16": "bf16", "windowed": "windowed", "sphere": "sphere"}


@functools.lru_cache(maxsize=None)
def _xla_substeps():
    """Three substeps of every case of CASES in the JAX XLA engine without
    fused multiply-adds (tests/torch_xla_ref.py), from the port's packing,
    which equals the JAX package's slot for slot; one subprocess."""
    states = {}
    for case in CASES:
        _, tcfg, _, t, _, _ = _small(**CASES[case])
        states[XLA_CASE[case]] = state_arrays(tb.from_simstate(t.state, tcfg))
    return xla_substeps(states, 3)


@pytest.mark.parametrize("case", list(CASES))
def test_substeps_match_jax(case):
    """Three full substeps, so that migration runs on every axis, bit for
    bit against the JAX XLA engine, counters included."""
    _, tcfg, _, t, _, ti = _small(**CASES[case])
    s = tb.from_simstate(t.state, tcfg)
    for _ in range(3):
        s = tb.substep(s, tcfg, t.fluid, ti)
    assert_equal_to_xla(s, _xla_substeps()[XLA_CASE[case]])
    assert int(s.lost) == 0


def test_cfl_clamp_matches_jax():
    """A particle kicked 8 cells per substep is clamped into its bucket's
    +-1-cell range and counted, as in the JAX engine."""
    jcfg, tcfg, j, t, _, _ = _small()
    b = jb.from_simstate(j.state, jcfg)
    occ = b.mass > 0
    b = jb.BucketState(pos=b.pos, vel=jnp.where(occ, 40.0, 0.0) * jnp.ones_like(b.vel),
                       C=b.C, mass=b.mass, ids=b.ids, lost=b.lost,
                       cfl_clamped=b.cfl_clamped, deferred=b.deferred)
    s = _to_port(b)
    jp, jf = _jax_pieces(jcfg)
    b = jf(b, jp(b, j.fluid), j.fluid)
    s = tb.substep(s, tcfg, t.fluid)
    assert int(s.cfl_clamped) > 0
    assert_matches(b, s)
    cell = tb.cell_coords(tcfg, "cpu")
    occ = s.mass > 0
    for a in range(3):
        d = torch.floor(s.pos[a]) - cell[a][None, :]
        assert bool((d[occ] == 0).all()), f"axis {a}"


def _edge_plane_mass(state: tb.BucketState, config: SimConfig) -> float:
    m = state.mass.sum(dim=0).reshape(config.grid_res)
    edges = [m[0], m[-1], m[:, 0], m[:, -1], m[:, :, 0], m[:, :, -1]]
    return float(sum(e.abs().sum() for e in edges))


@pytest.mark.parametrize("scene", ["small", "pool"])
def test_edge_planes_stay_empty(scene):
    """The kernels bound neighbour reads by 3D coordinates while the plain
    engine reads flat offsets that wrap rows; the two agree because no
    particle ever sits in an axis's first or last plane. Checked after
    violent substeps (kicked particles) and on the benchmark pool's window."""
    if scene == "small":
        _, cfg, _, t, _, _ = _small()
        s = tb.from_simstate(t.state, cfg)
        s.vel = torch.where(s.mass > 0, 40.0, 0.0).expand_as(s.vel).contiguous()
        fluid = t.fluid
    else:
        sc = benchmark_scene(20_000, device="cpu")
        cfg = window_config(sc.config, 12)
        s = tb.from_simstate(sc.state, cfg)
        fluid = sc.fluid
    for _ in range(4):
        s = tb.substep(s, cfg, fluid)
        assert _edge_plane_mass(s, cfg) == 0.0
    kp.check_supported(cfg)


def test_cuda_wrappers_take_plain_version_on_cpu():
    _, tcfg, _, t, _, _ = _small("bfloat16")
    s = tb.from_simstate(t.state, tcfg)
    n_p, n_f = kp.launches, kf.launches
    g = kp.p2g_update(s, tcfg, t.fluid)
    g_plain = kp.p2g_update_plain(s, tcfg, t.fluid)
    assert torch.equal(g.mom, g_plain.mom) and torch.equal(g.mass, g_plain.mass)
    out = kf.g2p_migrate(s, g, tcfg, t.fluid)
    want = make_step(tcfg, mode="bucketed", substeps=1)(s, t.fluid)
    for f in FIELDS:
        assert torch.equal(getattr(out, f), getattr(want, f)), f
    assert (kp.launches, kf.launches) == (n_p, n_f)  # no kernel ran


# fixed-point 3D configs run on P and F; fixed-point 2D stays outside
@pytest.mark.parametrize("kw", [dict(fixed_point=True, grid_res=(16, 16)),
                                dict(grid_res=(16, 16)), dict(clamp_lo=0.5),
                                dict(bin_capacity=65)])
def test_kernels_refuse_configs_outside_the_slice(kw):
    """2D configs and edge clamps are outside kernels P and F; K = 65 is
    inside (above 64 slots a cell they walk a cell's slots 64 at a time)."""
    cfg = SimConfig(grid_res=(16, 16, 16)).replace(**kw)
    if kw == dict(bin_capacity=65):
        kp.check_supported(cfg)
    else:
        with pytest.raises(NotImplementedError):
            kp.check_supported(cfg)
    # splat emission is in the slice now; it needs the render scalars
    with pytest.raises(ValueError, match="render_scals"):
        kf.g2p_migrate(None, None, None, None, emit_splats=True)


def test_nan_position_is_clamped_and_kept():
    """A live slot whose position is NaN: the plain engine clamps it into
    the domain as the kernels' fminf/fmaxf do (tb._clip) and keeps the
    particle; the NaN lives on in vel and C and spreads to the neighbours
    through the grid, and no particle goes missing or counts as lost."""
    _, tcfg, _, t, _, _ = _small()
    state = tb.from_simstate(t.state, tcfg)
    n0 = int((state.mass > 0).sum())
    k, c = np.unravel_index(int(torch.argmax(state.mass)), tuple(state.mass.shape))
    pos = state.pos.clone()
    pos[0, int(k), int(c)] = float("nan")
    state = state.replace(pos=pos)
    for _ in range(2):
        state = tb.substep(state, tcfg, t.fluid)
    assert bool(state.pos.isfinite().all())
    assert int((~state.vel.isfinite()).any(dim=0).sum()) > 1
    assert int((state.mass > 0).sum()) == n0 and int(state.lost) == 0
