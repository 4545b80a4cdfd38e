"""Kernels P, F, X, BL, SH and the splat kernels against their plain
PyTorch versions on a CUDA card, at the small scene of
tests/test_fused.py, P and F also in
fixed-point mode, the per-pass kernels A, B, D and E there too, the two
sharded stages of P and F's shard mode (and the sharded step against the
unsharded one), and the 2D kernels sim2d and migrate2d at dam_break_2d's
size (f32 and bf16 vel/C); mode="cuda"'s routing to the plain engine and,
on dense scenes, to the kernels above 64 slots a cell; F and
sim2d with 12 spheres, and the oracle, the binned engine, the sort-based
slabs and legacy_quad on the card. Every test needs the card and skips
without one. They import no JAX, so on a machine without JAX run them with

    python -m pytest --noconftest tests/test_torch_cuda.py

Bars: the JAX package's own (tests/test_fused.py). The kernels repeat the
plain version's arithmetic operation for operation and build without fused
multiply-adds, so they are expected to agree with it bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mpm_tpu_torch.core.state import Grid
from mpm_tpu_torch.models.scenes import dam_break_2d, fluid_2d_friction, fluid_3d
from mpm_tpu_torch.ops import bucketed
from mpm_tpu_torch.ops import fixed_point
from mpm_tpu_torch.ops.cuda import g2p_migrate as kf
from mpm_tpu_torch.ops.cuda import migrate_planes as ke
from mpm_tpu_torch.ops.cuda import p2g_shard as ks
from mpm_tpu_torch.ops.cuda import p2g_update as kp
from mpm_tpu_torch.ops.cuda import planes
from mpm_tpu_torch.ops.cuda import substep2d as k2d
from mpm_tpu_torch.ops.interact import Interaction
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.ops.window import window_config
from mpm_tpu_torch.parallel import domain
from torch_card_cases import (assert_splats_equal, assert_states_close,  # noqa: F401 (dev)
                              assert_states_equal, dev)
from torch_dilate_cases import DILATE_CASES, dilate_case, splat_pass
from torch_shade_cases import SHADE_CASES, shade_case
from torch_wide_cases import FIELDS, dense_scene

pytestmark = pytest.mark.requires_cuda

GOLDEN_3D = os.path.join(os.path.dirname(__file__), "golden",
                         "fluid_3d_small_bucketed.npz")
GOLDEN_2D = os.path.join(os.path.dirname(__file__), "golden", "dam_break_2d_oracle.npz")


def _scene(dev, storage="float32", grid_res=None, spacing=0.8, **kw):
    sc = fluid_3d(grid_res=16, box=8.0, spacing=spacing, device=dev)
    config = sc.config.replace(**{"bin_capacity": 8, "storage_dtype": storage, **kw})
    if grid_res is not None:
        config = window_config(config.replace(grid_res=grid_res), 16)
    return config, sc.fluid, bucketed.from_simstate(sc.state, config)


def _warm(state, config, fluid, n=2):
    """A few plain substeps so vel and C are non-zero."""
    for _ in range(n):
        state = bucketed.substep(state, config, fluid)
    return state


P_CASES = {
    "float32": {},
    "bfloat16": dict(storage="bfloat16"),
    "eos_power_static": dict(eos_power_static=7.0),
    "friction": dict(bc="friction", bc_band_hi=3),
    "stick": dict(bc="stick"),
    "legacy_strain": dict(legacy_strain=True),
}


@pytest.mark.parametrize("case", list(P_CASES))
def test_kernel_p_matches_plain(dev, case):
    config, fluid, state = _scene(dev, **P_CASES[case])
    state = _warm(state, config, fluid)
    n0 = kp.launches
    got = kp.p2g_update(state, config, fluid)
    torch.cuda.synchronize()
    assert kp.launches == n0 + 1
    want = kp.p2g_update_plain(state, config, fluid)
    scale = float(want.mom.abs().max())
    assert scale > 0
    torch.testing.assert_close(got.mom, want.mom, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(got.mass, want.mass, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["float32", "bfloat16", "windowed", "interactions"])
def test_kernel_f_matches_plain(dev, case):
    storage = "bfloat16" if case == "bfloat16" else "float32"
    config, fluid, state = _scene(
        dev, storage, grid_res=(16, 32, 16) if case == "windowed" else None)
    inter = (Interaction.sphere((8.0, 8.0, 8.0), radius=4.0, strength=0.5),
             Interaction.mouse((6.0, 7.0, 8.0), radius=3.0, strength=0.2)) \
        if case == "interactions" else ()
    state = _warm(state, config, fluid)
    grid = kp.p2g_update_plain(state, config, fluid)
    n0 = kf.launches
    got = kf.g2p_migrate(state, grid, config, fluid, inter)
    torch.cuda.synchronize()
    assert kf.launches == n0 + 1
    want = kf.g2p_migrate_plain(state, grid, config, fluid, inter)
    assert_states_close(got, want, storage == "bfloat16")


def test_ceiling_band_matches_plain(dev):
    """Particles in the last legal row of a window, moving up fast: the
    kernel's ceiling rejection counts and clamps as the plain version's."""
    from mpm_tpu_torch.core.params import FluidParams, SimConfig
    from mpm_tpu_torch.core.state import make_state

    wcfg = window_config(SimConfig(grid_res=(16, 32, 16), substeps=2,
                                   bin_capacity=8), 16)
    pos = np.stack(np.meshgrid(np.arange(5, 11) + 0.5, [12.9],
                               np.arange(5, 11) + 0.5, indexing="ij"),
                   -1).reshape(-1, 3)
    st = make_state(pos.astype(np.float32), dev)
    st.vel[1] = 5.0
    fluid = FluidParams.create(dim=3, gravity=0.0)
    b = bucketed.from_simstate(st, wcfg)
    got = make_step(wcfg, mode="cuda", substeps=3)(b, fluid)
    want = make_step(wcfg, mode="bucketed", substeps=3)(b, fluid)
    assert int(got.ceiling) > 0
    assert_states_close(got, want, False)


def test_substeps_match_plain(dev):
    config, fluid, state = _scene(dev, "bfloat16")
    got = make_step(config, mode="cuda", substeps=6)(state, fluid)
    want = make_step(config, mode="bucketed", substeps=6)(state, fluid)
    assert_states_close(got, want, True)
    assert int(got.lost) == 0


def test_golden_anchor(dev):
    """The 3D bucket-engine fixture of tests/test_golden.py replayed through
    the kernels, at the fused engine's bar there (atol 5e-4)."""
    data = np.load(GOLDEN_3D)
    config, fluid, state = _scene(dev)
    step = make_step(config, mode="cuda", substeps=1)
    for i in range(1, 31):
        state = step(state, fluid)
        if i in (10, 30):
            s = bucketed.to_simstate(state)
            np.testing.assert_allclose(s.pos.cpu().numpy(), data[f"pos_s{i}"],
                                       atol=5e-4)
    assert int(state.lost) == 0


def test_unsupported_configs_raise(dev):
    config, fluid, state = _scene(dev)
    with pytest.raises(NotImplementedError, match="edge planes"):
        kp.p2g_update(state, config.replace(clamp_lo=0.5), fluid)
    grid = kp.p2g_update(state, config, fluid)
    with pytest.raises(ValueError, match="render_scals"):
        kf.g2p_migrate(state, grid, config, fluid, emit_splats=True)


# ---- fixed-point P and F, and the decode on the card ----------------------

def test_decode_divides_on_the_card(dev):
    """fixed_point.decode of a CUDA tensor equals x / mult on the CPU bit
    for bit (a CPU scalar divisor would make it a multiply by 1e-7)."""
    x = np.random.default_rng(11).integers(-2**31, 2**31 - 1, 100_000, dtype=np.int64)
    x = torch.from_numpy(x.astype(np.int32))
    want = fixed_point.decode(x, 1e7)
    assert torch.equal(fixed_point.decode(x.to(dev), 1e7).cpu(), want)
    assert torch.equal(want, x.float() / torch.tensor(1e7))


def test_kernel_p_and_f_fixed_point_match_plain(dev):
    """Kernels P and F on an int32 grid: P's grid bit for bit, F's state
    at F's bars (expected bit-equal)."""
    config, fluid, state = _scene(dev, fixed_point=True)
    state = _warm(state, config, fluid)
    got = kp.p2g_update(state, config, fluid)
    want = kp.p2g_update_plain(state, config, fluid)
    assert got.mom.dtype == torch.int32 and got.mass.dtype == torch.int32
    assert int(want.mom.abs().max()) > 0
    assert torch.equal(got.mom, want.mom) and torch.equal(got.mass, want.mass)
    n0 = kf.launches
    out = kf.g2p_migrate(state, want, config, fluid)
    torch.cuda.synchronize()
    assert kf.launches == n0 + 1
    assert_states_close(out, kf.g2p_migrate_plain(state, want, config, fluid), False)


def test_fixed_point_permutation_bit_exact(dev):
    """tests/test_fused.py:135-160 through the kernels: three overflow-free
    substeps of a permuted input give the same particles bit for bit."""
    sc = fluid_3d(grid_res=16, box=8.0, spacing=0.8, device=dev)
    config = sc.config.replace(bin_capacity=8, fixed_point=True)
    perm = torch.from_numpy(np.random.default_rng(42).permutation(sc.state.num_particles))
    outs = []
    for st in (sc.state, sc.state.permute(perm.to(dev))):
        b = make_step(config, mode="cuda", substeps=3)(bucketed.from_simstate(st, config),
                                                       sc.fluid)
        assert int(b.deferred) == 0 and int(b.lost) == 0
        outs.append(bucketed.to_simstate(b))
    for f in ("ids", "pos", "vel", "C"):
        assert torch.equal(getattr(outs[0], f), getattr(outs[1], f)), f


# ---- the per-pass kernels A, B, D and E -----------------------------------

def test_per_pass_kernels_match_plain(dev):
    config, fluid, state = _scene(dev)
    state = _warm(state, config, fluid)
    n0 = (planes.p2g1_launches, planes.p2g2_launches, planes.g2p_launches)
    g1 = planes.p2g1_planes(state, config)
    w1 = planes.p2g1_plain(state, config)
    assert torch.equal(g1.mass, w1.mass) and torch.equal(g1.mom, w1.mom)
    g2 = planes.p2g2_planes(state, w1.mass, config, fluid)
    assert torch.equal(g2, planes.p2g2_plain(state, w1.mass, config, fluid))
    grid = kp.p2g_update_plain(state, config, fluid)
    vel, C = planes.g2p_planes(state, grid, config)
    wvel, wC = planes.g2p_plain(state, grid, config)
    torch.cuda.synchronize()
    assert torch.equal(vel, wvel) and torch.equal(C, wC)
    assert (planes.p2g1_launches, planes.p2g2_launches, planes.g2p_launches) == \
        tuple(n + 1 for n in n0)


def test_kernel_e_matches_plain(dev):
    """Kernel E on a perturbed state that moves along every axis and
    crowds cells past K, so some moves are deferred."""
    config, fluid, state = _scene(dev)
    gen = torch.Generator(device="cpu").manual_seed(3)
    occ = state.mass > 0
    d = (torch.rand(state.pos.shape, generator=gen) * 1.8 - 0.9).to(dev)
    pos = torch.clamp(state.pos + torch.where(occ, d, 0.0), 2.0, 13.5)
    # cells of even x, y and z in the middle send everything up each axis
    cell = bucketed.cell_coords(config, dev)
    push = ((cell % 2 == 0).all(dim=0) & (cell >= 5).all(dim=0) & (cell <= 10).all(dim=0))
    pos = torch.where(occ & push, torch.floor(state.pos) + 1.5, pos)
    pre = state.replace(pos=pos.contiguous())
    n0 = ke.launches
    got = ke.migrate_planes(pre, config)
    torch.cuda.synchronize()
    assert ke.launches == n0 + 1
    want = ke.migrate_planes_plain(pre, config)
    assert int(want.deferred) > 0
    for f in ("pos", "vel", "C", "mass", "ids", "lost", "deferred"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_per_pass_substep_and_env(dev, monkeypatch):
    """MPM_PALLAS_OLD=1 routes mode="cuda" through A, B, D and E (no P or
    F), at F's bars against the plain per-pass substep; the golden anchor
    holds through it."""
    monkeypatch.setenv("MPM_PALLAS_OLD", "1")
    config, fluid, state = _scene(dev)
    n_pf = (kp.launches, kf.launches)
    n_e = ke.launches
    got = make_step(config, mode="cuda", substeps=3)(state, fluid)
    want = state
    for _ in range(3):
        want = planes.substep_plain(want, config, fluid)
    assert (kp.launches, kf.launches) == n_pf and ke.launches == n_e + 3
    assert_states_close(got, want, False)
    data = np.load(GOLDEN_3D)
    step = make_step(config, mode="cuda", substeps=1)
    for i in range(1, 31):
        state = step(state, fluid)
        if i in (10, 30):
            s = bucketed.to_simstate(state)
            np.testing.assert_allclose(s.pos.cpu().numpy(), data[f"pos_s{i}"], atol=5e-4)
    assert int(state.lost) == 0


# ---- 2D kernels: sim2d and migrate2d (tests/test_kernels2d.py's bars) ----

def _scene2d(dev, name="dam_break_2d", **kw):
    sc = {"dam_break_2d": dam_break_2d, "fluid_2d_friction": fluid_2d_friction}[name](
        device=dev)
    config = sc.config.replace(**kw)
    return config, sc.fluid, bucketed.from_simstate(sc.state, config)


MOUSE = (Interaction.mouse((32.0, 20.0), radius=10.0, strength=0.5),)
CASES_2D = {"free": ("dam_break_2d", ()), "mouse": ("dam_break_2d", MOUSE),
            "friction": ("fluid_2d_friction", ())}


@pytest.mark.parametrize("case", list(CASES_2D))
def test_sim2d_matches_plain(dev, case):
    name, inter = CASES_2D[case]
    config, fluid, state = _scene2d(dev, name)
    state = _warm(state, config, fluid, 4)
    n0 = k2d.sim2d_launches
    got = k2d.sim2d(state, config, fluid, inter)
    torch.cuda.synchronize()
    assert k2d.sim2d_launches == n0 + 1
    want = k2d.sim2d_plain(state, config, fluid, inter)
    assert_states_close(got, want, False)
    assert torch.equal(got.mass, want.mass) and torch.equal(got.ids, want.ids)


@pytest.mark.parametrize("case", list(CASES_2D))
def test_migrate2d_matches_plain(dev, case):
    name, inter = CASES_2D[case]
    config, fluid, state = _scene2d(dev, name)
    state = k2d.sim2d_plain(_warm(state, config, fluid, 4), config, fluid, inter)
    n0 = k2d.migrate2d_launches
    got = k2d.migrate2d(state, config)
    torch.cuda.synchronize()
    assert k2d.migrate2d_launches == n0 + 1
    want = k2d.migrate2d_plain(state, config)
    assert_states_close(got, want, False)
    assert torch.equal(got.mass, want.mass)


def test_crush_2d_matches_plain(dev):
    """tests/test_kernels2d.py's crush (gravity (0, 40), 30 substeps)
    through the kernels: no loss, deferred moves, no bucket over K; then
    one more substep against the plain version."""
    import dataclasses

    config, fluid, state = _scene2d(dev)
    fluid = dataclasses.replace(fluid, gravity=torch.tensor([0.0, 40.0]))
    state = make_step(config, mode="cuda", substeps=30)(state, fluid)
    occ = state.mass > 0
    assert int(state.lost) == 0 and int(state.deferred) > 0
    assert int(occ.sum()) == 1024 and int(occ.sum(dim=0).max()) <= config.bin_capacity
    got = k2d.substep2d(state, config, fluid)
    want = make_step(config, mode="bucketed", substeps=1)(state, fluid)
    assert_states_close(got, want, False)


def test_golden_anchor_2d(dev):
    """tests/test_golden.py's 2D anchor through the kernels: K=32, atol
    2e-3 at frames 1, 5 and 10, no deferred move."""
    data = np.load(GOLDEN_2D)
    config, fluid, state = _scene2d(dev, bin_capacity=32)
    step = make_step(config, mode="cuda")
    for frame in range(1, 11):
        state = step(state, fluid)
        if frame in (1, 5, 10):
            s = bucketed.to_simstate(state)
            np.testing.assert_allclose(s.pos.cpu().numpy(), data[f"pos_f{frame}"], atol=2e-3)
    assert int(state.deferred) == 0 and int(state.lost) == 0


def test_2d_kernels_refuse_fixed_point(dev):
    """A direct call outside the 2D kernels' envelope raises; mode="cuda"
    runs such a config on the plain engine (test_route_runs_the_plain_engine)."""
    config, fluid, state = _scene2d(dev)
    with pytest.raises(NotImplementedError, match="fixed-point"):
        k2d.sim2d(state, config.replace(fixed_point=True), fluid)


@pytest.mark.parametrize("case", list(CASES_2D))
def test_2d_kernels_bf16_bit_equal(dev, case):
    """bf16 vel/C in the 2D pair (kernels2d.py:76-77, 476-477): sim2d and
    migrate2d equal their plain versions on bf16 storage bit for bit, and
    the whole substep through make_step(mode="cuda") too."""
    name, inter = CASES_2D[case]
    config, fluid, state = _scene2d(dev, name, storage_dtype="bfloat16")
    assert state.vel.dtype == torch.bfloat16
    state = _warm(state, config, fluid, 4)
    n0 = (k2d.sim2d_launches, k2d.migrate2d_launches)
    got = k2d.sim2d(state, config, fluid, inter)
    want = k2d.sim2d_plain(state, config, fluid, inter)
    assert_states_equal(got, want)
    assert_states_equal(k2d.migrate2d(want, config), k2d.migrate2d_plain(want, config))
    torch.cuda.synchronize()
    assert (k2d.sim2d_launches, k2d.migrate2d_launches) == (n0[0] + 1, n0[1] + 1)
    assert_states_equal(make_step(config, mode="cuda", substeps=5)(state, fluid, inter),
                      make_step(config, mode="bucketed", substeps=5)(state, fluid, inter))


def _spheres(dim, n=12, seed=3):
    """n spheres over the small scenes' fluid, both kinds, one inactive."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        c = rng.uniform(4.0, 12.0 if dim == 3 else 40.0, dim).tolist()
        make = Interaction.sphere if i % 2 else Interaction.mouse
        out.append(make(c, radius=float(rng.uniform(2.0, 6.0)),
                        strength=float(rng.uniform(0.1, 0.6)), active=0.0 if i == 5 else 1.0))
    return tuple(out)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_kernels_take_twelve_spheres(dev, storage):
    """Kernel F and sim2d read any number of spheres from a device array,
    in list order: with 12 both equal their plain versions bit for bit."""
    config, fluid, state = _scene(dev, storage)
    state = _warm(state, config, fluid)
    grid = kp.p2g_update_plain(state, config, fluid)
    inter = _spheres(3)
    assert_states_equal(kf.g2p_migrate(state, grid, config, fluid, inter),
                      kf.g2p_migrate_plain(state, grid, config, fluid, inter))
    config2, fluid2, state2 = _scene2d(dev, storage_dtype=storage)
    state2 = _warm(state2, config2, fluid2, 4)
    inter2 = _spheres(2)
    assert_states_equal(k2d.sim2d(state2, config2, fluid2, inter2),
                      k2d.sim2d_plain(state2, config2, fluid2, inter2))


def test_route_runs_the_plain_engine(dev):
    """Fixed-point 2D, which the JAX package runs on its XLA engine, runs
    through mode="cuda" on the plain engine, bit-equal to mode="bucketed",
    launching no kernel."""
    config, fluid, state = _scene2d(dev, fixed_point=True)
    n0 = dict(kernel_counts())
    got = make_step(config, mode="cuda", substeps=3)(state, fluid)
    want = make_step(config, mode="bucketed", substeps=3)(state, fluid)
    torch.cuda.synchronize()
    assert kernel_counts() == n0
    assert_states_equal(got, want)
    assert int(got.lost) == 0


WIDE_CASES = {"k40_3d": ("3d", dict(bin_capacity=40)),
              "k40_fixed_3d": ("3d", dict(bin_capacity=40, fixed_point=True)),
              "k64_dense_3d": ("3d", dict(bin_capacity=64, spacing=0.3)),
              "k40_2d": ("2d", dict(bin_capacity=40))}


@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_route_k_above_32_runs_the_kernels(dev, case):
    """K > 32 takes the kernels' 64-bit slot masks: mode="cuda" launches
    them and equals mode="bucketed" bit for bit. The dense case (spacing
    0.3: 27 to 64 particles a cell) sets slot bits up to 63."""
    kind, kw = WIDE_CASES[case]
    if kind == "2d":
        config, fluid, state = _scene2d(dev, **kw)
    else:
        config, fluid, state = _scene(dev, **kw)
    if case == "k64_dense_3d":
        assert int((state.mass > 0).sum(0).max()) > 32
    n0 = dict(kernel_counts())
    got = make_step(config, mode="cuda", substeps=3)(state, fluid)
    want = make_step(config, mode="bucketed", substeps=3)(state, fluid)
    torch.cuda.synchronize()
    n1 = kernel_counts()
    assert all(n1[k] > n0[k] for k in (("sim2d", "migrate2d") if kind == "2d" else ("p2g_update", "g2p_migrate")))
    assert_states_equal(got, want)


# the dense scenes of tests/torch_wide_cases.py (more than 64 particles in the
# fullest cell; K = 200: 125 to 216 a fluid cell): (dim, K, grid)
DENSE = {"k72_3d": (3, 72, 16), "k128_3d": (3, 128, 16), "k200_3d": (3, 200, 16),
         "k72_2d": (2, 72, 32)}


def _dense(dev, case):
    dim, k, grid = DENSE[case]
    config, fluid, state = dense_scene(dim, k, dev, grid=grid, warm=0)
    assert int((state.mass > 0).sum(0).max()) > 64
    return config, fluid, state


@pytest.mark.parametrize("case", list(DENSE))
def test_route_k_above_64_runs_the_chunked_kernels(dev, case):
    """K > 64: the kernels walk a cell's slots a chunk of 64 at a time;
    mode="cuda" launches them (P and F, or sim2d and migrate2d) and equals
    mode="bucketed" bit for bit over 3 substeps."""
    config, fluid, state = _dense(dev, case)
    names = ("sim2d", "migrate2d") if config.dim == 2 else ("p2g_update", "g2p_migrate")
    n0 = dict(kernel_counts())
    got = make_step(config, mode="cuda", substeps=3)(state, fluid)
    torch.cuda.synchronize()
    n1 = kernel_counts()
    want = make_step(config, mode="bucketed", substeps=3)(state, fluid)
    assert all(n1[k] == n0[k] + 3 for k in names), (n0, n1)
    assert_states_equal(got, want)


def test_per_pass_kernels_at_k72(dev, monkeypatch):
    """A, B, D and E on the dense K = 72 scene bit for bit their plain
    versions (E on the state after the plain tail, which moves and defers),
    and MPM_PALLAS_OLD=1's substep through them against the plain per-pass
    substep."""
    config, fluid, state = _dense(dev, "k72_3d")
    state = _warm(state, config, fluid, 1)
    g1 = planes.p2g1_planes(state, config)
    w1 = planes.p2g1_plain(state, config)
    assert torch.equal(g1.mass, w1.mass) and torch.equal(g1.mom, w1.mom)
    g2 = planes.p2g2_planes(state, w1.mass, config, fluid)
    assert torch.equal(g2, planes.p2g2_plain(state, w1.mass, config, fluid))
    grid = kp.p2g_update_plain(state, config, fluid)
    vel, C = planes.g2p_planes(state, grid, config)
    wvel, wC = planes.g2p_plain(state, grid, config)
    assert torch.equal(vel, wvel) and torch.equal(C, wC)
    pre = bucketed.g2p_bucketed(state, grid, config, fluid)
    got = ke.migrate_planes(pre, config)
    want = ke.migrate_planes_plain(pre, config)
    for f in ("pos", "vel", "C", "mass", "ids", "lost", "deferred"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    monkeypatch.setenv("MPM_PALLAS_OLD", "1")
    n_e = ke.launches
    got = make_step(config, mode="cuda", substeps=3)(state, fluid)
    want = state
    for _ in range(3):
        want = planes.substep_plain(want, config, fluid)
    assert ke.launches == n_e + 3
    assert_states_close(got, want, False)


def test_route_beyond_the_kernels_raises(dev):
    """Clamps into the edge planes raise under mode="cuda"; a windowed
    config outside the envelope (fixed-point 2D with a domain) raises
    ValueError, as in the JAX package."""
    for kw in (dict(clamp_lo=0.5), dict(clamp_hi_offset=1.0)):
        config, fluid, state = _scene(dev, **kw)
        with pytest.raises(NotImplementedError, match="mode='bucketed'"):
            make_step(config, mode="cuda", substeps=1)(state, fluid)
    config, fluid, state = _scene2d(dev, fixed_point=True)
    config = config.replace(domain_res=(config.grid_res[0], 2 * config.grid_res[1]))
    with pytest.raises(ValueError, match="windowed"):
        make_step(config, mode="cuda", substeps=1)(state, fluid)


def kernel_counts():
    from mpm_tpu_torch.__main__ import kernel_launches

    return kernel_launches()


# ---- render kernels: X (extract), F's splat emission, BL (blur), SH (shade),
# the splat kernels (z-buffer, dilation)

def _view_cam():
    from mpm_tpu_torch.render import Camera, default_view

    return default_view((16, 16, 16)), Camera(width=160, height=96)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_kernel_x_matches_plain(dev, storage):
    from mpm_tpu_torch.render import extract_kernel as kx

    config, fluid, state = _scene(dev, storage)
    state = _warm(state, config, fluid)
    view, cam = _view_cam()
    n0 = kx.launches
    got = kx.extract_cell_splats(state, view, cam)
    torch.cuda.synchronize()
    assert kx.launches == n0 + 1
    want = kx.extract_cell_splats_plain(state, view, cam)
    assert int((want[2] < kx.CELL_BG).sum()) > 0
    assert_splats_equal(got, want)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_kernel_f_emission_matches_plain(dev, storage):
    from mpm_tpu_torch.ops.cuda import step as cuda_step
    from mpm_tpu_torch.render import extract_kernel as kx

    config, fluid, state = _scene(dev, storage)
    state = _warm(state, config, fluid)
    view, cam = _view_cam()
    rs = kx.render_scals_for(view, cam)
    n0 = kf.emit_launches
    got, splats = cuda_step.substep_emit(state, config, fluid, (), rs)
    torch.cuda.synchronize()
    assert kf.emit_launches == n0 + 1
    grid = kp.p2g_update(state, config, fluid)
    want = kf.g2p_migrate_plain(state, grid, config, fluid)
    assert_states_close(got, want, storage == "bfloat16")
    assert_splats_equal(splats, kx.cell_splats_plain(got.pos, got.vel, got.mass, rs))
    torch.testing.assert_close(splats, kx.extract_cell_splats(got, view, cam), rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(64, 256), (96, 200)])
def test_kernel_bl_matches_plain(dev, shape):
    """A fluid blob with noise, a hole and a near patch at depth 0.25, so
    the filter size reaches its cap of 100 at these heights (bar:
    tests/test_render.py:240)."""
    from mpm_tpu_torch.render import Camera
    from mpm_tpu_torch.render import blur_kernel as kb
    from mpm_tpu_torch.render.splat import BG_DEPTH

    h, w = shape
    rng = np.random.default_rng(7)
    depth = np.full((h, w), BG_DEPTH, np.float32)
    depth[10:50, 40:190] = 30.0 + rng.uniform(-2, 2, (40, 150)).astype(np.float32)
    depth[20:25, 90:110] = 0.25
    depth[30:34, 60:64] = BG_DEPTH
    d = torch.from_numpy(depth).to(dev)
    cam = Camera(width=w, height=h)
    kw = dict(radius=100, max_filter=100, blur_filter_size=7.0, depth_threshold=10.0)
    pc = kb.proj_const_for(cam, 7.0)
    assert int(kb.filter_sizes(d, 100, 100, pc).max()) == 100
    n0 = kb.launches
    got = kb.blur_depth_kernel(d, cam, **kw)
    torch.cuda.synchronize()
    assert kb.launches == n0 + 1
    want = kb.blur_depth_plain(d, cam, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-4)


def _bl_case(case):
    """(depth [H, W], camera) of a kernel-BL stress case: a noisy fluid
    layer at depth 30 with holes, and patches at depth 0.25, whose filter
    size is the cap of 100 at these heights."""
    from mpm_tpu_torch.render import Camera
    from mpm_tpu_torch.render.splat import BG_DEPTH

    shape = {"ragged": (97, 203), "near_edges": (150, 230), "background": (80, 96),
             "one_wide": (150, 1)}[case]
    h, w = shape
    rng = np.random.default_rng(11)
    depth = 30.0 + rng.uniform(-2, 2, shape).astype(np.float32)
    depth[rng.uniform(size=shape) < 0.2] = BG_DEPTH
    if case == "ragged":
        depth[40:46, 150:203] = 0.25  # to the right edge, across a tile's columns
    elif case == "near_edges":
        depth[28:37, 28:37] = 0.25  # around a tile's corner (32, 32)
        depth[0:4, 0:6] = 0.25  # the top and left edges
        depth[h - 4:, w - 6:] = 0.25  # the bottom and right edges
        depth[60:100, 100:104] = 0.25  # a column through a tile's bottom rows
    elif case == "background":
        depth[:] = BG_DEPTH
    else:
        depth[0:3] = 0.25
        depth[70:75] = 0.25
    return depth, Camera(width=max(w, 64), height=h)


@pytest.mark.parametrize("case", ["ragged", "near_edges", "background", "one_wide"])
def test_kernel_bl_stress_matches_plain(dev, case):
    """Kernel BL bit for bit against its plain version: a shape that is no
    multiple of the 32 x 32 tile, fsize-100 patches at a tile's corner and
    at the image's edges (the Y halo crosses tiles and the border), an
    all-background buffer and a buffer one pixel wide."""
    from mpm_tpu_torch.render import blur_kernel as kb

    depth, cam = _bl_case(case)
    d = torch.from_numpy(depth).to(dev)
    kw = dict(radius=100, max_filter=100, blur_filter_size=7.0, depth_threshold=10.0)
    pc = kb.proj_const_for(cam, 7.0)
    if case != "background":
        assert int(kb.filter_sizes(d, 100, 100, pc).max()) == 100
    n0 = kb.launches
    got = kb.blur_depth_kernel(d, cam, **kw)
    torch.cuda.synchronize()
    assert kb.launches == n0 + 1
    want = kb.blur_depth_plain(d, cam, **kw)
    assert torch.equal(got, want), float((got - want).abs().max())
    if case == "background":
        assert torch.equal(got, d)



@pytest.mark.parametrize("case", SHADE_CASES)
def test_kernel_sh_matches_plain(dev, case):
    """Kernel SH against its plain version (ssfr.shade, the crop composited
    over the background) at the benchmark's 1920x1080 frame and crop:
    `live` identical, every pixel that is not live equal, and the u8 frames
    more than 1 level apart on at most 0.01% of the pixels (the benchmark's
    px_off_pct bar). One launch a call. Prints the share of bit-equal pixels
    and the largest difference."""
    from mpm_tpu_torch.render import frame_to_u8
    from mpm_tpu_torch.render import shade_kernel as ksh

    k = shade_case(case, dev, full_size=True)
    n0 = ksh.launches
    got, live = ksh.shade_kernel(**k)
    torch.cuda.synchronize()
    assert ksh.launches == n0 + 1
    want, want_live = ksh.shade_plain(**k)
    assert torch.equal(live, want_live) and int(live.sum()) > 0
    on = torch.zeros(got.shape[:2], dtype=torch.bool, device=dev)
    y0, x0, ch, cw = k["crop"] or (0, 0, *on.shape)
    on[y0:y0 + ch, x0:x0 + cw] = live
    assert torch.equal(got[~on], want[~on])
    du8 = (frame_to_u8(got).int() - frame_to_u8(want).int()).abs()
    off_pct = float((du8 > 1).any(dim=-1).float().mean()) * 100
    equal_pct = float((got[on] == want[on]).all(dim=-1).float().mean()) * 100
    print(f"kernel SH {case}: {int(live.sum())} live pixels, {equal_pct:.4f}% bit-equal, "
          f"max abs diff {float((got - want).abs().max()):.3g}, {off_pct:.4f}% off by > 1 "
          "u8 level (bar 0.01)")
    assert off_pct <= 0.01

@pytest.mark.parametrize("case", DILATE_CASES)
def test_kernel_splat_matches_plain(dev, case):
    """The splat kernels against the plain chain on the card, bit for bit:
    the z-buffer and the key, then the dilation's depth, velocity, sx and
    sy (tests/torch_dilate_cases.py: the benchmark cell's 1080p crop at R
    6, a whole 1080p frame, 640x360 at R 6 and 8, the velocity and lit
    modes, the tracking tie rule, an empty buffer, a near patch at the
    clamp r^2 / R^2, a composite of 2 slabs, a particle array's deposit).
    One launch a z-buffer or key, one a dilation."""
    from mpm_tpu_torch.render import splat
    from mpm_tpu_torch.render import splat_kernel as ksp
    from mpm_tpu_torch.render.camera import view_to_screen, world_to_view

    k = dilate_case(case, dev, full_size=True)
    n0 = (ksp.zbuffer_launches, ksp.dilate_launches)
    if case == "particles":
        px, py, z = view_to_screen(world_to_view(k["pos"], k["view"]), k["cam"])
        bufs = splat._point_deposit(px, py, z, k["vel"], k["cam"], z > k["cam"].near)
        got = splat._dilate_kernel(bufs.depth, k["cam"], k["radius"], k["R"],
                                   velocity=bufs.velocity, with_velocity=True, with_normals=True)
        want = splat._dilate_spheres(bufs, k["cam"], k["radius"], k["R"], with_velocity=True,
                                     with_normals=True)
        zbuffers = 0
    else:
        d, key, got = splat_pass(k, splat.zbuffer_cells, splat.velocity_key,
                                 splat.buffers_from_zbuffer)
        wd, wkey, want = splat_pass(k, splat.zbuffer_cells_plain, splat.velocity_key_plain,
                                    splat.buffers_from_zbuffer_plain)
        assert torch.equal(d, wd)
        assert (key is None) == (wkey is None) and (key is None or torch.equal(key, wkey))
        zbuffers = k["slabs"] * (1 + int(k["velocity"]))
    torch.cuda.synchronize()
    assert (ksp.zbuffer_launches - n0[0], ksp.dilate_launches - n0[1]) == (zbuffers, 1)
    for f in ("depth", "velocity", "sx", "sy"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), (f, int((a != b).sum()))
    occupied = int((got.depth < 4000.0).sum())
    assert occupied == 0 if case == "empty" else occupied > 0
    print(f"splat kernels {case}: {tuple(got.depth.shape)}, R {k['R']}, {occupied} pixels "
          "covered, bit-equal")


def _x_state(dev, case, storage="float32"):
    """Bucket arrays (pos, vel, mass) of a kernel-X stress case, and the
    view and camera: the cells of a 16^3 grid in view, K=8 (K=32 for
    "full"), every slot of a cell at its own seeded place."""
    import types

    view, cam = _view_cam()
    k = 32 if case == "full" else 8
    res = 16
    c = res ** 3
    rng = np.random.default_rng(5)
    cells = np.stack(np.meshgrid(*(np.arange(res),) * 3, indexing="ij"), 0).reshape(3, 1, c)
    pos = (cells + rng.uniform(0.0, 1.0, (3, k, c))).astype(np.float32)
    vel = rng.normal(0.0, 1.0, (3, k, c)).astype(np.float32)
    mass = (rng.uniform(size=(k, c)) < 0.5).astype(np.float32)
    if case == "empty":
        mass[:] = 0.0
    elif case == "full":
        mass[:] = 1.0
    elif case == "near_plane":  # slots at the eye, around the near plane and behind it
        eye = np.linalg.inv(np.asarray(view, np.float64))[:3, 3]
        fwd = -np.asarray(view, np.float64)[2, :3]
        offs = rng.uniform(-0.1, 0.1, (k, c))
        pos = (eye[:, None, None] + fwd[:, None, None] * offs).astype(np.float32)
        mass[:] = 1.0
    elif case == "ties":  # slots 2..5 of each cell at one place, slot 3 the first with mass
        pos[:, 2:6] = pos[:, 2:3]
        mass[2] = 0.0
        mass[3:6] = 1.0
    st = types.SimpleNamespace(
        pos=torch.from_numpy(pos).to(dev),
        vel=torch.from_numpy(vel).to(dev, getattr(torch, storage)),
        mass=torch.from_numpy(mass).to(dev))
    return st, view, cam


@pytest.mark.parametrize("case, storage", [("empty", "float32"), ("full", "float32"),
                                           ("full", "bfloat16"), ("near_plane", "float32"),
                                           ("ties", "float32")])
def test_kernel_x_stress_matches_plain(dev, case, storage):
    """Kernel X bit for bit against its plain version: every slot empty,
    K=32 with every slot filled, slots with mass at and behind the near
    plane, and equal depths in a cell, where the first slot must win."""
    from mpm_tpu_torch.render import extract_kernel as kx

    st, view, cam = _x_state(dev, case, storage)
    n0 = kx.launches
    got = kx.extract_cell_splats(st, view, cam)
    torch.cuda.synchronize()
    assert kx.launches == n0 + 1
    want = kx.extract_cell_splats_plain(st, view, cam)
    for r in range(5):
        assert torch.equal(got[r], want[r]), r
    live = want[2] < kx.CELL_BG
    if case == "empty":
        assert not bool(live.any())
    elif case == "near_plane":
        assert 0 < int(live.sum()) and int((want[4] < 8).sum()) > 0
    elif case == "ties":  # where the tied slots are the nearest, slot 3's |vel|
        sc = kx.render_scals_for(view, cam).tolist()
        p = st.pos[:, 3]
        won = live & (want[2] == -(sc[8] * p[0] + sc[9] * p[1] + sc[10] * p[2] + sc[11]))
        assert int(won.sum()) > 0
        v3 = st.vel[:, 3].float().pow(2).sum(0).sqrt()
        torch.testing.assert_close(want[3][won], v3[won], rtol=1e-6, atol=0)


@pytest.mark.parametrize("storage, fixed", [("float32", False), ("bfloat16", False),
                                            ("float32", True)])
def test_shard_kernels_match_plain(dev, storage, fixed):
    """The two sharded stages of kernel P and kernel F in shard mode on each
    of 4 padded slabs, fed the plain versions' exchanged grids: bit for
    bit their plain versions."""
    config, fluid, state = _scene(dev, storage, fixed_point=fixed)
    _check_shard_kernels(dev, config, fluid, _warm(state, config, fluid))


def test_shard_kernels_match_plain_at_k72(dev):
    """The same on the dense K = 72 scene (the kernels' 64-slot chunks)."""
    config, fluid, state = _dense(dev, "k72_3d")
    _check_shard_kernels(dev, config, fluid, _warm(state, config, fluid, 1))


def _check_shard_kernels(dev, config, fluid, state):
    loc, pc = 4, 256
    padded = domain._exchange_state_halo(
        domain.shard_bucket_state(state, config, domain.SlabMesh.on(dev, 4)).slabs, pc)
    cfg = bucketed.slab_config(config, loc + 4)
    x0s = [a * loc - 2 for a in range(4)]
    g1 = [ks.p2g1_shard_plain(p, cfg, fluid, x0) for p, x0 in zip(padded, x0s)]
    gm = domain._exchange_grid([g.mass.clone() for g in g1], loc, pc)  # in place
    n0 = (ks.p2g1_launches, ks.p2g2u_launches, kf.shard_launches)
    for p, x0, g, m in zip(padded, x0s, g1, gm):
        got = ks.p2g1_shard(p, cfg, fluid, x0)
        assert torch.equal(got.mass, g.mass) and torch.equal(got.mom, g.mom)
        grid1 = Grid(mom=g.mom, mass=m)
        gv = ks.p2g2u_shard_plain(p, grid1, cfg, fluid, x0)
        assert torch.equal(ks.p2g2u_shard(p, grid1, cfg, fluid, x0), gv)
        slab = bucketed.Slab(x0=x0, go=1, c_lo=2, c_hi=loc + 1)
        # the stage-2 output as the grid velocity: its end planes are not
        # exchanged here, which is the same input for both versions
        out = kf.g2p_migrate(p, Grid(mom=gv, mass=m), cfg, fluid, slab=slab)
        want = kf.g2p_migrate_plain(p, Grid(mom=gv, mass=m), cfg, fluid, slab=slab)
        assert_states_equal(out, want)
    torch.cuda.synchronize()
    assert (ks.p2g1_launches, ks.p2g2u_launches, kf.shard_launches) == tuple(x + 4 for x in n0)


@pytest.mark.parametrize("n_slabs", [2, 4, 8])
def test_sharded_step_equals_unsharded_kernels(dev, n_slabs):
    """3 sharded substeps through the kernels on n_slabs slabs of the card
    equal 3 substeps of kernels P and F slot for slot, counters included,
    under gravity -10 (moves deferred at the slab boundaries)."""
    config, fluid, state = _scene(dev)
    fluid = dataclasses.replace(fluid, gravity=torch.tensor([0.0, -10.0, 0.0]))
    want = make_step(config, mode="cuda", substeps=3)(state, fluid)
    mesh = domain.SlabMesh.on(dev, n_slabs)
    out = domain.make_sharded_bucket_step(config, mesh, substeps=3)(
        domain.shard_bucket_state(state, config, mesh), fluid)
    got = domain.gather_bucket_state(out)
    assert_states_equal(got, want)
    assert int(got.deferred) > 0


def test_sharded_fixed_step_equals_unsharded_kernels(dev):
    """The same on 4 slabs with an int32 fixed-point grid: the sharded
    kernels equal fixed-mode P and F slot for slot, counters included."""
    config, fluid, state = _scene(dev, fixed_point=True)
    fluid = dataclasses.replace(fluid, gravity=torch.tensor([0.0, -10.0, 0.0]))
    want = make_step(config, mode="cuda", substeps=3)(state, fluid)
    mesh = domain.SlabMesh.on(dev, 4)
    out = domain.make_sharded_bucket_step(config, mesh, substeps=3)(
        domain.shard_bucket_state(state, config, mesh), fluid)
    got = domain.gather_bucket_state(out)
    assert_states_equal(got, want)
    assert int(got.deferred) > 0


# ---- the migration's choose / move split and pass 2's staged tiles -------

def _stress_grid(config, fluid, dev, seed):
    """A random grid velocity that moves particles up to 1.5 cells a
    substep: moves on every axis, deferred moves and CFL clamps."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    gv = (torch.rand((config.dim, config.num_cells), generator=gen) * 2 - 1) * (
        1.5 / float(fluid.dt))
    if config.fixed_point:
        gv = fixed_point.encode(gv, config.fixed_point_mult)
    return Grid(mom=gv.to(dev).contiguous(), mass=None)


# case: (lattice spacing, config fields); spacing 0.5 fills every cell at K=8;
# "dense": tests/torch_wide_cases' dense 16^3 scene at K above 64 (64 to 125
# particles a fluid cell), each cell's slots in two or more 64-slot chunks;
# "columns": _columns_state, under a still grid
MIGRATION_CASES = {
    "f32": (0.5, dict(bin_capacity=8)),
    "bf16_k4": (0.5, dict(bin_capacity=4, storage_dtype="bfloat16")),
    "fixed": (0.5, dict(bin_capacity=8, fixed_point=True)),
    "ceiling": (0.8, dict(bin_capacity=8)),
    "dense_k72": ("dense", dict(bin_capacity=72)),
    "dense_k128": ("dense", dict(bin_capacity=128)),
    "f32_k16": (0.5, dict(bin_capacity=16)),
    "left_of_left": ("columns", dict(bin_capacity=8)),
}

COLUMNS = [(x, y) for x in range(4, 12) for y in range(4, 12)]


def _columns_state(dev, kw):
    """Columns along z of a 16^3 grid at K=8, one at each (x, y) of
    COLUMNS: cell z=4 holds 3 particles moving up, z=5 holds 5 that stay,
    z=6 holds 2 moving down, every position inside its cell on x and y. The
    left-movers of z=6 rank 0 and 1 into z=5, whose occupancy is 5: 5 + rank
    < 8, so only the rule's other term, the 3 right-movers of z=4 (cell - 2)
    that fill z=5, rejects them. Under a still grid that is 2 deferred moves
    a column, each clamped back into z=6."""
    from mpm_tpu_torch.core.state import make_state

    sc = fluid_3d(grid_res=16, box=8.0, device=dev)
    config = sc.config.replace(**kw)
    rng = np.random.default_rng(17)
    rows = [np.array([x, y, z]) + rng.uniform(0.1, 0.9, size=(n, 3))
            for x, y in COLUMNS for z, n in ((4, 3), (5, 5), (6, 2))]
    state = bucketed.from_simstate(
        make_state(np.concatenate(rows).astype(np.float32), dev), config)
    zc = torch.arange(config.num_cells, device=dev) % config.grid_res[2]
    step = torch.where(zc == 4, 1.0, torch.where(zc == 6, -1.0, 0.0))
    pos = state.pos.clone()
    pos[2] = pos[2] + torch.where(state.mass > 0, step[None, :], 0.0)
    return config, sc.fluid, state.replace(pos=pos.contiguous())


def _moved_from_high_slots(before, after, config) -> int:
    """Particles in slot 64 or higher of `before` that `after` holds in
    another z-column: each left its cell in the migration's first phase
    (z), from a slot of its source's second chunk or later."""
    nz = config.grid_res[-1]
    ids0, ids1 = before.ids.cpu(), after.ids.cpu()
    n = int(max(ids0.max(), ids1.max())) + 1
    cell = torch.arange(config.num_cells).expand_as(ids0)
    where0 = torch.full((n,), -1, dtype=torch.long)
    where1 = torch.full((n,), -1, dtype=torch.long)
    high = (ids0 >= 0) & (torch.arange(ids0.shape[0])[:, None] >= 64)
    where0[ids0[high].long()] = cell[high]
    where1[ids1[ids1 >= 0].long()] = cell[ids1 >= 0]
    seen = (where0 >= 0) & (where1 >= 0)
    return int((seen & (where0 % nz != where1 % nz)).sum())


@pytest.mark.parametrize("case", list(MIGRATION_CASES))
def test_kernel_f_migration_stress_matches_plain(dev, case):
    """Kernel F under a random grid velocity (deferred moves, CFL clamps;
    at K=4, and on the dense scene at K=72, the packing overflows, so
    `lost` starts above 0 and the kernel carries it; the window's ceiling
    band rejects upward moves; on the dense scenes particles of slots 64
    and up move into the neighbours' candidate lists; K=16 in float32 is
    the flagship's width), or on _columns_state under a still grid, whose
    deferred moves only the right-movers of cell - 2 cause: every field and
    counter bit for bit the plain version's. The conservative rejection
    keeps any bucket from overflowing, so the kernel adds 0 to `lost`, as
    the plain version does."""
    spacing, kw = MIGRATION_CASES[case]
    if spacing == "dense":
        config, fluid, state = dense_scene(3, kw["bin_capacity"], dev, grid=16)
    elif spacing == "columns":
        config, fluid, state = _columns_state(dev, kw)
    else:
        sc = fluid_3d(grid_res=16, box=8.0, spacing=spacing, device=dev)
        config, fluid, st = sc.config.replace(**kw), sc.fluid, sc.state
        if case == "ceiling":  # the window's arrays y < 16 of 32; the fluid's top in its band
            config = window_config(config.replace(grid_res=(16, 32, 16)), 16)
            st = dataclasses.replace(
                st, pos=st.pos + torch.tensor([[0.0], [2.0], [0.0]], device=dev))
        state = _warm(bucketed.from_simstate(st, config), config, fluid)
    grid = _stress_grid(config, fluid, dev, seed=5)
    if case == "ceiling":  # everything moves up fast
        up = torch.zeros_like(grid.mom)
        up[1] = up[1] + 1.5 / float(fluid.dt)
        grid = Grid(mom=up, mass=None)
    if spacing == "columns":
        grid = Grid(mom=torch.zeros_like(grid.mom), mass=None)
    n0 = kf.launches
    got = kf.g2p_migrate(state, grid, config, fluid)
    torch.cuda.synchronize()
    assert kf.launches == n0 + 1
    want = kf.g2p_migrate_plain(state, grid, config, fluid)
    assert_states_equal(got, want)
    assert int(want.deferred) > 0
    if case in ("bf16_k4", "dense_k72"):
        assert int(want.lost) > 0
    if case == "ceiling":
        assert int(want.ceiling) > 0
    if spacing == "dense":
        assert _moved_from_high_slots(state, want, config) > 0
    if spacing == "columns":
        assert int(want.deferred) == int(state.deferred) + 2 * len(COLUMNS)


def test_kernel_f_launches_five_kernels(dev):
    """One call of kernel F under the profiler: five device kernels (G2P and
    its tail, one select a migration phase, the gather), six with the splat
    emission (the extraction last), each named with a substring that the
    benchmark's metrics find F's time by; nothing else but PyTorch's own
    kernels around the call."""
    from torch.profiler import ProfilerActivity, profile

    from mpm_tpu_torch.render import extract_kernel as kx

    config, fluid, state = _scene(dev)
    state = _warm(state, config, fluid)
    grid = kp.p2g_update_plain(state, config, fluid)
    view, cam = _view_cam()
    rs = kx.render_scals_for(view, cam)
    calls = {False: lambda: kf.g2p_migrate(state, grid, config, fluid),
             True: lambda: kf.g2p_migrate(state, grid, config, fluid, emit_splats=True,
                                          render_scals=rs)}
    for emit, call in calls.items():
        call()  # built and loaded outside the profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        names = [e.name for e in kernels
                 if not e.name.startswith(("Memcpy", "Memset")) and "at::" not in e.name]
        main = [n for n in names if "extract_cells" not in n]
        assert len(main) == 5, names
        assert all(any(k in n for k in ("g2p_tail", "migrate_select", "migrate_gather"))
                   for n in main), names
        assert [n for n in names if "migrate_select" in n] == names[1:4], names
        assert len(names) == 5 + emit, names


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_kernel_f_matches_plain_on_a_nan_position(dev, storage):
    """A live slot whose position is NaN, and the grid kernel P's plain
    version makes from that state: kernel F clamps the position into the
    domain with fminf/fmaxf and keeps the particle, its NaN left in vel
    and C, and so does the plain version (ops/bucketed._clip). Every field
    bit for bit, NaN where NaN; no particle lost."""
    config, fluid, state = _scene(dev, storage)
    state = _warm(state, config, fluid)
    k, c = np.unravel_index(int(torch.argmax(state.mass)), tuple(state.mass.shape))
    pos = state.pos.clone()
    pos[0, int(k), int(c)] = float("nan")
    state = state.replace(pos=pos)
    grid = kp.p2g_update_plain(state, config, fluid)
    got = kf.g2p_migrate(state, grid, config, fluid)
    want = kf.g2p_migrate_plain(state, grid, config, fluid)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a.is_floating_point():
            assert torch.equal(a.isnan(), b.isnan()), f
            a, b = (torch.where(x.isnan(), 0.0, x) for x in (a, b))
        assert torch.equal(a, b), f
    assert bool(want.pos.isfinite().all()) and not bool(want.vel.isfinite().all())
    assert int((want.mass > 0).sum()) == int((state.mass > 0).sum())
    assert int(want.lost) == int(state.lost)


def _outward_grid(gcfg, fluid, dev):
    """A grid velocity of 1.5 cells a substep along x, away from the slab's
    middle plane on either side."""
    nx = gcfg.grid_res[0]
    plane = torch.arange(gcfg.num_cells) // (gcfg.num_cells // nx)
    gv = torch.zeros((3, gcfg.num_cells))
    gv[0] = torch.where(plane < nx // 2, -1.5, 1.5) / float(fluid.dt)
    return Grid(mom=gv.to(dev).contiguous(), mass=None)


def _plane_ids(state, plane, cfg):
    per = cfg.num_cells // cfg.grid_res[0]
    ids = state.ids[:, plane * per:(plane + 1) * per]
    return set(ids[ids >= 0].tolist())


@pytest.mark.parametrize("case", ["random", "both_ends"])
def test_kernel_f_shard_mode_stress_matches_plain(dev, case):
    """Kernel F's shard mode on each of 4 padded slabs under a random grid
    velocity, or on each of 8 under one pushing every particle away from
    the slab's middle ("both_ends": where both padded end planes hold
    particles, some of each leave the slab's arrays, uncounted, and movers
    into full cells defer): the counters count the slab's own planes only,
    bit for bit the plain version's."""
    config, fluid, state = _scene(dev, "bfloat16", spacing=0.5)
    state = _warm(state, config, fluid)
    n, pc = (4, 256) if case == "random" else (8, 256)
    loc = config.grid_res[0] // n
    padded = domain._exchange_state_halo(
        domain.shard_bucket_state(state, config, domain.SlabMesh.on(dev, n)).slabs, pc)
    cfg = bucketed.slab_config(config, loc + 4)
    gcfg = bucketed.slab_config(config, loc + 6)
    crossed = 0
    for a, p in enumerate(padded):
        slab = bucketed.Slab(x0=a * loc - 2, go=1, c_lo=2, c_hi=loc + 1)
        grid = (_stress_grid(gcfg, fluid, dev, seed=7 + a) if case == "random"
                else _outward_grid(gcfg, fluid, dev))
        got = kf.g2p_migrate(p, grid, cfg, fluid, slab=slab)
        want = kf.g2p_migrate_plain(p, grid, cfg, fluid, slab=slab)
        assert_states_equal(got, want)
        assert int(want.deferred) > 0
        ends = [_plane_ids(p, end, cfg) for end in (0, loc + 3)]
        if case == "both_ends" and all(ends):
            kept = set(want.ids[want.ids >= 0].tolist())
            assert all(e - kept for e in ends), a
            crossed += 1
    assert case == "random" or crossed >= 2


def test_migrate2d_stress_matches_plain(dev):
    """migrate2d (D=2, K=4) on full cells perturbed by up to 0.9 cells on
    both axes, with moves deferred: bit for bit the plain version."""
    sc = dam_break_2d(spacing=0.5, device=dev)
    config, fluid = sc.config, sc.fluid
    state = _warm(bucketed.from_simstate(sc.state, config), config, fluid, 4)
    gen = torch.Generator(device="cpu").manual_seed(9)
    occ = state.mass > 0
    d = (torch.rand(state.pos.shape, generator=gen) * 1.8 - 0.9).to(dev)
    pos = torch.clamp(state.pos + torch.where(occ, d, 0.0), 2.0, 61.5)
    pre = state.replace(pos=pos.contiguous())
    got = k2d.migrate2d(pre, config)
    want = k2d.migrate2d_plain(pre, config)
    assert_states_equal(got, want)
    assert int(want.deferred) > 0


def _odd_grid_state(dev, storage, legacy_strain, res=(61, 53, 67), seed=13):
    """Random particles (about one a cell) with random vel and C on a grid
    that is no multiple of pass 2's tile on any axis."""
    from mpm_tpu_torch.core.params import FluidParams, SimConfig
    from mpm_tpu_torch.core.state import make_state

    config = SimConfig(grid_res=res, bin_capacity=8, storage_dtype=storage,
                       legacy_strain=legacy_strain)
    rng = np.random.default_rng(seed)
    n = int(np.prod(res))
    pos = rng.uniform(2.0, np.array(res) - 2.0, (n, 3))
    vel = rng.normal(size=(n, 3))
    C = rng.normal(size=(3, 3, n)) * 0.3
    st = make_state(pos.astype(np.float32), dev, vel=vel.astype(np.float32),
                    C=C.astype(np.float32))
    return config, FluidParams.create(dim=3), bucketed.from_simstate(st, config)


@pytest.mark.parametrize("legacy_strain", [False, True])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_p2g_pass2_tiles_match_plain_on_odd_grid(dev, storage, legacy_strain):
    """Pass 2's staged tiles at the tile edges of a 61 x 53 x 67 grid:
    kernel P, the sharded stage 2 (the whole state as a slab, go = 1: 63
    grid planes) and, in float32, kernel B, each bit for bit its plain
    version."""
    config, fluid, state = _odd_grid_state(dev, storage, legacy_strain)
    got = kp.p2g_update(state, config, fluid)
    want = kp.p2g_update_plain(state, config, fluid)
    assert torch.equal(got.mom, want.mom) and torch.equal(got.mass, want.mass)
    g1 = ks.p2g1_shard_plain(state, config, fluid, 0)
    assert torch.equal(ks.p2g2u_shard(state, g1, config, fluid, 0),
                       ks.p2g2u_shard_plain(state, g1, config, fluid, 0))
    if storage == "float32":
        w1 = planes.p2g1_plain(state, config)
        assert torch.equal(planes.p2g2_planes(state, w1.mass, config, fluid),
                           planes.p2g2_plain(state, w1.mass, config, fluid))
    torch.cuda.synchronize()


# ---- pass 1's tiles (p2g_mass_tile) under stress -------------------------


def _filled_state(dev, res, k, fill, storage="float32", fixed=False, seed=21):
    """K slots at seeded random places in every cell where `fill` ([C] bool)
    holds, with seeded random mass, vel and C; the other cells empty."""
    from mpm_tpu_torch.core.params import FluidParams, SimConfig

    config = SimConfig(grid_res=res, bin_capacity=k, storage_dtype=storage, fixed_point=fixed)
    rng = np.random.default_rng(seed)
    d, c = len(res), int(np.prod(res))
    corner = np.stack(np.unravel_index(np.arange(c), res)).astype(np.float32)[:, None, :]
    occ = np.broadcast_to(fill[None, :], (k, c))
    pos = np.where(occ, corner + rng.uniform(0.0, 1.0, (d, k, c)), corner + 0.5)
    mass = np.where(occ, rng.uniform(0.5, 1.5, (k, c)), 0.0)
    vel = np.where(occ, rng.normal(size=(d, k, c)), 0.0)
    Cm = np.where(occ, rng.normal(size=(d, d, k, c)) * 0.3, 0.0)
    ids = np.where(occ, np.arange(k * c).reshape(k, c), -1)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(dev)

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    state = bucketed.BucketState(pos=t(pos), vel=t(vel, config.vc_dtype),
                                 C=t(Cm, config.vc_dtype), mass=t(mass),
                                 ids=t(ids, torch.int32), lost=zero, cfl_clamped=zero,
                                 deferred=zero, ceiling=zero)
    return config, FluidParams.create(dim=d), state


def _cells(res, where):
    """[C] bool of the cells (coordinates [D, C]) `where` picks, edge planes
    excluded (the clamps keep them empty)."""
    co = np.stack(np.unravel_index(np.arange(int(np.prod(res))), res))
    inner = np.all([(co[a] >= 1) & (co[a] <= res[a] - 2) for a in range(len(res))], axis=0)
    return inner & where(co)


# case: (K, storage, fixed point, cells); 10 x 19 x 37 is no multiple of the
# 2 x 8 x 16 tile on y or z. "full": every slot of the interior cells
# (bit 31 at K=32); "edges": only the buckets just outside each tile's y and
# z faces, its halo
PASS1_CASES = {
    "k32_full_f32": (32, "float32", False, "full"),
    "k32_full_bf16": (32, "bfloat16", False, "full"),
    "k32_full_f32_fixed": (32, "float32", True, "full"),
    "k32_full_bf16_fixed": (32, "bfloat16", True, "full"),
    "empty": (8, "float32", False, "none"),
    "edges_bf16": (8, "bfloat16", False, "edges"),
    "edges_fixed": (8, "float32", True, "edges"),
}
PASS1_CELLS = {
    "full": lambda co: np.ones(co.shape[1], bool),
    "none": lambda co: np.zeros(co.shape[1], bool),
    "edges": lambda co: np.isin(co[1] % 8, (0, 7)) & np.isin(co[2] % 16, (0, 15)),
}


@pytest.mark.parametrize("case", list(PASS1_CASES))
def test_p2g_pass1_tiles_stress_match_plain(dev, case):
    """Pass 1's tile kernel through each of its 3D launchers on stress
    states, bit for bit the plain bucketed.p2g_pass1: kernel P (its grid
    mass, and the grid velocity after pass 2), the sharded stage 1 on the
    whole state as a slab (go = 1) and, in float32, kernel A."""
    k, storage, fixed, cells = PASS1_CASES[case]
    res = (10, 19, 37)
    config, fluid, state = _filled_state(dev, res, k, _cells(res, PASS1_CELLS[cells]), storage,
                                         fixed)
    n0 = (kp.launches, ks.p2g1_launches, planes.p2g1_launches)
    got = kp.p2g_update(state, config, fluid)
    want = kp.p2g_update_plain(state, config, fluid)
    assert torch.equal(got.mass, want.mass) and torch.equal(got.mom, want.mom)
    g1 = ks.p2g1_shard(state, config, fluid, 0)
    w1 = ks.p2g1_shard_plain(state, config, fluid, 0)
    assert torch.equal(g1.mass, w1.mass) and torch.equal(g1.mom, w1.mom)
    a = storage == "float32" and not fixed
    if a:
        ga, wa = planes.p2g1_planes(state, config), planes.p2g1_plain(state, config)
        assert torch.equal(ga.mass, wa.mass) and torch.equal(ga.mom, wa.mom)
    torch.cuda.synchronize()
    assert (kp.launches, ks.p2g1_launches, planes.p2g1_launches) == (n0[0] + 1, n0[1] + 1,
                                                                     n0[2] + int(a))
    if cells == "none":
        assert not bool(want.mass.any()) and not bool(w1.mass.any())
    else:
        assert int((w1.mass != 0).sum()) > 0


@pytest.mark.parametrize("storage, fixed", [("float32", False), ("bfloat16", False),
                                            ("float32", True), ("bfloat16", True)])
def test_p2g1_shard_stress_at_the_global_ends(dev, storage, fixed):
    """The sharded stage 1 on the first slab (x0 = -2) and the last slab of
    a state with every interior slot occupied (K=32), bit for bit its plain
    version: the slab's padding reaches past both ends of the grid."""
    res = (14, 19, 37)
    config, fluid, state = _filled_state(dev, res, 32, _cells(res, PASS1_CELLS["full"]),
                                         storage, fixed, seed=23)
    loc, pc = 7, res[1] * res[2]
    padded = domain._exchange_state_halo(
        domain.shard_bucket_state(state, config, domain.SlabMesh.on(dev, 2)).slabs, pc)
    cfg = bucketed.slab_config(config, loc + 4)
    for a, p in enumerate(padded):
        x0 = a * loc - 2
        got, want = ks.p2g1_shard(p, cfg, fluid, x0), ks.p2g1_shard_plain(p, cfg, fluid, x0)
        assert torch.equal(got.mass, want.mass) and torch.equal(got.mom, want.mom), x0
    torch.cuda.synchronize()


@pytest.mark.parametrize("cells", ["full", "edges"])
def test_sim2d_pass1_stress_matches_plain(dev, cells):
    """sim2d (pass 1's tile kernel at D=2, 8 x 32 tiles) on a 21 x 45 grid,
    every interior slot occupied at K=32 or only the buckets just outside
    each tile's faces, bit for bit its plain version."""
    res = (21, 45)
    where = {"full": lambda co: np.ones(co.shape[1], bool),
             "edges": lambda co: np.isin(co[0] % 8, (0, 7)) & np.isin(co[1] % 32, (0, 31))}
    config, fluid, state = _filled_state(dev, res, 32, _cells(res, where[cells]))
    n0 = k2d.sim2d_launches
    got = k2d.sim2d(state, config, fluid, ())
    torch.cuda.synchronize()
    assert k2d.sim2d_launches == n0 + 1
    assert_states_equal(got, k2d.sim2d_plain(state, config, fluid, ()))


# ---- the oracle, the binned engine, the sort-based slabs, legacy_quad ------

def test_oracle_golden_replay_on_the_card(dev):
    """The golden 2D replay through the oracle (the sorting accumulating
    index_put_ on the card): frames 1, 5, 10 within 2e-3 of the fixture,
    the same bits on two runs."""
    data = np.load(GOLDEN_2D)
    sc = dam_break_2d(device=dev)
    step = make_step(sc.config, mode="reference")
    runs = []
    for _ in range(2):
        st = sc.state
        for frame in range(1, 11):
            st = step(st, sc.fluid)
            if frame in (1, 5, 10):
                np.testing.assert_allclose(st.by_id().pos.cpu().numpy(), data[f"pos_f{frame}"],
                                           atol=2e-3)
        runs.append(st)
    assert torch.equal(runs[0].pos, runs[1].pos) and torch.equal(runs[0].vel, runs[1].vel)


@pytest.mark.parametrize("scene", ["dam_break_2d", "fluid_3d", "fluid_3d_fixed_point"])
def test_binned_matches_oracle_on_the_card(dev, scene):
    """One substep of each scene at its full size (fluid_3d: 157,464
    particles on 64^3): ids equal, vel/C within 1e-5, pos within max(1e-6,
    one float32 ulp) (the oracle adds a cell's run in float32, binned in
    float64); fixed point bit-equal across two runs."""
    from mpm_tpu_torch.models.scenes import get_scene

    sc = get_scene(scene, device=dev)
    a = make_step(sc.config, mode="reference", substeps=1)(sc.state, sc.fluid).by_id()
    b = make_step(sc.config, mode="binned", substeps=1)(sc.state, sc.fluid).by_id()
    assert torch.equal(a.ids, b.ids)
    ulp = torch.clamp_min(a.pos.abs() * 2.0 ** -23, 1e-6)
    assert bool(((a.pos - b.pos).abs() <= ulp).all())
    for x, y in ((a.vel, b.vel), (a.C, b.C)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-5)
    if sc.config.fixed_point:
        c = make_step(sc.config, mode="binned", substeps=1)(sc.state, sc.fluid).by_id()
        assert torch.equal(b.pos, c.pos) and torch.equal(b.vel, c.vel)


@pytest.mark.parametrize("fixed", [False, True])
def test_sorted_shard_step_on_the_card(dev, fixed):
    """tests/test_sharded.py's small scene on 4 slabs of the card against
    the binned engine: ids equal, pos within 2e-3; fixed point bit-exact."""
    from mpm_tpu_torch.models.scenes import fluid_3d_fixed_point

    f = fluid_3d_fixed_point if fixed else fluid_3d
    sc = f(grid_res=16, box=10.0, spacing=1.0, device=dev)
    sc = sc._replace(config=sc.config.replace(substeps=2))
    n = sc.state.num_particles
    sconf = domain.ShardConfig(n_shards=4, local_capacity=n + 2 * 128 + 64,
                               migration_capacity=128)
    mesh = domain.SlabMesh.on(dev, 4)
    state = domain.shard_scene(sc, sconf, mesh)
    step = domain.make_sharded_step(sc.config, sconf, mesh, substeps=2)
    ref = make_step(sc.config, mode="binned", substeps=2)
    s_ref = sc.state
    for _ in range(2):
        state, s_ref = step(state, sc.fluid), ref(s_ref, sc.fluid)
    live, want = domain.gather_live(state), s_ref.by_id()
    assert torch.equal(live.ids, want.ids)
    if fixed:
        assert torch.equal(live.pos, want.pos) and torch.equal(live.vel, want.vel)
    else:
        torch.testing.assert_close(live.pos, want.pos, rtol=0, atol=2e-3)
    domain.demo_sharded_step(4, dev)


def test_legacy_quad_frame_on_the_card(dev):
    """render_frame_buckets(mode="legacy_quad") on the card: the fluid mask
    equal to the CPU frame's, the grey within 1e-4 (the exponentials of two
    devices)."""
    from mpm_tpu_torch.render import Camera, RenderConfig, default_view, render_frame_buckets

    config, fluid, state = _scene(dev)
    n = int((state.mass > 0).sum())
    rc = RenderConfig(camera=Camera(width=128, height=96), mode="legacy_quad")
    view = default_view((16, 16, 16))
    got = render_frame_buckets(state, view, rc, num_particles=n).cpu()
    cpu_state = bucketed.BucketState(*[t.cpu() for t in (
        state.pos, state.vel, state.C, state.mass, state.ids, state.lost, state.cfl_clamped,
        state.deferred, state.ceiling)])
    want = render_frame_buckets(cpu_state, view, rc, num_particles=n)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
