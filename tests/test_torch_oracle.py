"""The port's oracle (mpm_tpu_torch.ops.reference) on the CPU: the golden
fixture of tests/test_golden.py, the JAX oracle run without fused
multiply-adds, and the invariants of tests/test_oracle.py.

Bars. The fixture came from the JAX oracle under XLA on the CPU, which
contracts multiply-adds to FMA: the port's oracle equals it at atol 0 at
frame 1 and is then held bit for bit to the JAX oracle run without FMA
(tests/torch_jax_cases.py) at frames 1, 5 and 10; against the fixture it
stays within the fused engine's 2e-3 there (measured below 2e-5). The
binned engine meets the fixture at 2e-3. Invariants at the JAX tests' own
tolerances.
"""

import os

import numpy as np
import pytest
import torch

from mpm_tpu.models import scenes as jscenes
from mpm_tpu.ops import reference as jreference
from mpm_tpu.ops.transfer import geometry as jgeometry
from mpm_tpu.core.state import zero_grid as jzero_grid
from mpm_tpu_torch.core.state import make_state, zero_grid
from mpm_tpu_torch.models.scenes import get_scene
from mpm_tpu_torch.ops import bspline, reference
from mpm_tpu_torch.ops.interact import Interaction
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.ops.transfer import flat_tap_offsets, geometry

from torch_jax_cases import run_cases

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "dam_break_2d_oracle.npz")
FRAMES = (1, 5, 10)


@pytest.fixture(scope="module")
def scene2d():
    return get_scene("dam_break_2d", device="cpu")


@pytest.fixture(scope="module")
def jax_oracle(scene2d):
    """The JAX oracle's golden replay without FMA: pos and vel by id after
    frames 1, 5 and 10."""
    s = scene2d.config.substeps
    out = run_cases({"o": dict(scene="dam_break_2d", engine="reference", substeps=10 * s,
                               record=[f * s for f in FRAMES])})["o"]
    return {f: {k: out[k if f == 10 else f"{k}@{f * s}"] for k in ("pos", "vel", "C")}
            for f in FRAMES}


def test_golden_fixture_oracle(scene2d, jax_oracle):
    """tests/test_golden.py's replay through make_step(mode="reference"):
    atol 0 at frame 1, bit for bit against the no-FMA JAX oracle at every
    checked frame, within 2e-3 of the fixture."""
    data = np.load(GOLDEN)
    step = make_step(scene2d.config, mode="reference")
    state = scene2d.state
    for frame in range(1, 11):
        state = step(state, scene2d.fluid)
        if frame in FRAMES:
            s = state.by_id()
            got = s.pos.numpy()
            if frame == 1:
                np.testing.assert_array_equal(got, data["pos_f1"])
            np.testing.assert_allclose(got, data[f"pos_f{frame}"], rtol=0, atol=2e-3)
            for k in ("pos", "vel", "C"):
                np.testing.assert_array_equal(getattr(s, k).numpy(), jax_oracle[frame][k],
                                              err_msg=f"frame {frame} {k}")


def test_golden_fixture_binned(scene2d):
    """The binned engine's replay within 2e-3 of the fixture
    (tests/test_golden.py's bar)."""
    data = np.load(GOLDEN)
    step = make_step(scene2d.config, mode="binned")
    state = scene2d.state
    for frame in range(1, 11):
        state = step(state, scene2d.fluid)
        if frame in FRAMES:
            np.testing.assert_allclose(state.by_id().pos.numpy(), data[f"pos_f{frame}"],
                                       rtol=0, atol=2e-3)


def test_scene_particle_counts():
    assert get_scene("dam_break_2d", device="cpu").state.num_particles == 1024
    assert get_scene("fluid_3d_fixed_point", device="cpu").state.num_particles == 4096


def test_bspline_partition_of_unity(scene2d):
    """Weights sum to 1 (atol 1e-6) and their first moment to 0 (1e-5)."""
    geom = geometry(scene2d.state.pos, scene2d.config)
    taps = bspline.taps(scene2d.config.dim)
    wsum = sum(bspline.tap_weight(geom.d, t) for t in taps)
    np.testing.assert_allclose(wsum.numpy(), 1.0, atol=1e-6)
    m1 = sum(bspline.tap_weight(geom.d, t) * bspline.tap_dist(geom.d, t) for t in taps)
    np.testing.assert_allclose(m1.numpy(), 0.0, atol=1e-5)


def test_geometry_matches_jax(scene2d):
    """Base cells, offsets, flat ids and tap offsets equal the JAX
    package's bit for bit."""
    j = jscenes.get_scene("dam_break_2d")
    jg = jgeometry(j.state.pos, j.config)
    g = geometry(scene2d.state.pos, scene2d.config)
    for f in ("base", "d", "flat_base"):
        np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(jg, f)))
    from mpm_tpu.ops.transfer import flat_tap_offsets as jflat

    assert flat_tap_offsets(scene2d.config) == jflat(j.config)


def test_p2g_conserves_mass_and_momentum(scene2d):
    """Grid mass equals particle mass (rtol 1e-6) and grid momentum the
    particles' (atol 1e-3); both within 1e-6 of the JAX oracle's P2G pass 1
    on the same seeded velocities (in-process JAX contracts to FMA)."""
    from mpm_tpu.core.state import make_state as jmake_state

    state, config = scene2d.state, scene2d.config
    vel = np.random.default_rng(0).normal(size=tuple(state.vel.shape)).astype(np.float32) * 0.1
    state = make_state(state.pos.T.numpy(), "cpu", vel=vel.T)
    grid = reference.p2g_1(state, zero_grid(config, "cpu"), geometry(state.pos, config), config)
    np.testing.assert_allclose(float(grid.mass.sum()), float(state.mass.sum()), rtol=1e-6)
    pm = (state.mass * state.vel).sum(dim=1)
    np.testing.assert_allclose(grid.mom.sum(dim=1).numpy(), pm.numpy(), atol=1e-3)

    jcfg = jscenes.get_scene("dam_break_2d").config
    js = jmake_state(state.pos.T.numpy(), vel=vel.T)
    jgrid = jreference.p2g_1(js, jzero_grid(jcfg), jgeometry(js.pos, jcfg), jcfg)
    np.testing.assert_allclose(grid.mass.numpy(), np.asarray(jgrid.mass), rtol=0, atol=1e-6)
    np.testing.assert_allclose(grid.mom.numpy(), np.asarray(jgrid.mom), rtol=0, atol=1e-6)


def test_frames_run_and_stay_bounded(scene2d):
    state, config, fluid = scene2d.state, scene2d.config, scene2d.fluid
    step = make_step(config, mode="reference")
    for _ in range(10):
        state = step(state, fluid)
    pos = state.pos.numpy()
    assert np.all(np.isfinite(pos)) and np.all(np.isfinite(state.vel.numpy()))
    assert np.all(pos >= config.clamp_lo - 1e-6)
    res = np.asarray(config.grid_res).reshape(-1, 1)
    assert np.all(pos <= res - config.clamp_hi_offset + 1e-6)
    assert float(pos[1].mean()) > 32.0  # falling: gravity is +y in 2D


def test_dam_break_x_symmetry(scene2d):
    """A mirror-symmetric lattice about x = 31.5 stays symmetric (atol
    1e-3; tests/test_oracle.py's off-integer lattice)."""
    c = 31.5
    half = 0.2 + np.arange(16)
    xs = np.concatenate([c - half, c + half])
    ys = 16.0 + 0.3 + np.arange(32)
    xg, yg = np.meshgrid(xs, ys, indexing="ij")
    pos = np.stack([xg.reshape(-1), yg.reshape(-1)], axis=-1).astype(np.float32)
    state = make_state(pos, "cpu")
    config = scene2d.config.replace(num_particles=pos.shape[0])
    step = make_step(config, mode="reference")
    for _ in range(5):
        state = step(state, scene2d.fluid)
    x = state.pos[0].numpy()
    np.testing.assert_allclose(x.mean(), c, atol=1e-3)
    np.testing.assert_allclose(np.sort(x - c), np.sort(-(x - c)), atol=1e-3)


def test_mass_never_created(scene2d):
    total0 = float(scene2d.state.mass.sum())
    state = make_step(scene2d.config, mode="reference")(scene2d.state, scene2d.fluid)
    assert float(state.mass.sum()) == total0


def test_interaction_pushes_particles(scene2d):
    step = make_step(scene2d.config, mode="reference")
    push = (Interaction.mouse((32.0, 32.0), radius=10.0, strength=0.5),)
    d_push = (step(scene2d.state, scene2d.fluid, push).pos - 32.0).norm(dim=0)
    d_free = (step(scene2d.state, scene2d.fluid).pos - 32.0).norm(dim=0)
    assert float(d_push.mean()) > float(d_free.mean())


def test_fixed_point_oracle_matches_jax():
    """fluid_3d_fixed_point (4,096 particles, int32 grid, a per-tap encode)
    one oracle substep: the grid sums are integers, so pos, vel and C equal
    the no-FMA JAX oracle's with XLA's reciprocal decode modelled
    (tests/torch_xla_ref.reciprocal_decode) bit for bit."""
    from torch_xla_ref import reciprocal_decode

    want = run_cases({"f": dict(scene="fluid_3d_fixed_point", engine="reference",
                                substeps=1)})["f"]
    sc = get_scene("fluid_3d_fixed_point", device="cpu")
    with reciprocal_decode():
        got = make_step(sc.config, mode="reference", substeps=1)(sc.state, sc.fluid).by_id()
    for k in ("pos", "vel", "C", "ids"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), want[k], err_msg=k)
