"""The port's per-pass substep (mpm_tpu_torch/ops/cuda/planes.py and
migrate_planes.py: kernels A, B, D and E, here through their plain
versions) against the JAX package's per-pass Pallas kernels
(mpm_tpu/ops/pallas/bucket_kernels.py and migrate_kernels.py) in interpret
mode, on tests/test_pallas.py's small scene (16^3, K=8).

Bars: the JAX package's own (tests/test_pallas.py): grid mass and
momentum within 1e-6; the per-pass substep's pos within 1e-6 and vel within
1e-5 with ids equal slot for slot; the migration equal by id. D's vel and C
are held within 1e-5, F's bar (tests/test_fused.py). Each JAX function is
called once and its result shared."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpm_tpu.models.scenes import fluid_3d as jfluid_3d
from mpm_tpu.ops import bucketed as jb
from mpm_tpu.ops.grid import update_grid as jupdate_grid
from mpm_tpu.ops.pallas import bucket_kernels as bk
from mpm_tpu.ops.pallas import migrate_kernels as mk
from mpm_tpu_torch import convert
from mpm_tpu_torch.models.scenes import fluid_3d as tfluid_3d
from mpm_tpu_torch.ops import bucketed as tb
from mpm_tpu_torch.ops.cuda import migrate_planes as ke
from mpm_tpu_torch.ops.cuda import planes
from mpm_tpu_torch.ops.cuda import step as cuda_step
from mpm_tpu_torch.ops.cuda.migrate_planes import check_planes
from mpm_tpu_torch.ops.step import make_step, resolve_substep

torch.set_num_threads(2)

FIELDS = ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred", "ceiling")


def _to_port(b) -> tb.BucketState:
    return convert.bucket_state_from_numpy(
        *(np.asarray(getattr(b, f)) for f in FIELDS), device="cpu")


@functools.lru_cache(maxsize=None)
def _small():
    """(jax config, port config, jax scene, port scene, JAX XLA substep)."""
    j = jfluid_3d(grid_res=16, box=8.0, spacing=0.8)
    t = tfluid_3d(grid_res=16, box=8.0, spacing=0.8, device="cpu")
    jcfg = j.config.replace(bin_capacity=8)
    tcfg = t.config.replace(bin_capacity=8)
    return jcfg, tcfg, j, t, jax.jit(lambda b, f: jb.substep(b, jcfg, f, ()))


@pytest.fixture(scope="module")
def warm():
    """The small scene after two JAX XLA substeps (vel and C non-zero),
    in both packages."""
    jcfg, tcfg, j, t, jstep = _small()
    b = jb.from_simstate(j.state, jcfg)
    for _ in range(2):
        b = jstep(b, j.fluid)
    return b, _to_port(b)


@pytest.fixture(scope="module")
def jax_passes(warm):
    """The JAX per-pass kernels in interpret mode on the warm state: the
    grid of A + B, the updated grid, D's (vel, C), and one per-pass substep
    (which reuses the compiled A, B and D)."""
    jcfg, _, j, _, _ = _small()
    b, _ = warm
    grid = bk.p2g_pallas(b, jcfg, j.fluid, interpret=True)
    gu = jupdate_grid(grid, jcfg, j.fluid)
    vel, C = bk.g2p_pallas(b, gu, jcfg, interpret=True)
    sub = bk.substep(b, jcfg, j.fluid, (), interpret=True)
    return grid, gu, (vel, C), sub


def test_grid_of_kernels_a_and_b_matches_jax(warm, jax_passes):
    _, tcfg, _, t, _ = _small()
    grid = jax_passes[0]
    got = planes.p2g_planes(warm[1], tcfg, t.fluid)
    assert float(np.abs(np.asarray(grid.mom)).max()) > 0
    np.testing.assert_allclose(got.mass.numpy(), np.asarray(grid.mass), atol=1e-6)
    np.testing.assert_allclose(got.mom.numpy(), np.asarray(grid.mom), atol=1e-6)


def test_kernel_d_matches_jax(warm, jax_passes):
    """D from the JAX package's updated grid, fed through convert."""
    _, tcfg, _, _, _ = _small()
    gu, (vel, C) = jax_passes[1], jax_passes[2]
    grid = convert.grid_from_numpy(np.asarray(gu.mom), np.asarray(gu.mass), "cpu")
    tvel, tC = planes.g2p_planes(warm[1], grid, tcfg)
    assert float(np.abs(np.asarray(vel)).max()) > 0
    np.testing.assert_allclose(tvel.numpy(), np.asarray(vel), atol=1e-5)
    np.testing.assert_allclose(tC.numpy(), np.asarray(C), atol=1e-5)


def test_per_pass_substep_matches_jax(warm, jax_passes):
    _, tcfg, _, t, _ = _small()
    sub = jax_passes[3]
    got = planes.substep(warm[1], tcfg, t.fluid)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(sub.ids))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(sub.pos), atol=1e-6)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(sub.vel), atol=1e-5)
    for f in ("lost", "cfl_clamped", "deferred"):
        assert int(getattr(got, f)) == int(getattr(sub, f)), f


def test_kernel_e_matches_jax():
    """tests/test_pallas.py's perturbed state (migrations in every
    direction) through the port's kernel E and the JAX kernel E: equal by
    particle id, `lost` equal."""
    jcfg, tcfg, j, _, _ = _small()
    b0 = jb.from_simstate(j.state, jcfg)
    occ = b0.mass > 0
    dpos = jax.random.uniform(jax.random.PRNGKey(3), b0.pos.shape, minval=-0.9, maxval=0.9)
    pos = jnp.clip(b0.pos + jnp.where(occ, dpos, 0.0), 2.0, 13.5)
    pre = jb.BucketState(pos=pos, vel=b0.vel, C=b0.C, mass=b0.mass, ids=b0.ids, lost=b0.lost,
                         cfl_clamped=b0.cfl_clamped, deferred=b0.deferred)
    want = mk.migrate_pallas(pre, jcfg, interpret=True)
    got = ke.migrate_planes(_to_port(pre), tcfg)
    a = jb.to_simstate(want, jcfg.num_particles)
    s = tb.to_simstate(got)
    np.testing.assert_array_equal(s.ids.numpy(), np.asarray(a.ids))
    np.testing.assert_array_equal(s.pos.numpy(), np.asarray(a.pos))
    np.testing.assert_array_equal(s.C.numpy(), np.asarray(a.C))
    assert int(got.lost) == int(want.lost) == 0


def test_three_per_pass_substeps_match_jax_xla():
    """Three per-pass substeps from rest against the JAX XLA engine, the
    per-pass path's own reference in tests/test_pallas.py, at F's bars."""
    jcfg, tcfg, j, t, jstep = _small()
    b = jb.from_simstate(j.state, jcfg)
    s = tb.from_simstate(t.state, tcfg)
    for _ in range(3):
        b = jstep(b, j.fluid)
        s = planes.substep(s, tcfg, t.fluid)
    np.testing.assert_array_equal(s.ids.numpy(), np.asarray(b.ids))
    np.testing.assert_allclose(s.pos.numpy(), np.asarray(b.pos), atol=1e-6)
    np.testing.assert_allclose(s.vel.numpy(), np.asarray(b.vel), atol=1e-5)
    np.testing.assert_allclose(s.C.numpy(), np.asarray(b.C), atol=1e-5)
    assert int(s.lost) == int(b.lost) == 0


def test_env_selects_the_per_pass_substep(monkeypatch):
    """MPM_PALLAS_OLD=1 is read when the substep is resolved."""
    assert resolve_substep("cuda") is cuda_step.substep
    monkeypatch.setenv("MPM_PALLAS_OLD", "1")
    assert resolve_substep("cuda") is planes.substep
    assert resolve_substep("auto") is planes.substep
    monkeypatch.setenv("MPM_PALLAS_OLD", "0")
    assert resolve_substep("auto") is cuda_step.substep


@pytest.mark.parametrize("kw,err", [(dict(domain_res=(16, 32, 16)), ValueError),
                                    (dict(storage_dtype="bfloat16"), NotImplementedError),
                                    (dict(fixed_point=True), NotImplementedError)])
def test_per_pass_substep_refuses(kw, err, monkeypatch):
    """The per-pass kernels refuse windowed, bf16 and fixed-point configs,
    naming mode="cuda". Under MPM_PALLAS_OLD=1 mode="cuda" still raises for
    the windowed config (they would not keep the ceiling band), and runs
    bf16 and fixed point on the plain engine, bit-equal to mode="bucketed",
    as bucket_kernels.substep sends them to the XLA engine."""
    _, tcfg, _, t, _ = _small()
    cfg = tcfg.replace(**kw)
    with pytest.raises(err, match="mode=\"cuda\"" if err is NotImplementedError else "ceiling"):
        check_planes(cfg)
    monkeypatch.setenv("MPM_PALLAS_OLD", "1")
    if err is ValueError:
        with pytest.raises(err, match="ceiling"):
            make_step(cfg, mode="cuda", substeps=1)(tb.from_simstate(t.state, tcfg), t.fluid)
        return
    s = tb.from_simstate(t.state, cfg)
    got = make_step(cfg, mode="cuda", substeps=2)(s, t.fluid)
    want = make_step(cfg, mode="bucketed", substeps=2)(s, t.fluid)
    for f in ("pos", "vel", "C", "mass", "ids", "lost", "deferred"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
