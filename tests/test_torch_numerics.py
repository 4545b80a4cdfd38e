"""Numerics shared by every engine, the PyTorch port against the JAX package
on the same seeded numpy inputs: B-spline weights, pow_static and the EOS,
the grid update with its BC bands, interactions, fixed-point coding and the
port's correctly rounded square root and power.

These are elementwise formulas written in the same operation order in both
packages; where a bar is not exact equality it allows float32 rounding of
XLA's fused loops (a few ulp)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpm_tpu.core.params import FluidParams as JFluid
from mpm_tpu.core.params import SimConfig as JConfig
from mpm_tpu.core.state import Grid as JGrid
from mpm_tpu.ops import bspline as jbs
from mpm_tpu.ops import fixed_point as jfp
from mpm_tpu.ops import grid as jgrid
from mpm_tpu.ops import interact as jint
from mpm_tpu.ops import stress as jst
from mpm_tpu_torch.core.params import FluidParams as TFluid
from mpm_tpu_torch.core.params import SimConfig as TConfig
from mpm_tpu_torch.core.state import Grid as TGrid
from mpm_tpu_torch.ops import bspline as tbs
from mpm_tpu_torch.ops import fixed_point as tfp
from mpm_tpu_torch.ops.fmath import pow_rn, sqrt_rn
from mpm_tpu_torch.ops import grid as tgrid
from mpm_tpu_torch.ops import interact as tint
from mpm_tpu_torch.ops import stress as tst

torch.set_num_threads(2)

RTOL = 4e-7  # a few float32 ulp


def _close(j, t, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def test_bspline_taps_weights_and_dists():
    rng = np.random.default_rng(0)
    pos = rng.uniform(2.0, 14.0, (3, 4, 50)).astype(np.float32)
    d_np = pos - np.floor(pos) - 0.5
    assert jbs.taps(3) == tbs.taps(3)
    for tap in jbs.taps(3):
        _close(jbs.tap_weight(jnp.asarray(d_np), tap),
               tbs.tap_weight(torch.from_numpy(d_np), tap))
        _close(jbs.tap_dist(jnp.asarray(d_np), tap),
               tbs.tap_dist(torch.from_numpy(d_np), tap))


def test_matvec_and_transpose():
    rng = np.random.default_rng(1)
    M = rng.normal(size=(3, 3, 4, 20)).astype(np.float32)
    v = rng.normal(size=(3, 4, 20)).astype(np.float32)
    for jf, tf in ((jbs.matvec, tbs.matvec), (jbs.matvec_t, tbs.matvec_t)):
        _close(jf(jnp.asarray(M), jnp.asarray(v)),
               tf(torch.from_numpy(M), torch.from_numpy(v)), atol=1e-6)


@pytest.mark.parametrize("p", [7.0, 4.0, 1.0, 2.5])
def test_pow_static(p):
    x = np.random.default_rng(2).uniform(0.5, 1.6, (200,)).astype(np.float32)
    j = jst.pow_static(jnp.asarray(x), p)
    t = tst.pow_static(torch.from_numpy(x), p)
    if float(p).is_integer():  # unrolled multiplies in one fixed order
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    else:
        _close(j, t, rtol=2e-6)


@pytest.mark.parametrize("static", [7.0, 0.0])
def test_eos_pressure(static):
    rho = np.random.default_rng(3).uniform(2.0, 9.0, (4, 64)).astype(np.float32)
    jf = JFluid.create(dim=3, rest_density=6.0, eos_stiffness=12.0, eos_power=7.0)
    tf = TFluid.create(dim=3, rest_density=6.0, eos_stiffness=12.0, eos_power=7.0)
    _close(jst.eos_pressure(jnp.asarray(rho), jf, static),
           tst.eos_pressure(torch.from_numpy(rho), tf, static), rtol=2e-6, atol=1e-6)


GRID_CASES = {
    "slip": dict(),
    "stick": dict(bc="stick"),
    "friction": dict(bc="friction", friction=0.5, bc_band_hi=3),
    "windowed": dict(grid_res=(16, 8, 16), domain_res=(16, 16, 16)),
}


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_update_grid(case):
    kw = dict(grid_res=(16, 16, 16), bin_capacity=8)
    kw.update(GRID_CASES[case])
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    rng = np.random.default_rng(4)
    c = jcfg.num_cells
    mass = rng.uniform(0.0, 3.0, (c,)).astype(np.float32)
    mass[rng.uniform(size=c) < 0.3] = 0.0
    mom = rng.normal(size=(3, c)).astype(np.float32)
    jf = JFluid.create(dim=3, dt=0.05)
    tf = TFluid.create(dim=3, dt=0.05)
    jg = jgrid.update_grid(JGrid(mom=jnp.asarray(mom), mass=jnp.asarray(mass)), jcfg, jf)
    tg = tgrid.update_grid(TGrid(mom=torch.from_numpy(mom), mass=torch.from_numpy(mass)),
                           tcfg, tf)
    _close(jg.mom, tg.mom, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(jg.mass), tg.mass.numpy())
    for a in range(3):
        np.testing.assert_array_equal(np.asarray(jgrid.boundary_bands(jcfg)[a]),
                                      tgrid.boundary_bands(tcfg, "cpu")[a].numpy())


def test_apply_interactions():
    rng = np.random.default_rng(5)
    pos = rng.uniform(2.0, 14.0, (3, 4, 100)).astype(np.float32)
    pos[:, 0, 0] = (8.0, 8.0, 8.0)  # exactly at the sphere's center: no force
    vel = rng.normal(size=(3, 4, 100)).astype(np.float32)
    jits = (jint.Interaction.sphere((8.0, 8.0, 8.0), radius=4.0, strength=0.5),
            jint.Interaction.mouse((5.0, 6.0, 7.0), radius=3.0, strength=0.1),
            jint.Interaction.sphere((3.0, 3.0, 3.0), radius=5.0, active=0.0))
    tits = (tint.Interaction.sphere((8.0, 8.0, 8.0), radius=4.0, strength=0.5),
            tint.Interaction.mouse((5.0, 6.0, 7.0), radius=3.0, strength=0.1),
            tint.Interaction.sphere((3.0, 3.0, 3.0), radius=5.0, active=0.0))
    for jf in dataclasses.fields(jint.Interaction):
        for ji, ti in zip(jits, tits):
            np.testing.assert_array_equal(np.asarray(getattr(ji, jf.name)),
                                          getattr(ti, jf.name).numpy())
    j = jint.apply_interactions(jnp.asarray(pos), jnp.asarray(vel), jits)
    t = tint.apply_interactions(torch.from_numpy(pos), torch.from_numpy(vel), tits)
    _close(j, t, atol=1e-6)
    assert not np.allclose(t.numpy(), vel)  # the emitters did push
    np.testing.assert_array_equal(t[:, 0, 0].numpy(), vel[:, 0, 0])


def test_fixed_point_coding():
    x = np.random.default_rng(6).normal(size=(3, 50)).astype(np.float32) * 10
    je = jfp.encode(jnp.asarray(x), 1e7)
    te = tfp.encode(torch.from_numpy(x), 1e7)
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    _close(jfp.decode(je, 1e7), tfp.decode(te, 1e7))


SQRT_CASES = {
    "uniform": (0.0, 100.0),
    "near_zero": (0.0, 1e-30),
    "over_1e6": (1e6, 1e12),
}


@pytest.mark.parametrize("case", list(SQRT_CASES))
def test_sqrt_rn_matches_numpy(case):
    """The port's square root equals IEEE float32 `np.sqrt` bit for bit on
    2^20 seeded values (PyTorch's vectorised CPU sqrt does not)."""
    lo, hi = SQRT_CASES[case]
    x = np.random.default_rng(7).uniform(lo, hi, 1 << 20).astype(np.float32)
    got = sqrt_rn(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), np.sqrt(x).view(np.int32))


POW_RANGES = {
    "unit": (0.5, 2.0),
    "below_one": (1e-3, 1.0),
    "wide": (1.0, 1e5),
}
POW_EXPONENTS = {"7": 7.0, "1/2.2": float(np.float32(1.0 / 2.2))}


def _pow_inputs(case):
    lo, hi = POW_RANGES[case]
    return np.random.default_rng(8).uniform(lo, hi, 1 << 20).astype(np.float32)


@pytest.mark.parametrize("p", list(POW_EXPONENTS))
@pytest.mark.parametrize("case", list(POW_RANGES))
def test_pow_rn_matches_numpy(case, p):
    """The port's power equals numpy's float64 power rounded to float32 bit
    for bit on 2^20 seeded values (PyTorch's vectorised CPU power does not:
    it differs on 16,388 to 22,580 of them)."""
    x = _pow_inputs(case)
    e = POW_EXPONENTS[p]
    want = np.power(x.astype(np.float64), e).astype(np.float32)
    got = pow_rn(torch.from_numpy(x), e).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # a 0-d float32 exponent (FluidParams.eos_power) rounds alike
    got_t = pow_rn(torch.from_numpy(x), torch.tensor(e, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(got_t.view(np.int32), want.view(np.int32))


# XLA's CPU float32 power is not correctly rounded either: the count of the
# 2^20 values of each case where it differs from the correctly rounded
# power, as measured (the same with and without --xla_cpu_max_isa=AVX); no
# value differs by more than 1 ulp
XLA_POW_RESIDUAL = {
    ("unit", "7"): 703, ("unit", "1/2.2"): 576,
    ("below_one", "7"): 709, ("below_one", "1/2.2"): 685,
    ("wide", "7"): 707, ("wide", "1/2.2"): 652,
}


@pytest.mark.parametrize("p", list(POW_EXPONENTS))
@pytest.mark.parametrize("case", list(POW_RANGES))
def test_pow_rn_residual_against_xla(case, p):
    """What the port's correctly rounded power leaves against the JAX
    package's XLA CPU `pow`: XLA's own rounding, at most 1 ulp on a few
    hundred of 2^20 values. The EOS with a run-time exponent therefore
    meets XLA's bit for bit only where no such value is reached."""
    x = _pow_inputs(case)
    e = POW_EXPONENTS[p]
    got = pow_rn(torch.from_numpy(x), e).numpy()
    xla = np.asarray(jnp.power(jnp.asarray(x), jnp.float32(e)))
    ulps = np.abs(got.view(np.int32).astype(np.int64) - xla.view(np.int32).astype(np.int64))
    assert int((ulps > 0).sum()) == XLA_POW_RESIDUAL[(case, p)]
    assert int(ulps.max()) == 1
