"""The port's fixed-point engine (int32 grid accumulation: the plain
version of kernels P and F in fixed-point mode) and the S4 scene against
the JAX package on the CPU, at tests/test_fused.py's small fixed config
(16^3, K=8, fixed_point=True).

Bars: against the JAX fused kernels in interpret mode, the JAX package's
own (tests/test_fused.py:113-132): ids equal, pos within 1e-5, vel within
1e-4. Against the JAX XLA fixed-point engine, bit for bit (see the test).
Within the port, the int32 sums commute exactly, so the engine is
bit-exact across particle permutations (tests/test_fused.py:135-160)."""

import functools

import numpy as np
import pytest
import torch

from mpm_tpu.models.scenes import fluid_3d as jfluid_3d
from mpm_tpu.models.scenes import fluid_3d_fixed_point as jfluid_3d_fixed_point
from mpm_tpu.ops import bucketed as jb
from mpm_tpu.ops.pallas import fused
from mpm_tpu_torch import convert
from mpm_tpu_torch.models.scenes import SCENES, fluid_3d_fixed_point
from mpm_tpu_torch.models.scenes import fluid_3d as tfluid_3d
from mpm_tpu_torch.ops import bucketed as tb
from mpm_tpu_torch.ops.cuda import g2p_migrate as kf
from mpm_tpu_torch.ops.cuda import p2g_update as kp
from mpm_tpu_torch.ops.cuda import step as cuda_step
from torch_xla_ref import assert_equal_to_xla, reciprocal_decode, state_arrays, xla_substeps

torch.set_num_threads(2)

FIELDS = ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred", "ceiling")


@functools.lru_cache(maxsize=None)
def _small_fixed():
    """(jax config, port config, jax scene, port scene)."""
    j = jfluid_3d(grid_res=16, box=8.0, spacing=0.8)
    t = tfluid_3d(grid_res=16, box=8.0, spacing=0.8, device="cpu")
    return (j.config.replace(bin_capacity=8, fixed_point=True),
            t.config.replace(bin_capacity=8, fixed_point=True), j, t)


def _to_port(b) -> tb.BucketState:
    return convert.bucket_state_from_numpy(
        *(np.asarray(getattr(b, f)) for f in FIELDS), device="cpu")


@pytest.fixture(scope="module")
def jax_fused_substep():
    """One JAX fused fixed-point substep in interpret mode (kernels P and F
    with int32 grids), from the packed initial state."""
    jcfg, _, j, _ = _small_fixed()
    b = jb.from_simstate(j.state, jcfg)
    return b, fused.substep_fused(b, jcfg, j.fluid, (), interpret=True)


def test_plain_fixed_engine_matches_jax_fused(jax_fused_substep):
    _, tcfg, _, t = _small_fixed()
    b0, want = jax_fused_substep
    s = _to_port(b0)
    grid = kp.p2g_update(s, tcfg, t.fluid)  # the plain version: a CPU state
    assert grid.mom.dtype == torch.int32 and grid.mass.dtype == torch.int32
    got = kf.g2p_migrate(s, grid, tcfg, t.fluid)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), atol=1e-5)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel), atol=1e-4)
    assert int(got.lost) == int(want.lost) == 0


def test_plain_fixed_engine_matches_jax_xla():
    """Three substeps against the JAX XLA fixed-point engine, bit for bit,
    counters included. Both sum the same int32 encodings of each slot's
    contributions; the float arithmetic before each truncation agrees once
    XLA runs without fused multiply-adds and the port decodes as XLA's jit
    does, by the reciprocal (tests/torch_xla_ref.py says why: without
    either, vel differs in 1,309 elements and C in 6,165)."""
    _, tcfg, _, t = _small_fixed()
    s = tb.from_simstate(t.state, tcfg)
    want = xla_substeps({"fixed": state_arrays(s)}, 3)["fixed"]
    with reciprocal_decode():
        for _ in range(3):
            s = cuda_step.substep(s, tcfg, t.fluid)
    assert_equal_to_xla(s, want)
    assert int(s.lost) == 0


def test_s4_scene_matches_jax():
    j = jfluid_3d_fixed_point()
    t = fluid_3d_fixed_point(device="cpu")
    assert SCENES["fluid_3d_fixed_point"] is fluid_3d_fixed_point
    assert t.name == j.name and t.config.fixed_point and t.config.num_particles == 4096
    for f in ("grid_res", "num_particles", "substeps", "clamp_lo", "clamp_hi_offset",
              "wall_min", "wall_max_offset", "wall_stiffness", "fixed_point",
              "fixed_point_mult", "bin_capacity", "storage_dtype", "bc"):
        assert getattr(t.config, f) == getattr(j.config, f), f
    for f in ("pos", "vel", "C", "mass", "ids"):
        np.testing.assert_array_equal(getattr(t.state, f).numpy(), np.asarray(getattr(j.state, f)))
    for f in ("dt", "eos_stiffness", "eos_power", "rest_density", "gravity"):
        np.testing.assert_array_equal(getattr(t.fluid, f).numpy(), np.asarray(getattr(j.fluid, f)))


def test_plain_fixed_engine_permutation_bit_exact():
    """Three overflow-free substeps of a permuted input give the same
    particles, bit for bit."""
    _, tcfg, _, t = _small_fixed()
    perm = torch.from_numpy(np.random.default_rng(42).permutation(t.state.num_particles))
    outs = []
    for st in (t.state, t.state.permute(perm)):
        b = tb.from_simstate(st, tcfg)
        for _ in range(3):
            b = cuda_step.substep(b, tcfg, t.fluid)
        assert int(b.deferred) == 0 and int(b.lost) == 0
        outs.append(tb.to_simstate(b))
    for f in ("ids", "pos", "vel", "C"):
        assert torch.equal(getattr(outs[0], f), getattr(outs[1], f)), f

