"""The dense scenes of the wide-slot tests (tests/test_torch_wide_slots*.py):
a 16^3 fluid_3d at spacing 0.24 (64 to 125 particles a fluid cell) and a
32^2 dam_break_2d at spacing 0.12 (64 to 81 a cell), so that the fullest
cell holds more than 64 particles. Both take a rest density near their
packing (80 and 70 particles a cell), so that their pressure stays near the
floor and a substep moves particles by a fraction of a cell, as the sparse
scenes' do. Each scene is packed by the port and handed to JAX as the same
arrays.

Bars: the JAX package's (tests/test_fused.py): ids equal, float32 pos
within 1e-6, vel and C within 1e-5, counters equal."""

import functools

import jax.numpy as jnp
import numpy as np

from mpm_tpu.core.params import FluidParams as JFluid
from mpm_tpu.core.params import SimConfig as JConfig
from mpm_tpu.models.scenes import dam_break_2d as jdam_break_2d
from mpm_tpu.models.scenes import fluid_3d as jfluid_3d
from mpm_tpu.ops import bucketed as jb
from mpm_tpu.ops.pallas import fused as jfused
from mpm_tpu.ops.pallas import kernels2d as jk2d
from mpm_tpu_torch.utils import wide_k

FIELDS = ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred", "ceiling")


@functools.lru_cache(maxsize=None)
def dense(dim: int, k: int):
    """(port config, port fluid, port state, JAX config, JAX fluid, JAX
    state): the dense scene (utils/wide_k.dense_kwargs: 16^3, or 32^2 in
    2D) packed by the port, the same arrays in JAX."""
    grid = 16 if dim == 3 else 32
    cfg, fluid, b = wide_k.dense_scene(dim, k, "cpu", grid=grid, warm=0)
    scene_kw, fluid_kw = wide_k.dense_kwargs(dim, k, grid)
    j = (jfluid_3d if dim == 3 else jdam_break_2d)(**scene_kw)
    jstate = jb.BucketState(**{f: jnp.asarray(getattr(b, f).numpy()) for f in FIELDS})
    return cfg, fluid, b, j.config.replace(bin_capacity=k), JFluid.create(**fluid_kw), jstate


def assert_matches(jstate, tstate):
    np.testing.assert_array_equal(np.asarray(jstate.ids), tstate.ids.numpy())
    np.testing.assert_allclose(np.asarray(jstate.pos), tstate.pos.numpy(), atol=1e-6)
    for f in ("vel", "C"):
        np.testing.assert_allclose(np.asarray(getattr(jstate, f)), getattr(tstate, f).numpy(),
                                   atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jstate.mass), tstate.mass.numpy())
    for f in FIELDS[5:]:
        assert int(getattr(jstate, f)) == int(getattr(tstate, f)), f


def jax_route(cfg: JConfig) -> str:
    """The JAX package's mode="pallas" route (fused.substep_fused)."""
    if cfg.dim == 2:
        return "kernel" if jk2d.supported2d(cfg, cfg.bin_capacity) else "plain"
    return "kernel" if jfused.fused_supported(cfg, cfg.bin_capacity) else "plain"
