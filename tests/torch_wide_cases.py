"""The dense scenes of the wide-slot tests (tests/test_torch_wide_slots*.py
and the card tests): a 16^3 fluid_3d at spacing 0.24 (64 to 125 particles
a fluid cell; K = 200 at spacing 0.19, 125 to 216) and a 32^2 dam_break_2d
at spacing 0.12 (64 to 81 a cell), so that the fullest cell holds more
than 64 particles. Each takes a rest density near its packing (80, 170
and 70 particles a cell), so that its pressure stays near the floor and a
substep moves particles by a fraction of a cell, as the sparse scenes'
do. Each scene is packed by the port and handed to JAX as the same arrays.
JAX is imported only by the functions that compare with it, so the card
tests, which import no JAX, take `dense_scene` from here.

Bars: the JAX package's (tests/test_fused.py): ids equal, float32 pos
within 1e-6, vel and C within 1e-5, counters equal."""

import functools

import numpy as np

from mpm_tpu_torch.core.params import FluidParams
from mpm_tpu_torch.models.scenes import dam_break_2d, fluid_3d
from mpm_tpu_torch.ops import bucketed

FIELDS = ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred", "ceiling")

# the dense scenes' (spacing, rest density): 3D below K = 200 and at 200, 3D
# of at most 64 a cell ("fit"), 2D
DENSE_3D = {"default": (0.24, 80.0), 200: (0.19, 170.0), "fit": (0.3, 40.0)}
DENSE_2D = (0.12, 70.0)


def dense_kwargs(dim: int, k: int, grid: int, fit: bool = False) -> tuple[dict, dict]:
    """(scene kwargs, FluidParams.create kwargs) of the dense scene of `dim`
    axes at K = k on a `grid`-wide grid: 3D fluid_3d, a box half the grid
    wide (`fit`: at most 64 particles a cell, the same at every K); 2D
    dam_break_2d, a box a quarter of it; each scene's own fluid but for the
    rest density."""
    if dim == 3:
        spacing, rho = DENSE_3D["fit"] if fit else DENSE_3D.get(k, DENSE_3D["default"])
        return (dict(grid_res=grid, box=grid / 2, spacing=spacing),
                dict(dim=3, eos_stiffness=1.0, eos_power=7.0, rest_density=rho))
    spacing, rho = DENSE_2D
    return (dict(grid_res=grid, box=grid / 4, spacing=spacing),
            dict(dim=2, dt=0.2, gravity=(0.0, 0.3), eos_stiffness=10.0, eos_power=7.0,
                 rest_density=rho))


def dense_scene(dim: int, k: int, dev, grid: int, warm: int = 2, fit: bool = False):
    """(config, fluid, state): the dense scene (dense_kwargs) on `dev`,
    packed at K = k, after `warm` plain substeps."""
    scene_kw, fluid_kw = dense_kwargs(dim, k, grid, fit)
    sc = (fluid_3d if dim == 3 else dam_break_2d)(device=dev, **scene_kw)
    fluid = FluidParams.create(**fluid_kw)
    config = sc.config.replace(bin_capacity=k)
    state = bucketed.from_simstate(sc.state, config)
    for _ in range(warm):
        state = bucketed.substep(state, config, fluid)
    return config, fluid, state


@functools.lru_cache(maxsize=None)
def dense(dim: int, k: int):
    """(port config, port fluid, port state, JAX config, JAX fluid, JAX
    state): the dense scene (16^3, or 32^2 in 2D) packed by the port, the
    same arrays in JAX."""
    import jax.numpy as jnp

    from mpm_tpu.core.params import FluidParams as JFluid
    from mpm_tpu.models.scenes import dam_break_2d as jdam_break_2d
    from mpm_tpu.models.scenes import fluid_3d as jfluid_3d
    from mpm_tpu.ops import bucketed as jb

    grid = 16 if dim == 3 else 32
    cfg, fluid, b = dense_scene(dim, k, "cpu", grid=grid, warm=0)
    scene_kw, fluid_kw = dense_kwargs(dim, k, grid)
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


def jax_route(cfg) -> str:
    """The JAX package's mode="pallas" route (fused.substep_fused)."""
    from mpm_tpu.ops.pallas import fused as jfused
    from mpm_tpu.ops.pallas import kernels2d as jk2d

    if cfg.dim == 2:
        return "kernel" if jk2d.supported2d(cfg, cfg.bin_capacity) else "plain"
    return "kernel" if jfused.fused_supported(cfg, cfg.bin_capacity) else "plain"
