"""The port's sort-based sharded step (mpm_tpu_torch.parallel.domain) and
its binned engine on fluid_3d_fixed_point (tests/test_sharded.py's small
scene: 16^3, 1,000 particles, 2 substeps a call), held bit for bit to the
JAX package's make_sharded_step on 4 forced host devices, run without fused
multiply-adds (tests/torch_jax_cases.py). JAX's sharded step equals its
binned engine bit for bit in fixed point (tests/test_sharded.py), so the
port's binned engine is held to it too.

Bar: pos, vel and ids bit for bit after 2 calls, with XLA's roundings
modelled in the port (tests/torch_xla_ref.py): the decode as a multiply by
the reciprocal of the multiplier, and in the G2P gather that multiply moved
onto the tap weight, x * (w * (1 / mult)), as XLA reassociates it in 3D.
tests/test_torch_sorted_shard_jax_float.py holds the float scene.
"""

import numpy as np
import pytest
import torch

from mpm_tpu_torch.models.scenes import fluid_3d_fixed_point
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.parallel import domain

from torch_jax_cases import run_cases
from torch_xla_ref import reassociated_gather, reciprocal_decode

torch.set_num_threads(2)

SCENE_KW = dict(grid_res=16, box=10.0, spacing=1.0)
CALLS = 2


def _scene():
    sc = fluid_3d_fixed_point(device="cpu", **SCENE_KW)
    return sc._replace(config=sc.config.replace(substeps=2))


def capacities(n):
    """tests/test_sharded.py's: the worst slab holds about half the box; a
    migration window covers a boundary plane's population."""
    return dict(local_capacity=n + 2 * 128 + 64, migration_capacity=128)


@pytest.fixture(scope="module")
def jax_sharded():
    n = _scene().state.num_particles
    return run_cases({"fixed4": dict(scene="fluid_3d_fixed_point", scene_kw=SCENE_KW,
                                     config={"substeps": 2},
                                     engine="sharded", n_shards=4, substeps=CALLS, per_call=2,
                                     **capacities(n))})["fixed4"]


def port_sharded(sc, n_slabs, calls):
    sconf = domain.ShardConfig(n_shards=n_slabs, **capacities(sc.state.num_particles))
    mesh = domain.SlabMesh.on("cpu", n_slabs)
    state = domain.shard_scene(sc, sconf, mesh)
    step = domain.make_sharded_step(sc.config, sconf, mesh, substeps=2)
    for _ in range(calls):
        state = step(state, sc.fluid)
    return domain.gather_live(state)


def port_binned(sc, calls):
    step = make_step(sc.config, mode="binned", substeps=2)
    s = sc.state
    for _ in range(calls):
        s = step(s, sc.fluid)
    return s.by_id()


@pytest.mark.parametrize("engine", ["sharded4", "sharded2", "binned"])
def test_fixed_point_bit_equal_to_jax_sharded(jax_sharded, engine):
    sc = _scene()
    with reciprocal_decode(), reassociated_gather():
        got = (port_binned(sc, CALLS) if engine == "binned"
               else port_sharded(sc, int(engine[-1]), CALLS))
    assert got.num_particles == sc.state.num_particles, "particles lost or duplicated"
    for f in ("ids", "pos", "vel"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), jax_sharded[f], err_msg=f)
