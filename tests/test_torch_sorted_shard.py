"""The port's sort-based sharded step (mpm_tpu_torch.parallel.domain:
ShardConfig, shard_scene, make_sharded_step, gather_live,
demo_sharded_step) on CPU slabs of a SlabMesh, held to the port's binned
engine as tests/test_sharded.py:29-80 holds the JAX one: 2 and 4 slabs,
ids equal and pos within 2e-3; fixed point bit-exact (pos and vel); the
JAX package's demo. And the halo exchanges' primitives against their
definitions.
"""

import numpy as np
import pytest
import torch

from mpm_tpu_torch.core.state import Grid
from mpm_tpu_torch.models.scenes import fluid_3d, fluid_3d_fixed_point
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.parallel import domain

torch.set_num_threads(2)


def _small_scene(fixed=False):
    f = fluid_3d_fixed_point if fixed else fluid_3d
    sc = f(grid_res=16, box=10.0, spacing=1.0, device="cpu")
    return sc._replace(config=sc.config.replace(substeps=2))


def _run(sc, n_slabs, frames):
    n = sc.state.num_particles
    sconf = domain.ShardConfig(n_shards=n_slabs, local_capacity=n + 2 * 128 + 64,
                               migration_capacity=128)
    mesh = domain.SlabMesh.on("cpu", n_slabs)
    state = domain.shard_scene(sc, sconf, mesh)
    step = domain.make_sharded_step(sc.config, sconf, mesh, substeps=2)
    ref = make_step(sc.config, mode="binned", substeps=2)
    s_ref = sc.state
    for _ in range(frames):
        state = step(state, sc.fluid)
        s_ref = ref(s_ref, sc.fluid)
    return domain.gather_live(state), s_ref.by_id()


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_sharded_matches_unsharded(n_slabs):
    sc = _small_scene()
    live, want = _run(sc, n_slabs, 3)
    assert live.num_particles == sc.state.num_particles, "particles lost or duplicated"
    assert torch.equal(live.ids, want.ids)
    np.testing.assert_allclose(live.pos.numpy(), want.pos.numpy(), rtol=0, atol=2e-3)


def test_sharded_fixed_point_bit_exact():
    """Integer grid sums commute, so 4 slabs equal the unsharded sorted
    engine bit for bit."""
    live, want = _run(_small_scene(fixed=True), 4, 2)
    assert torch.equal(live.ids, want.ids)
    assert torch.equal(live.pos, want.pos) and torch.equal(live.vel, want.vel)


def test_dryrun_entrypoint():
    domain.demo_sharded_step(4, device="cpu")


def test_shard_scene_parks_dead_slots_inside_their_slab():
    """Each slab holds the particles of its planes first, then dead slots
    (mass 0, ids -1) parked at its centre; capacity overflow raises."""
    sc = _small_scene()
    n = sc.state.num_particles
    sconf = domain.ShardConfig(n_shards=4, local_capacity=n, migration_capacity=8)
    state = domain.shard_scene(sc, sconf, domain.SlabMesh.on("cpu", 4))
    assert sum(int((s.mass > 0).sum()) for s in state.slabs) == n
    for a, s in enumerate(state.slabs):
        live = s.mass > 0
        assert bool((torch.floor(s.pos[0, live]) // 4 == a).all())
        assert bool((s.pos[0, ~live] == a * 4 + 2.0).all()) and bool((s.ids[~live] == -1).all())
    with pytest.raises(ValueError, match="exceed capacity"):
        domain.shard_scene(sc, domain.ShardConfig(n_shards=2, local_capacity=64,
                                                  migration_capacity=8),
                           domain.SlabMesh.on("cpu", 2))


def test_halo_reduce_and_fill():
    """Three slabs of 2 planes (+1 halo a side), 4 cells a plane: the
    reduce adds a neighbour's halo plane into the edge plane it covers,
    the fill copies the neighbour's edge plane into the halo, zero past
    the global ends; the mass-less reduce leaves mass alone."""
    loc, pc = 2, 4
    grids = [Grid(mom=torch.arange(2 * (loc + 2) * pc, dtype=torch.float32).reshape(2, -1)
                  + 100 * a, mass=torch.arange((loc + 2) * pc, dtype=torch.float32) + 100 * a)
             for a in range(3)]

    def plane(x, p):
        return x[..., p * pc:(p + 1) * pc]

    red = domain._halo_reduce(grids, loc, pc)
    assert torch.equal(plane(red[1].mass, 1), plane(grids[1].mass, 1)
                       + plane(grids[0].mass, loc + 1))
    assert torch.equal(plane(red[1].mom, loc), plane(grids[1].mom, loc) + plane(grids[2].mom, 0))
    assert torch.equal(plane(red[0].mass, 1), plane(grids[0].mass, 1))  # no left neighbour
    assert torch.equal(domain._halo_reduce(grids, loc, pc, mom_only=True)[1].mass,
                       grids[1].mass)
    fill = domain._halo_fill(red, loc, pc, mom_too=False)
    assert torch.equal(plane(fill[1].mass, 0), plane(red[0].mass, loc))
    assert torch.equal(plane(fill[1].mass, loc + 1), plane(red[2].mass, 1))
    assert not plane(fill[1].mom, 0).any() and not plane(fill[2].mass, loc + 1).any()
    full = domain._halo_fill(red, loc, pc, mom_too=True)
    assert torch.equal(plane(full[1].mom, loc + 1), plane(red[2].mom, 1))
