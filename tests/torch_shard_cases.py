"""Shared cases of the sharded-step tests (tests/test_torch_sharded.py and
tests/test_torch_sharded_fixed.py, two files so that each stays short on
one test worker): the 16^3 scene of tests/test_sharded.py (K=8) in both
packages, its references, and the bars.

Bars. Against the JAX XLA engine (mpm_tpu.ops.bucketed.substep), 3
substeps, bit for bit, counters included: the JAX half runs without fused
multiply-adds in a subprocess, and the fixed-point port decodes by the
reciprocal as XLA's jit does (tests/torch_xla_ref.py says why). Within the
port the sharded step equals the unsharded one bit for bit, counters
included, with the port's own IEEE decode."""

import dataclasses
import functools

import numpy as np
import torch

from mpm_tpu.models.scenes import fluid_3d as jfluid_3d
from mpm_tpu_torch.core.state import make_state
from mpm_tpu_torch.models.scenes import fluid_3d
from mpm_tpu_torch.ops import bucketed as tb
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.parallel import domain
from torch_xla_ref import (FIELDS, STORAGE, assert_equal_to_xla, folded_tops, reciprocal_decode,
                           state_arrays, xla_substeps)



@functools.lru_cache(maxsize=None)
def scenes():
    """(jax scene, port scene, port fluid with gravity -10). Gravity -10
    crowds cells at the slab boundaries, so that the deferred and CFL
    counters and their plane gate are exercised; at the scene's gravity
    both stay 0."""
    j = jfluid_3d(grid_res=16, box=8.0, spacing=0.8)
    t = fluid_3d(grid_res=16, box=8.0, spacing=0.8, device="cpu")
    heavy = dataclasses.replace(t.fluid, gravity=torch.tensor([0.0, -10.0, 0.0]))
    return j, t, heavy


def configs(storage):
    j, t, _ = scenes()
    kw = STORAGE[storage]
    return j.config.replace(bin_capacity=8, **kw), t.config.replace(bin_capacity=8, **kw)


def full_state(config) -> tb.BucketState:
    """K particles at seeded random places in every interior cell of the
    scene's grid (the edge planes stay empty, as the clamps keep them), with
    seeded random velocities: every slot of those cells occupied, the most
    a cell holds (P2G's partials take K slots each; the migration defers
    every move into a full cell)."""
    rng = np.random.default_rng(7)
    k, res = config.bin_capacity, np.array(config.grid_res)
    cells = np.stack(np.meshgrid(*(np.arange(1, n - 1) for n in res), indexing="ij"),
                     -1).reshape(-1, 3)
    pos = np.repeat(cells, k, axis=0) + rng.uniform(0.0, 1.0, (len(cells) * k, 3))
    vel = rng.normal(0.0, 2.0, pos.shape)
    st = tb.from_simstate(make_state(pos.astype(np.float32), "cpu",
                                     vel=vel.astype(np.float32)), config)
    assert bool((st.mass.reshape(k, *res)[:, 1:-1, 1:-1, 1:-1] > 0).all())
    return st


@functools.lru_cache(maxsize=None)
def initial(storage) -> tb.BucketState:
    if storage == "full":
        return full_state(configs(storage)[1])
    return tb.from_simstate(scenes()[1].state, configs(storage)[1])


@functools.lru_cache(maxsize=None)
def references(storage, heavy: bool):
    """(3 substeps of the port's unsharded plain engine, and at the scene's
    gravity 3 substeps of the JAX XLA engine as numpy arrays by field)."""
    _, tcfg = configs(storage)
    _, t, g10 = scenes()
    step = make_step(tcfg, mode="bucketed", substeps=3)
    ref = step(initial(storage), g10 if heavy else t.fluid)
    if heavy:
        return ref, None
    # the port's packing equals the JAX package's slot for slot
    # (tests/test_torch_bucketed.py), so JAX starts from the same arrays
    return ref, xla_substeps({storage: state_arrays(initial(storage))}, 3)[storage]


def sharded(storage, n_slabs, heavy: bool) -> tb.BucketState:
    """3 sharded substeps on n_slabs CPU slabs, gathered."""
    _, tcfg = configs(storage)
    mesh = domain.SlabMesh.on("cpu", n_slabs)
    fluid = scenes()[2] if heavy else scenes()[1].fluid
    out = domain.make_sharded_bucket_step(tcfg, mesh, substeps=3)(
        domain.shard_bucket_state(initial(storage), tcfg, mesh), fluid)
    assert len(out.slabs) == n_slabs
    return domain.gather_bucket_state(out)


def assert_bit_equal(got, want):
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def check_matrix_case(storage, n_slabs):
    """The sharded step at the scene's gravity: bit for bit the port's
    unsharded engine, and bit for bit the JAX XLA engine."""
    ref, want = references(storage, False)
    got = sharded(storage, n_slabs, False)
    assert_bit_equal(got, ref)
    if storage in ("fixed", "full"):  # the port's engine with XLA's decode or clamp tops
        _, tcfg = configs(storage)
        with reciprocal_decode() if storage == "fixed" else folded_tops():
            got = make_step(tcfg, mode="bucketed", substeps=3)(initial(storage), scenes()[1].fluid)
    assert_equal_to_xla(got, want)


def check_counts_case(storage):
    """Gravity -10 on 8 slabs of 2 planes: bit for bit the unsharded engine,
    with deferred moves and CFL clamps counted once across the slabs."""
    got = sharded(storage, 8, True)
    assert_bit_equal(got, references(storage, True)[0])
    assert int(got.deferred) > 0 and int(got.cfl_clamped) > 0 and int(got.lost) == 0
