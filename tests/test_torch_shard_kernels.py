"""The two sharded stages of kernel P (mpm_tpu_torch/ops/cuda/p2g_shard.py),
their plain versions on the CPU, against the JAX package's Pallas shard
kernels (p2g1_shard_pallas, p2g2u_shard_pallas) in interpret mode, on one
padded slab of the 16^3 scene of tests/test_sharded.py (K=8).

Bars, on grid planes [2, L-1] (the exact ones): float32 within 1e-6 of the
largest value. A fixed-point grid encodes each slot's contribution, and the
JAX kernels multiply the tap weights in another order and encode the
pass-1 momentum and the force of a slot as one sum, so an encoding may
differ by a unit: the int32 mass within one unit per contribution (27 K),
the velocity within twice that bound on the momentum (two encodings) over
the node's mass, plus 2 units. Within the port the stages equal unsharded
kernel P's plain version bit for bit (tests/test_torch_sharded.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpm_tpu.models.scenes import fluid_3d as jfluid_3d
from mpm_tpu.ops import bucketed as jb
from mpm_tpu.ops.pallas.p2g_fused import p2g1_shard_pallas, p2g2u_shard_pallas
from mpm_tpu_torch.core.state import Grid
from mpm_tpu_torch.models.scenes import fluid_3d
from mpm_tpu_torch.ops import bucketed as tb
from mpm_tpu_torch.ops.cuda import p2g_shard as ks
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.parallel import domain

torch.set_num_threads(2)

FIELDS = ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred", "ceiling")


@pytest.mark.parametrize("storage", ["f32", "fixed"])
def test_shard_stages_match_jax_shard_kernels(storage):
    """p2g1_shard and p2g2u_shard (plain) on one padded slab (the second of
    4: 8 planes from global plane 2) of the scene after 3 substeps, against
    p2g1_shard_pallas and p2g2u_shard_pallas fed the same slab and the same
    exchanged grid mass."""
    j = jfluid_3d(grid_res=16, box=8.0, spacing=0.8)
    t = fluid_3d(grid_res=16, box=8.0, spacing=0.8, device="cpu")
    kw = {"fixed_point": True} if storage == "fixed" else {}
    jcfg = j.config.replace(bin_capacity=8, **kw)
    tcfg = t.config.replace(bin_capacity=8, **kw)
    fluid = t.fluid
    s = make_step(tcfg, mode="bucketed", substeps=3)(tb.from_simstate(t.state, tcfg), fluid)
    n, loc, pc, k = 4, 4, 256, 8
    L, a, h = loc + 4, 1, 17  # the JAX kernels pad each plane by h = nz + 1
    x0 = a * loc - 2
    cfg = tb.slab_config(tcfg, L)
    padded = domain._exchange_state_halo(
        domain.shard_bucket_state(s, tcfg, domain.SlabMesh.on("cpu", n)).slabs, pc)
    g1 = [ks.p2g1_shard(p, cfg, fluid, i * loc - 2) for i, p in enumerate(padded)]
    gmass = domain._exchange_grid([g.mass for g in g1], loc, pc)[a]
    gvel = ks.p2g2u_shard(padded[a], Grid(mom=g1[a].mom, mass=gmass), cfg, fluid, x0)
    assert ks.p2g1_launches == ks.p2g2u_launches == 0  # CPU tensors: plain versions

    jst = jb.BucketState(*(jnp.asarray(getattr(padded[a], f).numpy()) for f in FIELDS))
    jm = np.asarray(p2g1_shard_pallas(jst, j.fluid, jcfg, jnp.float32(x0), interpret=True))
    gm_j = np.zeros((L + 2, pc + 2 * h), jm.dtype)
    gm_j[:, h:h + pc] = gmass.reshape(L + 2, pc).numpy()
    jv = np.asarray(p2g2u_shard_pallas(jst, jnp.asarray(gm_j), j.fluid, jcfg, jnp.float32(x0),
                                       interpret=True))
    exact = slice(2, L)
    want_m = jm[exact, h:h + pc].astype(np.float64)
    want_v = jv[exact, :, h:h + pc].astype(np.float64)
    got_m = g1[a].mass.reshape(L + 2, pc)[exact].numpy().astype(np.float64)
    got_v = gvel.reshape(3, L + 2, pc).permute(1, 0, 2)[exact].numpy().astype(np.float64)
    assert want_m.max() > 0 and np.abs(want_v).max() > 0
    if storage == "f32":
        np.testing.assert_allclose(got_m, want_m, rtol=0, atol=1e-6 * np.abs(want_m).max())
        np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-6 * np.abs(want_v).max())
    else:
        assert gvel.dtype == torch.int32
        assert np.abs(got_m - want_m).max() <= 27 * k
        mass = got_m / tcfg.fixed_point_mult
        bound = 2 * 27 * k / np.where(mass > 0, mass, np.inf) + 2  # units
        assert (np.abs(got_v - want_v) <= bound[:, None, :]).all()
