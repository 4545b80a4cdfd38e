"""The dense 16^3 fluid_3d of tests/torch_wide_cases.py at K = 100 and 128:
JAX's P2G with the grid update and its G2P, which do not unroll over K,
against the port's plain halves (the plain versions of kernels P and F),
within the JAX package's bars; and a substep of mode="cuda" against
mode="bucketed" bit for bit. JAX's whole substep, whose migration unrolls
over K, is compared at K = 72 (tests/test_torch_wide_slots.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpm_tpu.ops import bucketed as jb
from mpm_tpu.ops.grid import update_grid as jupdate_grid
from mpm_tpu_torch.ops import bucketed as tb
from mpm_tpu_torch.ops.grid import update_grid
from mpm_tpu_torch.ops.step import make_step

from torch_wide_cases import FIELDS, assert_matches, dense

torch.set_num_threads(2)


@pytest.mark.parametrize("k", [100, 128])
def test_wide_halves_match_jax(k):
    cfg, fluid, b, jcfg, jfluid, jstate = dense(3, k)
    jg = jax.jit(lambda s, fl: jupdate_grid(jb.p2g_bucketed(s, jcfg, fl), jcfg, fl))(
        jstate, jfluid)
    grid = update_grid(tb.p2g_bucketed(b, cfg, fluid), cfg, fluid)
    assert float(np.abs(np.asarray(jg.mom)).max()) > 0
    np.testing.assert_allclose(np.asarray(jg.mom), grid.mom.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jg.mass), grid.mass.numpy(), rtol=1e-6, atol=1e-6)
    jgrid = jg.__class__(mom=jnp.asarray(grid.mom.numpy()), mass=jnp.asarray(grid.mass.numpy()))
    want = jax.jit(lambda s, g, fl: jb.g2p_bucketed(s, g, jcfg, fl))(jstate, jgrid, jfluid)
    assert_matches(want, tb.g2p_bucketed(b, grid, cfg, fluid))

    got = make_step(cfg, mode="cuda", substeps=1)(b, fluid)
    ref = make_step(cfg, mode="bucketed", substeps=1)(b, fluid)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
