"""The port's x-slab decomposition on the CPU, continued from
tests/test_torch_sharded.py: the sharded step on 2, 4 and 8 slabs with an
int32 fixed-point grid against the JAX XLA engine and, bit for bit, the
port's unsharded engine; the counters' plane gate under gravity -10 in
every storage; kernel F's shard mode (its plain version) on single slabs.
tests/torch_shard_cases.py states the bars."""

import pytest
import torch

from mpm_tpu_torch.core.state import Grid
from mpm_tpu_torch.ops import bucketed as tb
from mpm_tpu_torch.ops.cuda import g2p_migrate as kf
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.parallel import domain
from torch_shard_cases import check_counts_case, check_matrix_case, configs, initial, scenes

torch.set_num_threads(2)


@pytest.mark.parametrize("n_slabs", [2, 4, 8])
def test_sharded_fixed_step_matches_jax_and_unsharded(n_slabs):
    check_matrix_case("fixed", n_slabs)


@pytest.mark.parametrize("storage", ["f32", "bf16", "fixed"])
def test_sharded_step_counts_like_unsharded(storage):
    check_counts_case(storage)


def test_kernel_f_shard_mode_plain_counts_own_planes():
    """Kernel F's shard mode on one padded slab: its own planes equal the
    unsharded kernel F's planes, and the counters count them only."""
    _, tcfg = configs("f32")
    fluid = scenes()[2]
    s = make_step(tcfg, mode="bucketed", substeps=2)(initial("f32"), fluid)
    grid = tb.update_grid(tb.p2g_bucketed(s, tcfg, fluid), tcfg, fluid)
    zero = {f: torch.zeros((), dtype=torch.int32) for f in ("lost", "cfl_clamped", "deferred",
                                                             "ceiling")}
    s = s.replace(**zero)
    whole = kf.g2p_migrate(s, grid, tcfg, fluid)
    n, loc, pc = 4, 4, 256
    mesh = domain.SlabMesh.on("cpu", n)
    padded = domain._exchange_state_halo(domain.shard_bucket_state(s, tcfg, mesh).slabs, pc)
    cfg = tb.slab_config(tcfg, loc + 4)
    total = dict.fromkeys(zero, 0)
    for a, p in enumerate(padded):
        x0 = a * loc - 2
        gv = grid.mom.reshape(3, 16, pc)
        lo, hi = max(x0 - 1, 0), min(x0 + loc + 5, 16)
        g = torch.zeros((3, loc + 6, pc))
        g[:, lo - (x0 - 1):hi - (x0 - 1)] = gv[:, lo:hi]
        out = kf.g2p_migrate(p, Grid(mom=g.reshape(3, -1), mass=None), cfg, fluid,
                             slab=tb.Slab(x0=x0, go=1, c_lo=2, c_hi=loc + 1))
        own = slice(2 * pc, (loc + 2) * pc)
        cells = slice(a * loc * pc, (a + 1) * loc * pc)
        for f in ("pos", "vel", "C", "mass", "ids"):
            assert torch.equal(getattr(out, f)[..., own], getattr(whole, f)[..., cells]), f
        for f in total:
            total[f] += int(getattr(out, f))
    assert kf.launches == 0
    for f in total:
        assert total[f] == int(getattr(whole, f)), f
    assert total["deferred"] > 0 and total["cfl_clamped"] > 0
