"""Kernel P's two shard stages' share of their roofline bound: the least
time an H100 could take for every slab's stage 1 and stage 2 of a substep
(bench_torch/roofline_shard on the program's last traced state) over the
stages' device time a substep in the trace, summed over the cards, in %.
The cell runs no whole-grid P, so P's kernel names are the stages'."""

from bench_torch import roofline_shard

P_KERNELS = ("p2g_mass_tile", "p2g_coef", "p2g_force_tile")


def read(ctx):
    red, drv = ctx["trace"], ctx["drv"]
    substeps = ctx["window"]["calls"] * drv.per_call
    t = red.device_s(*P_KERNELS) if red is not None else 0.0
    if t <= 0.0 or substeps <= 0:
        return None
    bound = roofline_shard.bound_s(*drv.work_slabs(), roofline_shard.p2g1_shard_work,
                                   roofline_shard.p2g2u_shard_work)
    return 100.0 * bound * substeps / t
