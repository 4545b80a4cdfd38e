"""Kernel F's shard mode's share of its roofline bound: the least time an
H100 could take for every slab's F of a substep (bench_torch/roofline_shard
on the program's last traced state) over F's device time a substep in the
trace, summed over the cards, in %. The cell runs F in shard mode alone."""

from bench_torch import roofline_shard

F_KERNELS = ("g2p_tail", "migrate_reject", "migrate_select", "migrate_gather")


def read(ctx):
    red, drv = ctx["trace"], ctx["drv"]
    substeps = ctx["window"]["calls"] * drv.per_call
    t = red.device_s(*F_KERNELS) if red is not None else 0.0
    if t <= 0.0 or substeps <= 0:
        return None
    bound = roofline_shard.bound_s(*drv.work_slabs(), roofline_shard.g2p_shard_work)
    return 100.0 * bound * substeps / t
