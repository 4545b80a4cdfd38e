"""Kernel F's share of its roofline bound (no splat emission): the least
time an H100 could take for F's work (bench_torch/roofline.g2p_migrate_work
on the program's last traced state) over F's device time a launch, in %."""

from bench_torch import roofline

F_KERNELS = ("g2p_tail", "migrate_reject", "migrate_select", "migrate_gather")


def read(ctx):
    red, drv = ctx["trace"], ctx["drv"]
    launches = ctx["window"]["calls"] * drv.per_call
    t = red.device_s(*F_KERNELS) if red is not None else 0.0
    if t <= 0.0 or launches <= 0:
        return None
    state, config = drv.work_state()
    ms, _ = roofline.bound_ms(*roofline.g2p_migrate_work(state, config, emit=False))
    return 100.0 * ms * 1e-3 * launches / t
