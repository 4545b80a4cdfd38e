"""Kernel P's share of its roofline bound: the least time an H100 could
take for P's work (bench_torch/roofline.p2g_update_work on the program's
last traced state) over P's device time a launch in the trace, in %."""

from bench_torch import roofline

P_KERNELS = ("p2g_mass_tile", "p2g_coef", "p2g_force_tile")


def read(ctx):
    red, drv = ctx["trace"], ctx["drv"]
    launches = ctx["window"]["calls"] * drv.per_call
    t = red.device_s(*P_KERNELS) if red is not None else 0.0
    if t <= 0.0 or launches <= 0:
        return None
    state, config = drv.work_state()
    ms, _ = roofline.bound_ms(*roofline.p2g_update_work(state, config))
    return 100.0 * ms * 1e-3 * launches / t
