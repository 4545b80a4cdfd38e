"""Device idle time in which the host's innermost program span is the sim
driver's (YWindow.step, its poll and resize, make_step's frame of
substeps), over the window of bench_torch/spans.of, in %."""

from bench_torch import spans

DRIVER_SPANS = ("mpm.window.step", "mpm.window.poll", "mpm.window.resize", "mpm.step.frame")


def read(ctx):
    sp = spans.of(ctx)
    if sp is None or sp.window_s <= 0.0:
        return None
    idle = sp.idle_by_span()
    return 100.0 * sum(idle.get(n, 0.0) for n in DRIVER_SPANS) / sp.window_s
