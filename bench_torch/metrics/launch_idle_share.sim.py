"""Device idle time in which the host's innermost program span is a kernel
wrapper's (P's or F's whole host path: checks, allocations, launch), over
the window of bench_torch/spans.of, in %."""

from bench_torch import spans

KERNEL_SPANS = ("mpm.kernel.p2g", "mpm.kernel.g2p")


def read(ctx):
    sp = spans.of(ctx)
    if sp is None or sp.window_s <= 0.0:
        return None
    idle = sp.idle_by_span()
    return 100.0 * sum(idle.get(n, 0.0) for n in KERNEL_SPANS) / sp.window_s
