"""Device milliseconds a substep of the work launched in the slab exchanges
(the spans `mpm.shard.halo` and `mpm.shard.grid`: the copies between slabs
and the concatenations around them), summed over the cards, over the window
of bench_torch/shard_trace.of."""

from bench_torch import shard_trace

EXCHANGE_SPANS = ("mpm.shard.halo", "mpm.shard.grid")


def read(ctx):
    sp, _ = shard_trace.of(ctx)
    substeps = ctx["window"]["calls"] * ctx["drv"].per_call
    if sp is None or substeps <= 0 or not set(EXCHANGE_SPANS) & sp.names():
        return None
    return sp.device_s_under(*EXCHANGE_SPANS) * 1e3 / substeps
