"""The host's milliseconds a substep in the span `mpm.shard.substep`, less
its waits on a device (spans.Spans.host_s): the one thread's time to issue
the work of every slab's substep, over the window of
bench_torch/shard_trace.of."""

from bench_torch import shard_trace

SUBSTEP_SPAN = "mpm.shard.substep"


def read(ctx):
    sp, _ = shard_trace.of(ctx)
    substeps = ctx["window"]["calls"] * ctx["drv"].per_call
    if sp is None or substeps <= 0 or SUBSTEP_SPAN not in sp.names():
        return None
    return sp.host_s(SUBSTEP_SPAN) * 1e3 / substeps
