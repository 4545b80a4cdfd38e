"""The idlest card's idle share: the largest over the mesh's cards of 1 -
that card's own union of device activity / the traced window, in %, over
the window of bench_torch/shard_trace.of."""

from bench_torch import shard_trace


def read(ctx):
    _, cards = shard_trace.of(ctx)
    if cards is None or cards.window_s <= 0.0:
        return None
    return 100.0 * max(cards.idle_share(d.index) for d in ctx["drv"].cards())
