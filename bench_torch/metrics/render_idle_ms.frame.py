"""Device idle milliseconds a frame in which the host's innermost program
span is a render pass's (`mpm.render.*`: splat, dilate, blur, shade,
thickness, u8), over the window of bench_torch/spans.of."""

from bench_torch import spans

RENDER = "mpm.render."


def read(ctx):
    sp = spans.of(ctx)
    if sp is None or sp.calls <= 0 or not any(n.startswith(RENDER) for n in sp.names()):
        return None
    idle = sp.idle_by_span()
    return sum(s for n, s in idle.items() if n.startswith(RENDER)) * 1e3 / sp.calls
