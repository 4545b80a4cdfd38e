"""Device milliseconds a frame of the work launched inside the program's
`mpm.render.dilate` span (the sphere dilation of the z-buffer), over the
window of bench_torch/spans.of."""

from bench_torch import spans

DILATE = "mpm.render.dilate"


def read(ctx):
    sp = spans.of(ctx)
    if sp is None or sp.calls <= 0 or DILATE not in sp.names():
        return None
    return sp.device_s_under(DILATE) * 1e3 / sp.calls
