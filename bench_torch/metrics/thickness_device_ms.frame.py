"""Device milliseconds a frame of the work launched inside the program's
`mpm.render.thickness` spans (splat.thickness_deposit and
ssfr.thickness_map: the deposit, the Gaussian and the map), over the window
of bench_torch/spans.of."""

from bench_torch import spans

THICKNESS = "mpm.render.thickness"


def read(ctx):
    sp = spans.of(ctx)
    if sp is None or sp.calls <= 0 or THICKNESS not in sp.names():
        return None
    return sp.device_s_under(THICKNESS) * 1e3 / sp.calls
