"""The host's milliseconds a frame to issue the thickness pass: the
program's `mpm.render.thickness` spans less the time the host waits in them
on the device, over the window of bench_torch/spans.of."""

from bench_torch import spans

THICKNESS = "mpm.render.thickness"


def read(ctx):
    sp = spans.of(ctx)
    if sp is None or sp.calls <= 0 or THICKNESS not in sp.names():
        return None
    return sp.host_s(THICKNESS) * 1e3 / sp.calls
