"""The host's milliseconds to issue a frame: the program's `mpm.frame` spans
(make_full_frame_step's frame, substeps to u8) less the time the host waits
in them on the device (its synchronises and blocking copies), over the
window of bench_torch/spans.of, a frame."""

from bench_torch import spans


def read(ctx):
    sp = spans.of(ctx)
    if sp is None or sp.calls <= 0 or "mpm.frame" not in sp.names():
        return None
    return sp.host_s("mpm.frame") * 1e3 / sp.calls
