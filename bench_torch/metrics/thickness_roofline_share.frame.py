"""The thickness pass's share of its roofline bound, in %: the least time
an H100 could take for the pass (bench_torch/roofline_thickness on the
frame's splat points, one a cell of the frame's grid, and its crop) over
the device time a frame launched inside the `mpm.render.thickness` spans
(bench_torch/spans.of)."""

from bench_torch import roofline, roofline_thickness, spans

THICKNESS = "mpm.render.thickness"


def read(ctx):
    sp, drv = spans.of(ctx), ctx["drv"]
    if sp is None or sp.calls <= 0 or THICKNESS not in sp.names():
        return None
    ms = sp.device_s_under(THICKNESS) * 1e3 / sp.calls
    if ms <= 0.0:
        return None
    _, _, ch, cw = drv.rc.crop or (0, 0, drv.rc.camera.height, drv.rc.camera.width)
    work = roofline_thickness.thickness_work(drv.frame_cfg.num_cells, ch, cw,
                                             drv.rc.ssfr.thickness_blur_radius)
    return 100.0 * roofline.bound_ms(*work)[0] / ms
