"""Device milliseconds a frame of everything but the substep kernels P and
F (F's splat emission counted with F): the render chain, the tonemap, the
copy to the host and the glue between them."""

SUBSTEP_KERNELS = ("p2g_mass_tile", "p2g_coef", "p2g_force_tile", "g2p_tail", "migrate_reject",
                   "migrate_select", "migrate_gather", "extract_cells_kernel")


def read(ctx):
    red = ctx["trace"]
    frames = ctx["window"]["calls"]
    if red is None or frames <= 0:
        return None
    t = red.device_s(exclude=SUBSTEP_KERNELS)
    return t / frames * 1e3 if t > 0.0 else None
