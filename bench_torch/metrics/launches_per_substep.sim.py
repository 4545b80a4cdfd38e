"""Device kernels, copies and sets in the traced window, a substep."""


def read(ctx):
    red = ctx["trace"]
    substeps = ctx["window"]["calls"] * ctx["drv"].per_call
    if red is None or substeps <= 0 or red.count() == 0:
        return None
    return red.count() / substeps
