"""Device kernels, copies and sets in the traced window, a frame."""


def read(ctx):
    red = ctx["trace"]
    frames = ctx["window"]["calls"]
    if red is None or frames <= 0 or red.count() == 0:
        return None
    return red.count() / frames
