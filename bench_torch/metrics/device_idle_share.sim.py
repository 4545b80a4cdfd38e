"""1 - (the union of device activity / the traced window), in %."""


def read(ctx):
    red = ctx["trace"]
    if red is None or red.window_s <= 0.0 or red.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - red.busy_s / red.window_s)
