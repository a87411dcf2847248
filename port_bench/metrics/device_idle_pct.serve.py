"""Share of the traced serving window in which nothing ran on the device
(no kernel, copy or memset: the union of their intervals), in %."""


def read(ctx):
    s = ctx.summary
    if not s.device or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s() / s.window_s)
