"""Mean host-clock milliseconds spent inside the train step's call per
step, over the measured (untraced) window."""


def read(ctx):
    return sum(ctx.host_ms) / len(ctx.host_ms) if ctx.host_ms else None
