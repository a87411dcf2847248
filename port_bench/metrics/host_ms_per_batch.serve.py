"""Mean host-clock milliseconds spent inside the serving entry per batch,
over the measured (untraced) window: from handing the batch to the entry to
its return, the input copy's wait included."""


def read(ctx):
    return sum(ctx.host_ms) / len(ctx.host_ms) if ctx.host_ms else None
