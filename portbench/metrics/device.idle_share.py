"""Percent of the traced sub-window in which no operation ran on the
device (the union of the profiled device intervals)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
