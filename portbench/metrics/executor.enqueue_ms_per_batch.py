"""Host ms for the call into the program to return, before the
synchronize, averaged over every request of the traced run's window (the
profiler off: its own recording on the host would be counted)."""


def read(ctx):
    return sum(t1 - t0 for t0, t1, _ in ctx.records) * 1e3 / len(ctx.records)
