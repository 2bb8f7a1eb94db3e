"""The 95th percentile, over every request of the window, of the time
from the call into the program to the synchronize on its output."""
import statistics


def read(ctx):
    ms = [(t2 - t0) * 1e3 for t0, _, t2 in ctx.records]
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
