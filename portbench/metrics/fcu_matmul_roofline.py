"""Percent: the yardstick's bound (work.py) of the traced passes through
the FCU's layers over the profiled device time of the port's
fcu_matmul device functions."""
from portbench import work


def read(ctx):
    return work.roofline_share(ctx, "fcu")
