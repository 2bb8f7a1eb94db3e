"""Percent: the yardstick's bound (work.py) of the traced passes through
the DW's layers over the profiled device time of the port's
dw_conv device functions."""
from portbench import work


def read(ctx):
    return work.roofline_share(ctx, "dw")
