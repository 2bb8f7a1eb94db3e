"""Profiled device ms of every operation that is none of the port's
kernels (bias, activations, pads, pools, joins, copies, fills), per frame
of the traced sub-window."""
from portbench import work


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    names = [n for parts in work.KERNEL_NAMES.values() for n in parts]
    return ctx.trace.device_s(exclude=names) * 1e3 / ctx.trace.frames
