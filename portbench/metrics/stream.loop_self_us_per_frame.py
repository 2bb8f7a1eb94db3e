"""Host us a frame in the stream engine's event loop itself: the
profiled ``stream.loop`` spans less the ``exec`` spans (the stages'
dispatch) inside them, over the frames the traced sub-window served.
None where the program emits no ``stream.loop`` span."""


def read(ctx):
    if ctx.trace is None:
        return None
    loops = [(s, e) for name, s, e in ctx.trace.host if name == "stream.loop"]
    if not loops:
        return None
    dispatch = sum(e - s for name, s, e in ctx.trace.host
                   if name == "exec" and any(a <= s and e <= b for a, b in loops))
    return (sum(e - s for s, e in loops) - dispatch) * 1e6 / ctx.trace.frames
