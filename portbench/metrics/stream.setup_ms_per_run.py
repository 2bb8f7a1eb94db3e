"""Host ms of a stream run's set-up (the plan's lookup, the engine's
build, the frames' submission): the profiled ``stream.setup`` spans
over the number of ``stream.serve`` spans in the traced sub-window.
None where the program emits no ``stream.serve`` span."""


def read(ctx):
    if ctx.trace is None:
        return None
    runs = sum(1 for name, _, _ in ctx.trace.host if name == "stream.serve")
    if not runs:
        return None
    setup = sum(e - s for name, s, e in ctx.trace.host if name == "stream.setup")
    return setup * 1e3 / runs
