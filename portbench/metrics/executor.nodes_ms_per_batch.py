"""Host ms a batch in the executor's node loop (its dispatch of every
node's kernels and glue): the profiled ``executor.nodes`` spans inside
``step.apply`` spans, over the number of ``step.apply`` spans in the
traced sub-window.  None where the program emits no ``step.apply`` span."""


def read(ctx):
    if ctx.trace is None:
        return None
    steps = [(s, e) for name, s, e in ctx.trace.host if name == "step.apply"]
    if not steps:
        return None
    inside = sum(e - s for name, s, e in ctx.trace.host
                 if name == "executor.nodes"
                 and any(a <= s and e <= b for a, b in steps))
    return inside * 1e3 / len(steps)
