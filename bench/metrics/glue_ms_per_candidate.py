"""Device milliseconds of elementwise, copy and layout operations (the
glue around the port's kernels and the libraries') a row of the traced
sub-window, from the profiler."""
from bench.profile_reader import GLUE


def read(ctx):
    if ctx.trace is None or not ctx.trace_rows:
        return None
    return ctx.trace.group_s(*GLUE) * 1e3 / ctx.trace_rows
