"""The share of the traced sub-window in which the device is idle while
the host's innermost program span is an ``engine.`` span (``delta_acc``,
the row cache and prefix planning, dispatch, stacking, storing, the one
gather), in percent (``program_spans.py``)."""
from bench.program_spans import idle_share


def read(ctx):
    return idle_share(ctx, "engine")
