"""The share of the traced sub-window in which the device is idle while
the host's innermost program span is a ``search.`` span (NSGA-II, the
objective, the cost model), in percent (``program_spans.py``)."""
from bench.program_spans import idle_share


def read(ctx):
    return idle_share(ctx, "search")
