"""Host milliseconds a generation outside the ``delta_acc`` calls: NSGA-II,
the cost model and the objective's assembly, from the benchmark's spans
around each step and each ``delta_acc`` call in the window.  Searches
only."""


def read(ctx):
    if ctx.traffic["kind"] != "search" or not ctx.steps:
        return None
    steps = sum(s["t1"] - s["t0"] for s in ctx.steps)
    return (steps - ctx.dacc_s) * 1e3 / len(ctx.steps)
