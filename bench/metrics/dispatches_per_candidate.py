"""The staged engine's dispatches over the window's rows (its own
counter over the rows the benchmark handed over)."""


def read(ctx):
    if "dispatches" not in ctx.stats or not ctx.rows:
        return None
    return ctx.stats["dispatches"] / ctx.rows
