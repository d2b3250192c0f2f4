"""The share of the rows handed to ``delta_acc`` over the window that the
engine's row cache answered (``rows_cached / rows_requested``, its own
counters in ``staged_stats()``), in percent."""


def read(ctx):
    asked = ctx.stats.get("rows_requested", 0)
    if not asked:
        return None
    return 100.0 * ctx.stats["rows_cached"] / asked
