"""The share of unit runs the staged engine avoided over the window
(``unit_runs_avoided / full_unit_runs``, its own counters), in percent."""


def read(ctx):
    full = ctx.stats.get("full_unit_runs", 0)
    if not full:
        return None
    return 100.0 * ctx.stats["unit_runs_avoided"] / full
