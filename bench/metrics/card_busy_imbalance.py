"""How unevenly the cell's cards are kept busy over the traced sub-window:
100 x (1 - the mean card's busy time / the busiest card's), each card's
busy time the union of its device intervals.  0 when every card is as
busy as the busiest; 50 when two of four cards do all the work."""


def read(ctx):
    if ctx.trace is None:
        return None
    busiest = max(ctx.trace.busy_s_per_card)
    if busiest <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / busiest)
