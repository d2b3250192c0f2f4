"""The share of the traced sub-window in which no operation ran on a card
(one minus the union of the card's device intervals over the span), the
mean over the cell's cards, in percent."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
