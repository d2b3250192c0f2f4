"""Population rows handed to ``delta_acc`` in the window's completed
steps (rows answered from the evaluator's cache included) over the
window's wall time: the rate a search's user feels."""


def read(ctx):
    return ctx.rows / ctx.wall
