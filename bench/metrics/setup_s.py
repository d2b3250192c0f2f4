"""Process start to the first timed row: imports, the kernel library
(built on a checkout's first run), weights and inputs, labels, the
evaluator's memory probe and the warm-up step."""


def read(ctx):
    return ctx.setup_s
