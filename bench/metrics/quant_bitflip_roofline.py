"""``quant_bitflip`` against its roofline: the larger of the needed
integer operations (15 a hash draw, the draws once an environment) over
the INT32 peak and the needed bytes (each unit input read once and
written once, a needed unit run each) over HBM bandwidth, over the
kernels' device time (``quant_bitflip_kernel`` and ``amax_kernel``) in the
traced sub-window, in percent."""
from bench import peaks


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.group_s("quant_bitflip")
    w = ctx.trace_work
    bound = max(w["act_draws"] * peaks.HASH_OPS_PER_DRAW / peaks.INT32_OPS,
                w["act_bytes"] / peaks.HBM_BYTES)
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
