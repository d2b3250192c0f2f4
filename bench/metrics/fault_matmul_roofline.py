"""``fault_matmul``'s bf16 route (the hash pass ``fault_weight_tiles`` and
the product ``matmul_tiles``) against its roofline: the weight products
the traced sub-window's needed unit runs take (the larger of their
tensor-core FLOPs over the BF16 peak and their bytes over HBM bandwidth)
plus the weights' hash draws (15 operations each, once an environment)
over the INT32 peak, over both kernels' device time, in percent."""
from bench import peaks


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.group_s("fault_weight_tiles", "matmul_tiles")
    w = ctx.trace_work
    bound = max(w["fm_flops"] / peaks.BF16_FLOPS,
                w["fm_bytes"] / peaks.HBM_BYTES) \
        + w["fm_draws"] * peaks.HASH_OPS_PER_DRAW / peaks.INT32_OPS
    if t <= 0 or w["fm_flops"] <= 0:
        return None
    return 100.0 * bound / t
