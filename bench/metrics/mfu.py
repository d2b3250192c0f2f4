"""The window's share of the chip's peak: the model FLOPs its rows need
(the needed unit runs' products, convolutions, attention and head, from
``work/<config>.py``) over the window's wall time, the chips and the peak
of the configuration's dtype (BF16 989.4 TFLOP/s, FP32 66.9), in
percent."""
from bench import peaks


def read(ctx):
    flops = ctx.work["flops"]
    if flops <= 0:
        return None
    peak = peaks.DTYPE_FLOPS[ctx.conf["dtype"]]
    return 100.0 * flops / (ctx.wall * ctx.chips * peak)
