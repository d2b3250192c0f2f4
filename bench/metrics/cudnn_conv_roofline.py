"""cuDNN's convolutions against the float32 peak (TF32 off, the path's
precision): the convolution FLOPs the traced sub-window's rows need
(``work/<config>.py``, needed unit runs only) over 66.9 TFLOP/s, over the
convolution kernels' device time, in percent."""
from bench import peaks


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.group_s("cudnn_conv")
    flops = ctx.trace_work["conv_flops"]
    if t <= 0 or flops <= 0:
        return None
    return 100.0 * flops / peaks.FP32_FLOPS / t
