"""The share of the traced sub-window in which the device is idle while
the host's innermost program span is a ``kernel.`` span: host time in the
wrappers of the port's own kernels (checks, buffers, the ctypes launch)
while the card waits, in percent (``program_spans.py``)."""
from bench.program_spans import idle_share


def read(ctx):
    return idle_share(ctx, "kernels")
