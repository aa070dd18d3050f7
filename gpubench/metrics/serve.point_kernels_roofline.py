"""The point kernels' share of their roofline over the traced serve window:
the least time of every launch (``gpubench.counting``) over their device
time in the trace, in %."""

from gpubench.metrics._common import roofline


def read(ctx):
    return roofline(ctx)
