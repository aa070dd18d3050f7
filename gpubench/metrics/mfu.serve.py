"""The whole serve window's share of the H100's f32 peak: the FLOPs of
every forward that it ran (``gpubench.counting``) over its seconds
and 67 TFLOP/s, in %."""

from gpubench.metrics._common import mfu


def read(ctx):
    return mfu(ctx)
