"""Host milliseconds a tile spent waiting for the serving runner's device
lock, on the serving thread and the prefetch worker together (the
program's ``tumseg.lock.wait`` spans), over the tiles served in the
traced window (``tumseg.serve.scene`` spans)."""

from gpubench.metrics._spans import ms_per


def read(ctx):
    return ms_per(ctx, "tumseg.lock.wait", "tumseg.serve.scene")
