"""Host milliseconds a call of blocking device-to-host readbacks inside
the call (the program's ``tumseg.readback`` spans within
``tumseg.train.call``), over the calls in the traced window."""

from gpubench.metrics._spans import ms_per


def read(ctx):
    return ms_per(ctx, "tumseg.readback", "tumseg.train.call",
                  within="tumseg.train.call")
