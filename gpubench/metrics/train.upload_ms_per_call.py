"""Host milliseconds a call of blocking host-to-device uploads inside the
call, the rejection rounds' room ids and rows, each of which first waits
for the device's queued work (the program's ``tumseg.upload`` spans
within ``tumseg.train.call``), over the calls in the traced window."""

from gpubench.metrics._spans import ms_per


def read(ctx):
    return ms_per(ctx, "tumseg.upload", "tumseg.train.call",
                  within="tumseg.train.call")
