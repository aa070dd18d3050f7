"""Host milliseconds a call of launching its CUDA graph, mostly the wait
for room in the device's queue (the program's ``tumseg.graphs.replay``
spans within ``tumseg.train.call``), over the calls in the traced window;
none off CUDA."""

from gpubench.metrics._spans import ms_per


def read(ctx):
    return ms_per(ctx, "tumseg.graphs.replay", "tumseg.train.call",
                  within="tumseg.train.call", graphs=True)
