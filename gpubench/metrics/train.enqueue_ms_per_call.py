"""Host milliseconds a call of running its CUDA graph: bindings, static
copies and clones, less the replay's launch, which waits for room in the
device's queue (the self time of the program's ``tumseg.graphs.run``
spans within ``tumseg.train.call``), over the calls in the traced window;
none off CUDA."""

from gpubench.metrics._spans import ms_per


def read(ctx):
    return ms_per(ctx, "tumseg.graphs.run", "tumseg.train.call", own=True,
                  within="tumseg.train.call", graphs=True)
