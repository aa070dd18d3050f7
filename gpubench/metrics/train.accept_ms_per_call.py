"""Host milliseconds a call of the device sampler's rejection rounds, less
their uploads and readbacks, which wait for the device (the self time of
the program's ``tumseg.sampler.accept`` spans), over the calls in the
traced window (``tumseg.train.call`` spans)."""

from gpubench.metrics._spans import ms_per


def read(ctx):
    return ms_per(ctx, "tumseg.sampler.accept", "tumseg.train.call", own=True)
