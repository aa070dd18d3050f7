"""The device's idle share of the traced serve window: 1 - the union of
its operations' intervals over the window, in %."""

from gpubench.metrics._common import idle


def read(ctx):
    return idle(ctx)
