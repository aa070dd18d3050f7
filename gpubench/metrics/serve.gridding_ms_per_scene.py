"""Host milliseconds of a tile's gridding on the host (the program's
``tumseg.serve.grid`` spans, the computation and not its memo), over
their count in the traced window."""

from gpubench.metrics._spans import ms_per


def read(ctx):
    return ms_per(ctx, "tumseg.serve.grid", "tumseg.serve.grid")
