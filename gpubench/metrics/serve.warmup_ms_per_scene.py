"""Host milliseconds a tile of the CUDA graphs' eager warm-ups (the
program's ``tumseg.graphs.warmup`` spans) over the tiles served in the
traced window (``tumseg.serve.scene`` spans); none off CUDA."""

from gpubench.metrics._spans import ms_per


def read(ctx):
    return ms_per(ctx, "tumseg.graphs.warmup", "tumseg.serve.scene",
                  graphs=True)
