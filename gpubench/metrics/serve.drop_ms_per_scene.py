"""Host milliseconds a tile of dropping the last tile's CUDA graphs when a
new tile's tensors are bound (the program's ``tumseg.graphs.drop``
spans) over the tiles served in the traced window (``tumseg.serve.scene``
spans); none off CUDA."""

from gpubench.metrics._spans import ms_per


def read(ctx):
    return ms_per(ctx, "tumseg.graphs.drop", "tumseg.serve.scene", graphs=True)
