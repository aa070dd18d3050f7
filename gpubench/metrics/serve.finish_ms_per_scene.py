"""Host milliseconds of a tile's finish: the gate, the argmax and their
launches, less the gate's upload and the labels' readback, which wait for
the tile's votes (the self time of the program's ``tumseg.serve.finish``
spans), over their count in the traced window."""

from gpubench.metrics._spans import ms_per


def read(ctx):
    return ms_per(ctx, "tumseg.serve.finish", "tumseg.serve.finish",
                  own=True)
