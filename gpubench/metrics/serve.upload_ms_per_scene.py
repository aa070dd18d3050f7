"""Host milliseconds a tile of blocking host-to-device uploads on the
serving thread, the finish's gate mask, which first waits for the tile's
queued votes (the program's ``tumseg.upload`` spans within
``tumseg.serve.scene``), over the tiles served in the traced window."""

from gpubench.metrics._spans import ms_per


def read(ctx):
    return ms_per(ctx, "tumseg.upload", "tumseg.serve.scene",
                  within="tumseg.serve.scene")
