"""Host milliseconds a tile of blocking device-to-host readbacks on the
serving thread, the finish's labels (the program's ``tumseg.readback``
spans within ``tumseg.serve.scene``), over the tiles served in the traced
window."""

from gpubench.metrics._spans import ms_per


def read(ctx):
    return ms_per(ctx, "tumseg.readback", "tumseg.serve.scene",
                  within="tumseg.serve.scene")
