"""Host milliseconds of CUDA-graph capture a tile: the runner's
``StepGraphs.capture_seconds`` over the window, over the tiles served."""


def read(ctx):
    if not ctx["tiles"]:
        return None
    return 1e3 * ctx["capture_s"] / ctx["tiles"]
