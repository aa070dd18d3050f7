"""Milliseconds a tile of ``InferenceRunner.prefetch_scene`` on the
worker (host gridding and the uploads), the harness's span around it, over
the tiles served in the window."""


def read(ctx):
    spans = ctx["prefetch_s"]
    return 1e3 * sum(spans) / len(spans) if spans else None
