"""Device milliseconds a training step of the grouping kernels: the ball
query, group, fused ball query + group and group backward families
(``gpubench.trace.point_kernels``; the group family holds the centroid
gathers too) over the traced train window's steps; none off CUDA. The
profiler has to see every launch of those families that the program
counted (``kernels.launches``), graph replays included: a trace that lost
some raises."""

from gpubench import trace as T

FAMILIES = ("ball_query", "group", "fused_ball_group", "group_backward")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or ctx["device"] != "cuda" or not ctx["steps"]:
        return None
    seen = T.point_kernels(tr["kernels"])
    counted = {f: sum(ctx["launches"].get(k, 0) for k in T.FAMILIES[f])
               for f in FAMILIES}
    if any(seen.get(f, (0, 0.0))[0] != c for f, c in counted.items()):
        raise RuntimeError(
            "grouping launches: the trace holds %s, the program counted %s"
            % ({f: seen.get(f, (0, 0.0))[0] for f in FAMILIES}, counted))
    return 1e3 * sum(seen.get(f, (0, 0.0))[1] for f in FAMILIES) \
        / ctx["steps"]
