"""The BatchNorm kernels' share of their roofline over the traced train
window: the least time of their launches (``counting.bound_s`` over the
architecture module's ``bn_launches``, a step's times the steps) over the
device time of ``bn_apply``, ``bn_backward_terms`` and ``bn_backward_dx``
in the trace, in %. A kernel whose launches in the trace are not the
count's keeps its device time and loses its least time, so the share
falls. The profiler has to see every launch that the program counted
(``kernels.launches``), graph replays included: a trace that lost some
raises. None off CUDA, and where the architecture module has no
``bn_launches``."""

import re

from gpubench import counting, spec

KERNELS = ("bn_apply", "bn_backward_terms", "bn_backward_dx")
NAME = re.compile(r"(?<![A-Za-z0-9_])(bn_apply|bn_backward_terms|"
                  r"bn_backward_dx)_kernel(?![A-Za-z0-9_])")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or ctx["device"] != "cuda" or not ctx["steps"]:
        return None
    count = getattr(spec.architecture(ctx["cfg"]), "bn_launches", None)
    if count is None:
        return None
    seen = {}
    for name, s in tr["kernels"]:
        m = NAME.search(name)
        if m:
            n, secs = seen.get(m.group(1), (0, 0.0))
            seen[m.group(1)] = (n + 1, secs + s)
    counted = {k: ctx["launches"].get(k, 0) for k in KERNELS}
    if any(seen.get(k, (0, 0.0))[0] != c for k, c in counted.items()):
        raise RuntimeError(
            "BatchNorm launches: the trace holds %s, the program counted %s"
            % ({k: seen.get(k, (0, 0.0))[0] for k in KERNELS}, counted))
    per = count(ctx["cfg"], ctx["batch"], ctx["points"], True)
    bound = secs = 0.0
    for k in KERNELS:
        costs = [c for c in per if c["kernel"] == k]
        runs, dev_s = seen.get(k, (0, 0.0))
        if costs and runs == ctx["steps"] * len(costs):
            bound += counting.bound_s(costs) * ctx["steps"]
        secs += dev_s
    return 100.0 * bound / secs if bound > 0 and secs > 0 else None
