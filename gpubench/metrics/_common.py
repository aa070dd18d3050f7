"""What the per-layer readers share. A reader is ``read(ctx)`` in
``metrics/<metric>.py``: ``ctx`` holds the loop's counters (``window_s``,
``launches``, ...), its configuration and, in a traced run, ``trace``
(``gpubench.trace.Trace.reduce``). It returns the metric's value, or None
where it finds nothing to read."""

from __future__ import annotations

from gpubench import counting, spec, trace as T


def units(ctx) -> int:
    """Forwards (serving) or steps (training) that the window ran."""
    return ctx["steps"] if ctx["train"] else ctx["forwards"]


def mfu(ctx) -> float:
    cfg, B, N = ctx["cfg"], ctx["batch"], ctx["points"]
    arch = spec.architecture(cfg)
    per = (arch.step_flops if ctx["train"] else arch.forward_flops)(cfg, B, N)
    return 100.0 * per * units(ctx) / (ctx["window_s"]
                                       * counting.F32_FLOPS_PER_S)


def roofline(ctx):
    """The point kernels' least time over their device time, in %. The
    time is every point-kernel launch that the trace holds; the least time
    counts only the families whose launches the trace, the program's
    counter (``kernels.launches``) and the configuration's count (its
    architecture module's ``launches``) agree on, so a family that the
    count cannot price (a launch structure that changed) lowers the share
    and never raises it; where none is priced (an architecture that
    launches no point kernel) it reads nothing. Each family, its launches
    and whether it was priced go into ``ctx["roofline_families"]`` for the
    result's line. The profiler has to see every launch that the
    program counted, graph replays included: a trace that lost some
    raises."""
    tr = ctx.get("trace")
    if tr is None or ctx["device"] != "cuda":
        return None
    per = spec.architecture(ctx["cfg"]).launches(
        ctx["cfg"], ctx["batch"], ctx["points"], ctx["train"])
    n = units(ctx)
    seen = T.point_kernels(tr["kernels"])
    counted = {f: sum(ctx["launches"].get(k, 0) for k in names)
               for f, names in T.FAMILIES.items()}
    if any(seen.get(f, (0, 0.0))[0] != c for f, c in counted.items()):
        raise RuntimeError(
            "point-kernel launches: the trace holds %s, the program counted "
            "%s" % ({f: c for f, (c, _) in seen.items()}, counted))
    bound = secs = 0.0
    families = {}
    for fam, names in T.FAMILIES.items():
        costs = [c for c in per if c["kernel"] in names]
        runs, dev_s = seen.get(fam, (0, 0.0))
        priced = bool(costs) and runs == n * len(costs)
        if runs or costs:
            families[fam] = {"launches": runs, "expected": n * len(costs),
                             "device_s": dev_s, "priced": priced}
        if priced:
            bound += counting.bound_s(costs) * n
        secs += dev_s
    ctx["roofline_families"] = families
    return 100.0 * bound / secs if bound > 0 and secs > 0 else None


def idle(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
