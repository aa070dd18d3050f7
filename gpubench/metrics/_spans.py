"""What the readers of the program's spans share. The program records its
spans (``tumseg_torch.utils.profiling``) only while a profiler runs, so in
a run the store holds the traced window's spans alone. A program without
the store (one older than its spans) gives no reading, and neither does a
denominator of 0."""

from __future__ import annotations


def totals(within=None):
    """The program's ``span_totals(within)``, or None where it has none."""
    from tumseg_torch.utils import profiling

    read = getattr(profiling, "span_totals", None)
    return None if read is None else read(within)


def ms_per(ctx, name, per, *, own=False, within=None, graphs=False):
    """Milliseconds of the spans ``name`` (their self time with ``own``;
    only those inside a ``within`` span) over the number of ``per`` spans;
    with ``graphs`` None off CUDA, where the program runs no CUDA graph."""
    if graphs and ctx["device"] != "cuda":
        return None
    inner, outer = totals(within), totals()
    if inner is None or not outer.get(per, {}).get("count"):
        return None
    spans = inner.get(name, {"seconds": 0.0, "self_seconds": 0.0})
    seconds = spans["self_seconds" if own else "seconds"]
    return 1e3 * seconds / outer[per]["count"]
