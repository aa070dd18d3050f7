"""The roofline reader on a made-up trace: every family priced when its
launches agree with the configuration's count; a family whose launches do
not agree keeps its device time in the share and loses its least time, so
the share falls and the result names it; a trace that lost launches
raises; an architecture whose count holds no launch reads no share."""

from __future__ import annotations

import pytest

from gpubench import counting, spec
from gpubench.metrics import _common
from gpubench.tests import tiny
from gpubench.trace import FAMILIES

FORWARDS = 10
KERNEL = {"fps": "fps_kernel", "ball_query": "ball_query_kernel",
          "group": "group_kernel",
          "three_nn_interpolate": "three_nn_interpolate_kernel"}


def _ctx(drop_group=0):
    """A serving window of FORWARDS SSG forwards, each launch 10 us on the
    device; ``drop_group`` group launches fewer a forward than counted."""
    cfg = spec.config("pointnet2_ssg")
    per = spec.architecture(cfg).launches(cfg, 32, 4096, False)
    kernels, launches = [], {}
    for _ in range(FORWARDS):
        skipped = 0
        for c in per:
            if c["kernel"] == "group" and skipped < drop_group:
                skipped += 1
                continue
            kernels.append((f"void tumseg::{KERNEL[c['kernel']]}<float>",
                            1e-5))
            launches[c["kernel"]] = launches.get(c["kernel"], 0) + 1
    return {"trace": {"kernels": kernels + [("gemm", 1.0)]},
            "device": "cuda", "cfg": cfg, "batch": 32, "points": 4096,
            "train": False, "forwards": FORWARDS, "launches": launches}, per


def test_every_family_priced():
    ctx, per = _ctx()
    share = _common.roofline(ctx)
    expect = 100.0 * counting.bound_s(per) * FORWARDS / (
        len(per) * FORWARDS * 1e-5)
    assert share == pytest.approx(expect)
    assert all(f["priced"] for f in ctx["roofline_families"].values())


def test_a_family_off_the_count_lowers_the_share_and_is_named():
    full, _ = _ctx()
    ctx, per = _ctx(drop_group=1)
    share = _common.roofline(ctx)
    fam = ctx["roofline_families"]
    assert not fam["group"]["priced"]
    assert fam["group"]["launches"] == fam["group"]["expected"] - FORWARDS
    priced = [c for c in per if c["kernel"] != "group"]
    secs = (len(per) - 1) * FORWARDS * 1e-5
    assert share == pytest.approx(
        100.0 * counting.bound_s(priced) * FORWARDS / secs)
    assert share < _common.roofline(full)


def test_a_trace_that_lost_launches_raises():
    ctx, _ = _ctx()
    ctx["launches"] = dict(ctx["launches"], fps=ctx["launches"]["fps"] + 1)
    with pytest.raises(RuntimeError, match="point-kernel launches"):
        _common.roofline(ctx)


@pytest.mark.parametrize("name", [c["name"] for c in
                                  spec.load_benchmark()["configs"]])
def test_families_cover_the_counted_kernels(name):
    cfg = spec.config(name)
    kinds = {c["kernel"] for train in (False, True)
             for c in spec.architecture(cfg).launches(cfg, 2, 256, train)}
    assert kinds <= {k for names in FAMILIES.values() for k in names}


@pytest.mark.parametrize("train", [False, True])
def test_no_point_kernel_reads_no_share(train):
    cfg = tiny.full_config("pointnet")
    ctx = {"trace": {"kernels": [("gemm", 1.0)]}, "device": "cuda",
           "cfg": cfg, "batch": 32, "points": 4096, "train": train,
           "forwards": FORWARDS, "steps": FORWARDS, "launches": {}}
    assert _common.roofline(ctx) is None
    assert ctx["roofline_families"] == {}
    ctx["window_s"] = 1.0
    assert _common.mfu(ctx) > 0
