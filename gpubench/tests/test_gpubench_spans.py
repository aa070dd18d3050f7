"""The readers of the program's spans, on the tiny cells run with
``--trace 1`` on the CPU: the host-only metrics read numbers, the graph
metrics (warm-up, drop, enqueue, replay) none, as the CPU runs no CUDA
graph; a program without the span store (an older program with this
benchmark laid over it), or a window without the denominator's spans,
gives no reading."""

from __future__ import annotations

import pytest

from gpubench import spec
from gpubench.metrics import _spans
from gpubench.tests import tiny
from tumseg_torch.utils import profiling

BENCH = spec.load_benchmark()
NEW = {"serve": {"serve.finish_ms_per_scene", "serve.lock_wait_ms_per_scene",
                 "serve.gridding_ms_per_scene", "serve.upload_ms_per_scene",
                 "serve.readback_ms_per_scene"},
       "train": {"train.accept_ms_per_call", "train.readback_ms_per_call",
                 "train.upload_ms_per_call"}}
GRAPHS = {"serve": {"serve.warmup_ms_per_scene", "serve.drop_ms_per_scene"},
          "train": {"train.enqueue_ms_per_call", "train.replay_ms_per_call"}}


def test_every_span_metric_is_listed_with_its_cells():
    spans = {m["name"]: m for m in BENCH["per_layer"]
             if m["source"] == "program_span"}
    for kind, cells in (("serve", ["ssg.serve.facade", "msg.serve.facade"]),
                        ("train", ["ssg.train.facade", "msg.train.facade"])):
        for name in NEW[kind] | GRAPHS[kind]:
            assert spans[name]["workloads"] == cells
            assert (spans[name]["unit"], spans[name]["better"]) == ("ms",
                                                                    "lower")
    assert len(spans) == 12


@pytest.mark.parametrize("workload,kind", [("ssg.serve.facade", "serve"),
                                           ("ssg.train.facade", "train")])
def test_traced_tiny_cell_reads_the_host_spans(monkeypatch, workload, kind):
    profiling.reset_spans()
    line = tiny.execute(monkeypatch, workload, trace=1)
    for name in NEW[kind]:
        value = line["metrics"][name]["value"]
        assert isinstance(value, float) and value >= 0.0, name
    assert not GRAPHS[kind] & set(line["metrics"])
    totals = profiling.span_totals()
    if kind == "serve":
        assert totals["tumseg.serve.scene"]["count"] == line["attempted"]
        assert line["metrics"]["serve.finish_ms_per_scene"]["value"] > 0.0
    else:
        assert totals["tumseg.train.call"]["count"] == line["attempted"]
        assert line["metrics"]["train.accept_ms_per_call"]["value"] > 0.0


def test_no_reading_without_the_store_or_the_denominator(monkeypatch):
    ctx = {"device": "cuda"}
    profiling.reset_spans()
    for name in NEW["serve"] | NEW["train"] | GRAPHS["serve"] | \
            GRAPHS["train"]:
        assert spec.reader(name)(ctx) is None, name
    monkeypatch.delattr(profiling, "span_totals")
    assert _spans.totals() is None
    assert _spans.ms_per(ctx, "tumseg.readback", "tumseg.train.call") is None


def test_ms_per_divides_by_the_denominator_spans():
    import torch

    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(4):
            with profiling.span("tumseg.train.call"):
                with profiling.span("tumseg.sampler.accept"):
                    profiling.readback(torch.ones(3))
        profiling.readback(torch.ones(3))       # outside any call
    t = profiling.span_totals()
    ctx = {"device": "cpu"}
    assert _spans.ms_per(ctx, "tumseg.readback", "tumseg.train.call",
                         within="tumseg.train.call") == pytest.approx(
        1e3 * profiling.span_totals("tumseg.train.call")[
            "tumseg.readback"]["seconds"] / 4)
    assert profiling.span_totals("tumseg.train.call")[
        "tumseg.readback"]["count"] == 4
    assert _spans.ms_per(ctx, "tumseg.sampler.accept", "tumseg.train.call",
                         own=True) == pytest.approx(
        1e3 * t["tumseg.sampler.accept"]["self_seconds"] / 4)
    assert _spans.ms_per(ctx, "tumseg.graphs.run", "tumseg.train.call",
                         graphs=True) is None
    assert _spans.ms_per({"device": "cuda"}, "tumseg.graphs.run",
                         "tumseg.train.call", graphs=True) == 0.0
    profiling.reset_spans()
