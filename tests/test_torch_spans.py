"""The program's spans (``tumseg_torch.utils.profiling``) on the CPU:

- a span records only while a ``torch.profiler`` session runs, on the
  main thread and on a worker thread that started before the session, and
  with no session it is one shared no-op;
- a span's self time is its duration less its children's, its parent and
  request id are recorded, and totals are kept within each enclosing span;
- ``readback`` and ``upload`` are spans, ``WaitedLock`` spans the wait on
  every thread, and ``StepGraphs``' spans match its counters;
- a tiny serve and a tiny training call record nothing untraced, and
  traced record their spans where the work happens;
- main-thread spans are host events of the benchmark's trace.

The card's own check (the warm-ups, captures and drops of a real vote run)
is ``tests/test_torch_cuda.py::test_serving_spans_match_the_graph_counters``.
"""

import importlib
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tumseg_torch.data.dataset import TestGridDataset
from tumseg_torch.data.device_sampler import DeviceBlockSampler
from tumseg_torch.data.las import write_las
from tumseg_torch.infer.voting import InferenceRunner
from tumseg_torch.train.loop import TrainEngine
from tumseg_torch.utils import graphs as G
from tumseg_torch.utils import profiling as P

C = 8


@pytest.fixture(autouse=True)
def store():
    """An empty store, and one intra-op thread: the suite runs several
    test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    P.reset_spans()
    yield
    P.reset_spans()
    torch.set_num_threads(threads)


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _records():
    return [(r.name, r.parent, r.request) for r in P.span_records()]


def test_spans_record_only_while_a_profiler_runs():
    assert P.span("tumseg.a") is P.span("tumseg.b", 3)
    with P.span("tumseg.a"):
        pass
    with _profiler():
        with P.span("tumseg.a"):
            pass
    with P.span("tumseg.a"):
        pass
    assert _records() == [("tumseg.a", None, None)]
    assert P.span_totals()["tumseg.a"]["count"] == 1


def test_an_untraced_span_makes_no_span(monkeypatch):
    monkeypatch.setattr(P, "_Span", None)       # calling it would raise
    with P.span("tumseg.a", 1):
        pass
    assert P.span_records() == [] and P.span_totals() == {}


def test_a_worker_started_before_the_profiler_records():
    def work(i):
        with P.span("tumseg.work", i):
            time.sleep(0.005)
        return threading.get_ident()

    with ThreadPoolExecutor(max_workers=1) as pool:
        first = pool.submit(work, 0).result()    # the worker starts untraced
        with _profiler():
            ident = pool.submit(work, 1).result()
        pool.submit(work, 2).result()
    assert ident == first != threading.get_ident()
    assert [(r.name, r.request, r.thread) for r in P.span_records()] == [
        ("tumseg.work", 1, ident)]


def test_self_time_parents_requests_and_enclosing_totals():
    with _profiler():
        with P.span("tumseg.outer", 7):
            time.sleep(0.02)
            with P.span("tumseg.inner"):
                time.sleep(0.01)
            with P.span("tumseg.inner", 8):
                with P.span("tumseg.leaf"):
                    time.sleep(0.01)
    assert _records() == [("tumseg.inner", "tumseg.outer", 7),
                          ("tumseg.leaf", "tumseg.inner", 8),
                          ("tumseg.inner", "tumseg.outer", 8),
                          ("tumseg.outer", None, 7)]
    for r in P.span_records():
        children = sum(c.seconds for c in P.span_records()
                       if c.parent == r.name and c.start >= r.start
                       and c.start + c.seconds <= r.start + r.seconds)
        assert r.self_seconds == pytest.approx(r.seconds - children,
                                               abs=1e-9)
    t = P.span_totals()
    assert t["tumseg.outer"]["self_seconds"] == pytest.approx(
        t["tumseg.outer"]["seconds"] - t["tumseg.inner"]["seconds"],
        abs=1e-9)
    assert t["tumseg.outer"]["self_seconds"] >= 0.02
    assert t["tumseg.inner"]["count"] == 2
    assert set(P.span_totals("tumseg.outer")) == {"tumseg.inner",
                                                  "tumseg.leaf"}
    assert P.span_totals("tumseg.inner") == {
        "tumseg.leaf": t["tumseg.leaf"]}
    assert P.span_totals("tumseg.leaf") == {}


def test_readback_and_upload_are_spans():
    t = torch.arange(10, dtype=torch.int64)
    a = np.arange(4, dtype=np.int32)
    assert torch.equal(P.readback(t), t)
    assert torch.equal(P.upload(a, "cpu"), torch.from_numpy(a))
    assert P.span_records() == []
    with _profiler():
        with P.span("tumseg.outer", 5):
            P.readback(t[:4])
            up = P.upload(a, "cpu")
    assert up.dtype == torch.int32 and up.tolist() == [0, 1, 2, 3]
    assert _records() == [("tumseg.readback", "tumseg.outer", 5),
                          ("tumseg.upload", "tumseg.outer", 5),
                          ("tumseg.outer", None, 5)]


def test_waited_lock_spans_the_wait_on_every_thread():
    lock = P.WaitedLock()
    held = threading.Event()

    def hold():
        with lock:
            held.set()
            time.sleep(0.2)

    with _profiler():
        thread = threading.Thread(target=hold)
        thread.start()
        assert held.wait(timeout=30)
        with lock:
            pass
        thread.join(timeout=30)
    assert not thread.is_alive()
    waits = [r for r in P.span_records() if r.name == "tumseg.lock.wait"]
    assert len(waits) == 2 and len({r.thread for r in waits}) == 2
    assert max(r.seconds for r in waits) >= 0.1


def test_step_graphs_spans_match_their_counters(monkeypatch):
    """``StepGraphs.run``'s control flow on the CPU, its warm-up and
    capture stood in, over bindings that change once."""
    graphs = G.StepGraphs("cpu", lock=P.WaitedLock())

    class Graph:
        def replay(self):
            pass

    def capture(key, fn, inputs, generators):
        graphs.captures += 1
        return G._Graph(Graph(), [t.clone() for t in inputs],
                        fn(*inputs), ({}, {}))

    monkeypatch.setattr(graphs, "_warm_up", lambda fn, inputs: fn(*inputs))
    monkeypatch.setattr(graphs, "_capture", capture)
    x = torch.ones(3)
    with _profiler():
        for b in (1, 1, 1, 2, 2, 2):
            graphs.run("k", lambda t: (t * 2,), (x,), [], lambda: (b,))
    t = P.span_totals()
    assert t["tumseg.graphs.run"]["count"] == 6
    assert t["tumseg.graphs.warmup"]["count"] == graphs.warmups == 2
    assert t["tumseg.graphs.capture"]["count"] == graphs.captures == 2
    assert t["tumseg.graphs.replay"]["count"] == graphs.replays == 4
    assert t["tumseg.graphs.drop"]["count"] == 2
    assert t["tumseg.lock.wait"]["count"] == 4
    assert set(P.span_totals("tumseg.graphs.run")) == {
        "tumseg.graphs.warmup", "tumseg.graphs.capture",
        "tumseg.graphs.replay", "tumseg.graphs.drop", "tumseg.lock.wait"}


# -- the program's own spans, at a tiny size ---------------------------------

def _small_model(monkeypatch, extra=0):
    """The SSG with fewer centroids a stage."""
    mod = importlib.import_module("tumseg_torch.models.pointnet2_sem_seg")
    for sa, n in zip(mod.SA_CFGS, (64, 16, 8, 4)):
        monkeypatch.setitem(sa, "npoint", n)
    torch.manual_seed(0)
    return mod.get_model(C, extra)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiles")
    rng = np.random.default_rng(3)
    paths = []
    for i in range(2):
        n = 1200
        xyz = np.stack([2.0 * rng.random(n), rng.uniform(0, 1.0, n),
                        rng.uniform(0, 4.0, n)], 1)
        paths.append(str(d / f"scene{i}.las"))
        write_las(paths[-1], xyz, rng.choice([1, 2, 3, 7], n))
    return paths


def test_a_tiny_serve_records_its_spans_only_when_traced(scenes,
                                                         monkeypatch):
    ds = TestGridDataset(las_file_list=scenes, num_classes=C,
                         block_points=128, class8=True, color=False, seed=0)
    runner = InferenceRunner(_small_model(monkeypatch), C, batch_size=2,
                             device="cpu", device_features=True,
                             device_reblock=True)
    with ThreadPoolExecutor(max_workers=1) as pool:
        pool.submit(runner.prefetch_scene, ds, 0).result()
        runner.infer_scene(ds, 0, 1)
        assert P.span_records() == []
        with _profiler():
            pool.submit(runner.prefetch_scene, ds, 1).result()
            labels = runner.infer_scene(ds, 1, 1)
    assert labels.shape == (1200,)
    assert sorted(set(_records()), key=str) == sorted({
        ("tumseg.serve.grid", None, 1),
        ("tumseg.lock.wait", None, None),
        ("tumseg.serve.scene", None, 1),
        ("tumseg.serve.finish", "tumseg.serve.scene", 1),
        ("tumseg.upload", "tumseg.serve.finish", 1),
        ("tumseg.readback", "tumseg.serve.finish", 1)}, key=str)
    threads = {r.name: r.thread for r in P.span_records()}
    assert threads["tumseg.serve.grid"] != threads["tumseg.serve.scene"]


def test_a_tiny_train_call_records_its_spans_only_when_traced(monkeypatch):
    rng = np.random.default_rng(5)
    rooms = [rng.random((3000, 3)) * np.array([2.0, 1.5, 3.0]) + i
             for i in range(2)]
    sampler = DeviceBlockSampler(
        rooms, [rng.integers(0, C, len(p)) for p in rooms],
        [[rng.random(len(p)) * 255] for p in rooms], [True], num_point=128,
        min_block_points=32, device="cpu")
    engine = TrainEngine(_small_model(monkeypatch, 1), C, np.ones(C), seed=0,
                         device="cpu", sampler=sampler)
    ids = np.array([[0, 1], [1, 0]])
    engine.train_batch_rooms_multi(ids, 1e-3, 0.1)
    assert P.span_records() == []
    rounds = sampler.stats["rounds"]
    with _profiler():
        engine.train_batch_rooms_multi(ids, 1e-3, 0.1)
    recs = _records()
    assert recs[-1] == ("tumseg.train.call", None, 2)
    assert recs[-2] == ("tumseg.sampler.accept", "tumseg.train.call", 2)
    assert recs[0] == ("tumseg.upload", "tumseg.sampler.accept", 2)
    rounds = sampler.stats["rounds"] - rounds
    assert recs[1:-2] == rounds * [
        ("tumseg.upload", "tumseg.sampler.accept", 2),
        ("tumseg.readback", "tumseg.sampler.accept", 2)]


def test_main_thread_spans_are_host_events_of_the_benchmark_trace():
    from gpubench.trace import Trace

    with warnings.catch_warnings():
        # on a machine without CUDA: "CUDA is not available, disabling ..."
        warnings.simplefilter("ignore", UserWarning)
        with Trace() as tr:
            with P.span("tumseg.serve.scene", 0):
                with P.span("tumseg.serve.finish"):
                    torch.ones(8).sum()
    names = {e.name() for e in tr.prof.profiler.kineto_results.events()}
    assert {"tumseg.serve.scene", "tumseg.serve.finish"} <= names
