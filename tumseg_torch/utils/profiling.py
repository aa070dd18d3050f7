"""Profiling (``tumseg/utils/profiling.py``) on ``torch.profiler``:

- ``trace(logdir)``: a context manager that profiles the CPU and, where
  there is one, the CUDA device, and writes a Chrome trace into ``logdir``
  (viewable in ``chrome://tracing`` or Perfetto); it yields the profiler,
  whose ``key_averages()`` give the same events by name;
- ``span(name, request=None)``: the program's spans (below); ``annotate``
  is the same function under its earlier name;
- ``span_totals(within=None)``, ``span_records()``, ``reset_spans()``: the
  spans' in-memory store;
- ``readback(t)`` and ``upload(a, device)``: the blocking copies to the
  host and to the device, as the spans ``tumseg.readback`` and
  ``tumseg.upload``;
- ``WaitedLock``: a lock whose acquiring is the span ``tumseg.lock.wait``;
- ``StepTimer``: per-step host timing with points/sec accounting. It reads
  the host's clock only: on a CUDA device, where work is queued and the
  call returns, it times the host's enqueue unless the caller fences
  (``device_fence``) before ``stop``;
- ``device_fence(x=None)``: waits for the queued device work, on ``x``'s
  CUDA device or the current one.

A span is a named interval of the host's work. It records only while a
``torch.profiler`` session runs, ``trace(logdir)`` or a benchmark's traced
window, gated on PyTorch's process-wide flag of a running profiler, which
every thread reads; with no profiler running ``span`` checks that flag and
returns a shared no-op context. A recording span:

- opens a ``record_function`` range of its name, which puts it on the
  profiler's timeline beside the device's work (a thread that started
  before the profiler, such as a pool's worker, reaches only the store
  below), and an NVTX range of its name once CUDA is initialized;
- on exit adds to the store, per name: the count, the total host seconds
  and the self seconds (its duration less what its child spans on the same
  thread covered); totals are also kept per enclosing span name
  (``span_totals(within=...)``); and appends a record of its name, parent,
  request id, thread, start and seconds to a bounded log
  (``span_records()``, the last ``RECORDS_KEPT``);
- takes the request id it is given (the scene index while serving, a call's
  first step count while training), or else its parent's.

A span makes no CUDA call, no synchronization and no device allocation, so
it may run while another thread captures a CUDA graph.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

RECORDS_KEPT = 1 << 16


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write its Chrome trace to
    ``logdir/trace_<pid>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}.json"))


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]     # the enclosing span's name on the thread
    request: object
    thread: int               # threading.get_ident()
    start: float              # time.perf_counter() at entry
    seconds: float
    self_seconds: float


class _Store:
    """The spans recorded since the last :func:`reset_spans`."""

    def __init__(self):
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        with self.lock:
            # (enclosing name or None, name) -> [count, seconds, self s]
            self.totals: Dict[tuple, List[float]] = {}
            self.records = collections.deque(maxlen=RECORDS_KEPT)

    def add(self, span: "_Span", seconds: float) -> None:
        own = seconds - span.children
        keys = {(None, span.name)}
        up = span.parent
        while up is not None:
            keys.add((up.name, span.name))
            up = up.parent
        with self.lock:
            for key in keys:
                t = self.totals.setdefault(key, [0, 0.0, 0.0])
                t[0] += 1
                t[1] += seconds
                t[2] += own
            self.records.append(SpanRecord(
                span.name, None if span.parent is None else span.parent.name,
                span.request, threading.get_ident(), span.t0, seconds, own))


_store = _Store()
_open = threading.local()       # .stack: this thread's open spans


class _Span:
    __slots__ = ("name", "request", "parent", "children", "t0", "_range",
                 "_nvtx")

    def __init__(self, name: str, request):
        self.name, self.request = name, request

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        if self.request is None and self.parent is not None:
            self.request = self.parent.request
        self.children = 0.0
        self._nvtx = torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        _open.stack.pop()
        self._range.__exit__(*exc)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self.parent is not None:
            self.parent.children += seconds
        _store.add(self, seconds)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, request=None):
    """A context manager: the span ``name`` (see the module's docstring)
    while a profiler runs, else a no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, request)


annotate = span


def span_totals(within: Optional[str] = None) -> Dict[str, Dict[str, float]]:
    """``{name: {"count", "seconds", "self_seconds"}}`` of the spans
    recorded since :func:`reset_spans`; with ``within``, only the spans
    that ran inside a span of that name on their thread."""
    with _store.lock:
        return {name: {"count": t[0], "seconds": t[1], "self_seconds": t[2]}
                for (outer, name), t in _store.totals.items()
                if outer == within}


def span_records() -> List[SpanRecord]:
    """The last ``RECORDS_KEPT`` spans recorded, in the order they ended."""
    with _store.lock:
        return list(_store.records)


def reset_spans() -> None:
    """Empties the store."""
    _store.reset()


def readback(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``, which waits for the device's queued work and copies
    ``t`` to the host, as the span ``tumseg.readback`` (on the CPU the same
    call, which copies nothing)."""
    with span("tumseg.readback"):
        return t.cpu()


def upload(a, device) -> torch.Tensor:
    """``torch.as_tensor(a, device=device)`` as the span ``tumseg.upload``.
    From pageable host memory the copy waits for the device's queued work
    before it starts, so the span is mostly that wait."""
    with span("tumseg.upload"):
        return torch.as_tensor(a, device=device)


class WaitedLock:
    """A ``threading.Lock`` for ``with``, whose acquiring is the span
    ``tumseg.lock.wait``."""

    def __init__(self):
        self._lock = threading.Lock()

    def __enter__(self):
        with span("tumseg.lock.wait"):
            self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


def device_fence(x: Optional[torch.Tensor] = None) -> None:
    """Wait until the queued work of ``x``'s CUDA device (default: the
    current one) has finished; a no-op on the CPU, where work is done when
    it returns."""
    if x is not None and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    elif x is None and torch.cuda.is_available():
        torch.cuda.synchronize()


class StepTimer:
    """Accumulates per-step host durations and derives throughput. On a
    CUDA device a step's duration is the host's enqueue of its work unless
    the step ends in ``device_fence``."""

    def __init__(self, points_per_step: int):
        self.points_per_step = points_per_step
        self.durations: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        assert self._t0 is not None, "start() not called"
        dt = time.perf_counter() - self._t0
        self.durations.append(dt)
        self._t0 = None
        return dt

    @contextlib.contextmanager
    def step(self):
        self.start()
        yield
        self.stop()

    @property
    def mean_step_time(self) -> float:
        return sum(self.durations) / max(len(self.durations), 1)

    @property
    def points_per_sec(self) -> float:
        m = self.mean_step_time
        return self.points_per_step / m if m > 0 else 0.0

    def report(self) -> str:
        return (f"steps={len(self.durations)} "
                f"mean={self.mean_step_time * 1e3:.2f}ms "
                f"points/sec={self.points_per_sec:,.0f}")
