"""Profiling (``tumseg/utils/profiling.py``) on ``torch.profiler``:

- ``trace(logdir)``: a context manager that profiles the CPU and, where
  there is one, the CUDA device, and writes a Chrome trace into ``logdir``
  (viewable in ``chrome://tracing`` or Perfetto); it yields the profiler,
  whose ``key_averages()`` give the same events by name;
- ``annotate(name)``: a named range, a ``record_function`` that the trace
  shows on the host timeline, plus an NVTX range when CUDA is available;
- ``StepTimer``: per-step wall timing with points/sec accounting;
- ``device_fence(x=None)``: waits for the queued device work, on ``x``'s
  CUDA device or the current one.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import torch


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


@contextlib.contextmanager
def annotate(name: str):
    """A named range in profiler timelines (and in NVTX on CUDA)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def device_fence(x: Optional[torch.Tensor] = None) -> None:
    """Wait until the queued work of ``x``'s CUDA device (default: the
    current one) has finished; a no-op on the CPU, where work is done when
    it returns."""
    if x is not None and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    elif x is None and torch.cuda.is_available():
        torch.cuda.synchronize()


class StepTimer:
    """Accumulates per-step durations and derives throughput."""

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
