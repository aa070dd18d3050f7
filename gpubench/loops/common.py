"""What both loops share: seeds derived from the run's seed, the device's
memory and the window's clock."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from gpubench import trace as T


def derived(seed: int, *purpose: int) -> int:
    """A 63-bit seed for one purpose of the run's ``seed``."""
    state = np.random.SeedSequence([int(seed), *purpose])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    """Starts the peak of device memory afresh: the harness's own bulk
    making of inputs is not the program's."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


class Window:
    """The measured window: its start, its end and, with ``trace``, the
    profiler around it and the ``gpubench.window`` range that marks it."""

    def __init__(self, device, trace: bool):
        self.device, self.tracing = device, trace
        self.trace = T.Trace() if trace else None
        self.start = self.end = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        if self.trace is not None:
            self._stack.enter_context(self.trace)
            self._stack.enter_context(
                torch.profiler.record_function(T.WINDOW))
        sync(self.device)
        self.start = time.perf_counter()
        return self

    def close(self) -> float:
        """Waits for the device and ends the window; -> its seconds."""
        sync(self.device)
        self.end = time.perf_counter()
        self._stack.close()
        self.stop_s = time.perf_counter() - self.end
        return self.end - self.start

    def __exit__(self, *exc):
        if self.end is None:
            self._stack.close()
        return False

    def reduced(self):
        if self.trace is None:
            return None
        t0 = time.perf_counter()
        out = self.trace.reduce()
        out["stop_s"] = self.stop_s
        out["reduce_s"] = time.perf_counter() - t0
        return out
