"""The device trace of a run's window (``--trace 1``): ``torch.profiler``
with CPU and CUDA activity, reduced to what the per-layer readers and the
result's ``device`` and ``breakdown`` take.

- ``window_s``: the length of the window, the span of the harness's
  ``gpubench.window`` range;
- ``busy_s``: the length of the union of the device operations' intervals
  (kernels, copies, sets) inside the window;
- ``kernels``: every device operation's (name, seconds), for the readers;
- ``device_ops``: the ten names that took the most device time;
- ``idle_gaps``: the ten longest gaps between device operations inside the
  window, each named by the host event that overlaps it most, the
  shortest of those that overlap it as much (the harness's ranges, the
  program's ops and the CUDA runtime's calls).
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

WINDOW = "gpubench.window"
# the port's point kernels (tumseg_torch/csrc), by their device names
POINT_KERNEL = re.compile(
    r"(?<![A-Za-z0-9_])(fps|ball_query|fused_ball_group|group|group_backward|"
    r"interpolate_backward|three_nn_interpolate)_kernel(?![A-Za-z0-9_])")


# a device kernel's family -> the program's launch counters that run it
FAMILIES = {"fps": ("fps",), "ball_query": ("ball_query", "ball_query_multi"),
            "fused_ball_group": ("fused_ball_group",), "group": ("group",),
            "group_backward": ("group_backward",),
            "interpolate_backward": ("interpolate_backward",),
            "three_nn_interpolate": ("three_nn_interpolate",
                                     "three_nn_window")}


class Trace:
    """A profiler session; :meth:`reduce` after it has stopped."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def reduce(self) -> Dict:
        events = self.prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        window = None
        dev: List[Tuple[int, int, str]] = []
        host: List[Tuple[int, int, str]] = []
        for e in events:
            start, end, name = e.start_ns(), e.end_ns(), e.name()
            if e.device_type() == cuda:
                # a range's copy on the device timeline is no operation
                if not e.is_user_annotation() and name != WINDOW:
                    dev.append((start, end, name))
            elif name == WINDOW:
                window = (start, end)
            else:
                host.append((start, end, name))
        if window is None:
            raise RuntimeError("the trace holds no gpubench.window range")
        w0, w1 = window
        dev = sorted((max(s, w0), min(t, w1), n) for s, t, n in dev
                     if t > w0 and s < w1)
        merged: List[List[int]] = []
        for s, t, _ in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        busy = sum(t - s for s, t in merged)
        gaps, prev = [], w0
        for s, t in merged:
            if s > prev:
                gaps.append((s - prev, prev, s))
            prev = max(prev, t)
        if w1 > prev:
            gaps.append((w1 - prev, prev, w1))
        gaps.sort(reverse=True)
        by_name = defaultdict(int)
        for s, t, n in dev:
            by_name[n] += t - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {
            "window_s": (w1 - w0) / 1e9,
            "busy_s": busy / 1e9,
            "kernels": [(n, (t - s) / 1e9) for s, t, n in dev],
            "device_ops": [[n, v / 1e9] for n, v in top],
            "idle_gaps": [[_host_name(host, a, b), g / 1e9]
                          for g, a, b in gaps[:10]],
        }


def _host_name(host, a: int, b: int) -> str:
    """The host event that overlaps [a, b] the longest."""
    best, name = (0, 0), "nothing traced on the host"
    for s, t, n in host:
        over = (min(t, b) - max(s, a), s - t)
        if over[0] > 0 and over > best:
            best, name = over, n
    return name


def point_kernels(kernels) -> Dict[str, Tuple[int, float]]:
    """(launches, device seconds) of each family of point kernels."""
    out: Dict[str, Tuple[int, float]] = {}
    for name, s in kernels:
        m = POINT_KERNEL.search(name)
        if m:
            n, secs = out.get(m.group(1), (0, 0.0))
            out[m.group(1)] = (n + 1, secs + s)
    return out
