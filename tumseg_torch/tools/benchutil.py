"""What the port's benches share (``voting_bench``, ``train_sustained``,
``sampler_probe``, ``breakdown``, ``serve_probe3``, ``roofline``): the
device from ``--gpu``, the card's line, CUDA-event timers and the
summary of a bench's runs.

Every bench runs on ``cuda:<gpu>`` (``--gpu 0`` by default) and on the CPU
only with ``--gpu cpu``, through the CLIs' device resolution. On the card
it times with CUDA events on the current stream, the device drained before
the first event and after the last; on the CPU, where there are no events,
with ``time.perf_counter``. Its first line is the card's name and power
limit as ``nvidia-smi`` gives them, so every time it prints is that
card's."""

from __future__ import annotations

import json
import subprocess
import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from tumseg_torch.cli.test import resolve_device

CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


def add_gpu_arg(ap) -> None:
    ap.add_argument("--gpu", default="0",
                    help="CUDA device index, or 'cpu'")


def device_of(gpu: str) -> torch.device:
    """``cuda:<gpu>``, or the CPU for ``--gpu cpu``; raises without a CUDA
    device otherwise (``tumseg_torch.cli.test.resolve_device``)."""
    device = resolve_device(gpu)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        # full f32 everywhere, as the entry points keep it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def print_card(device: torch.device) -> None:
    """Prints the card's name and power limit (``nvidia-smi``'s line of the
    device's index), or what the CPU run is."""
    line = "cpu (no card: every time below is the CPU's)"
    if device.type == "cuda":
        out = subprocess.run(CARD_QUERY, capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()
        line = out[device.index or 0]
    print(line, flush=True)


def emit(line: Dict) -> Dict:
    """Prints one JSON line and returns it."""
    print(json.dumps(line), flush=True)
    return line


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def elapsed_ms(device: torch.device, fn: Callable[[], object]) -> float:
    """Milliseconds of ``fn()``: CUDA events around it on the current
    stream (the device drained before and after), or ``perf_counter`` on
    the CPU."""
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end)


def mean_ms(device: torch.device, fn: Callable[[], object],
            reps: int) -> float:
    """The mean milliseconds of one of ``reps`` calls of ``fn`` run back to
    back between two events."""
    def calls():
        for _ in range(reps):
            fn()
    return elapsed_ms(device, calls) / reps


def summary(runs: Sequence[float]) -> Dict[str, object]:
    """Every run, their median and their minimum."""
    runs = [float(r) for r in runs]
    return {"runs": runs, "median": float(np.median(runs)),
            "min": float(min(runs))}


def captured(device: torch.device, fn: Callable, inputs=(), generators=()):
    """A callable that runs ``fn(*inputs)`` (which returns a tuple of
    tensors): on the card the replay of its CUDA graph, warmed up and
    captured by ``StepGraphs`` with ``generators`` registered, so each
    replay draws anew; on the CPU ``fn`` itself.

    The graph reads the addresses of what ``fn``'s closure holds and of
    the ``StepGraphs``' static copies, so the callable holds ``fn`` and
    the ``StepGraphs`` for as long as it lives: a caller may drop its own
    references, and the memory is not handed to another tensor while a
    replay still reads it."""
    if device.type != "cuda":
        return lambda: fn(*inputs)
    from tumseg_torch.utils.graphs import StepGraphs

    graphs = StepGraphs(device)
    for _ in range(2):   # the warm-up, then the capture and a replay
        graphs.run(("bench",), fn, inputs, generators, tuple)
    entry = graphs.graphs[("bench",)]

    def replay():
        entry.graph.replay()

    replay.program = (graphs, fn, inputs)
    return replay


def repeat_ms(device: torch.device, fn: Callable[[], object], reps: int,
              runs: int = 3) -> List[float]:
    """``runs`` runs of :func:`mean_ms` after one warm-up call."""
    fn()
    return [mean_ms(device, fn, reps) for _ in range(runs)]
