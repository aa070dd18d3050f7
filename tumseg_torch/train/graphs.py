"""CUDA graphs of the training engine's steps: the port's counterpart of
``tumseg``'s ``jax.jit`` train and eval steps and of its ``lax.scan``
supersteps, k steps in one dispatch (``tumseg/train/loop.py:175-274``).

A step here is a function of device tensors that enqueues a fixed
sequence of work: for a room-id superstep the selection of its k batches,
then k forwards, losses, backwards and optimizer updates. :class:`StepGraphs`
runs such a function by key:

1. the first call of a key runs it eagerly on a side stream, the warm-up:
   a real step, which builds the kernels, makes the optimizer state and
   the stream's cuBLAS workspace, and runs under
   ``torch.cuda.set_sync_debug_mode("error")``, so an op that would read
   back to the host, which no capture can hold, raises there by name;
2. the second call captures the function on that stream into a graph with
   a private memory pool, from static copies of its inputs, with every
   generator it draws from registered with the graph;
3. that call and every later one copy their inputs into the static ones
   and replay the graph on the current stream: one dispatch.

A replay equals the eager step bit for bit: the same kernels run on the
same memory in the same order. A registered generator's draws start, in a
replay, at the offset that the generator has at that moment, as an eager
draw would start, and advance it by what the capture drew
(``CUDAGraph.register_generator_state``); re-seeding a generator between
replays and drawing from it outside the graph both work as in eager code.

A graph reads and writes the memory that its tensors had at capture: the
parameters, buffers, optimizer state, learning rate and loss weights.
``bindings`` gives those tensors' addresses; when they differ from the
last call's (a tensor replaced rather than written in place, as
``load_optimizer_leaves`` replaces the optimizer state), every graph is
dropped, to be warmed up and captured again. Python values that the
function reads at capture (the model's mode, the compute dtype, the ops
switches) belong in the key. A failed capture raises; nothing falls back
to eager.
"""

from __future__ import annotations

import warnings
from typing import (Callable, Dict, Hashable, List, NamedTuple, Sequence,
                    Tuple)

import torch

from tumseg_torch.ops import kernels


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]      # static copies, written before a replay
    outputs: Tuple[torch.Tensor, ...]
    launches: tuple                 # kernels.capturing()'s tallies


class StepGraphs:
    """The CUDA graphs of one engine's steps on ``device``. ``captures``
    and ``replays`` count the graphs captured and the replays run."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphs: Dict[Hashable, _Graph] = {}
        self._warm = set()
        self._bindings = None
        self._stream = None
        self.captures = 0
        self.replays = 0

    def check_bindings(self, addresses: Tuple) -> None:
        """Drops every graph, its memory pool and its warm-up when
        ``addresses`` differ from those the graphs were captured with: the
        next call of each key warms up and captures again."""
        if addresses != self._bindings:
            self.graphs.clear()
            self._warm.clear()
            self._bindings = addresses

    def run(self, key: Hashable, fn: Callable, inputs: Sequence[torch.Tensor],
            generators: Sequence[torch.Generator],
            bindings: Callable[[], Tuple]) -> Tuple[torch.Tensor, ...]:
        """``fn(*inputs)`` -> a tuple of tensors, as the graph of ``key``
        (see the module's docstring). ``generators`` are those that ``fn``
        draws from; ``bindings()`` the addresses of what it touches."""
        self.check_bindings(bindings())
        entry = self.graphs.get(key)
        if entry is None:
            if key not in self._warm:
                out = self._warm_up(fn, inputs)
                self._warm.add(key)
                # a warm-up writes in place; it only adds what did not
                # exist (the optimizer state, at the first step)
                self._bindings = bindings()
                return out
            entry = self.graphs[key] = self._capture(key, fn, inputs,
                                                     generators)
        for static, given in zip(entry.inputs, inputs):
            static.copy_(given)
        entry.graph.replay()
        kernels.replayed(entry.launches)
        self.replays += 1
        # the next replay overwrites the static outputs
        return tuple(t.clone() for t in entry.outputs)

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _warm_up(self, fn, inputs):
        stream = self._side_stream()
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():
            # "a prototype feature": it misses some syncs, and the capture
            # that follows fails on any
            warnings.filterwarnings("ignore", "Synchronization debug mode")
            try:
                with torch.cuda.stream(stream):
                    torch.cuda.set_sync_debug_mode("error")
                    out = fn(*inputs)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        current.wait_stream(stream)
        return out

    def _capture(self, key, fn, inputs, generators) -> _Graph:
        static = [t.clone() for t in inputs]
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        try:
            with kernels.capturing() as launches:
                with torch.cuda.graph(graph, stream=self._side_stream(),
                                      capture_error_mode="global"):
                    outputs = fn(*static)
        except Exception as e:
            raise RuntimeError(f"capturing the {key[0]} step {key[1:]} as a "
                               f"CUDA graph failed: {e}") from e
        self.captures += 1
        return _Graph(graph, static, outputs, launches)
