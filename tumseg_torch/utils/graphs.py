"""CUDA graphs of the port's device programs: the counterparts of
``tumseg``'s ``jax.jit`` programs. The training engine runs its train and
eval steps and its ``lax.scan`` supersteps, k steps in one dispatch
(``tumseg/train/loop.py:175-274``), through them; the serving runner its
B-block forward, each vote's chunks and its re-blocking
(``tumseg/infer/voting.py:134-188, 250-316, 480-592``).

A program here is a function of device tensors that enqueues a fixed
sequence of work: for a room-id superstep the selection of its k batches,
then k forwards, losses, backwards and optimizer updates; for a vote's
chunk its featurization, forward, argmax and vote. :class:`StepGraphs`
runs such a function by key:

1. the first call of a key runs it eagerly on a side stream, the warm-up:
   a real call, which builds the kernels, makes the optimizer state and
   the stream's cuBLAS workspace, and runs under
   ``torch.cuda.set_sync_debug_mode("error")``, so an op that would read
   back to the host, which no capture can hold, raises there by name;
2. the second call captures the function on that stream into a graph with
   a private memory pool, from static copies of its inputs, with every
   generator it draws from registered with the graph;
3. that call and every later one copy their inputs into the static ones
   and replay the graph on the current stream: one dispatch.

A replay equals the eager call bit for bit: the same kernels run on the
same memory in the same order. A registered generator's draws start, in a
replay, at the offset that the generator has at that moment, as an eager
draw would start, and advance it by what the capture drew
(``CUDAGraph.register_generator_state``); re-seeding a generator between
replays and drawing from it outside the graph both work as in eager code.

A graph reads and writes the memory that its tensors had at capture: the
parameters, buffers, optimizer state, learning rate and loss weights of a
step; the weights, the scene, its grid and the vote pool of a serving
program. ``bindings`` gives those tensors' addresses; when they differ from
the last call's (a tensor replaced rather than written in place, as
``load_optimizer_leaves`` replaces the optimizer state, or another scene
voted), every graph is dropped, to be warmed up and captured again. Python
values that the function reads at capture (the model's mode, the compute
dtype, the ops switches, a scene's shapes) belong in the key. A failed
capture raises; nothing falls back to eager.

The sync check of a warm-up holds for the whole process, and a capture
forbids a sync from any thread. So ``lock``, where given, is held through
every warm-up and capture, and a thread that does device work beside the
programs (the serving runner's prefetch, which uploads the next scene)
holds it around that work.

On a ``mesh`` whose collectives can be captured (NCCL on a CUDA device,
``Mesh.capturable``) a program holds its collectives, the counterpart of a
``jax.jit(shard_map(...))`` program with its ``psum``s inside. Such a
program needs three things, which :class:`StepGraphs` states and enforces:

- the communicator exists before the first capture (NCCL makes it at a
  group's first collective, with allocations and syncs that no capture can
  hold): the engine's ``broadcast_state`` at construction and every key's
  eager warm-up make it, and the key check below runs a collective first;
- every rank warms up and captures the same keys on the same call, or one
  rank's captured all-reduce would meet another rank's eager one. The
  keys hold no rank-dependent value, every rank rebinds on the same call
  (a ``load_state`` runs on all of them), and before each warm-up and capture
  the ranks compare a digest of the key (:func:`agree_on_key`: a Python
  value is described by its type where its repr would differ between
  ranks); a rank that differs raises on every rank, before any of them
  enqueues the program;
- nothing in another thread breaks the capture. ``ProcessGroupNCCL``'s
  watchdog thread queries the events of the eager collectives it tracks,
  which a capture in ``"global"`` mode forbids to every thread. On the
  card (torch 2.11, NCCL 2.28) global captures of the mesh's steps held all
  the same, with the async error handling on and off; the watchdog's
  behaviour is PyTorch's, though, and may change. So a mesh's captures run
  in ``"thread_local"`` mode (:data:`MESH_CAPTURE_MODE`): the capturing
  thread is still held to capture's rules, the watchdog's queries are not,
  and the runner's prefetch, the one other thread that touches the
  device, is held out by ``lock``. The key check's readback also completes
  every eager collective before a capture begins.

A failed capture raises on a mesh as well; nothing falls back to eager.
"""

from __future__ import annotations

import contextlib
import hashlib
import time
import warnings
from typing import (Callable, Dict, Hashable, List, NamedTuple, Sequence,
                    Tuple)

import torch

from tumseg_torch.ops import kernels
from tumseg_torch.utils.profiling import span


# the capture mode of a mesh's programs: see the module's docstring
MESH_CAPTURE_MODE = "thread_local"


def describe_key(value) -> str:
    """A program key as every rank sees it: numbers, strings, dtypes, None
    and tuples by their repr, any other object (a generator, a sampler) by
    its type alone."""
    if isinstance(value, (tuple, list)):
        return "(" + ", ".join(describe_key(v) for v in value) + ")"
    if value is None or isinstance(value, (bool, int, float, str,
                                           torch.dtype)):
        return repr(value)
    return type(value).__name__


def agree_on_key(mesh, phase: str, key: Hashable) -> None:
    """Raises on every rank of ``mesh`` unless all of them call this with
    the same ``phase`` ("warm-up", "capture") and key (by
    :func:`describe_key`): rank 0's digest is broadcast, and a count of the
    ranks that differ is all-reduced and read back."""
    text = f"{phase} {describe_key(key)}"
    digest = int.from_bytes(hashlib.sha256(text.encode()).digest()[:7],
                            "little")
    mine = torch.tensor([digest], dtype=torch.int64, device=mesh.device)
    first = mesh.broadcast_(mine.clone())
    differ = mesh.all_reduce_((first != mine).to(torch.int64))
    if int(differ.item()):
        raise RuntimeError(
            f"rank {mesh.rank}: {int(differ.item())} of the {mesh.size} "
            f"ranks would {phase} another program than rank 0 here; this "
            f"rank's is {text}")


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]      # static copies, written before a replay
    outputs: Tuple[torch.Tensor, ...]
    launches: tuple                 # kernels.capturing()'s tallies


class StepGraphs:
    """The CUDA graphs of one engine's or runner's programs on ``device``.
    ``warmups``, ``captures`` and ``replays`` count the eager first calls,
    the graphs captured and the replays run; ``capture_seconds`` is the
    host time of the captures. Under a profiler, :meth:`run` and each
    warm-up, capture, replay and drop of graphs is a span
    (``tumseg_torch.utils.profiling``): ``tumseg.graphs.run``,
    ``.warmup``, ``.capture``, ``.replay``, ``.drop``; the replay's span is
    mostly the launch's wait for room in the device's queue. ``lock`` and
    ``mesh`` (a capturable mesh whose collectives the programs hold): see
    the module's docstring."""

    def __init__(self, device, lock=None, mesh=None):
        if mesh is not None and not mesh.capturable:
            raise ValueError(f"the collectives of {mesh} cannot be captured "
                             f"into a CUDA graph: run its programs eagerly")
        self.device = torch.device(device)
        self.lock = contextlib.nullcontext() if lock is None else lock
        self.mesh = mesh
        self.capture_mode = "global" if mesh is None else MESH_CAPTURE_MODE
        self.graphs: Dict[Hashable, _Graph] = {}
        self._warm = set()
        self._bindings = None
        self._stream = None
        self.warmups = 0
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0

    def check_bindings(self, addresses: Tuple) -> None:
        """Drops every graph, its memory pool and its warm-up when
        ``addresses`` differ from those the graphs were captured with: the
        next call of each key warms up and captures again."""
        if addresses != self._bindings:
            with span("tumseg.graphs.drop"):
                self.graphs.clear()
                self._warm.clear()
            self._bindings = addresses

    def run(self, key: Hashable, fn: Callable, inputs: Sequence[torch.Tensor],
            generators: Sequence[torch.Generator],
            bindings: Callable[[], Tuple]) -> Tuple[torch.Tensor, ...]:
        """``fn(*inputs)`` -> a tuple of tensors, as the graph of ``key``
        (see the module's docstring). ``generators`` are those that ``fn``
        draws from; ``bindings()`` the addresses of what it touches."""
        with span("tumseg.graphs.run"):
            self.check_bindings(bindings())
            entry = self.graphs.get(key)
            if entry is None:
                if self.mesh is not None:
                    agree_on_key(self.mesh, "capture" if key in self._warm
                                 else "warm-up", key)
                if key not in self._warm:
                    with self.lock, span("tumseg.graphs.warmup"):
                        out = self._warm_up(fn, inputs)
                    self._warm.add(key)
                    self.warmups += 1
                    # a warm-up writes in place; it only adds what did not
                    # exist (the optimizer state, at the first step)
                    self._bindings = bindings()
                    return out
                with self.lock, span("tumseg.graphs.capture"):
                    entry = self.graphs[key] = self._capture(
                        key, fn, inputs, generators)
            for static, given in zip(entry.inputs, inputs):
                static.copy_(given)
            with span("tumseg.graphs.replay"):
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
        t0 = time.perf_counter()
        static = [t.clone() for t in inputs]
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        try:
            with kernels.capturing() as launches:
                with torch.cuda.graph(graph, stream=self._side_stream(),
                                      capture_error_mode=self.capture_mode):
                    outputs = fn(*static)
        except Exception as e:
            raise RuntimeError(f"capturing the {key[0]} program {key[1:]} as "
                               f"a CUDA graph failed: {e}") from e
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return _Graph(graph, static, outputs, launches)
