"""Whole-scene voting inference (``tumseg/infer/voting.py``).

For each scene, ``num_votes`` random re-blockings run through the model in
``batch_size`` chunks and every point's class votes pool on the device; the
label is the argmax of the pool, and per-class IoU is tallied against the
scene's ground truth. Three paths, chosen as ``tumseg`` chooses them:

- device re-blocking (the default on CUDA, ``tumseg``'s path on its
  accelerator): the scene's columns and its grid structure are uploaded
  once; each vote fills and shuffles the grid cells on the device
  (:func:`reblock_on_device`), then each B-block chunk is featurized on the
  device, forwarded, and its argmax votes are added into a flat
  ``[(n + 1) * C]`` pool (row ``n`` is the dump row of padding blocks);
- device featurization: host ``grid_indices`` every vote (the next one
  drawn on a worker thread), the same device featurization and vote;
- host re-blocking: ``TestGridDataset.__getitem__`` builds the feature
  blocks on the host (the next vote's on a worker thread).

``compute_dtype`` (e.g. ``torch.bfloat16``) runs every forward in that
compute dtype and, as ``tumseg``'s runner passes only the compute dtype,
with the single-pass bf16 gathers (``tumseg/infer/voting.py:250-252``).

With a ``mesh`` (``tumseg_torch.parallel``, one process a device;
``tumseg/infer/voting.py:255-270, 561-583``), every rank forwards its
contiguous share of a vote's blocks (padded to a multiple of
``batch_size``), ``batch_size / size`` blocks a forward, into a zero local
pool increment, and one all-reduce adds the increment to the pool on every
rank (:meth:`InferenceRunner._reduce_vote`); the carried pool itself is
never reduced. Vote counts are small integers in f32, so the order of the
sums cannot change the pool. On the host-drawn paths (host re-blocking,
device featurization) rank 0 draws the vote's blocks and broadcasts them,
so the ranks vote on one re-blocking; on device re-blocking every rank
draws the same ``(seed, scene, vote)`` stream.

On a CUDA device every serving program runs as a CUDA graph
(:class:`tumseg_torch.utils.graphs.StepGraphs`), the counterparts of
``tumseg``'s ``jax.jit`` programs: the B-block forward of
:meth:`InferenceRunner.predict_blocks` (``jax.jit(forward)``,
``tumseg/infer/voting.py:250-272``), each chunk of a vote (featurize,
forward, argmax and the vote into the pool on the device paths, the body
of ``_vote_scan_fn``'s scan, ``:480-540``; forward, argmax and
:func:`_scatter_votes` on the host path) and each vote's re-blocking
(``_reblock_on_device``, ``:134-188``). The first call of a program's key
runs eagerly, the second is captured, every later one is one replay, bit
for bit the eager call. The graphs bind the weights, the scene's tensors,
its grid and the pool: another scene drops and captures them again, so a
scene of V votes in NB blocks costs one warm-up and one capture of its
chunk and of its re-blocking. ``cuda_graphs=False``, the counterpart of
``jax.disable_jit``, serves eagerly. Every program runs under
``torch.inference_mode``.

On an NCCL mesh of CUDA devices (``Mesh.capturable``) each vote's
all-reduce of the increment and its add into the pool are one more program,
``vote_reduce``: one replay a vote on all three paths, the ``psum(inc)``
that ``tumseg``'s vote program holds (``:561-583``). The host draws'
broadcasts stay outside the graphs, and so does :meth:`predict_blocks`'
all-reduce of the labels, read back at once. On a gloo mesh (the CPU, or
ranks that share one card) the all-reduce runs eagerly between the chunk
programs: gloo's collectives cannot be captured.

The TPU's scene-shape buckets and block granules
(``tumseg/infer/voting.py:384-392``, ``:452-458``) are left out: they
exist to spare XLA recompiles, and PyTorch does not recompile. So is the
``TUMSEG_VOTE_SCATTER`` A/B of the vote accumulation (``voting.py:541-559``),
a TPU scatter-lowering choice; the port adds each chunk's votes as it goes,
``tumseg``'s "scan" mode.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tumseg_torch import ops
from tumseg_torch.data.dataset import _COLOR_FEATURES
from tumseg_torch.parallel.mesh import pad_to_multiple
from tumseg_torch.utils.graphs import StepGraphs
from tumseg_torch.utils.profiling import WaitedLock, readback, span, upload
from tumseg_torch.utils.progress import progress
from tumseg_torch.viz.writers import write_labels_txt, write_obj_pointcloud
from tumseg_torch.train import metrics as M


def _scatter_votes(pool: torch.Tensor, point_idx: torch.Tensor,
                   pred: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """pool [N_scene, C] (contiguous) += one_hot(pred) at point_idx where
    keep, in place: one ``index_add_`` of ``keep`` at ``idx * C + pred``
    into the flat pool (``index_put_`` reads its indices' range back to the
    host, which a CUDA graph cannot hold). Counts are integers below 2**24
    in f32, so the order of the atomic adds on the card cannot change the
    pool."""
    flat = (point_idx.reshape(-1).long() * pool.shape[1]
            + pred.reshape(-1).long())
    pool.view(-1).index_add_(0, flat, keep.reshape(-1).to(pool.dtype))
    return pool


def _pad_rows(a: np.ndarray, rows: int, fill=None) -> np.ndarray:
    """``a`` with its leading axis padded to ``rows``: its last row
    repeated, or rows of ``fill``."""
    short = rows - a.shape[0]
    if short <= 0:
        return a
    pad = (np.repeat(a[-1:], short, axis=0) if fill is None
           else np.full((short,) + a.shape[1:], fill, a.dtype))
    return np.concatenate([a, pad])


def vote_seed(seed: int, scene_idx: int, vote: int) -> int:
    """The seed of one vote's re-blocking draws: scenes and votes draw
    independently (``jax.random.fold_in`` in ``tumseg``)."""
    state = np.random.SeedSequence([seed, scene_idx, vote])
    return int(state.generate_state(1, np.uint64)[0])


def draw_vote(generator: torch.Generator, length: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The draws of one vote's :func:`reblock_on_device` from
    ``generator``: (u [L] f32 in [0, 1), keys [L] int64 below 2**32)."""
    device = generator.device
    u = torch.rand(length, generator=generator, device=device)
    keys = torch.randint(0, 2 ** 32, (length,), generator=generator,
                         device=device, dtype=torch.int64)
    return u, keys


def _build_reblock_arrays(cells, block_points: int):
    """Host-side one-time flats for DEVICE re-blocking: concatenate every
    cell's candidates padded to a block_points multiple (zeros in the
    shortfall slots, replaced on device by random in-cell picks). Region
    layout is static per scene, so after the in-cell shuffle the flat
    sequence reshapes straight into [NB, block_points] blocks.

    Cells are laid out GROUPED BY BLOCK COUNT (stable within a group) so
    the in-cell shuffle can run as per-group [n_cells, k*block_points]
    row sorts instead of one global composite-key sort. Block order is
    irrelevant to voting (the vote pool is a per-point scatter-add over all
    real blocks). Returns (..., segments, order): ``segments`` is a tuple
    of (blocks_per_cell, n_cells) runs describing the grouped layout;
    ``order`` maps layout position -> index into ``cells``
    (``tumseg/infer/voting.py:81-131``; the block offsets stay in the
    cells' f64, where ``tumseg`` rounds them to f32, see :func:`featurize`).
    """
    # grid_structure's contract: only non-empty cells are emitted — the
    # fill path divides by count, so an empty cell must fail loudly here
    # rather than silently vote foreign points (ValueError, not assert:
    # the check must survive `python -O`)
    if any(int(c[0].size) == 0 for c in cells):
        raise ValueError("empty grid cell passed to device re-blocking")
    nb_per_cell = [int(np.ceil(int(c[0].size) / block_points))
                   for c in cells]
    order = sorted(range(len(cells)), key=lambda i: nb_per_cell[i])
    segments = []
    for i in order:
        k = nb_per_cell[i]
        if segments and segments[-1][0] == k:
            segments[-1][1] += 1
        else:
            segments.append([k, 1])
    segments = tuple((k, n) for k, n in segments)

    sizes, counts, base_parts, offsets = [], [], [], []
    for i in order:
        point_idxs, s_x, s_y = cells[i]
        n = int(point_idxs.size)
        ps = nb_per_cell[i] * block_points
        buf = np.zeros(ps, np.int32)
        buf[:n] = point_idxs
        base_parts.append(buf)
        sizes.append(ps)
        counts.append(n)
        offsets.append(np.repeat([[s_x, s_y]], nb_per_cell[i], axis=0))
    flat_base = np.concatenate(base_parts).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    return (flat_base, starts, np.asarray(counts, np.int32),
            np.asarray(sizes, np.int32), np.concatenate(offsets, axis=0),
            segments, np.asarray(order, np.int64))


def reblock_on_device(u: torch.Tensor, keys: torch.Tensor,
                      flat_base: torch.Tensor, starts_pos: torch.Tensor,
                      counts_pos: torch.Tensor, block_points: int,
                      segments: Optional[Sequence[Tuple[int, int]]] = None,
                      cell_rank: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """One vote's re-blocking on the device (``tumseg/infer/voting.py:
    134-188``): fill each cell's shortfall slots with random in-cell
    candidates, then shuffle within each cell. -> [NB, block_points] int32.

    The randomness comes in as tensors: ``u`` [L] f32 uniforms in [0, 1)
    pick the fills (``min(int32(u * count), count - 1)``, pinned to 0 on
    member slots, as ``tumseg`` does) and ``keys`` [L] (integers below 2**32)
    order the shuffle. With ``segments`` (the grouped layout of
    :func:`_build_reblock_arrays`) each (blocks_per_cell, n_cells) run is
    one stable sort of its keys per cell row; without, one stable sort by
    (``cell_rank``, key), the global fallback. Fed ``tumseg``'s draws, the
    result equals ``tumseg``'s."""
    L = flat_base.shape[0]
    r = torch.minimum((u * counts_pos).to(torch.int32), counts_pos - 1)
    pos_in_cell = torch.arange(L, dtype=torch.int32,
                               device=flat_base.device) - starts_pos
    fill = pos_in_cell >= counts_pos
    r = torch.where(fill, r, 0)
    seq = torch.where(fill, flat_base[(starts_pos + r).long()], flat_base)
    keys = keys.to(torch.int64)
    if segments is not None:
        parts, off = [], 0
        for k_blocks, n_cells in segments:
            m = k_blocks * block_points
            rows = seq[off:off + n_cells * m].reshape(n_cells, m)
            perm = torch.sort(keys[off:off + n_cells * m].reshape(n_cells, m),
                              dim=1, stable=True).indices
            parts.append(torch.gather(rows, 1, perm).reshape(-1))
            off += n_cells * m
        shuffled = parts[0] if len(parts) == 1 else torch.cat(parts)
    else:
        composite = (cell_rank.to(torch.int64) << 32) | keys
        shuffled = seq[torch.sort(composite, stable=True).indices]
    return shuffled.reshape(-1, block_points)


def featurize(scene_xyz: torch.Tensor, scene_extra: torch.Tensor,
              coord_max: torch.Tensor, color_mask: torch.Tensor,
              idx: torch.Tensor, offsets: torch.Tensor,
              block_size: float) -> torch.Tensor:
    """The f32 model input of a chunk of blocks, gathered from the uploaded
    scene (``forward_featurized`` of ``tumseg/infer/voting.py:274-290``):
    idx [B, P] (in range), offsets [B, 2] -> [B, P, 6 + E]: xyz centred on
    the block's column, xyz / coord_max, then the extra columns, colours
    / 255.

    The channels are computed in the scene's own precision (f64 for LAS
    tiles, offsets taken to it) and rounded to f32 once at the end, as
    ``TestGridDataset.__getitem__`` computes them on the host: the device
    paths then hand the model the host path's inputs bit for bit. ``tumseg``
    computes them in f32, a last-ulp difference that is enough to move
    FPS and ball-query choices at near-ties, and so labels."""
    pts = scene_xyz[idx.long()]                                # [B, P, 3]
    normalized = pts / coord_max
    centre = offsets.to(pts.dtype) + block_size / 2.0          # [B, 2]
    centered = torch.cat([pts[..., :2] - centre[:, None, :], pts[..., 2:]],
                         dim=-1)
    feats = [centered, normalized]
    if scene_extra.shape[1]:
        extra = scene_extra[idx.long()]
        feats.append(torch.where(color_mask, extra / 255.0, extra))
    return torch.cat([f.to(torch.float32) for f in feats], dim=-1)


class _HostDraws:
    """The host draws of a scene's votes, ``draw(scene_idx)`` each, the
    next one drawn on a worker thread while a vote runs. On a ``mesh`` only
    rank 0 draws, and :meth:`next` broadcasts its arrays to every rank."""

    def __init__(self, draw, scene_idx: int, num_votes: int, mesh=None):
        self.draw, self.scene_idx, self.left = draw, scene_idx, num_votes
        self.mesh = mesh
        self.executor = self.fut = None
        if mesh is None or mesh.rank == 0:
            self.executor = ThreadPoolExecutor(max_workers=1)
            self.fut = self.executor.submit(draw, scene_idx)

    def next(self, dtypes):
        """The next vote's arrays, as ``dtypes`` on a mesh."""
        self.left -= 1
        arrays = [None] * len(dtypes)
        if self.fut is not None:
            arrays = self.fut.result()
            if self.left > 0:
                self.fut = self.executor.submit(self.draw, self.scene_idx)
        if self.mesh is None:
            return arrays
        return tuple(self.mesh.broadcast_array(a, d)
                     for a, d in zip(arrays, dtypes))

    def close(self) -> None:
        if self.executor is not None:
            self.executor.shutdown(wait=False)


class InferenceRunner:
    """Batched forward of an ``nn.Module`` on ``device`` + device vote
    pooling. The model is moved to ``device`` and put in eval mode.

    ``device_features`` ("auto"/True/False) builds each chunk's channels on
    the device from a once-uploaded scene; "auto" takes it on CUDA.
    ``device_reblock`` ("auto" follows ``device_features``) re-blocks on the
    device too, from draws of a ``torch.Generator`` seeded by
    ``(seed, scene, vote)``. ``window_ops`` ("auto" is off, as ``tumseg``
    measured it) takes the z-window 3-NN at fp1 inside the vote loop. True
    works on the CPU as well, with the plain ops. ``compute_dtype`` (None:
    f32) is the model's compute dtype, ``tumseg``'s ``--bf16``. With a
    ``mesh`` the runner runs on ``mesh.device`` (``device`` is not read)
    and ``batch_size`` must be a multiple of the mesh size.

    On a CUDA device each serving program runs as a CUDA graph
    (``self.graphs``, a :class:`StepGraphs`; see the module's docstring),
    on an NCCL mesh each vote's all-reduce too; ``cuda_graphs=False`` serves
    eagerly, bit for bit the same."""

    def __init__(self, model: torch.nn.Module, num_classes: int,
                 batch_size: int = 32, device="cuda", mesh=None,
                 compute_dtype=None, device_features="auto",
                 device_reblock="auto", window_ops="auto", seed: int = 0,
                 cuda_graphs: bool = True):
        if mesh is not None:
            if batch_size % mesh.size:
                raise ValueError(
                    f"batch_size {batch_size} must be a multiple of the "
                    f"mesh size {mesh.size} for sharded inference")
            device = mesh.device
        self.mesh = mesh
        # full f32 everywhere: TF32 would cost the parity with tumseg
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.num_classes = num_classes
        self.batch_size = batch_size
        if device_features == "auto":
            device_features = self.device.type == "cuda"
        self.device_features = bool(device_features)
        if device_reblock == "auto":
            device_reblock = self.device_features
        self.device_reblock = bool(device_reblock)
        if window_ops == "auto":
            window_ops = False
        self.window_ops = bool(window_ops)
        self.seed = int(seed)
        self._scene_cache = {}
        self._grid_cache = {}
        self._cache_lock = threading.Lock()
        # held by uploads, warm-ups and captures: see StepGraphs
        self._device_lock = WaitedLock()
        self.graphs = (StepGraphs(
            self.device, lock=self._device_lock,
            mesh=mesh if mesh is not None and mesh.capturable else None)
            if cuda_graphs and self.device.type == "cuda" else None)
        self._bound = {}        # name -> (address, shape) of bound tensors
        self._buffers = {}      # the pool and the mesh increment
        self._generator = None  # the vote draws', re-seeded each vote

    def _labels(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N] argmax labels of the model's forward of ``x``."""
        return self.model(x, compute_dtype=self.compute_dtype)[0].argmax(
            dim=-1)

    def _bind(self, **tensors) -> None:
        """Names the tensors, beside the weights, that the next programs
        read or write in place (a scene's tensors, its grid, the pool, the
        mesh increment; a value is a tensor, a sequence or None): a graph
        captured against other ones is dropped."""
        for name, value in tensors.items():
            if not isinstance(value, (tuple, list)):
                value = (value,)
            self._bound[name] = tuple((t.data_ptr(), tuple(t.shape))
                                      for t in value
                                      if isinstance(t, torch.Tensor))

    def _bindings(self) -> tuple:
        """The addresses of the tensors that a captured program reads or
        writes in place."""
        weights = tuple(t.data_ptr() for t in (*self.model.parameters(),
                                                *self.model.buffers()))
        return weights + tuple(sorted(self._bound.items()))

    def _run(self, key: tuple, fn, inputs=(), generators=()):
        """``fn(*inputs)`` under inference mode: eager, or the CUDA graph of
        ``key`` and of every Python value that the program reads."""
        with torch.inference_mode():
            if self.graphs is None:
                return fn(*inputs)
            key += (self.compute_dtype, ops.switches())
            return self.graphs.run(key, fn, inputs, generators,
                                   self._bindings)

    def _zeroed(self, name: str, shape) -> torch.Tensor:
        """The runner's f32 buffer ``name`` (the pool, the mesh increment)
        of ``shape``, zeroed: one buffer, kept while the shape holds and
        zeroed in place, so the address that the graphs bind stays put and
        a scene voted again keeps its graphs."""
        buf = self._buffers.get(name)
        with torch.inference_mode():
            if buf is None or tuple(buf.shape) != tuple(shape):
                buf = self._buffers[name] = torch.zeros(
                    shape, dtype=torch.float32, device=self.device)
            else:
                buf.zero_()
        return buf

    def _pool(self, shape) -> torch.Tensor:
        """The scene's pool, zeroed, bound with the mesh's increment (on a
        mesh, else none)."""
        pool = self._zeroed("pool", shape)
        self._bind(pool=pool, increment=None if self.mesh is None
                   else self._zeroed("increment", shape))
        return pool

    def _reduce_vote(self, pool: torch.Tensor,
                     increment: torch.Tensor) -> None:
        """pool += the increment summed over the mesh, in place: on a
        capturable mesh one program (key ``vote_reduce``), else eager."""
        def reduce():
            pool.add_(self.mesh.all_reduce_(increment))
            return ()

        if self.mesh.capturable:
            self._run(("vote_reduce", tuple(pool.shape)), reduce)
        else:
            with torch.inference_mode():
                reduce()

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N] argmax labels of ``x`` [B, N, C] f32 on the device, as one
        program (``jax.jit(forward)``)."""
        return self._run(("forward", tuple(x.shape)),
                         lambda x: (self._labels(x),), (x,))[0]

    def predict_blocks(self, scene_data: np.ndarray) -> np.ndarray:
        """scene_data [num_blocks, N, C] -> predicted labels [num_blocks, N].
        Pads the block axis up to a batch multiple; padded rows are dropped.
        On a mesh each rank predicts its share and one all-reduce of the
        zero-filled labels gives every rank all of them."""
        if self.mesh is None:
            preds = [p[:real].cpu().numpy()
                     for p, real in self._predict_chunks(scene_data)]
            return np.concatenate(preds, axis=0)
        nb = scene_data.shape[0]
        (padded,), rows, bs = self._share(scene_data)
        labels = torch.zeros(padded.shape[:2], dtype=torch.int64,
                             device=self.device)
        local = labels[rows]
        for ci, (pred, real) in enumerate(
                self._predict_chunks(padded[rows], bs)):
            local[ci * bs:ci * bs + real] = pred[:real]
        labels[rows] = local
        return self.mesh.all_reduce_(labels)[:nb].cpu().numpy()

    def _share(self, *blocks: np.ndarray):
        """The block arrays padded (last block repeated) to a multiple of
        ``batch_size``, this rank's rows of them, and its forward size."""
        padded = [pad_to_multiple(b, self.batch_size)[0] for b in blocks]
        return (padded, self.mesh.rows(padded[0].shape[0]),
                self.batch_size // self.mesh.size)

    def _predict_chunks(self, scene_data: np.ndarray, bs=None):
        """Yield (device predictions [bs, N] int64, real_rows) per chunk of
        ``bs`` blocks (default ``batch_size``); a short last chunk is padded
        by repeating its last block."""
        bs = bs or self.batch_size
        for s in range(0, scene_data.shape[0], bs):
            chunk = scene_data[s:s + bs]
            x = torch.as_tensor(
                np.ascontiguousarray(_pad_rows(chunk, bs), np.float32),
                device=self.device)
            yield self._forward(x), chunk.shape[0]

    def _cached(self, cache, dataset, scene_idx: int, build):
        """Per-scene device cache (``tumseg/infer/voting.py:338-381``). An
        entry holds the scene's source array, checked with ``is`` (an id()
        can be reused after garbage collection), so a replaced scene is
        rebuilt. At most two scenes are held: the one being voted and the
        one ``prefetch_scene`` stages meanwhile; only completed entries are
        evicted, oldest first. Entries are ``[src, value, done_event]``
        claimed under a lock, so two threads missing the same scene build it
        once: the loser waits on the event."""
        key = (id(dataset), scene_idx)
        src = dataset.scene_points_list[scene_idx]
        with self._cache_lock:
            entry = cache.get(key)
            owner = entry is None or entry[0] is not src
            if owner:
                entry = [src, None, threading.Event()]
                cache.pop(key, None)
                cache[key] = entry
                done = [k for k in cache
                        if k != key and cache[k][2].is_set()]
                while len(cache) > 2 and done:
                    cache.pop(done.pop(0), None)
        if owner:
            try:
                entry[1] = build()
            finally:
                entry[2].set()
            return entry[1]
        entry[2].wait()
        if entry[1] is None:
            # the owning thread's build raised; rebuild uncached so the
            # failure surfaces in THIS thread too
            with self._cache_lock:
                if cache.get(key) is entry:
                    cache.pop(key, None)
            return build()
        return entry[1]

    def _scene_tensors(self, dataset, scene_idx: int):
        """The scene's columns on the device, uploaded once, in the host
        arrays' own precision: (xyz [n, 3], extra [n, E], coord_max [3],
        color_mask [E] bool). Not padded to a bucket: the only extra row the
        votes touch is the pool's dump row."""
        def build():
            pts = np.ascontiguousarray(
                dataset.scene_points_list[scene_idx][:, :3])
            n = pts.shape[0]
            E = dataset.num_extra_features
            if E:
                extra = np.stack(
                    [np.asarray(c)
                     for c in dataset.extra_features_data[scene_idx]], axis=1)
                color_mask = np.array([name in _COLOR_FEATURES
                                       for name in dataset.feature_name],
                                      dtype=bool)
            else:
                extra = np.zeros((n, 0), dtype=pts.dtype)
                color_mask = np.zeros((0,), dtype=bool)
            with self._device_lock:
                return tuple(torch.as_tensor(a, device=self.device)
                             for a in (pts, extra, pts.max(axis=0),
                                       color_mask))

        return self._cached(self._scene_cache, dataset, scene_idx, build)

    def _grid_tensors(self, dataset, scene_idx: int):
        """The scene's grid structure, uploaded once: (flat_base, starts_pos,
        counts_pos [L] int32 and offsets [NB, 2] f64 on the device;
        cell_rank [L] int32 on the host, which only the global-sort fallback
        of :func:`reblock_on_device` reads; segments). Every vote then needs
        only its draws."""
        def build():
            cells = dataset.grid_structure(scene_idx)
            (flat_base, starts, counts, sizes, offsets, segments,
             _order) = _build_reblock_arrays(cells, dataset.block_points)
            dev = self.device
            cell_rank = np.repeat(np.arange(starts.shape[0], dtype=np.int32),
                                  sizes)
            with self._device_lock:
                sizes_t = torch.as_tensor(sizes.astype(np.int64), device=dev)
                starts_pos, counts_pos = (
                    torch.repeat_interleave(torch.as_tensor(a, device=dev),
                                            sizes_t,
                                            output_size=flat_base.shape[0])
                    for a in (starts, counts))
                return (torch.as_tensor(flat_base, device=dev), starts_pos,
                        counts_pos, cell_rank,
                        torch.as_tensor(offsets, device=dev), segments)

        return self._cached(self._grid_cache, dataset, scene_idx, build)

    def prefetch_scene(self, dataset, scene_idx: int) -> None:
        """Stage a scene ahead of time (``run_testing`` calls this from its
        prefetch thread): its host gridding and, on the device paths, its
        uploads, so they overlap the current scene's votes. The uploads
        hold the runner's device lock, which holds them out of a warm-up or
        capture (see :class:`StepGraphs`). Under a profiler its gridding is
        the span ``tumseg.serve.grid``, request id ``scene_idx`` (a scene
        that no prefetch staged is gridded inside ``tumseg.serve.scene``)."""
        if not hasattr(dataset, "grid_structure"):
            return
        with span("tumseg.serve.grid", scene_idx):
            dataset.grid_structure(scene_idx)   # host gridding (memoized)
        if self.device_features:
            self._scene_tensors(dataset, scene_idx)
            if self.device_reblock:
                self._grid_tensors(dataset, scene_idx)

    def _vote_generator(self, scene_idx: int, vote: int) -> torch.Generator:
        """The runner's one vote generator on the device, re-seeded with
        :func:`vote_seed`: it draws what a fresh generator so seeded draws,
        and a graph registers it once."""
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(vote_seed(self.seed, scene_idx, vote))
        return self._generator

    def vote_draws(self, scene_idx: int, vote: int, length: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The draws of one vote's :func:`reblock_on_device` (see
        :func:`draw_vote`) for (seed, scene, vote)."""
        return draw_vote(self._vote_generator(scene_idx, vote), length)

    def _reblock(self, grid, scene_idx: int, vote: int, block_points: int
                 ) -> torch.Tensor:
        """One vote's draws and :func:`reblock_on_device` of the grid
        tensors ``grid`` as one program (``_reblock_on_device``) ->
        [NB, block_points] int32."""
        flat_base, starts_pos, counts_pos, _cell_rank, _offsets, segments = \
            grid
        gen = self._vote_generator(scene_idx, vote)
        length = flat_base.shape[0]

        def reblock():
            u, keys = draw_vote(gen, length)
            return (reblock_on_device(u, keys, flat_base, starts_pos,
                                      counts_pos, block_points, segments),)
        return self._run(("reblock", length, segments, block_points),
                         reblock, (), [gen])[0]

    @torch.inference_mode()
    def _vote(self, scene, idx_blocks: torch.Tensor, offsets: torch.Tensor,
              pool_flat: torch.Tensor, block_size: float) -> None:
        """One vote's chunk loop (``_vote_scan_fn``'s "scan" mode,
        ``tumseg/infer/voting.py:480-540``): each B-block chunk of
        ``idx_blocks`` [NB, P] is featurized, forwarded, and the ones of its
        argmax are added at ``idx * C + pred`` into ``pool_flat``
        [(n + 1) * C], in place, as one program. A short last chunk is
        padded to B with the dump row ``n``, so every chunk has the
        kernels' B-block shapes and a scene one chunk program. Counts are
        small integers in f32: atomics cannot change the pool. On a mesh
        the blocks are padded with dump rows to a multiple of B, this rank
        votes its share, B / size blocks a chunk, into the zeroed
        increment, and :meth:`_reduce_vote` adds the all-reduced increment
        to the pool."""
        n = scene[0].shape[0]
        bs, C = self.batch_size, self.num_classes
        target = pool_flat
        if self.mesh is not None:
            pad = (-idx_blocks.shape[0]) % bs
            idx_blocks = torch.cat(
                [idx_blocks, idx_blocks.new_full((pad, idx_blocks.shape[1]),
                                                 n)])
            offsets = torch.cat([offsets, offsets.new_zeros(pad, 2)])
            rows = self.mesh.rows(idx_blocks.shape[0])
            idx_blocks, offsets = idx_blocks[rows], offsets[rows]
            target = self._zeroed("increment", pool_flat.shape)
            bs //= self.mesh.size
        self._bind(scene=scene, pool=pool_flat,
                   increment=None if target is pool_flat else target)

        def chunk(idx, offs):
            points = featurize(*scene, idx.clamp(max=n - 1), offs,
                               block_size)
            pred = self._labels(points)
            flat = idx.reshape(-1).long() * C + pred.reshape(-1)
            target.index_add_(0, flat,
                              torch.ones_like(flat, dtype=target.dtype))
            return ()

        key = ("vote_chunk", bs, idx_blocks.shape[1], idx_blocks.dtype,
               offsets.dtype, float(block_size),
               tuple((t.dtype, tuple(t.shape)) for t in scene))
        for s in range(0, idx_blocks.shape[0], bs):
            idx = idx_blocks[s:s + bs]
            offs = offsets[s:s + bs]
            if idx.shape[0] < bs:
                pad = bs - idx.shape[0]
                idx = torch.cat([idx, idx.new_full((pad, idx.shape[1]), n)])
                offs = torch.cat([offs, offs.new_zeros(pad, 2)])
            self._run(key, chunk, (idx, offs))
        if self.mesh is not None:
            self._reduce_vote(pool_flat, target)

    def _finish(self, dataset, scene_idx: int, pool_flat: torch.Tensor,
                gt_weight_gate: bool) -> np.ndarray:
        """The labels of a flat pool: votes count only where
        ``labelweights[gt]`` is finite and nonzero (a per-point constant, so
        it gates the finished pool, ``tumseg/infer/voting.py:630-639``),
        then the argmax over the scene's rows, read back. Under a profiler
        it is the span ``tumseg.serve.finish``, the gate's upload
        ``tumseg.upload``."""
        with span("tumseg.serve.finish"):
            labels = dataset.semantic_labels_list[scene_idx].astype(np.int64)
            n = labels.shape[0]
            pool = pool_flat.reshape(n + 1, self.num_classes)[:n]
            if gt_weight_gate:
                smpw = np.asarray(dataset.labelweights, np.float32)[labels]
                keep = upload((smpw != 0) & ~np.isinf(smpw), self.device)
                pool = torch.where(keep[:, None], pool, 0.0)
            return readback(pool.argmax(dim=1)).numpy()

    def _infer_scene_device_reblock(self, dataset, scene_idx, num_votes,
                                    gt_weight_gate):
        """``tumseg/infer/voting.py:594-640``: scene and grid uploaded once,
        each vote re-blocked (one program) and voted on the device."""
        scene = self._scene_tensors(dataset, scene_idx)
        grid = self._grid_tensors(dataset, scene_idx)
        n = scene[0].shape[0]
        pool_flat = self._pool(((n + 1) * self.num_classes,))
        self._bind(scene=scene, grid=grid)
        bp = int(dataset.block_points)
        for vote in progress(range(num_votes), desc="votes"):
            idx_blocks = self._reblock(grid, scene_idx, vote, bp)
            with ops.window_enabled(self.window_ops):
                self._vote(scene, idx_blocks, grid[4], pool_flat,
                           float(dataset.block_size))
        return self._finish(dataset, scene_idx, pool_flat, gt_weight_gate)

    def _infer_scene_device_features(self, dataset, scene_idx, num_votes,
                                     gt_weight_gate):
        """``tumseg/infer/voting.py:642-686``: host ``grid_indices`` every
        vote (the next one drawn on a worker), device featurization and
        vote."""
        scene = self._scene_tensors(dataset, scene_idx)
        n = scene[0].shape[0]
        pool_flat = self._pool(((n + 1) * self.num_classes,))
        self._bind(scene=scene)
        draws = _HostDraws(dataset.grid_indices, scene_idx, num_votes,
                           self.mesh)
        try:
            for vote in progress(range(num_votes), desc="votes"):
                idx_blocks, offsets = draws.next((np.int32, np.float64))
                with ops.window_enabled(self.window_ops):
                    self._vote(
                        scene,
                        torch.as_tensor(idx_blocks.astype(np.int32),
                                        device=self.device),
                        torch.as_tensor(offsets, device=self.device),
                        pool_flat, float(dataset.block_size))
        finally:
            draws.close()
        return self._finish(dataset, scene_idx, pool_flat, gt_weight_gate)

    def _host_chunks(self, scene_data: np.ndarray, scene_index: np.ndarray,
                     keep: np.ndarray, target: torch.Tensor, bs: int) -> None:
        """Votes each chunk of ``bs`` host-featurized blocks into ``target``
        [N_scene, C]: forward, argmax and :func:`_scatter_votes` as one
        program. A short last chunk is padded to ``bs`` (its last block
        repeated, point index 0, ``keep`` False), so its padded rows cast no
        vote and every chunk has one shape (``tumseg/infer/voting.py:
        718-735``)."""
        def chunk(x, idx, kp):
            _scatter_votes(target, idx, self._labels(x), kp)
            return ()

        key = ("host_chunk", bs, scene_data.shape[1:], tuple(target.shape))
        for s in range(0, scene_data.shape[0], bs):
            arrays = (
                np.ascontiguousarray(_pad_rows(scene_data[s:s + bs], bs),
                                     np.float32),
                _pad_rows(np.asarray(scene_index[s:s + bs], np.int64), bs, 0),
                _pad_rows(np.asarray(keep[s:s + bs], bool), bs, False))
            self._run(key, chunk, tuple(torch.as_tensor(a, device=self.device)
                                        for a in arrays))

    def _infer_scene_host(self, dataset, scene_idx, num_votes,
                          gt_weight_gate):
        n_scene = dataset.semantic_labels_list[scene_idx].shape[0]
        pool = self._pool((n_scene, self.num_classes))

        def draw(i):
            scene_data, _, scene_smpw, scene_index = dataset.__getitem__(i)
            if gt_weight_gate:
                keep = (scene_smpw != 0) & ~np.isinf(scene_smpw)
            else:
                keep = np.ones_like(scene_smpw, dtype=bool)
            return scene_data, keep, scene_index

        draws = _HostDraws(draw, scene_idx, num_votes, self.mesh)
        try:
            for vote in progress(range(num_votes), desc="votes"):
                scene_data, keep, scene_index = draws.next(
                    (np.float32, np.bool_, np.int64))
                target, bs = pool, self.batch_size
                if self.mesh is not None:
                    # padded blocks cast no vote
                    keep = np.concatenate([keep, np.zeros(
                        ((-keep.shape[0]) % bs,) + keep.shape[1:], bool)])
                    (scene_data, scene_index), rows, bs = self._share(
                        scene_data, scene_index)
                    scene_data, keep = scene_data[rows], keep[rows]
                    scene_index = scene_index[rows]
                    target = self._zeroed("increment", pool.shape)
                self._host_chunks(scene_data, scene_index, keep, target, bs)
                if self.mesh is not None:
                    self._reduce_vote(pool, target)
        finally:
            draws.close()
        return pool.argmax(dim=1).cpu().numpy()

    def infer_scene(self, dataset, scene_idx: int, num_votes: int = 5,
                    gt_weight_gate: bool = True) -> np.ndarray:
        """Run ``num_votes`` re-blocked passes and return per-point labels
        for the whole scene [N_scene], through the path chosen at
        construction (``tumseg/infer/voting.py:688-701``).
        ``gt_weight_gate`` counts a point's votes only where
        ``labelweights[gt]`` is finite and nonzero, as the reference does.
        Under a profiler it is the span ``tumseg.serve.scene``, request id
        ``scene_idx``."""
        with torch.inference_mode(), span("tumseg.serve.scene", scene_idx):
            if (self.device_reblock and self.device_features
                    and hasattr(dataset, "grid_structure")):
                return self._infer_scene_device_reblock(
                    dataset, scene_idx, num_votes, gt_weight_gate)
            if self.device_features and hasattr(dataset, "grid_indices"):
                return self._infer_scene_device_features(
                    dataset, scene_idx, num_votes, gt_weight_gate)
            return self._infer_scene_host(dataset, scene_idx, num_votes,
                                          gt_weight_gate)


def run_testing(dataset, runner: InferenceRunner, *, num_votes: int,
                visual_dir=None, visual: bool = False,
                seg_label_to_cat: Dict = None, label2color: Dict = None,
                result_color: bool = True, log_string=print):
    """Voting inference over every scene, the per-scene and aggregate IoU
    report, ``visual/<scene>.txt`` label dumps and optional coloured .obj
    files (``tumseg/infer/voting.py:741-824``). While a scene votes, a
    one-worker pool stages the next one (``runner.prefetch_scene``); its
    result is read before that scene votes, so a failed prefetch raises
    there. The result also carries ``infer_seconds``, the wall time spent
    in ``infer_scene``. On a mesh every rank votes and only rank 0 writes
    the label dumps and .obj files."""
    num_classes = runner.num_classes
    scene_ids = [os.path.basename(str(f))[:-4] for f in dataset.file_list]
    totals = M.zero_tallies(num_classes)
    per_scene_miou = []
    infer_seconds = 0.0
    prefetch = (ThreadPoolExecutor(max_workers=1)
                if hasattr(dataset, "grid_structure") else None)
    staged = None

    log_string("---- EVALUATION WHOLE SCENE----")
    try:
        for batch_idx in range(len(dataset)):
            print("Inference [%d/%d] %s ..." % (batch_idx + 1, len(dataset),
                                                scene_ids[batch_idx]))
            if staged is not None:
                staged.result()
                staged = None
            if prefetch is not None and batch_idx + 1 < len(dataset):
                staged = prefetch.submit(runner.prefetch_scene, dataset,
                                         batch_idx + 1)
            whole_scene_label = dataset.semantic_labels_list[
                batch_idx].astype(int)
            whole_scene_data = dataset.scene_points_list[batch_idx]

            t0 = time.perf_counter()
            pred_label = runner.infer_scene(dataset, batch_idx, num_votes)
            infer_seconds += time.perf_counter() - t0

            t = M.confusion_tallies(torch.as_tensor(pred_label),
                                    torch.as_tensor(whole_scene_label),
                                    num_classes)
            scene_iou = M.iou_from_tallies(t)
            totals = M.accumulate_host(totals, t)
            seen = np.asarray(t["seen"])
            tmp_iou = (float(np.mean(scene_iou[seen != 0]))
                       if (seen != 0).any() else 0.0)
            print(scene_iou)
            per_scene_miou.append(tmp_iou)
            log_string("Mean IoU of %s: %.4f" % (scene_ids[batch_idx],
                                                  tmp_iou))
            print("----------------------------")

            if visual_dir is not None and (runner.mesh is None
                                           or runner.mesh.rank == 0):
                write_labels_txt(os.path.join(str(visual_dir),
                                              scene_ids[batch_idx] + ".txt"),
                                 pred_label)
                if visual:
                    kw = (dict(labels=pred_label, label2color=label2color)
                          if result_color else {})
                    kw_gt = (dict(labels=whole_scene_label,
                                  label2color=label2color)
                             if result_color else {})
                    write_obj_pointcloud(
                        os.path.join(str(visual_dir),
                                     scene_ids[batch_idx] + "_pred.obj"),
                        whole_scene_data, **kw)
                    write_obj_pointcloud(
                        os.path.join(str(visual_dir),
                                     scene_ids[batch_idx] + "_gt.obj"),
                        whole_scene_data, **kw_gt)
    finally:
        if prefetch is not None:
            prefetch.shutdown(wait=False)

    iou = M.iou_from_tallies(totals)
    iou_str = "------- IoU --------\n"
    for l in range(num_classes):
        if (totals["seen"][l] + totals["predicted"][l]) == 0:
            continue
        name = seg_label_to_cat[l] if seg_label_to_cat else str(l)
        iou_str += "class %s, IoU: %.3f \n" % (name + " " * (14 - len(name)),
                                               iou[l])
    log_string(iou_str)
    log_string("eval point avg class IoU: %f" % float(np.mean(iou)))
    log_string("eval whole scene point avg class acc: %f"
               % M.class_avg_accuracy(totals))
    total_seen = int(np.asarray(totals["seen"]).sum())
    log_string("eval whole scene point accuracy: %f"
               % (np.asarray(totals["correct"]).sum()
                  / float(total_seen + 1e-6)))
    return {"iou": iou, "miou": float(np.mean(iou)),
            "per_scene_miou": per_scene_miou, "tallies": totals,
            "infer_seconds": infer_seconds}
