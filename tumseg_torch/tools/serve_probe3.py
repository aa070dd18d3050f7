#!/usr/bin/env python
"""Per-phase device-time split of one vote of the port's serving, the
counterpart of ``benchmarks/serve_probe3.py``: the re-blocking, then the
vote's chunk program whole and with each of its parts taken out. On the
original's scene (1M points uniform over 20 m x 4 m x 12 m,
``voting_bench.scene``), the seeded ``pointnet2_sem_seg`` in bf16 compute,
B=32 blocks of 4096 points, device re-blocking and featurization, the
z-window 3-NN on (``ops.window_enabled``, as the original runs it):

  reblock_sort             a vote's re-blocking program alone
                           (``InferenceRunner._reblock``)
  scan_full                the vote's chunk program (featurize, forward,
                           argmax, vote into the pool: ``_vote``'s chunk)
  scan_no_scatter          the same with the vote scatter replaced by a sum
                           of the labels into one pool entry
  scan_contiguous_gather   the same with the featurization reading the
                           scene at contiguous rows instead of the
                           blocks' random ones
  scan_forward_only        the forward and vote of one constant block set
                           (no featurization)

    python -m tumseg_torch.tools.serve_probe3 [--gpu 0]

Each chunk variant is one CUDA graph a chunk (``InferenceRunner._run``,
warmed up and captured on an untimed vote), replayed over every chunk of a
vote, as ``_vote`` runs its chunks (a short last chunk padded with the
scene's dump row). The variants run in turns, one vote each a turn, so
that a drift of the card's clock shows in every one alike. A phase is the
mean over ``REPS`` votes of the CUDA event time of one vote; every vote
is printed too. The original's
dummy-granule phase (``scan_real_chunks_only``) has no counterpart: the
port pads a vote to whole chunks only, it has no block granules (see
``tumseg_torch/infer/voting.py``), so its ``derived`` line has no
``dummy_granule_ms``.

Prints the card's line, the ``nb``/``nb_pad``/``L``/``n_pad`` line (the
port pads the scene by no bucket: ``n_pad`` is the scene's points), one
line a phase (``phase``, ``ms_per_vote``, ``runs``), then the ``derived``
line.
"""

from __future__ import annotations

import argparse
import functools
import math
import sys
from typing import Dict

import numpy as np
import torch

from tumseg_torch.tools import benchutil, voting_bench

POINTS, BATCH, BLOCK_POINTS, REPS = 1_000_000, 32, 4096, 5
PHASES = ("scan_full", "scan_no_scatter", "scan_contiguous_gather",
          "scan_forward_only")


def chunk_programs(runner, scene, block_size: float, target, xconst):
    """The chunk program of each phase: ``fn(idx [B, P], offs [B, 2]) ->
    ()``, voting into ``target`` [(n + 1) * C] in place."""
    from tumseg_torch.infer.voting import featurize

    n = scene[0].shape[0]
    C = runner.num_classes

    def vote(idx, pred):
        flat = idx.reshape(-1).long() * C + pred.reshape(-1)
        target.index_add_(0, flat, torch.ones_like(flat, dtype=target.dtype))

    def full(idx, offs):
        points = featurize(*scene, idx.clamp(max=n - 1), offs, block_size)
        vote(idx, runner._labels(points))
        return ()

    def no_scatter(idx, offs):
        points = featurize(*scene, idx.clamp(max=n - 1), offs, block_size)
        target[:1].add_(runner._labels(points).sum().to(target.dtype))
        return ()

    def contiguous(idx, offs):
        rows = torch.arange(idx.numel(), device=idx.device).reshape(
            idx.shape) % (n - 1)
        vote(idx, runner._labels(featurize(*scene, rows, offs, block_size)))
        return ()

    def forward_only(idx, offs):
        vote(idx, runner._labels(xconst))
        return ()

    return dict(zip(PHASES, (full, no_scatter, contiguous, forward_only)))


def vote(runner, phase: str, chunk, idx_blocks, offsets, n: int) -> None:
    """One vote of ``chunk`` over the B-block chunks of ``idx_blocks`` [NB,
    P] and ``offsets`` [NB, 2], as ``InferenceRunner._vote`` runs them: a
    short last chunk padded with the dump row ``n`` (the scene's points),
    each chunk one program (key ``phase``)."""
    bs = runner.batch_size
    key = (phase, bs, idx_blocks.shape[1])
    for s in range(0, idx_blocks.shape[0], bs):
        idx, offs = idx_blocks[s:s + bs], offsets[s:s + bs]
        if idx.shape[0] < bs:
            pad = bs - idx.shape[0]
            idx = torch.cat([idx, idx.new_full((pad, idx.shape[1]), n)])
            offs = torch.cat([offs, offs.new_zeros(pad, 2)])
        runner._run(key, chunk, (idx, offs))


def setup(device):
    """(runner, dataset, scene tensors, grid tensors, pool) of the probe's
    scene, the scene and grid bound as the runner binds them."""
    from tumseg_torch.infer.voting import InferenceRunner

    xyz, labels = voting_bench.scene(POINTS)
    ds = voting_bench.scene_dataset(xyz, labels, BLOCK_POINTS, name="s.las")
    runner = InferenceRunner(voting_bench.seeded_model(), num_classes=8,
                             batch_size=BATCH, device=device,
                             compute_dtype=torch.bfloat16,
                             device_features=True, device_reblock=True,
                             window_ops=True)
    scene = runner._scene_tensors(ds, 0)
    grid = runner._grid_tensors(ds, 0)
    n = scene[0].shape[0]
    pool = runner._pool(((n + 1) * runner.num_classes,))
    runner._bind(scene=scene, grid=grid)
    return runner, ds, scene, grid, pool


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    benchutil.add_gpu_arg(ap)
    return ap.parse_args(argv)


def run(args) -> Dict:
    """Prints the card's line and the probe's lines; returns the phase
    lines by phase, the shape line under ``"shape"`` and the derived one
    under ``"derived"``."""
    from tumseg_torch import ops

    device = benchutil.device_of(args.gpu)
    benchutil.print_card(device)
    runner, ds, scene, grid, pool = setup(device)
    bp, bs = BLOCK_POINTS, BATCH
    flat_base = grid[0]
    n = scene[0].shape[0]
    idx = runner._reblock(grid, 0, 7, bp)
    nb = int(idx.shape[0])
    out = {"shape": benchutil.emit({
        "nb": nb, "nb_pad": math.ceil(nb / bs) * bs,
        "L": int(flat_base.shape[0]), "n_pad": n})}

    def emit(phase, runs):
        out[phase] = benchutil.emit({"phase": phase,
                                     "ms_per_vote": float(np.mean(runs)),
                                     "runs": runs})
        return out[phase]["ms_per_vote"]

    with torch.inference_mode():
        runner._reblock(grid, 0, 99, bp)
        emit("reblock_sort", [benchutil.elapsed_ms(
            device, lambda i=i: runner._reblock(grid, 0, 100 + i, bp))
            for i in range(REPS)])
        gen = torch.Generator(device=device)
        gen.manual_seed(3)
        xconst = torch.randn(bs, bp, 6, generator=gen, device=device)
        programs = chunk_programs(runner, scene, float(ds.block_size), pool,
                                  xconst)
        calls = {p: functools.partial(vote, runner, p, programs[p], idx,
                                      grid[4], n) for p in PHASES}
        runs = {p: [] for p in PHASES}
        with ops.window_enabled(True):
            for p in PHASES:
                calls[p]()      # the untimed vote: warm-up and capture
            for _ in range(REPS):   # the phases in turns
                for p in PHASES:
                    runs[p].append(benchutil.elapsed_ms(device, calls[p]))
        ms = {p: emit(p, runs[p]) for p in PHASES}
    out["derived"] = benchutil.emit({"derived": {
        "scatter_ms": ms["scan_full"] - ms["scan_no_scatter"],
        "random_vs_contiguous_gather_ms":
            ms["scan_full"] - ms["scan_contiguous_gather"],
        "featurize_total_ms": ms["scan_full"] - ms["scan_forward_only"],
    }})
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
