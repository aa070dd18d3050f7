#!/usr/bin/env python
"""Whole-scene voting throughput of the port, the counterpart of
``benchmarks/voting_bench.py``: the original's synthetic scene (1M points
uniform over 20 m x 4 m x 12 m, random labels, ``default_rng(0)``) served
by ``InferenceRunner`` (``pointnet2_sem_seg``, seeded random weights, bf16
compute, B=32 blocks of 4096 points) through its "auto" paths, which on the
card re-block on the device and run every serving program as a CUDA graph.

    python -m tumseg_torch.tools.voting_bench [--points 1000000]
        [--votes 2] [--batch 32] [--block_points 4096] [--eager]
        [--path device_reblock|device_features|host] [--gpu 0]

As in the original, one warm vote runs first (here it also warms up and
captures the programs); then ``--votes`` votes are timed. The wall time is
CUDA events around ``infer_scene``, labels on the host included; the
original's readback of its result is this synchronisation, and nothing is
subtracted. Then the host's per-vote costs: ``grid_indices`` (the blocks
that the device featurization path ships) and the full host featurization
(``__getitem__``).

Prints the card's line, then the original's line (``metric``,
``scene_points``, ``votes``, ``block_batches``, ``blocks_per_vote``,
``wall_s``, ``host_grid_s_per_vote``, ``host_full_featurize_s_per_vote``,
``device_features``, ``device_reblock``, ``value`` in scene-points/s) with
``cuda_graphs``, ``voted_points`` (points that the timed votes' pool
holds a vote for, which must be all of them) and
the idle share: 1 - busy / the event wall of the timed votes, busy the
votes' programs replayed back to back (each chunk at the replay time of
the vote's first chunk, and each re-blocking), as ``chip_smoke.py`` [sg]
takes it; null with ``--eager``, which has no programs to replay.
``--eager`` serves with ``cuda_graphs=False``, the counterpart of
``jax.disable_jit``; ``--path`` picks one of the runner's three paths.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from typing import Dict

import numpy as np
import torch

from tumseg_torch.tools import benchutil

PATHS = {"device_reblock": dict(device_features=True, device_reblock=True),
         "device_features": dict(device_features=True, device_reblock=False),
         "host": dict(device_features=False, device_reblock=False)}


def scene(n: int, seed: int = 0):
    """The original's facade-shaped scene: (xyz [n, 3] f64 uniform over
    20 m x 4 m x 12 m, labels [n] in [0, 8)), in its draw order."""
    r = np.random.default_rng(seed)
    xyz = np.stack([r.uniform(0, 20, n), r.uniform(0, 4, n),
                    r.uniform(0, 12, n)], 1)
    labels = r.integers(0, 8, n)
    return xyz, labels


def scene_dataset(xyz, labels, block_points: int, name="synthetic_scene.las"):
    """A ``TestGridDataset`` of the one scene, set up as the original sets
    up its own (no extra channels, unit label weights)."""
    from tumseg_torch.data.dataset import TestGridDataset

    ds = TestGridDataset(num_classes=8, block_points=block_points, seed=0)
    ds.scene_points_list = [xyz]
    ds.semantic_labels_list = [labels]
    ds.file_list = [name]
    ds.labelweights = np.ones(8, dtype=np.float32)
    return ds


def seeded_model(name: str = "pointnet2_sem_seg", extra: int = 0):
    """``name``'s module with weights from ``torch.manual_seed(0)``."""
    from tumseg_torch import models

    torch.manual_seed(0)
    return models.get_module(name).get_model(8, extra)


def program_busy_ms(runner, chunk_inputs, chunks: int):
    """(busy, chunk, re-blocking) device ms of one vote's programs replayed
    back to back: the chunk program at ``chunk_inputs`` (the vote's first
    chunk, copied into its statics) times ``chunks``, plus the re-blocking
    program where there is one (else 0). Each replay's time is the median
    of 3 runs of the mean of 5 (chunk) or 3 (re-blocking) replays after
    one warm-up replay. ``chip_smoke.py`` [sg] takes its busy time here."""
    graphs = runner.graphs.graphs
    chunk = next(v for k, v in graphs.items()
                 if k[0] in ("vote_chunk", "host_chunk"))
    with torch.inference_mode():   # the statics' mode
        for static, given in zip(chunk.inputs, chunk_inputs):
            static.copy_(given)
    dev = runner.device
    chunk_ms = float(np.median(benchutil.repeat_ms(dev, chunk.graph.replay,
                                                   5)))
    reblock = [v for k, v in graphs.items() if k[0] == "reblock"]
    reblock_ms = 0.0
    if reblock:
        reblock_ms = float(np.median(benchutil.repeat_ms(
            dev, reblock[0].graph.replay, 3)))
    return chunks * chunk_ms + reblock_ms, chunk_ms, reblock_ms


def first_chunk(runner, ds, bs: int, grid_blocks=None, host_blocks=None):
    """The inputs of a vote's first chunk program on ``runner``'s path:
    re-blocked on the device, from the host's ``grid_indices`` or from the
    host's featurized blocks (``ds.grid_indices(0)`` and ``ds[0]``, which
    only those paths need)."""
    dev = runner.device
    if runner.device_features and runner.device_reblock:
        grid = runner._grid_tensors(ds, 0)
        idx = runner._reblock(grid, 0, 0, ds.block_points)
        return idx[:bs], grid[4][:bs]
    if runner.device_features:
        idx, offsets = grid_blocks
        return (torch.as_tensor(idx[:bs].astype(np.int32), device=dev),
                torch.as_tensor(offsets[:bs], device=dev))
    data, _, _, index = host_blocks
    return (torch.as_tensor(np.ascontiguousarray(data[:bs], np.float32),
                            device=dev),
            torch.as_tensor(index[:bs].astype(np.int64), device=dev),
            torch.ones(index[:bs].shape, dtype=torch.bool, device=dev))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=1_000_000)
    ap.add_argument("--votes", type=int, default=2)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--block_points", type=int, default=4096)
    ap.add_argument("--eager", action="store_true",
                    help="serve with cuda_graphs=False")
    ap.add_argument("--path", default="auto", choices=("auto", *PATHS),
                    help="the runner's path (default: its 'auto' choice)")
    benchutil.add_gpu_arg(ap)
    return ap.parse_args(argv)


def run(args) -> Dict:
    """Prints the card's line and the bench's line; returns the line."""
    from tumseg_torch.infer.voting import InferenceRunner

    device = benchutil.device_of(args.gpu)
    benchutil.print_card(device)
    n = args.points
    xyz, labels = scene(n)
    ds = scene_dataset(xyz, labels, args.block_points)
    kw = {} if args.path == "auto" else PATHS[args.path]
    runner = InferenceRunner(seeded_model(), num_classes=8,
                             batch_size=args.batch, device=device,
                             compute_dtype=torch.bfloat16,
                             cuda_graphs=not args.eager, **kw)

    warm = runner.infer_scene(ds, 0, num_votes=1)
    assert warm.shape == (n,)
    wall = benchutil.elapsed_ms(device, lambda: runner.infer_scene(
        ds, 0, num_votes=args.votes)) / 1e3
    pps = n * args.votes / wall

    t0 = time.perf_counter()
    grid_blocks = ds.grid_indices(0)
    host_grid_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_blocks = ds[0]
    host_featurize_s = time.perf_counter() - t0
    nb = int(grid_blocks[0].shape[0])

    pool = runner._buffers["pool"].reshape(-1, 8)[:n]
    voted = int((pool.sum(1) > 0).sum())
    idle = None
    if runner.graphs is not None:
        chunks = math.ceil(nb / args.batch)
        busy_ms = args.votes * program_busy_ms(
            runner, first_chunk(runner, ds, args.batch, grid_blocks,
                                host_blocks), chunks)[0]
        idle = 1.0 - busy_ms / 1e3 / wall
    return benchutil.emit({
        "metric": "whole_scene_voting_points_per_sec",
        "scene_points": n,
        "votes": args.votes,
        "block_batches": int(np.ceil(nb / args.batch)),
        "blocks_per_vote": nb,
        "wall_s": wall,
        "host_grid_s_per_vote": host_grid_s,
        "host_full_featurize_s_per_vote": host_featurize_s,
        "device_features": runner.device_features,
        "device_reblock": runner.device_reblock,
        "cuda_graphs": runner.graphs is not None,
        "idle_share": idle,
        "voted_points": voted,
        "value": pps,
    })


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
