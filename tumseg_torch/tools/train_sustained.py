#!/usr/bin/env python
"""Sustained end-to-end training throughput of the port, data pipeline
included, the counterpart of ``benchmarks/train_sustained.py``. On the
original's two 600K-point facade tiles (``facadeA``/``facadeB``, seeds 0
and 1, made by ``tumseg_torch.tools.soak.make_tile``), ``pointnet2_sem_seg``
with colour and ``--class8``, bf16 compute, B=16 x 4096, the modes:

  device_rate      the same staged batch stepped back to back (the upper
                   bound: no data moves)
  device_pipeline  ``DeviceBlockSampler``: the rooms uploaded once, each
                   step sends [B] room ids and samples its blocks on the
                   device (one readback a rejection round)
  host_pipeline    ``TrainBlockDataset`` + ``BatchLoader(num_workers=8)``:
                   featurized f32 batches from the host
  superstep<k>     the device pipeline's room ids grouped k to a
                   ``train_batch_rooms_multi`` call, the tail as single
                   steps

    python -m tumseg_torch.tools.train_sustained [--points 600000]
        [--epochs 2] [--batch 16] [--npoint 4096] [--sample_rate 4.0]
        [--superstep 8] [--workdir DIR] [--eager] [--gpu 0]

On the card every step runs as a CUDA graph (``TrainEngine``'s default);
``--eager`` runs the same engine with ``cuda_graphs=False``. Each program
is warmed up and captured (two calls) before the timing. An epoch is timed
with CUDA events around its steps, the device drained after the last: the
counterpart of the original's per-epoch fence. The original subtracts a
readback latency measured once; here the synchronisation is local and
nothing is subtracted.

Prints the card's line, one line a mode with the original's keys (``mode``,
``steps``, ``batch``, ``npoint``, ``epoch_s`` (the fastest epoch),
``ms_per_step``, ``points_per_sec``) and every epoch's seconds and their
median (``epoch_s_runs``, ``epoch_s_median``), then the ``summary`` line of
each mode's points/s over ``device_rate``'s.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from tumseg_torch.tools import benchutil, soak

LR, MOMENTUM = 1e-3, 0.1


def make_tiles(work: Path, points: int):
    """The original's two training tiles, by ``soak.make_tile``."""
    paths = []
    for name, seed in [("facadeA.las", 0), ("facadeB.las", 1)]:
        p = str(work / name)
        soak.make_tile(p, points, seed)
        paths.append(p)
    return paths


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=600_000)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--npoint", type=int, default=4096)
    ap.add_argument("--sample_rate", type=float, default=4.0,
                    help="epoch length multiplier")
    ap.add_argument("--workdir", default=None,
                    help="made anew and removed; default a new temporary "
                         "directory")
    ap.add_argument("--superstep", type=int, default=8,
                    help="also bench the k-step call at this k (0 or 1 "
                         "disables)")
    ap.add_argument("--eager", action="store_true",
                    help="TrainEngine(cuda_graphs=False)")
    benchutil.add_gpu_arg(ap)
    return ap.parse_args(argv)


def mode_line(mode, epochs_ms, n_steps, B, P) -> Dict:
    runs = benchutil.summary([ms / 1e3 for ms in epochs_ms])
    best = runs["min"]
    return benchutil.emit({
        "mode": mode, "steps": n_steps, "batch": B, "npoint": P,
        "epoch_s": best, "ms_per_step": 1e3 * best / n_steps,
        "points_per_sec": n_steps * B * P / best,
        "epoch_s_runs": runs["runs"], "epoch_s_median": runs["median"]})


def run(args):
    """Prints the card's line and the bench's lines; returns them by
    mode."""
    from tumseg_torch import models
    from tumseg_torch.data.dataset import TrainBlockDataset
    from tumseg_torch.data.device_sampler import (DeviceBlockSampler,
                                                  DeviceSampleLoader)
    from tumseg_torch.data.loader import BatchLoader
    from tumseg_torch.train.loop import TrainEngine

    device = benchutil.device_of(args.gpu)
    benchutil.print_card(device)
    made = args.workdir is None
    work = Path(args.workdir or tempfile.mkdtemp(prefix="tumseg_sustained_"))
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        paths = make_tiles(work, args.points)
        ds = TrainBlockDataset(paths, num_classes=8, num_point=args.npoint,
                               color=True, class8=True, seed=0,
                               sample_rate=args.sample_rate)
    finally:
        if made:
            shutil.rmtree(work, ignore_errors=True)
    weights = ds.calculate_labelweights()
    sampler = DeviceBlockSampler.from_dataset(ds, device=device)
    torch.manual_seed(0)
    model = models.get_module("pointnet2_sem_seg").get_model(
        8, ds.num_extra_features)
    engine = TrainEngine(model, 8, weights, compute_dtype=torch.bfloat16,
                         seed=0, sampler=sampler, device=device,
                         cuda_graphs=not args.eager)

    B, P = args.batch, args.npoint
    n_steps = len(ds) // B
    host_loader = BatchLoader(ds, batch_size=B, shuffle=True, drop_last=True,
                              num_workers=8, seed=0)
    dev_loader = DeviceSampleLoader(ds, batch_size=B, shuffle=True, seed=0)

    # warm-up: each program's first call (eager) and its capture
    pts0, tgt0 = next(iter(host_loader))
    rooms0 = next(iter(dev_loader)).room_ids
    staged = (torch.as_tensor(pts0, dtype=torch.float32, device=device),
              torch.as_tensor(tgt0, dtype=torch.int64, device=device))
    k = args.superstep
    for _ in range(2):
        engine.train_batch(*staged, LR, MOMENTUM)
        engine.train_batch_rooms(rooms0, LR, MOMENTUM)
        if k > 1:
            engine.train_batch_rooms_multi(np.stack([rooms0] * k), LR,
                                           MOMENTUM)
    benchutil.sync(device)

    def epoch(mode):
        if mode == "device_rate":
            for _ in range(n_steps):
                engine.train_batch(*staged, LR, MOMENTUM)
        elif mode == "device_pipeline":
            for b in batches:
                engine.train_batch_rooms(b.room_ids, LR, MOMENTUM)
        elif mode == "host_pipeline":
            for pts, tgt in host_loader:
                engine.train_batch(pts, tgt, LR, MOMENTUM)
        else:
            ids = [b.room_ids for b in batches]
            groups = len(ids) // k
            for i in range(groups):
                engine.train_batch_rooms_multi(np.stack(ids[i * k:i * k + k]),
                                               LR, MOMENTUM)
            for ids_i in ids[groups * k:]:
                engine.train_batch_rooms(ids_i, LR, MOMENTUM)

    modes = ["device_rate", "device_pipeline", "host_pipeline"]
    if k > 1:
        modes.append(f"superstep{k}")
    results = {}
    for mode in modes:
        times = []
        for _ in range(args.epochs):
            if mode not in ("device_rate", "host_pipeline"):
                # an epoch's room ids, listed before it as in the original
                batches = list(iter(dev_loader))
            times.append(benchutil.elapsed_ms(device, lambda: epoch(mode)))
        results[mode] = mode_line(mode, times, n_steps, B, P)
    rate = results["device_rate"]["points_per_sec"]
    results["summary"] = benchutil.emit({
        "mode": "summary",
        **{f"{m}_vs_device_rate": results[m]["points_per_sec"] / rate
           for m in modes[1:]}})
    return results


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
