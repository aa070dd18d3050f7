#!/usr/bin/env python
"""Device-time split of the training sampler's phases, the counterpart of
``benchmarks/sampler_probe.py``: on the original's two 600K-point facade
tiles (seeds 0 and 1, ``tumseg_torch.tools.soak.make_tile``, colour and
``--class8``), ``DeviceBlockSampler`` at B=16 blocks of 4096 points, every
row from room 0:

  candidates_pass    one counting pass: [B] centres drawn, their 3 x 3 bins'
                     9 * cap candidate rows gathered and compared
                     (``trial_blocks``)
  rejection_loop     the rounds until every row accepts a block
                     (``accept``: ``TRIALS`` centres a pending row a round,
                     one readback a round)
  sort_u_idx         the stable sort of [B, 9 * cap] uniforms (the
                     candidates outside the block at 2) and its first P
                     indices, the selection of ``select``
  top_k              the same selection by ``torch.topk``, the alternative
  featurize_gathers  the [B, P] row gather of the packed table
  sample_batch_full  ``sample_batch``: all of it

    python -m tumseg_torch.tools.sampler_probe [--workdir DIR] [--gpu 0]

Each phase is timed with CUDA events over ``REPS`` calls back to back,
three runs, after a warm-up: on the card the phases without a readback
are one CUDA graph each (warmed up and captured, its generator registered,
so every replay draws anew), replayed ``REPS`` times; ``rejection_loop``
and ``sample_batch_full`` read back once a round, which no graph can hold,
and run eagerly. The original chains its calls inside one jit; a replay
cannot be folded away, so nothing perturbs the values.

Prints the card's line, the ``cap``/``cands`` line, then one line a phase
(``phase``, ``ms`` a call: the median of the runs, ``runs``, ``min_ms``).
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

TILES = [("a.las", 0), ("b.las", 1)]
POINTS, B, P, REPS = 600_000, 16, 4096, 20


# --- the phases, as functions of their draws (the tests call them) -------

def candidates_pass(sampler, rooms, u):
    """The blocks' counts [B] of the centres that the uniforms u [B] pick in
    rooms [B]: one pass over the 9 * cap candidates of each."""
    return sampler.trial_blocks(rooms, u)[1]


def inside_mask(sampler, rooms, centres):
    """[B, 9 * cap] block membership of the candidates of ``centres``."""
    return sampler._candidates(rooms, centres[:, 0], centres[:, 1])[1]


def sort_u_idx(sel_u, inside, P):
    """The first P of the candidates ranked by a stable sort of their
    uniforms, those outside the block at 2 (``select``'s order)."""
    keys = torch.where(inside, sel_u, 2.0)
    return torch.sort(keys, dim=1, stable=True).indices[:, :P]


def top_k(sel_u, inside, P):
    """The P smallest keys of :func:`sort_u_idx` by ``torch.topk``."""
    keys = torch.where(inside, sel_u, 2.0)
    return torch.topk(keys, P, dim=1, largest=False).indices


def featurize_gathers(sampler, sel):
    """The packed rows [B, P, 4 + E] of the payload rows ``sel``."""
    return sampler._packed[sel]


def make_sampler(work: Path, points: int, npoint: int, device):
    from tumseg_torch.data.dataset import TrainBlockDataset
    from tumseg_torch.data.device_sampler import DeviceBlockSampler

    paths = []
    for name, seed in TILES:
        p = str(work / name)
        soak.make_tile(p, points, seed)
        paths.append(p)
    ds = TrainBlockDataset(paths, num_classes=8, num_point=npoint, color=True,
                           class8=True, seed=0)
    return DeviceBlockSampler.from_dataset(ds, device=device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None,
                    help="made anew and removed; default a new temporary "
                         "directory")
    benchutil.add_gpu_arg(ap)
    return ap.parse_args(argv)


def run(args) -> Dict:
    """Prints the card's line and the probe's lines; returns the phase
    lines by phase, and the ``cap`` line under ``"cap"``."""
    device = benchutil.device_of(args.gpu)
    benchutil.print_card(device)
    made = args.workdir is None
    work = Path(args.workdir or tempfile.mkdtemp(prefix="tumseg_probe_"))
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        s = make_sampler(work, POINTS, P, device)
    finally:
        if made:
            shutil.rmtree(work, ignore_errors=True)
    out = {"cap": benchutil.emit({"cap": s.cap, "cands": 9 * s.cap})}

    n_c = 9 * s.cap
    rooms = torch.zeros(B, dtype=torch.int64, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    # the centres of one accepted draw, the blocks the selection phases use
    _, centres, _ = s.accept(np.zeros((1, B), np.int64), [gen])
    inside = inside_mask(s, rooms, centres)
    rows = int(s._packed.shape[0] - s.cap)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    graphed = {
        "candidates_pass": lambda: (candidates_pass(s, rooms, rand(B)),),
        "sort_u_idx": lambda: (sort_u_idx(rand(B, n_c), inside, P),),
        "top_k": lambda: (top_k(rand(B, n_c), inside, P),),
        "featurize_gathers": lambda: (featurize_gathers(s, torch.randint(
            0, rows, (B, P), generator=gen, device=device)),),
    }
    eager = {
        "rejection_loop": lambda: s.accept(np.zeros((1, B), np.int64),
                                           [gen]),
        "sample_batch_full": lambda: s.sample_batch(np.zeros(B, np.int64),
                                                    gen),
    }
    for phase in ("candidates_pass", "rejection_loop", "sort_u_idx", "top_k",
                  "featurize_gathers", "sample_batch_full"):
        if phase in graphed:
            call = benchutil.captured(device, graphed[phase],
                                      generators=[gen])
        else:
            call = eager[phase]
        runs = benchutil.summary(benchutil.repeat_ms(device, call, REPS))
        out[phase] = benchutil.emit({"phase": phase, "ms": runs["median"],
                                     "runs": runs["runs"],
                                     "min_ms": runs["min"]})
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
