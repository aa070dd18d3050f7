"""The comparisons that decide ``correct``: what the timed path produced
against the plain reference (``gpubench/reference``), run once the window
has closed and the program's state is freed. Each returns a list of
(name, value) pairs; ``limits/<workload>.json`` gives each its limit.

Serving, over the last tile that the window served (every vote of it):

- ``votes_gap``: |votes the program's pool holds - votes the reference's
  holds|, exact (a vote lost or doubled changes it);
- ``pool_rows_off``: the share of the tile's points whose pool row (the
  votes of each class) differs from the reference's;
- ``labels_off``: the share of the tile's points whose served label
  differs from the reference's.

Training, over two stretches, each number the larger of its two readings:
the set-up's two calls (the eager warm-up and the captured call that the
window replays), followed by the reference from the same weights, rooms,
room ids and seed; and the window's last call, followed by the reference
from the parameters and Adam moments that call started from (copied aside
before it), at the step count and draws that the harness counts for it:

- ``loss_gap``: the largest |program - reference| / |reference| over the
  steps' losses;
- ``moment_gap``: Adam's first moment after the calls, the worst leaf's
  |norm(program) - norm(reference)| over the larger of the reference's
  norm of that leaf and of the median leaf;
- ``change_gap``: the same of each leaf's change over the calls.

The last two leave out the leaves whose gradient in the reference's first
step is under a thousandth of the median leaf's (the biases of the convs
that a BatchNorm follows, moved by round-off alone).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from gpubench.reference import serve as ref_serve
from gpubench.reference import train as ref_train


def serve(cfg: Dict, weights, kept: Dict, seed: int, tile_index: int,
          device) -> List[Tuple[str, float]]:
    tile = kept["tile"]
    t = {"xyz": torch.as_tensor(tile["xyz"], device=device),
         "extra": torch.as_tensor(np.stack(tile["extra"], 1), device=device),
         "color": torch.ones(len(tile["extra"]), dtype=torch.bool,
                             device=device)}
    ref = ref_serve.vote_pool(cfg, weights, t, seed, tile_index, cfg["serve"])
    pool = kept["pool"].to(device)
    labels = torch.as_tensor(kept["labels"], device=device)
    n = ref.shape[0]
    return [
        ("votes_gap", float((pool.sum() - ref.sum()).abs())),
        ("pool_rows_off", float((pool != ref).any(1).sum()) / n),
        ("labels_off", float((labels != ref.argmax(1)).sum()) / n),
    ]


def _norm_gap(prog: Dict, ref: Dict, names) -> float:
    norms = {n: float(ref[n].norm()) for n in names}
    median = float(np.median(list(norms.values())))
    return max(abs(float(prog[n].float().norm()) - norms[n])
               / max(norms[n], median) for n in names)


def _train_gaps(prog_losses, prog_moments, prog_change, ref_losses,
                ref_moments, ref_change, kept) -> List[float]:
    ref_loss = np.asarray(ref_losses)
    return [float(np.max(np.abs(np.asarray(prog_losses) - ref_loss)
                         / np.abs(ref_loss))),
            _norm_gap(prog_moments, ref_moments, kept),
            _norm_gap(prog_change, ref_change, kept)]


def train(cfg: Dict, weights, prog: Dict, rooms, calls, class_weights,
          seed: int, device, last: Dict) -> List[Tuple[str, float]]:
    rooms = [dict(r, color=[True] * len(r["extra"])) for r in rooms]
    t = cfg["train"]
    tables = ref_train.Rooms(rooms, t["num_point"], t["block_size"],
                             t["min_block_points"], device)
    cw = torch.as_tensor(class_weights, device=device)
    losses, params, moments, first = ref_train.train_calls(
        cfg, weights, tables, calls, cw, seed, t)
    median = float(np.median(list(first.values())))
    kept = [n for n in params if first[n] >= 1e-3 * median]
    on = {n: v.to(device) for n, v in prog["params"].items()}
    start = _train_gaps(
        prog["losses"], {n: prog["moments"][n].to(device) for n in kept},
        {n: on[n] - weights[n] for n in kept}, losses, moments,
        {n: params[n] - weights[n] for n in kept}, kept)
    del params, moments
    begin = dict(weights, **{n: v.to(device)
                             for n, v in last["start"].items()})
    losses, params, moments, _ = ref_train.train_calls(
        cfg, begin, tables, [last["ids"]], cw, seed, t,
        start={"step": last["step"], "moments": last["start_moments"],
               "squares": last["start_squares"]})
    end = _train_gaps(
        last["losses"], {n: last["moments"][n].to(device) for n in kept},
        {n: last["params"][n].to(device) - begin[n] for n in kept},
        losses, moments, {n: params[n] - begin[n] for n in kept}, kept)
    names = ("loss_gap", "moment_gap", "change_gap")
    print("set-up calls: " + ", ".join(
        "%s %r" % p for p in zip(names, start)), file=sys.stderr)
    print("last call (step %d): " % last["step"] + ", ".join(
        "%s %r" % p for p in zip(names, end)), file=sys.stderr)
    return [(n, max(a, b)) for n, a, b in zip(names, start, end)]
