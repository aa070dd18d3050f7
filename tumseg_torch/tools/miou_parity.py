#!/usr/bin/env python
"""Trained-model mIoU of the port (the ``tumseg`` half of
``tools/miou_parity.py``): trains ``pointnet2_sem_seg`` from scratch on
seeded synthetic facade tiles through ``tumseg_torch.cli.train``, then
serves the best checkpoint on the held-out tile through
``tumseg_torch.cli.test`` and reports its mIoU.

``make_tiles`` writes the files ``tools/miou_parity.py`` writes at the same
seed, byte for byte, so the port at seed ``s`` trains on the tiles that
``tumseg`` and the reference trained on at ``s``, and its mIoU stands beside
theirs as recorded in ``PARITY.md``. The reference half (it needs the
reference's sources) and the ``tumseg`` half (it needs JAX) are not run
here.

Usage:  python -m tumseg_torch.tools.miou_parity [--epochs 6] [--npoint 512]
        [--seed 0] [--bf16] [--gpu 0] [--data_pipeline auto]
Prints one JSON line, ``{"miou_port", "seed", "config"}``; with
``--cross_eval --cross_seeds K`` the tester runs K more times with vote seeds
``seed + 100 (i + 1)`` and the line gains their mIoUs and spread. It runs on
``cuda:<gpu>``, on the CPU only with ``--gpu cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from tumseg_torch.ops import kernels
from tumseg_torch.tools.soak import launches_since


def make_tiles(tmpdir: str, seed: int, style: str = "small",
               points: int = 14000, color: bool = False):
    """Facade-like tiles whose labels are a learnable function of geometry.

    ``small`` (default, the round-1/2 config): 2 m x 1 m x 2.5 m tiles with a
    window grid / door / molding pattern. ``facade`` (production scale): the
    soak benchmark's 20 m x 4 m x 12 m structured facades (z bands + window
    stripes, optional label-correlated RGB) — dense enough for 4096-point
    1 m blocks, where mIoU trains into the 0.4+ regime.

    Raw 18-class codes (merged to 8 by --class8): wall(1), window(2),
    door(3), molding(5), terrain(12)."""
    from tumseg_torch.data.las import write_las

    paths = []
    r = np.random.default_rng(seed)
    for i, name in enumerate(["a.las", "b.las", "t.las"]):
        n = points
        if style == "facade":
            x = r.uniform(0, 20.0, n)
            y = r.uniform(0, 4.0, n)
            z = r.uniform(0, 12.0, n)
            labels = np.full(n, 1)                          # wall
            labels[z < 0.5] = 3                             # ground band
            stripe = ((x // 2).astype(int) % 2 == 1) & (z > 2)
            labels[stripe] = 2                              # window stripes
            labels[z > 11.0] = 7                            # roof band
        else:
            x = r.uniform(0, 2.0, n)
            y = r.uniform(0, 1.0, n)
            z = r.uniform(0, 2.5, n)
            labels = np.full(n, 1)                          # wall
            labels[z < 0.3] = 12                            # terrain
            win = ((np.floor(x / 0.5) % 2 == 0)
                   & (np.floor(z / 0.7) % 2 == 1) & (z > 0.8))
            labels[win] = 2                                 # window grid
            labels[(np.abs(x - 1.0) < 0.12) & (z < 0.9)
                   & (z >= 0.3)] = 3                        # door
            labels[np.abs(z - 1.6) < 0.06] = 5              # molding band
        kw = {}
        if color:
            rgb = np.full((n, 3), 120, np.int64)
            for lab, col in [(1, (200, 60, 60)), (2, (60, 60, 200)),
                             (3, (60, 200, 60)), (7, (200, 200, 60))]:
                m = labels == lab
                rgb[m] = (np.asarray(col)
                          + r.integers(-30, 30, (int(m.sum()), 3)))
            kw["rgb"] = np.clip(rgb, 0, 255).astype(np.uint16)
        p = f"{tmpdir}/{name}"
        write_las(p, np.stack([x, y, z], 1), labels, **kw)
        paths.append(p)
    return paths[:2], paths[2]


def _common_flags(test_path, args, tmpdir, seed):
    """``tools/miou_parity.py``'s flags, plus the device and ``--bf16``."""
    flags = [
        "--rootdir", tmpdir, "--test_area", test_path.rsplit("/", 1)[1],
        "--model", "pointnet2_sem_seg", "--class8",
        "--exp_dir", f"{tmpdir}/log", "--log_dir", "parity",
        "--seed", str(seed), "--gpu", args.gpu,
    ]
    if not args.color:
        flags.append("--RGB_OFF")
    if args.bf16:
        flags.append("--bf16")
    return flags


def train_port(test_path, args, tmpdir):
    """Trains through the port's CLI; returns its (accuracy, eval loss,
    eval mIoU) charts, one entry an epoch."""
    from tumseg_torch.cli import train as train_cli

    targs = train_cli.parse_args(
        _common_flags(test_path, args, tmpdir, args.seed) + [
            "--epoch", str(args.epochs), "--batch_size", str(args.batch),
            "--npoint", str(args.npoint),
            "--data_pipeline", args.data_pipeline])
    return train_cli.main(targs)


def serve_port(test_path, args, tmpdir, seed=None):
    """Voting test against the trained checkpoint; ``seed`` varies only the
    vote re-blocking randomness (training is untouched)."""
    from tumseg_torch.cli import test as test_cli

    eargs = test_cli.parse_args(
        _common_flags(test_path, args, tmpdir,
                      args.seed if seed is None else seed) + [
            "--exp_dir", f"{tmpdir}/log/sem_seg/",
            "--batch_size", str(args.batch), "--num_point", str(args.npoint),
            "--num_votes", str(args.votes)])
    out = test_cli.main(eargs)
    return float(out["miou"])


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--npoint", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--votes", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--tile_style", choices=["small", "facade"],
                    default="small",
                    help="'facade' = production-scale soak-style 20x4x12 m "
                         "structured tiles (use with --npoint 4096)")
    ap.add_argument("--tile_points", type=int, default=14000)
    ap.add_argument("--color", action="store_true",
                    help="label-correlated RGB tiles + color channels "
                         "(the reference's default taxonomy trains WITH "
                         "color)")
    ap.add_argument("--cross_eval", action="store_true",
                    help="also run the tester with --cross_seeds other vote "
                         "seeds (the port's tester only: the reference's "
                         "is not run here)")
    ap.add_argument("--cross_seeds", type=int, default=1,
                    help="vote seeds of --cross_eval, for a vote-sampling "
                         "spread")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute in training and testing")
    ap.add_argument("--gpu", default="0",
                    help="CUDA device index, or 'cpu'")
    ap.add_argument("--data_pipeline", choices=["auto", "host", "device"],
                    default="auto",
                    help="the training CLI's: 'host' trains on the blocks "
                         "tumseg's host loader draws, as tools/"
                         "miou_parity.py's runs on the CPU did")
    return ap.parse_args(argv)


def run(args):
    """Makes the tiles, trains and tests. Returns (the JSON line's dict,
    the run's details: per-epoch eval mIoU, seconds, and each kernel's
    launches in training and in the first test)."""
    tmpdir = args.workdir or tempfile.mkdtemp(prefix="miou_parity_")
    os.makedirs(tmpdir, exist_ok=True)
    # the training CLI resumes a best_model.pth it finds: start afresh
    shutil.rmtree(os.path.join(tmpdir, "log"), ignore_errors=True)
    _, test_path = make_tiles(tmpdir, args.seed, style=args.tile_style,
                              points=args.tile_points, color=args.color)

    before = dict(kernels.launches)
    t0 = time.perf_counter()
    _, _, eval_mious = train_port(test_path, args, tmpdir)
    train_s = time.perf_counter() - t0
    train_launches = launches_since(before)
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    miou = serve_port(test_path, args, tmpdir)
    test_s = time.perf_counter() - t0
    test_launches = launches_since(before)

    out = {"miou_port": round(miou, 4), "seed": args.seed,
           "config": vars(args)}
    if args.cross_eval:
        seeds = [args.seed + 100 * (i + 1) for i in range(args.cross_seeds)]
        scores = [serve_port(test_path, args, tmpdir, seed=s) for s in seeds]
        out["cross_seeds"] = seeds
        out["cross_mious"] = [round(v, 4) for v in scores]
        out["cross_spread_pts"] = round(float(np.ptp(scores)) * 100, 2)
    details = {"miou": miou, "eval_mious": [float(v) for v in eval_mious],
               "train_seconds": train_s, "test_seconds": test_s,
               "train_launches": train_launches,
               "test_launches": test_launches}
    return out, details


def main(argv=None) -> int:
    out, _ = run(parse_args(argv))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
