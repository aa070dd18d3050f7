#!/usr/bin/env python
"""Production-scale CLI soak of the port (``benchmarks/soak.py``): three
600K-point facade tiles, ``pointnet2_sem_seg`` with ``--class8 --bf16`` and
colour on, 3 epochs of training at B=16 x 4096 with checkpoints and
per-epoch eval through ``tumseg_torch.cli.train``, then a 3-vote B=32 x
4096 whole-scene test with ``--visual`` through ``tumseg_torch.cli.test``.

Usage: python -m tumseg_torch.tools.soak [--points 600000] [--epochs 3]
       [--votes 3] [--workdir DIR] [--gpu 0]

Prints one JSON line a phase (``synth``, ``train``, ``test``) and a
``summary`` line whose ``ok`` is the soak's gate: finite losses, mIoU > 0.3,
``checkpoints/best_model.pth`` written, and ``visual/test_tile.txt`` holding
one label a point of the tile. Exits non-zero when ``ok`` is false. It runs
on ``cuda:<gpu>``, on the CPU only with ``--gpu cpu`` (``--npoint``,
``--batch_size`` and ``--test_batch_size`` shrink it for that).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from tumseg_torch.ops import kernels
from tumseg_torch.viz.writers import read_labels_txt

MIOU_GATE = 0.3
TILES = [("facadeA.las", 0), ("facadeB.las", 1), ("test_tile.las", 2)]


def make_tile(path, n, seed):
    """Facade-shaped tile: 20m x 4m x 12m with crude structure so labels
    are learnable (z-bands + wall/window stripes), RGB correlated."""
    r = np.random.default_rng(seed)
    xyz = np.stack([r.uniform(0, 20, n), r.uniform(0, 4, n),
                    r.uniform(0, 12, n)], 1)
    labels = np.full(n, 1)                    # wall
    labels[xyz[:, 2] < 0.5] = 3               # ground band
    stripe = ((xyz[:, 0] // 2).astype(int) % 2 == 1) & (xyz[:, 2] > 2)
    labels[stripe] = 2                        # window stripes
    labels[xyz[:, 2] > 11.0] = 7              # roof band
    rgb = np.zeros((n, 3), np.uint16)
    for lab, col in [(1, (200, 60, 60)), (2, (60, 60, 200)),
                     (3, (60, 200, 60)), (7, (200, 200, 60))]:
        m = labels == lab
        rgb[m] = np.asarray(col) + r.integers(-30, 30, (int(m.sum()), 3))
    from tumseg_torch.data.las import write_las

    write_las(path, xyz, labels, rgb=rgb.astype(np.uint16))
    return n


def launches_since(before):
    """Each kernel's launches since the snapshot ``before``."""
    return {k: kernels.launches[k] - before[k] for k in kernels.launches}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=600_000)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--votes", type=int, default=3)
    ap.add_argument("--workdir", default=None,
                    help="made anew; default a new temporary directory")
    ap.add_argument("--gpu", default="0",
                    help="CUDA device index, or 'cpu'")
    ap.add_argument("--npoint", type=int, default=4096)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--test_batch_size", type=int, default=32)
    return ap.parse_args(argv)


def gate(checks) -> bool:
    """The soak's gate: finite losses, mIoU > 0.3, the checkpoint, and one
    label a point of the tile in the label dump."""
    return bool(checks["losses_finite"] and checks["miou"] > MIOU_GATE
                and checks["checkpoint"]
                and checks["visual_labels"] == checks["points"])


def run(args):
    """Runs the soak, printing its four phase lines. Returns the summary
    line's dict with, beside it, what the lines do not carry: the per-epoch
    eval mIoU, the served mIoU unrounded and each kernel's launches in
    training and in testing."""
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.cli import train as train_cli

    work = Path(args.workdir or tempfile.mkdtemp(prefix="tumseg_soak_"))
    shutil.rmtree(work, ignore_errors=True)
    (work / "data").mkdir(parents=True)

    t0 = time.perf_counter()
    for name, seed in TILES:
        make_tile(str(work / "data" / name), args.points, seed)
    print(json.dumps({"phase": "synth", "tiles": len(TILES),
                      "points": args.points,
                      "s": round(time.perf_counter() - t0, 1)}), flush=True)

    common = [
        "--rootdir", str(work / "data"),
        "--test_area", "test_tile.las",
        "--model", "pointnet2_sem_seg",
        "--class8", "--bf16",
        "--exp_dir", str(work / "log"),
        "--log_dir", "soak",
        "--seed", "0",
        "--gpu", args.gpu,
    ]
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    targs = train_cli.parse_args(common + [
        "--epoch", str(args.epochs), "--batch_size", str(args.batch_size),
        "--npoint", str(args.npoint)])
    acc, ml, iou = train_cli.main(targs)
    train_s = time.perf_counter() - t0
    train_launches = launches_since(before)
    print(json.dumps({"phase": "train", "epochs": args.epochs,
                      "s": round(train_s, 1),
                      "final_loss": round(float(ml[-1]), 4),
                      "final_acc": round(float(acc[-1]), 4),
                      "final_eval_miou": round(float(iou[-1]), 4)}),
          flush=True)

    before = dict(kernels.launches)
    t0 = time.perf_counter()
    eargs = test_cli.parse_args(common + [
        "--exp_dir", str(work / "log") + "/sem_seg/",
        "--batch_size", str(args.test_batch_size),
        "--num_point", str(args.npoint),
        "--num_votes", str(args.votes), "--visual"])
    out = test_cli.main(eargs)
    test_s = time.perf_counter() - t0
    test_launches = launches_since(before)
    print(json.dumps({"phase": "test", "votes": args.votes,
                      "s": round(test_s, 1),
                      "miou": round(float(out["miou"]), 4),
                      "scene_pts_per_s": round(
                          args.points * args.votes / test_s, 1)}), flush=True)

    run_dir = work / "log" / "sem_seg" / "soak"
    visual = run_dir / "visual" / "test_tile.txt"
    checks = {
        "losses_finite": bool(np.isfinite(ml).all()),
        "miou": float(out["miou"]),
        "checkpoint": (run_dir / "checkpoints" / "best_model.pth").exists(),
        "visual_labels": (read_labels_txt(str(visual)).size
                          if visual.exists() else 0),
        "points": args.points,
    }
    summary = {"phase": "summary", "ok": gate(checks),
               "train_s": round(train_s, 1), "test_s": round(test_s, 1),
               "losses_finite": checks["losses_finite"],
               "checkpoint": checks["checkpoint"],
               "visual_labels": checks["visual_labels"]}
    print(json.dumps(summary), flush=True)
    return dict(summary, miou=float(out["miou"]), points=args.points,
                eval_mious=[float(v) for v in iou],
                train_launches=train_launches, test_launches=test_launches,
                train_seconds=train_s, test_seconds=test_s)


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
