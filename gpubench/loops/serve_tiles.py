"""Serving a stream of new facade tiles, one client in a closed loop, as
``python -m tumseg_torch.cli.test`` serves its scenes: each tile is voted
``votes`` times by ``InferenceRunner.infer_scene`` on the device
re-blocking path, while one worker makes the next tile and stages it with
``InferenceRunner.prefetch_scene``, as ``run_testing`` does.

Set-up: the tiles (``distinct_tiles`` tiles of the mix's cycle of sizes
and one warm-up tile of the largest size, made in bulk on the device), the
weights (BatchNorm statistics calibrated on blocks of the warm-up tile by
the reference), the runner, and the warm-up tile, served in full. The
window then serves tiles 1, 2, ..., tile i with the points of made tile
``1 + (i - 1) % distinct_tiles``, each a new scene to the program, and
ends at the first tile completed at or after ``seconds``. The check runs
the reference over the last tile served, once the window has closed and
the program is freed."""

from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np
import torch

from gpubench import check, spec, tiles
from gpubench.loops.common import (Window, derived, memory_peak,
                                   reset_peak, sync)
from gpubench.reference import serve as ref_serve


def _dataset(cfg: Dict):
    from tumseg_torch.data.dataset import TestGridDataset

    s = cfg["serve"]
    ds = TestGridDataset(num_classes=cfg["num_classes"],
                         block_points=s["block_points"], stride=s["stride"],
                         block_size=s["block_size"], padding=s["padding"])
    ds.feature_name = list(tiles.COLOURS)
    ds.num_extra_features = len(tiles.COLOURS)
    return ds


def _put(ds, index: int, tile: Dict) -> None:
    for name in ("scene_points_list", "semantic_labels_list",
                 "extra_features_data", "file_list"):
        lst = getattr(ds, name)
        while len(lst) <= index:
            lst.append(None)
    ds.extra_features_data[index] = tile["extra"]
    ds.semantic_labels_list[index] = tile["labels"]
    ds.file_list[index] = f"tile_{index}.las"
    ds.scene_points_list[index] = tile["xyz"]


def _drop(ds, index: int) -> None:
    if index >= 0:
        for name in ("scene_points_list", "semantic_labels_list",
                     "extra_features_data"):
            getattr(ds, name)[index] = None


def calibration_blocks(cfg: Dict, tile: Dict, seed: int, count: int,
                       device) -> torch.Tensor:
    """``count`` blocks of the tile as serving featurizes them, around
    random wall points: [count, P, 6 + E] f32."""
    s = cfg["serve"]
    P, size = s["block_points"], s["block_size"]
    rng = np.random.default_rng(derived(seed, 3))
    xyz = tile["xyz"]
    extra = np.stack(tile["extra"], 1) / 255.0
    hi = xyz.max(0)
    out = []
    for c in rng.choice(xyz.shape[0], count, replace=False):
        near = np.nonzero((np.abs(xyz[:, 0] - xyz[c, 0]) <= size / 2)
                          & (np.abs(xyz[:, 1] - xyz[c, 1]) <= size / 2))[0]
        pick = rng.choice(near, P, replace=near.size < P)
        pts = xyz[pick]
        out.append(np.concatenate([pts[:, :2] - xyz[c, :2], pts[:, 2:],
                                   pts / hi, extra[pick]], 1))
    return torch.as_tensor(np.stack(out), dtype=torch.float32, device=device)


def _weights(cfg, seed, warm_tile, device):
    """The run's weights, BatchNorm statistics calibrated by the
    reference."""
    arch = spec.architecture(cfg)
    weights = arch.make_weights(cfg, derived(seed, 1), device)
    x = calibration_blocks(cfg, warm_tile, seed, cfg["serve"]["calibrate"],
                           device)
    with torch.no_grad():
        arch.Net(cfg, weights, "calibrate").forward(x)
    return weights


def _chunks(cfg: Dict, tile: Dict, device) -> int:
    """The B-block chunks of one vote of the tile (the reference's grid)."""
    s = cfg["serve"]
    cols = ref_serve.grid_columns(torch.as_tensor(tile["xyz"], device=device),
                                  s["block_size"], s["stride"], s["padding"])
    blocks = sum(-(-int(m.numel()) // s["block_points"]) for m, _, _ in cols)
    return -(-blocks // s["batch"])


def run(env) -> Dict:
    from tumseg_torch import models
    from tumseg_torch.infer.voting import InferenceRunner
    from tumseg_torch.ops import kernels

    cfg, mix, device, seed = env.cfg, env.mix, env.device, env.seed
    s = cfg["serve"]
    C, votes = cfg["num_classes"], s["votes"]
    made = tiles.make_tiles(
        mix, derived(seed, 7),
        [mix["warmup_points"]] + tiles.cycle(mix, mix["distinct_tiles"]), C,
        device)
    reset_peak(device)

    def make(index):
        """Tile ``index`` (0 the warm-up); made in set-up, as the CLI loads
        its tiles before it serves."""
        return made[0] if index == 0 else made[
            1 + (index - 1) % mix["distinct_tiles"]]

    warm = make(0)
    weights = _weights(cfg, seed, warm, device)
    model = models.get_module(cfg["model"]).get_model(C, len(tiles.COLOURS))
    model.load_state_dict({k: v.clone() for k, v in weights.items()})
    runner = InferenceRunner(model, C, batch_size=s["batch"], device=device,
                             compute_dtype=env.compute_dtype,
                             device_features=True, device_reblock=True,
                             seed=derived(seed, 4),
                             cuda_graphs=s["cuda_graphs"])
    ds = _dataset(cfg)
    prefetch_s = {}

    def stage(index):
        tile = make(index)
        _put(ds, index, tile)
        t0 = time.perf_counter()
        runner.prefetch_scene(ds, index)
        prefetch_s[index] = time.perf_counter() - t0
        return tile

    _put(ds, 0, warm)
    runner.prefetch_scene(ds, 0)
    worker = ThreadPoolExecutor(max_workers=1)
    staged = worker.submit(stage, 1)
    runner.infer_scene(ds, 0, votes)
    sync(device)

    served, ends, waits = [], [], []
    graphs = runner.graphs
    cap0 = graphs.capture_seconds if graphs else 0.0
    launches0 = dict(kernels.launches)
    win = Window(device, env.trace)
    try:
        with win:
            index = 1
            while True:
                t0 = time.perf_counter()
                tile = staged.result()
                waits.append(time.perf_counter() - t0)
                staged = worker.submit(stage, index + 1)
                labels = runner.infer_scene(ds, index, votes)
                served.append(tile["xyz"].shape[0])
                _drop(ds, index - 1)
                done = time.perf_counter() - win.start
                ends.append(done)
                if done >= env.window():
                    break
                index += 1
            seconds = win.close()
        staged.result()
    finally:
        worker.shutdown(wait=True)
    peak = memory_peak(device)
    tiles_n = len(served)
    kept = {"tile": tile, "labels": labels,
            "pool": runner._buffers["pool"].view(-1, C)[:-1].clone()}
    print("tile ends (s): " + " ".join("%.3f" % e for e in ends),
          file=sys.stderr)
    print("waits on the worker (s): " + " ".join("%.3f" % w for w in waits),
          file=sys.stderr)
    print("prefetch (s): " + " ".join(
        "%.3f" % prefetch_s[i] for i in range(1, tiles_n + 1)),
          file=sys.stderr)
    forwards = None
    if env.trace:
        chunks = {}
        for i in range(1, tiles_n + 1):
            tile_i = make(i)
            if id(tile_i) not in chunks:
                chunks[id(tile_i)] = _chunks(cfg, tile_i, device)
        forwards = votes * sum(chunks[id(make(i))]
                               for i in range(1, tiles_n + 1))
    ctx = {
        "window_s": seconds, "tiles": tiles_n, "votes": votes,
        "capture_s": (graphs.capture_seconds - cap0) if graphs else 0.0,
        "prefetch_s": [prefetch_s[i] for i in range(1, tiles_n + 1)],
        "launches": {k: kernels.launches[k] - launches0[k]
                     for k in kernels.launches},
        "cfg": cfg, "batch": s["batch"], "points": s["block_points"],
        "train": False, "forwards": forwards, "device": device.type,
    }
    out = {
        "e2e": {"serve_points_per_s": sum(served) * votes / seconds},
        "ctx": ctx, "trace": win.reduced(), "attempted": tiles_n,
        "failed": 0, "memory_peak_bytes": peak,
        "window_start": win.start}
    # the program's state is freed before the reference runs
    del runner, model, ds
    env.free()
    t0 = time.perf_counter()
    out["checks"] = check.serve(cfg, weights, kept, derived(seed, 4),
                                index, device)
    print("reference and comparison: %.1f s" % (time.perf_counter() - t0),
          file=sys.stderr)
    return out
