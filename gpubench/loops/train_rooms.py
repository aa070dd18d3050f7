"""Training on the device pipeline, one client in a closed loop, as
``python -m tumseg_torch.cli.train --data_pipeline device --superstep k``
trains an epoch: the rooms are uploaded once to a ``DeviceBlockSampler``,
``DeviceSampleLoader`` gives shuffled batches of room ids, and every k of
them are one ``TrainEngine.train_batch_rooms_multi`` call (``fit``'s
``_SuperstepBuffer``), at epoch 0's learning rate and BatchNorm momentum.

Set-up: the rooms (``tiles`` tiles of the mix), their class weights, the
weights, the engine, and its first two calls: the eager warm-up and the
capture, whose losses, parameters and Adam moments the check compares with
the reference. The window then makes calls until the first one that
returns at or after ``seconds``, and waits for the device. Before each
call it copies the parameters and Adam's moments aside (a few device
copies a call), so the check can also run the reference over the window's
last call from the state that call started from."""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace
from typing import Dict, Iterator

import numpy as np
import torch

from gpubench import check, spec, tiles
from gpubench.loops.common import (Window, derived, memory_peak,
                                   reset_peak, sync)


def class_weights(labels, num_classes: int) -> np.ndarray:
    """``(max(w) / w) ** (1/3)`` of the normalized label histogram, f32."""
    hist = np.bincount(np.concatenate(labels), minlength=num_classes)
    w = hist.astype(np.float32)
    w = w / np.sum(w)
    return np.power(np.amax(w) / w, 1.0 / 3.0)


def room_ids(rooms, num_point: int, sample_rate: float) -> np.ndarray:
    """A room per block of an epoch, in proportion to the rooms' points:
    ``TrainBlockDataset``'s sample list."""
    counts = np.asarray([r["xyz"].shape[0] for r in rooms])
    prob = counts / counts.sum()
    iters = int(counts.sum() * sample_rate / num_point)
    return np.concatenate([[i] * int(round(p * iters))
                           for i, p in enumerate(prob)]).astype(np.int64)


def calls(loader, k: int) -> Iterator[np.ndarray]:
    """[k, B] room ids a call, epoch after epoch; a group runs on into the
    next epoch, so every call is a k-step call and the window captures
    nothing (``fit`` ends an epoch's last group with single steps)."""
    buf = []
    while True:
        for batch in loader:
            buf.append(batch.room_ids)
            if len(buf) == k:
                yield np.stack(buf)
                buf = []


def run(env) -> Dict:
    from tumseg_torch import models
    from tumseg_torch.data.device_sampler import (DeviceBlockSampler,
                                                  DeviceSampleLoader)
    from tumseg_torch.train.loop import TrainEngine

    cfg, mix, device, seed = env.cfg, env.mix, env.device, env.seed
    t = cfg["train"]
    C, B, P, k = cfg["num_classes"], t["batch"], t["num_point"], t["superstep"]
    rooms = tiles.make_tiles(mix, derived(seed, 7),
                             tiles.cycle(mix, mix["tiles"]), C, device)
    reset_peak(device)
    weights_c = class_weights([r["labels"] for r in rooms], C)
    sampler = DeviceBlockSampler(
        [r["xyz"] for r in rooms], [r["labels"] for r in rooms],
        [r["extra"] for r in rooms], [True] * len(tiles.COLOURS),
        num_point=P, block_size=t["block_size"],
        min_block_points=t["min_block_points"], device=device)
    loader = DeviceSampleLoader(
        SimpleNamespace(room_idxs=room_ids(rooms, P, mix["sample_rate"])),
        batch_size=B, shuffle=True, drop_last=True, seed=derived(seed, 5))
    weights = spec.architecture(cfg).make_weights(cfg, derived(seed, 1),
                                                  device)
    model = models.get_module(cfg["model"]).get_model(C, len(tiles.COLOURS))
    model.load_state_dict({n: v.clone() for n, v in weights.items()})
    engine = TrainEngine(model, C, weights_c, optimizer=t["optimizer"],
                         weight_decay=t["weight_decay"],
                         seed=derived(seed, 6), device=device,
                         exact_gathers=not t["fast_gather"],
                         compute_dtype=env.compute_dtype, sampler=sampler,
                         cuda_graphs=t["cuda_graphs"])
    lr, momentum = t["lr"], t["bn_momentum"]
    stream = calls(loader, k)
    first = [next(stream) for _ in range(mix["check_calls"])]
    losses = []
    for ids in first:
        losses.append(engine.train_batch_rooms_multi(ids, lr, momentum)[0])
    sync(device)
    names = [n for n, _ in engine.model.named_parameters()]
    params = dict(engine.model.named_parameters())
    prog = {
        "losses": [float(v) for v in torch.cat(losses).cpu()],
        "params": {n: params[n].detach().clone() for n in names},
        "moments": {n: engine.optimizer.state[params[n]].get(
            "exp_avg", torch.zeros_like(params[n])).clone() for n in names}}

    rounds0 = sampler.stats["rounds"]
    from tumseg_torch.ops import kernels
    launches0 = dict(kernels.launches)
    state = [engine.optimizer.state[params[n]] for n in names]
    live = [params[n].detach() for n in names] + [
        st.get(key, torch.zeros_like(params[n]))
        for key in ("exp_avg", "exp_avg_sq") for n, st in zip(names, state)]
    snap = [x.clone() for x in live]
    gaps, n_calls = [], 0
    win = Window(device, env.trace)
    with win:
        last = win.start
        while True:
            ids = next(stream)
            torch._foreach_copy_(snap, live)
            result = engine.train_batch_rooms_multi(ids, lr, momentum)
            now = time.perf_counter()
            gaps.append(now - last)
            last = now
            n_calls += 1
            if now - win.start >= env.window():
                break
        seconds = win.close()
    peak = memory_peak(device)
    steps = n_calls * k
    ctx = {
        "window_s": seconds, "calls": n_calls, "steps": steps,
        "rounds": sampler.stats["rounds"] - rounds0,
        "launches": {n: kernels.launches[n] - launches0[n]
                     for n in kernels.launches},
        "cfg": cfg, "batch": B, "points": P, "train": True,
        "device": device.type,
    }
    gaps_ms = sorted(1e3 * g for g in gaps)
    print("call gaps (ms): median %.2f, p90 %.2f, max %.2f over %d" % (
        np.median(gaps_ms), np.percentile(gaps_ms, 90), gaps_ms[-1],
        len(gaps_ms)), file=sys.stderr)
    out = {
        "e2e": {"train_points_per_s": steps * B * P / seconds,
                "train_call_ms_p90": float(np.percentile(gaps_ms, 90))},
        "ctx": ctx, "trace": win.reduced(), "attempted": n_calls,
        "failed": 0, "memory_peak_bytes": peak,
        "window_start": win.start}
    L = len(names)
    last_call = {
        "ids": ids, "step": (len(first) + n_calls - 1) * k,
        "losses": [float(v) for v in result[0].cpu()],
        "start": dict(zip(names, snap[:L])),
        "start_moments": dict(zip(names, snap[L:2 * L])),
        "start_squares": dict(zip(names, snap[2 * L:])),
        "params": {n: x.clone() for n, x in zip(names, live[:L])},
        "moments": {n: x.clone() for n, x in zip(names, live[L:2 * L])}}
    del engine, model, sampler, params, state, live
    env.free()
    t0 = time.perf_counter()
    out["checks"] = check.train(cfg, weights, prog, rooms, first, weights_c,
                                derived(seed, 6), device, last_call)
    print("reference and comparison: %.1f s" % (time.perf_counter() - t0),
          file=sys.stderr)
    return out
