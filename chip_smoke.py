#!/usr/bin/env python3
"""On-card smoke test of the tumseg_torch port: ``python3 chip_smoke.py``
from the root of a checkout, on a machine with one NVIDIA GPU.

a. prints the card's name and power limit, builds the CUDA kernels from
   ``tumseg_torch/csrc`` and prints the build time;
b. runs each kernel and its plain PyTorch version on the same inputs at the
   shapes of a B=32 x 4096-point forward of ``pointnet2_sem_seg`` and holds
   them equal (indices identical, grouping bitwise, interpolation within
   rtol 1e-5 / atol 1e-6), timing both with CUDA events;
c. runs that forward with the kernels and with the plain versions: log-probs
   within 1e-4 and argmax equal on >= 99.99% of points, both timed;
d. serves a synthetic ~300K-point facade tile through
   ``tumseg_torch.cli.test.main`` (2 votes, the seeded random weights of c,
   BN statistics calibrated on facade blocks), checks the report and the
   label dump, and checks that every kernel was launched at least
   (forwards x launches per forward) times in that run;
e. runs each backward kernel and its plain version on unit-normal
   cotangents at the shapes of a B=16 x 4096 training step (group at
   sa2-sa4, plus sentinel rows and repeated indices; interpolation at
   fp1-fp4), holds them within rtol 1e-5 / atol 1e-4 (f32 atomics add in
   a varying order) and times both;
f. takes one training step (train-mode BN, weighted NLL, backward) of the
   seeded model on one B=16 x 4096 batch with the kernels and under
   ``ops.plain()``: loss within rtol 1e-5, every parameter gradient within
   1e-4 of the largest gradient of its layer; then times the step
   (forward + backward + Adam) both ways;
g. trains through ``tumseg_torch.cli.train.main`` on a synthetic ~600K-point
   facade tile (2 epochs, B=16 x 4096, >= 10 steps), checks that the logged
   losses are finite, that ``best_model.pth`` serves through
   ``tumseg_torch.cli.test``, and that the backward kernels were launched at
   least steps x 3 (group: sa2-sa4) and steps x 4 (interpolation: fp1-fp4)
   times in that run.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``. Any failed phase raises, and the script
then exits non-zero without printing either line. Without a CUDA device it
exits with code 2.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

SEED = 0
DEVICE = "cuda:0"
B, N = 32, 4096
TRAIN_B = 16
SCENE_POINTS = 300_000
TRAIN_POINTS = 600_000
HELD_OUT_POINTS = 50_000
TRAIN_EPOCHS = 2
SA = [(1024, 0.1), (256, 0.2), (64, 0.4), (16, 0.8)]  # (npoint, radius)
K = 32
SA_CHANNELS = [9, 67, 131, 259]  # grouped channels of sa1..sa4
FP_D = [128, 256, 256, 512]  # points2 channels of fp1..fp4
REPLACES = {
    "fps": "tumseg/ops/pallas/fps.py:39",
    "ball_query": "tumseg/ops/pallas/ballquery.py:279",
    "group": "tumseg/ops/pallas/group.py:60",
    "three_nn_interpolate": "tumseg/ops/pallas/threenn.py:70",
    "group_backward": "tumseg/ops/pallas/group.py:75",
    "interpolate_backward": "tumseg/ops/pallas/interpolate.py:48",
}
SOURCES = {
    "fps": "tumseg_torch/csrc/fps.cu",
    "ball_query": "tumseg_torch/csrc/ball_query.cu",
    "group": "tumseg_torch/csrc/group.cu",
    "three_nn_interpolate": "tumseg_torch/csrc/three_nn_interpolate.cu",
    "group_backward": "tumseg_torch/csrc/group_backward.cu",
    "interpolate_backward": "tumseg_torch/csrc/interpolate_backward.cu",
}
# launches of each kernel in one forward: group runs once per set
# abstraction for the neighbourhoods and once for the centroid gather
PER_FORWARD = {"fps": 4, "ball_query": 4, "group": 8,
               "three_nn_interpolate": 4}


def facade_blocks(rng, b, n):
    """[b, n, 3] points of 1 m x 1 m x 10 m columns: most on a wall plane
    (y ~ 0, 2 cm noise), the rest spread through the column's depth."""
    x = rng.uniform(-0.5, 0.5, (b, n))
    on_wall = rng.random((b, n)) < 0.7
    y = np.where(on_wall, rng.normal(0.0, 0.02, (b, n)),
                 rng.uniform(-0.5, 0.5, (b, n)))
    z = rng.uniform(0.0, 10.0, (b, n))
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def facade_batch(rng, b, n):
    """[b, n, 6] model inputs of facade blocks: block-relative xyz, then xyz
    normalised by the batch's extent."""
    xyz = facade_blocks(rng, b, n)
    norm = xyz - xyz.min(axis=(0, 1)) + 0.01
    return np.concatenate([xyz, norm / norm.max(axis=(0, 1))],
                          axis=-1).astype(np.float32)


def write_facade_tile(rng, path, n):
    """A 20 m x 2 m x 15 m facade tile of ``n`` points, 80% on a wall,
    labelled with all 8 classes."""
    from tumseg.data.las import write_las

    on_wall = rng.random(n) < 0.8
    xyz = np.stack([rng.uniform(0.0, 20.0, n),
                    np.where(on_wall, 1.0 + rng.normal(0.0, 0.03, n),
                             rng.uniform(0.0, 2.0, n)),
                    rng.uniform(0.0, 15.0, n)], axis=1)
    write_las(str(path), xyz, rng.choice([1, 2, 3, 6, 13, 11, 7, 8], n))


def time_ms(torch, fn, reps):
    """Median over 3 runs of the mean per-call device time (CUDA events
    around ``reps`` calls) after one warm-up call; also returns the runs."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / reps)
    return float(np.median(runs)), runs


class Report:
    def __init__(self):
        self.kernels = {name: {"name": name, "route": "cuda",
                               "source": SOURCES[name],
                               "replaces": REPLACES[name], "launches": 0,
                               "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
                        for name in SOURCES}

    def add(self, torch, name, label, kernel_fn, plain_fn, err, reps=20,
            plain_reps=3, phase="b", on_path=True):
        """Times ``kernel_fn`` and ``plain_fn``; the times of the shapes the
        main path runs (``on_path``) add up to the kernel's ms per forward
        (phase b) or per training step (phase e)."""
        ms, runs = time_ms(torch, kernel_fn, reps)
        pms, pruns = time_ms(torch, plain_fn, plain_reps)
        k = self.kernels[name]
        if on_path:
            k["ms"] += ms
            k["plain_ms"] += pms
        k["max_abs_err"] = max(k["max_abs_err"], float(err))
        print(f"[{phase}] {name:22s} {label:28s} kernel {ms:9.4f} ms "
              f"{[round(r, 4) for r in runs]}  plain {pms:9.4f} ms "
              f"{[round(r, 4) for r in pruns]}  max|err| {err:g}")


def phase_kernels(torch, report):
    from tumseg_torch.ops import core, kernels

    rng = np.random.default_rng(SEED)
    dev = torch.device(DEVICE)
    xyz = torch.as_tensor(facade_blocks(rng, B, N), device=dev)
    xyzs, idxs = [xyz], []
    for npoint, radius in SA:
        src = xyzs[-1]
        f_k = kernels.farthest_point_sample(src, npoint)
        f_p = core.farthest_point_sample(src, npoint)
        if not torch.equal(f_k, f_p):
            raise AssertionError(f"fps {src.shape[1]}->{npoint}: indices "
                                 "differ from the plain version")
        report.add(torch, "fps", f"N={src.shape[1]} npoint={npoint}",
                   lambda: kernels.farthest_point_sample(src, npoint),
                   lambda: core.farthest_point_sample(src, npoint), 0.0,
                   reps=5, plain_reps=1)

        g_k = kernels.group_points(f_k[:, :, None].contiguous(), src,
                                   torch.zeros_like(src[:, :npoint]))
        g_p = core.gather_rows(src, f_k)
        if not torch.equal(g_k[:, :, 0], g_p):
            raise AssertionError("gather_rows differs from the plain version")
        idx1 = f_k[:, :, None].contiguous()
        zc = torch.zeros(B, npoint, 3, device=dev)
        report.add(torch, "group", f"gather_rows N={src.shape[1]} S={npoint}",
                   lambda: kernels.group_points(idx1, src, zc),
                   lambda: core.group_points(idx1, src, zc), 0.0)
        new_xyz = g_p.contiguous()

        b_k = kernels.query_ball_point(radius, K, src, new_xyz)
        b_p = core.query_ball_point(radius, K, src, new_xyz)
        if not torch.equal(b_k, b_p):
            bad = (b_k != b_p).any(-1).float().mean().item()
            raise AssertionError(f"ball query r={radius}: {bad:.2e} of "
                                 "queries differ from the plain version")
        report.add(torch, "ball_query",
                   f"N={src.shape[1]} S={npoint} r={radius}",
                   lambda: kernels.query_ball_point(radius, K, src, new_xyz),
                   lambda: core.query_ball_point(radius, K, src, new_xyz), 0.0,
                   plain_reps=2)
        xyzs.append(new_xyz)
        idxs.append(b_k)

    far = torch.full((1, 1, 3), 1000.0, device=dev)
    empty = kernels.query_ball_point(0.1, K, xyz[:1].contiguous(), far)
    if not (empty == N).all() or not torch.equal(
            empty, core.query_ball_point(0.1, K, xyz[:1], far)):
        raise AssertionError("empty ball must give the sentinel N")
    print("[b] ball_query empty ball -> sentinel N: ok")

    for stage, (C, idx, ctr) in enumerate(zip(SA_CHANNELS, idxs, xyzs[1:])):
        src_xyz = xyzs[stage]
        feats = torch.as_tensor(
            rng.standard_normal((B, src_xyz.shape[1], C - 3)).astype(
                np.float32), device=dev)
        src = torch.cat([src_xyz, feats], dim=-1)
        g_k = kernels.group_points(idx, src, ctr)
        g_p = core.group_points(idx, src, ctr)
        if not torch.equal(g_k, g_p):
            raise AssertionError(f"group sa{stage + 1} C={C} is not bitwise "
                                 "equal to the plain version")
        if stage in (0, 3):
            sent = idx.clone()
            sent[:, :, 5] = src.shape[1]
            s_k = kernels.group_points(sent, src, ctr)
            want = torch.cat([-ctr, torch.zeros_like(feats[:, :ctr.shape[1]])],
                             dim=-1)
            if not (torch.equal(s_k, core.group_points(sent, src, ctr))
                    and torch.equal(s_k[:, :, 5], want)):
                raise AssertionError("group sentinel row must read as zeros")
        report.add(torch, "group", f"sa{stage + 1} S={idx.shape[1]} C={C}",
                   lambda: kernels.group_points(idx, src, ctr),
                   lambda: core.group_points(idx, src, ctr), 0.0)

    for xyz1, xyz2, d in zip(xyzs[:-1], xyzs[1:], FP_D):
        n1, s = xyz1.shape[1], xyz2.shape[1]
        p2 = torch.as_tensor(rng.standard_normal((B, s, d)).astype(np.float32),
                             device=dev)
        dk, ik, ok = kernels.three_nn_interpolate(xyz1, xyz2, p2)
        dp, ip, op = core.three_nn_interpolate(xyz1, xyz2, p2)
        if not (torch.equal(ik, ip) and torch.equal(dk, dp)):
            raise AssertionError(f"3-NN N={n1} S={s}: indices or distances "
                                 "differ from the plain version")
        torch.testing.assert_close(ok, op, rtol=1e-5, atol=1e-6)
        err = (ok - op).abs().max().item()
        report.add(torch, "three_nn_interpolate", f"N={n1} S={s} D={d}",
                   lambda: kernels.three_nn_interpolate(xyz1, xyz2, p2),
                   lambda: core.three_nn_interpolate(xyz1, xyz2, p2), err,
                   plain_reps=2)


def phase_forward(torch):
    from tumseg_torch import ops
    from tumseg_torch.models.pointnet2_sem_seg import get_model
    from tumseg_torch.nn.layers import calibrate_batch_norm

    x = torch.as_tensor(facade_batch(np.random.default_rng(SEED + 1), B, N),
                        device=DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    model = get_model(8).to(DEVICE).eval()
    # BN statistics of these blocks make the random net's labels depend on
    # its input (calibrated through the kernels, before any count is read)
    calibrate_batch_norm(model, x)

    def kernel_fwd():
        return model(x)[0]

    def plain_fwd():
        with ops.plain():
            return model(x)[0]

    with torch.inference_mode():
        lk, lp = kernel_fwd(), plain_fwd()
        if lk.shape != (B, N, 8) or not torch.isfinite(lk).all():
            raise AssertionError("forward log-probs not finite / bad shape")
        diff = (lk - lp).abs().max().item()
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        classes = lk.argmax(-1).unique().numel()
        print(f"[c] forward B={B}x{N}: max|dlogp| {diff:g}, argmax agree "
              f"{agree:.6f}, {classes} classes predicted")
        if diff > 1e-4 or agree < 0.9999:
            raise AssertionError("kernel forward disagrees with plain")
        if classes < 2:
            raise AssertionError("constant labels: the check would be void")
        kms, kruns = time_ms(torch, kernel_fwd, 3)
        pms, pruns = time_ms(torch, plain_fwd, 1)
    print(f"[c] forward kernels {kms:.3f} ms {[round(r, 3) for r in kruns]}; "
          f"plain {pms:.3f} ms {[round(r, 3) for r in pruns]}")
    return {k: v.cpu() for k, v in model.state_dict().items()}


def phase_serve(torch, work, state_dict):
    from tumseg.data.dataset import TestGridDataset
    from tumseg.viz.writers import read_labels_txt
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.models.convert import variables_from_state_dict
    from tumseg_torch.ops import kernels
    from tumseg_torch.train.checkpoint import save_checkpoint

    rng = np.random.default_rng(SEED + 2)
    n = SCENE_POINTS
    data = work / "data"
    data.mkdir(parents=True)
    write_facade_tile(rng, data / "facade.las", n)

    ckpt_dir = work / "log" / "sem_seg" / "smoke" / "checkpoints"
    ckpt_dir.mkdir(parents=True)
    save_checkpoint(str(ckpt_dir / "best_model.pth"), epoch=0,
                    variables=variables_from_state_dict(state_dict))

    votes = 2
    args = test_cli.parse_args([
        "--rootdir", str(data), "--test_area", "facade.las",
        "--exp_dir", str(work / "log") + "/sem_seg/", "--log_dir", "smoke",
        "--num_votes", str(votes), "--batch_size", str(B),
        "--num_point", str(N), "--class8", "--RGB_OFF", "--seed", str(SEED)])
    kernels.reset_launches()
    out = test_cli.main(args)
    launches = dict(kernels.launches)

    if not math.isfinite(out["miou"]) or not 0.0 <= out["miou"] <= 1.0:
        raise AssertionError(f"mIoU {out['miou']} is not a finite ratio")
    txt = work / "log" / "sem_seg" / "smoke" / "visual" / "facade.txt"
    pred = read_labels_txt(str(txt))
    if pred.shape != (n,) or pred.min() < 0 or pred.max() >= 8:
        raise AssertionError(f"{txt}: {pred.shape} labels for {n} points")
    if len(np.unique(pred)) < 2:
        raise AssertionError("served labels are constant")
    cells = TestGridDataset(las_file_list=[str(data / "facade.las")],
                            num_classes=8, block_points=N, color=False,
                            class8=True).grid_structure(0)
    blocks = sum(math.ceil(c[0].size / N) for c in cells)
    forwards = votes * math.ceil(blocks / B)
    for name, per in PER_FORWARD.items():
        if launches[name] < forwards * per:
            raise AssertionError(f"{name}: {launches[name]} launches in the "
                                 f"serving run, expected >= {forwards * per}")
    rate = n * votes / out["infer_seconds"]
    print(f"[d] served {n} points x {votes} votes ({blocks} blocks/vote, "
          f"{forwards} forwards) in {out['infer_seconds']:.3f} s: "
          f"{rate:.0f} scene-points/s; mIoU {out['miou']:.4f}; "
          f"launches {launches}")
    return launches

def phase_backward(torch, report):
    from tumseg_torch.ops import core, kernels

    rng = np.random.default_rng(SEED + 3)
    dev = torch.device(DEVICE)

    def check(name, label, kernel_fn, plain_fn, on_path=True):
        got, want = kernel_fn(), plain_fn()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        err = (got - want).abs().max().item()
        report.add(torch, name, label, kernel_fn, plain_fn, err,
                   phase="e", on_path=on_path)

    xyz = torch.as_tensor(facade_blocks(rng, TRAIN_B, N), device=dev)
    xyzs, idxs = [xyz], []
    for npoint, radius in SA:
        fps = kernels.farthest_point_sample(xyzs[-1], npoint)
        new_xyz = core.gather_rows(xyzs[-1], fps).contiguous()
        idxs.append(kernels.query_ball_point(radius, K, xyzs[-1], new_xyz))
        xyzs.append(new_xyz)

    # group backward where the source needs a gradient: sa2-sa4
    for stage in (1, 2, 3):
        idx, n, c = idxs[stage], xyzs[stage].shape[1], SA_CHANNELS[stage]
        g = torch.randn(*idx.shape, c, device=dev)
        check("group_backward", f"sa{stage + 1} N={n} S={idx.shape[1]} C={c}",
              lambda: kernels.group_points_backward(idx, g, n),
              lambda: core.group_points_backward(idx, g, n))
    idx, n = idxs[1].clone(), xyzs[1].shape[1]
    idx[:, ::7] = n               # empty balls: every entry the sentinel
    idx[:, :, 5] = n              # a sentinel inside every other ball
    idx[:, 1::7, 8:] = idx[:, 1::7, :1]  # short balls padded with repeats
    idx[:, 2::7, 0] = 0           # one row that many balls hold
    g = torch.randn(*idx.shape, SA_CHANNELS[1], device=dev)
    check("group_backward", "sa2 sentinels + repeats",
          lambda: kernels.group_points_backward(idx, g, n),
          lambda: core.group_points_backward(idx, g, n), on_path=False)

    for lvl, d in enumerate(FP_D):  # fp1..fp4 interpolate lvl+1 onto lvl
        xyz1, xyz2 = xyzs[lvl], xyzs[lvl + 1]
        s = xyz2.shape[1]
        dists, nn_idx, _ = kernels.three_nn_interpolate(
            xyz1, xyz2, torch.zeros(TRAIN_B, s, 1, device=dev))
        w = core.interpolation_weights(dists)
        g = torch.randn(TRAIN_B, xyz1.shape[1], d, device=dev)
        check("interpolate_backward",
              f"fp{lvl + 1} N={xyz1.shape[1]} S={s} D={d}",
              lambda: kernels.interpolate_backward(nn_idx, w, g, s),
              lambda: core.interpolate_backward(nn_idx, w, g, s))


def phase_train_step(torch, state_dict):
    import copy

    from tumseg_torch import ops
    from tumseg_torch.models.pointnet2_sem_seg import get_model
    from tumseg_torch.train.loop import make_optimizer

    rng = np.random.default_rng(SEED + 4)
    x = torch.as_tensor(facade_batch(rng, TRAIN_B, N), device=DEVICE)
    # labels by height band, so the loss has something to fit
    target = (x[..., 5] * 7.999).long()
    weight = torch.as_tensor(rng.random(8).astype(np.float32) + 0.5,
                             device=DEVICE)
    base = get_model(8).to(DEVICE)
    base.load_state_dict(state_dict)
    base.train()

    def step(model, opt=None):
        logp, _ = model(x)
        loss = model.loss(logp, target, weight)
        if opt is not None:
            opt.zero_grad(set_to_none=True)
        loss.backward()
        if opt is not None:
            opt.step()
        return loss.detach()

    def grads(plain):
        model = copy.deepcopy(base)
        if plain:
            with ops.plain():
                loss = step(model)
        else:
            loss = step(model)
        return float(loss), {n: p.grad for n, p in model.named_parameters()}

    lk, gk = grads(False)
    lp, gp = grads(True)
    if not (math.isfinite(lk) and abs(lk - lp) <= 1e-5 * abs(lp)):
        raise AssertionError(f"train-step loss {lk} (kernels) vs {lp} (plain)")
    # a layer's scale: the largest gradient of its weight and bias. The bias
    # of a Dense before a train-mode BN has an exact gradient of 0 (the
    # batch mean removes it) and carries only rounding noise.
    layer_max = {}
    for name, g in gp.items():
        layer = name.rsplit(".", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 0.0),
                               g.abs().max().item())
    worst, worst_name = 0.0, ""
    for name, g in gk.items():
        scale = layer_max[name.rsplit(".", 1)[0]]
        rel = (g - gp[name]).abs().max().item() / scale
        if not math.isfinite(rel) or rel > 1e-4:
            raise AssertionError(f"gradient of {name}: max|dg| = "
                                 f"{rel:g} x its layer's max|g|")
        if rel > worst:
            worst, worst_name = rel, name
    print(f"[f] train step B={TRAIN_B}x{N}: loss {lk:.6f} (kernels) "
          f"{lp:.6f} (plain); worst gradient {worst:.3g} x max|g| "
          f"({worst_name}), {len(gk)} tensors")

    def timed(plain):
        model = copy.deepcopy(base)
        opt = make_optimizer(model.parameters(), "Adam", 1e-4)

        def one():
            if plain:
                with ops.plain():
                    step(model, opt)
            else:
                step(model, opt)
        return time_ms(torch, one, 1)

    runs = {}
    for label, plain in (("plain", True), ("kernels", False),
                         ("kernels", False), ("plain", True)):
        runs.setdefault(label, []).append(timed(plain)[0])
    print(f"[f] train step B={TRAIN_B}x{N} (forward + backward + Adam, "
          f"median of 3, two turns each): kernels "
          f"{[round(v, 3) for v in runs['kernels']]} ms, plain "
          f"{[round(v, 3) for v in runs['plain']]} ms")


def phase_train_cli(torch, work):
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.cli import train as train_cli
    from tumseg_torch.ops import kernels

    rng = np.random.default_rng(SEED + 5)
    data = work / "train_data"
    data.mkdir(parents=True)
    write_facade_tile(rng, data / "facade.las", TRAIN_POINTS)
    write_facade_tile(rng, data / "held_out.las", HELD_OUT_POINTS)
    log = work / "train_log"
    args = train_cli.parse_args([
        "--rootdir", str(data), "--test_area", "held_out.las",
        "--exp_dir", str(log), "--log_dir", "smoke", "--epoch",
        str(TRAIN_EPOCHS), "--batch_size", str(TRAIN_B), "--npoint", str(N),
        "--class8", "--RGB_OFF", "--seed", str(SEED)])
    blocks = int(TRAIN_POINTS / N)
    steps = TRAIN_EPOCHS * (int(0.7 * blocks) // TRAIN_B)
    if steps < 10:
        raise AssertionError(f"only {steps} training steps")
    kernels.reset_launches()
    acc, eval_loss, iou = train_cli.main(args)
    launches = dict(kernels.launches)

    text = (log / "sem_seg" / "smoke" / "logs" / "pointnet2_sem_seg.txt"
            ).read_text()
    losses = [float(line.rsplit(":", 1)[1]) for line in text.splitlines()
              if "Training mean loss:" in line]
    rates = [line.rsplit(":", 1)[1].strip() for line in text.splitlines()
             if "Training points/sec:" in line]
    if len(losses) != TRAIN_EPOCHS or not all(
            math.isfinite(v) for v in losses + list(eval_loss)):
        raise AssertionError(f"training losses {losses}, eval {eval_loss}")
    for name, per in (("group_backward", 3), ("interpolate_backward", 4)):
        if launches[name] < steps * per:
            raise AssertionError(f"{name}: {launches[name]} launches in the "
                                 f"training run, expected >= {steps * per}")
    ckpt = log / "sem_seg" / "smoke" / "checkpoints" / "best_model.pth"
    if not ckpt.exists():
        raise AssertionError(f"{ckpt} was not written")
    out = test_cli.main(test_cli.parse_args([
        "--rootdir", str(data), "--test_area", "held_out.las",
        "--exp_dir", str(log / "sem_seg") + "/", "--log_dir", "smoke",
        "--num_votes", "1", "--batch_size", str(TRAIN_B),
        "--num_point", str(N), "--class8", "--RGB_OFF", "--seed",
        str(SEED)]))
    if not 0.0 <= out["miou"] <= 1.0:
        raise AssertionError(f"served mIoU {out['miou']}")
    for epoch, rate in enumerate(rates):
        print(f"[g] epoch {epoch + 1} Training points/sec: {rate}")
    print(f"[g] trained {steps} steps of B={TRAIN_B}x{N} over "
          f"{TRAIN_EPOCHS} epochs: mean losses {losses}, eval losses "
          f"{list(eval_loss)}, best mIoU {max(iou):.4f}; best_model.pth "
          f"served with mIoU {out['miou']:.4f}; launches {launches}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tumseg_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"[a] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    build.library()
    print(f"[a] kernels built and loaded in {build.build_seconds:.2f} s")

    report = Report()
    phase_kernels(torch, report)
    state_dict = phase_forward(torch)
    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    launches = phase_serve(torch, work, state_dict)
    phase_backward(torch, report)
    phase_train_step(torch, state_dict)
    launches.update({name: n for name, n in phase_train_cli(torch, work).items()
                     if name in ("group_backward", "interpolate_backward")})
    for name, k in report.kernels.items():
        k["launches"] = launches[name]
    print(json.dumps({"kernels": list(report.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
