#!/usr/bin/env python3
"""On-card smoke test of the tumseg_torch port: ``python3 chip_smoke.py``
from the root of a checkout, on a machine with one NVIDIA GPU.

a. prints the card's name and power limit, builds the CUDA kernels from
   ``tumseg_torch/csrc`` and prints the build time;
b. runs each kernel and its plain PyTorch version on the same inputs at the
   shapes of a B=32 x 4096-point forward of ``pointnet2_sem_seg`` and holds
   them equal (indices identical, grouping bitwise in both modes, the
   sentinel reading a zero row, interpolation within rtol 1e-5 / atol
   1e-6), timing both with CUDA events; the FPS, ball-query, group and
   3-NN kernels' lines also give the profiler's device time of the same
   calls (the 3-NN kernel's at each of fp1-fp4, with its geometry and
   whether its interpolation is bitwise the plain version's; the ball
   query's at each of sa1-sa4, with its geometry, the candidates a query
   tests by ``tumseg_torch.tools.ball_query_probe.walk_model``, its bytes
   bound and its issue-rate yardstick), FPS its time a
   step (event and device, over npoint steps) and its geometry, and the
   host time a call of the group wrapper and of ``index_select`` at the
   last centroid gather; FPS at each stage's shape is also held bitwise on
   a tie-heavy batch (an integer lattice) and with random starts;
c. runs that forward with the kernels and with the plain versions: log-probs
   within 1e-4 and argmax equal on >= 99.99% of points, both timed;
d. serves a synthetic ~300K-point facade tile through
   ``tumseg_torch.cli.test.main`` (2 votes, the seeded random weights of c,
   BN statistics calibrated on facade blocks), checks the report and the
   label dump, and checks that every kernel was launched at least
   (forwards x launches per forward) times in that run. The CLI's runner
   keeps its "auto" defaults, so on the card it serves through the device
   re-blocking path, as ``tumseg``'s CLI does on its accelerator;
e. runs each backward kernel and its plain version on unit-normal
   cotangents at the shapes of a B=16 x 4096 training step (group at
   sa2-sa4, plus sentinel rows and repeated indices; interpolation at
   fp1-fp4 and the MSG model's fp4, D = 1024) and times both, with the
   profiler's device time beside each line: each backward bitwise equal to
   its plain version run on the CPU and to itself over three runs (each
   sums in ascending row or entry order, no atomics); the interpolation
   backward also on the adversarial inputs of
   ``tumseg_torch.tools.interp_backward_probe.adversarial_cases`` (a source
   in every query, all three entries of a query on one source, a whole
   batch row on one source, S = 3, ragged N, D of 7, 40 and 1024), in both
   modes;
f. takes one training step (train-mode BN, weighted NLL, backward) of the
   seeded model on one B=16 x 4096 batch with the kernels and under
   ``ops.plain()`` (its two backward scatter-adds on the CPU, where they
   are the sequential sums the kernels compute: ``scatter_adds_on_cpu``),
   with exact gathers and then with the single-pass bf16 gathers that the
   training engine takes by default (``fast_gather``, as
   ``tumseg`` trains on its accelerator), both sides in the same mode: loss
   within rtol 1e-5, every parameter gradient within 1e-4 of the largest
   gradient of its layer (with fast gathers, within three times the
   kernels' own run-to-run spread over three more steps, which it prints,
   and at least 1e-4: see ``fast_step_limit``); then times the step
   (forward + backward + Adam) with the kernels in both modes and plain;
g. trains through ``tumseg_torch.cli.train.main`` on a synthetic ~600K-point
   facade tile (2 epochs, B=16 x 4096, >= 10 steps; fast gathers, the
   engine's default), checks that the logged losses are finite, that
   ``best_model.pth`` serves through ``tumseg_torch.cli.test``, that the
   backward kernels were launched at least steps x 3 (group: sa2-sa4) and
   steps x 4 (interpolation: fp1-fp4) times in that run, and that the group
   kernel stored bf16 at least steps x 4 times;
h. runs the multi-radius ball-query kernel at the four stage shapes of a
   B=32 x 4096-point forward of ``pointnet2_sem_seg_msg`` (radii .05/.1,
   .1/.2, .2/.4, .4/.8, K = 16/32): indices identical to its plain version
   and to the single-radius kernel run once per radius, plus an empty ball
   and unsorted radii; times it (event and device, with the geometry,
   candidates, bytes bound and yardstick of b) beside two single-radius
   launches; the
   group kernel at the MSG widths (C = 9, 99, 259, 515) bitwise its plain
   version in both modes;
i. runs that MSG forward with the kernels and with the plain versions:
   log-probs within 1e-4, argmax equal on >= 99.99% of points, >= 2 classes
   predicted, both timed;
j. serves the tile of d with the MSG model through
   ``tumseg_torch.cli.test --model pointnet2_sem_seg_msg`` (2 votes, the
   device path) and checks its launches per forward (ball query only through
   the multi-radius kernel);
k. takes one MSG training step at B=16 x 4096 with the kernels and plain
   (fast gathers both; loss within rtol 1e-5, every gradient within 1e-4 of
   its layer's largest, both timed), then trains through
   ``tumseg_torch.cli.train --model pointnet2_sem_seg_msg`` (1 epoch, >= 6
   steps, multi-radius ball query >= steps x 4 and group backward >= steps x
   6 launches, the group kernel's bf16 output >= steps x 8) and serves its
   ``best_model.pth``;
l. (run right after b) runs the z-window 3-NN kernel (the expansion-form
   z-slab walk of ``csrc/three_nn.cuh``, one launch) at fp1's shapes (B=32
   facade blocks of 4096 queries, their 1024 FPS centroids, window 384,
   tiles of 256) on three inputs: facade blocks, half the sources on one z
   (some queries fail tumseg's window guard) and one z for all (every query
   fails): indices, distances and the fused interpolation bitwise equal to
   the plain windowed 3-NN in both modes, and the first two to the kernel
   run as the full expansion-form row kernel; then on
   ``tumseg_torch.tools.three_nn_probe.window_cases()`` (negative
   distances, far from the origin, lattice ties, S past one tile) bitwise
   the plain expansion form; times it (event and device) beside the
   direct-form 3-NN kernel and the full row kernel at the same shapes, with
   the candidates its walk tests (``three_nn_probe.walk_model``), and checks
   with ``torch.profiler`` that one call's device time is the kernel alone,
   no sort;
m. serves the tile of d three ways in one call, SSG with the weights of c,
   through ``run_testing`` (2 votes, each scene gridded beforehand): the
   host path, the device re-blocking path and the device path with
   ``window_ops``; prints scene-points/s, wall seconds and the launches of
   every kernel of each, checks the window kernel's launches (>= forwards
   with the window, 0 without) and the direct-form 3-NN's (>= 3 and 4 per
   forward); checks that the device path's vote loop fed the blocks of a
   host-featurized vote gives the host's labels on >= 99.99% of points, and
   reports the label agreement between window on and off;
n. serves a ~1M-point facade tile (2 votes) by the host and the device path:
   scene-points/s, the re-blocking time of one vote, and the device idle
   share over the vote loop from ``torch.profiler`` (CUDA-busy time over
   the wall time of one profiled vote);
o. (after e) the fast (single-pass bf16) modes at a B=16 x 4096 training
   step's shapes: the group kernel at sa1-sa4 bitwise equal to the plain
   fast group, in bf16; the group backward at sa2-sa4 and on e's sentinels
   and repeats, with a bf16 and with an f32 cotangent, bitwise equal to the
   plain fast version run on the CPU and to itself over three runs; the
   interpolation forward at fp1-fp4 (and fp1 through the window kernel)
   within rtol 1e-5 / atol 1e-6 of its plain fast version, and its backward
   at fp1-fp4 and the MSG model's fp4 bitwise the plain fast version run on
   the CPU and itself over three runs; each fast time beside the same
   kernel's exact time at the same shapes;
p. (after l) the fused ball query + group kernel (the ball-query walk of
   ``csrc/ball_query.cuh`` with a grouping epilogue) at sa1-sa4 of the
   B=32 x 4096 forward, exact and fast, and on an input with an empty ball:
   grouped and idx bitwise equal to the ball-query kernel then the group
   kernel of the same mode and to the plain fused op, with short balls
   present; timed beside its bound and its plain version, and its device
   time by stage and over sa1-sa4 beside the split pair's (ball query then
   group) in both modes;
q. (after d) the fused switch end to end: one SSG forward under
   ``ops.fused_group_enabled()`` gives the log-probs of the switch off bit
   for bit, with 4 fused launches and 4 fewer ball-query launches; one
   training step (``TrainEngine``, fast gathers) under the switch gives the
   loss of the same step without it bit for bit, from the same state and
   generator, and its gradients bit for bit or, where they are not, no
   further from the split path's than three times the split path's own
   spread over three more steps (``fast_step_limit``);
r. (after k) fast against exact training: one SSG and one MSG step from the
   same weights and batch at ``exact_gathers=False`` and ``True``, printing
   the loss difference and the largest gradient difference relative to its
   layer's largest gradient (what the bf16 gathers cost; no threshold); the
   kernels' fast launches are > 0 in the fast step and 0 in the exact step
   and in eval.

Each kernel's time at the main path's shapes stands beside its bound: the
larger of its bytes (each input read once, each output written once) over
the H100's 3.35 TB/s and its f32 operations over 67 TFLOP/s, counted from
this run's inputs (a ball query and the fused kernel count 9 operations
a candidate their z-slab walk tests, the window 3-NN 14), and beside one
PyTorch call that computes the same function where there is one. A kernel
with a fast mode also reports ``fast_ms``, the fast mode's time, beside
``fast_exact_ms``, the exact mode's time at the same shapes (phase o's;
phase p's for the fused kernel). Every kernel also reports ``device_ms``
and ``library_device_ms``, the profiler's device time of the calls that
``ms`` and ``library_ms`` time with CUDA events (null where no PyTorch
call computes the function; where a call's device work is
shorter than its host work, as at the K = 1 centroid gathers, the event
time is the host's time a call). The
line before the last is a JSON summary of
the kernels; the last line is ``{"ok": true, "device": {...}}``. Any failed
phase raises, and the script then exits non-zero without printing either
line. Without a CUDA device it exits with code 2.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
DEVICE = "cuda:0"
B, N = 32, 4096
TRAIN_B = 16
SCENE_POINTS = 300_000
TRAIN_POINTS = 600_000
HELD_OUT_POINTS = 50_000
SCALE_POINTS = 1_000_000
SCALE_VOTES = 2
TRAIN_EPOCHS = 2
MSG_TRAIN_EPOCHS = 1
SA = [(1024, 0.1), (256, 0.2), (64, 0.4), (16, 0.8)]  # (npoint, radius)
K = 32
SA_CHANNELS = [9, 67, 131, 259]  # grouped channels of sa1..sa4
FP_D = [128, 256, 256, 512]  # points2 channels of fp1..fp4
MSG_SA = [(1024, (0.05, 0.1)), (256, (0.1, 0.2)), (64, (0.2, 0.4)),
          (16, (0.4, 0.8))]  # (npoint, radii) of pointnet2_sem_seg_msg
MSG_K = (16, 32)
MSG_CHANNELS = [9, 99, 259, 515]  # grouped channels of MSG sa1..sa4
# H100 SXM: HBM3 bytes/s and f32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
REPLACES = {
    "fps": "tumseg/ops/pallas/fps.py:39",
    "ball_query": "tumseg/ops/pallas/ballquery.py:279",
    "ball_query_multi": "tumseg/ops/pallas/ballquery.py:293",
    "group": "tumseg/ops/pallas/group.py:60",
    "three_nn_interpolate": "tumseg/ops/pallas/threenn.py:70",
    "group_backward": "tumseg/ops/pallas/group.py:75",
    "interpolate_backward": "tumseg/ops/pallas/interpolate.py:48",
    "three_nn_window": "tumseg/ops/pallas/threenn.py:218; "
                       "tumseg/ops/pallas/threenn.py:32",
    "fused_ball_group": "tumseg/ops/pallas/fusedgroup.py:51; "
                        "tumseg/ops/pallas/fusedgroup.py:120",
}
SOURCES = {
    "fps": "tumseg_torch/csrc/fps.cu",
    "ball_query": "tumseg_torch/csrc/ball_query.cu",
    "ball_query_multi": "tumseg_torch/csrc/ball_query_multi.cu",
    "group": "tumseg_torch/csrc/group.cu",
    "three_nn_interpolate": "tumseg_torch/csrc/three_nn_interpolate.cu",
    "group_backward": "tumseg_torch/csrc/group_backward.cu",
    "interpolate_backward": "tumseg_torch/csrc/interpolate_backward.cu",
    "three_nn_window": "tumseg_torch/csrc/three_nn_window.cu",
    "fused_ball_group": "tumseg_torch/csrc/fused_ball_group.cu",
}
# the kernels with a fast (single-pass bf16) mode
FAST = ("group", "three_nn_interpolate", "group_backward",
        "interpolate_backward", "three_nn_window", "fused_ball_group")
# the kernels whose lines also give the profiler's device time, and those
# of them that no single PyTorch call computes
DEVICE_TIMED = ("fps", "ball_query", "ball_query_multi", "group",
                "group_backward", "three_nn_interpolate",
                "interpolate_backward", "three_nn_window", "fused_ball_group")
NO_LIBRARY = ("fps", "ball_query", "ball_query_multi", "three_nn_interpolate",
              "three_nn_window", "fused_ball_group")
# launches of each kernel in one forward: group runs once per set
# abstraction for the centroid gather and once per radius for the
# neighbourhoods; a model's other ball query is never launched
PER_FORWARD = {
    "pointnet2_sem_seg": {"fps": 4, "ball_query": 4, "ball_query_multi": 0,
                          "group": 8, "three_nn_interpolate": 4,
                          "three_nn_window": 0},
    "pointnet2_sem_seg_msg": {"fps": 4, "ball_query": 0,
                              "ball_query_multi": 4, "group": 12,
                              "three_nn_interpolate": 4,
                              "three_nn_window": 0},
}
# backward launches of one training step: group backward where the source
# needs a gradient (sa2-sa4, once per radius), interpolation at fp1-fp4
PER_STEP = {
    "pointnet2_sem_seg": {"group_backward": 3, "interpolate_backward": 4},
    "pointnet2_sem_seg_msg": {"group_backward": 6, "interpolate_backward": 4,
                              "ball_query_multi": 4},
}
# fast launches of one training step with fast gathers: the neighbourhood
# groups (once per radius), the interpolations and both backward kernels
FAST_PER_STEP = {
    "pointnet2_sem_seg": {"group": 4, "three_nn_interpolate": 4,
                          "group_backward": 3, "interpolate_backward": 4},
    "pointnet2_sem_seg_msg": {"group": 8, "three_nn_interpolate": 4,
                              "group_backward": 6,
                              "interpolate_backward": 4},
}


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


def write_facade_tile(rng, path, n, length=20.0):
    """A ``length`` x 2 m x 15 m facade tile of ``n`` points, 80% on a wall,
    labelled with all 8 classes."""
    from tumseg_torch.data.las import write_las

    on_wall = rng.random(n) < 0.8
    xyz = np.stack([rng.uniform(0.0, length, n),
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


def device_ms(torch, fn, reps):
    """The profiler's per-call device time of ``fn`` over ``reps`` calls
    after one warm-up call: each kernel's mean duration (kernels told apart
    by name) times its launches a call, its events over ``reps`` rounded
    and at least one. The profiler now and then loses device events, in
    some phases most of a trace's, so a count short of ``reps`` still means
    one a call; without losses this is the CUDA-busy time of the calls
    over ``reps`` (one stream: the kernels do not overlap). A trace that
    holds no device event is taken again, up to three; None then."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                spans.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if spans:
            return sum(np.mean(v) * max(1, round(len(v) / reps))
                       for v in spans.values()) / 1e3
    return None


def host_us(torch, fn, calls=2000):
    """The host's time a call of ``fn`` in microseconds: ``perf_counter``
    around ``calls`` calls after a warm-up, the device drained before and
    after (where the device work is shorter, it is the event time too)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def scanned(torch, idx, n):
    """Candidates each query of a ball query [B, S, K] over ``n`` points
    tests when it scans in index order, as the fused kernel does: up to its
    K-th hit, or all ``n`` when its ball holds fewer (a short ball repeats
    its first hit, an empty one holds only n)."""
    last, first = idx[..., -1].long(), idx[..., 0].long()
    full = last != first if idx.shape[-1] > 1 else first != n
    return torch.where(full, last + 1, torch.full_like(last, n))


def _add(total, ms):
    return None if total is None or ms is None else total + ms


def _ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


class Report:
    def __init__(self):
        self.kernels = {name: {"name": name, "route": "cuda",
                               "source": SOURCES[name],
                               "replaces": REPLACES[name], "launches": 0,
                               "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                               "bound_ms": 0.0, "bound_by": None,
                               "library_ms": None}
                        for name in SOURCES}
        for name in FAST:
            self.kernels[name].update(fast_ms=0.0, fast_exact_ms=0.0)
        for name in DEVICE_TIMED:
            self.kernels[name].update(
                device_ms=0.0,
                library_device_ms=None if name in NO_LIBRARY else 0.0)
        self.terms = {name: [0.0, 0.0] for name in SOURCES}  # bytes, ops ms

    def add(self, torch, name, label, kernel_fn, plain_fn, err, *, nbytes,
            ops, library_fn=None, reps=20, plain_reps=3, phase="b",
            on_path=True):
        """Times ``kernel_fn``, ``plain_fn`` and, if given, ``library_fn``
        (one PyTorch call computing the same function). The times and
        bounds of the shapes the main path runs (``on_path``) add up to the
        kernel's ms per forward (phases b, h) or per training step (e).
        Returns the kernel's event ms and its device ms (None where the
        kernel is not device-timed or the profiler recorded nothing)."""
        ms, runs = time_ms(torch, kernel_fn, reps)
        pms, pruns = time_ms(torch, plain_fn, plain_reps)
        lms = time_ms(torch, library_fn, reps)[0] if library_fn else None
        dms = ldms = None
        if name in DEVICE_TIMED:
            dms = device_ms(torch, kernel_fn, reps)
            if library_fn:
                ldms = device_ms(torch, library_fn, reps)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        k = self.kernels[name]
        if on_path:
            k["ms"] += ms
            k["plain_ms"] += pms
            k["bound_ms"] += max(bytes_ms, ops_ms)
            self.terms[name][0] += bytes_ms
            self.terms[name][1] += ops_ms
            k["bound_by"] = ("bytes" if self.terms[name][0]
                             >= self.terms[name][1] else "operations")
            if lms is not None:
                k["library_ms"] = (k["library_ms"] or 0.0) + lms
            if name in DEVICE_TIMED:  # None once any line was not measured
                k["device_ms"] = _add(k["device_ms"], dms)
                if library_fn:
                    k["library_device_ms"] = _add(k["library_device_ms"],
                                                  ldms)
        k["max_abs_err"] = max(k["max_abs_err"], float(err))
        lib = "" if lms is None else f"  library {lms:9.4f} ms"
        dev = ""
        if name in DEVICE_TIMED:
            dev = f" (device {_ms(dms)})"
            if library_fn:
                lib += f" (device {_ms(ldms)})"
        print(f"[{phase}] {name:22s} {label:28s} kernel {ms:9.4f} ms "
              f"{[round(r, 4) for r in runs]}{dev}  plain {pms:9.4f} ms "
              f"{[round(r, 4) for r in pruns]}{lib}  bound "
              f"{max(bytes_ms, ops_ms):.5f} ms ({nbytes / 1e6:.2f} MB, "
              f"{ops / 1e9:.3f} Gop)  max|err| {err:g}")
        return ms, dms

    def add_fast(self, torch, name, label, fast_fn, exact_fn, err, phase):
        """Times a kernel's fast mode beside its exact mode at the same
        shapes; both add up to the kernel's ``fast_ms`` and
        ``fast_exact_ms``."""
        fms, fruns = time_ms(torch, fast_fn, 20)
        ems, eruns = time_ms(torch, exact_fn, 20)
        k = self.kernels[name]
        k["fast_ms"] += fms
        k["fast_exact_ms"] += ems
        k["max_abs_err"] = max(k["max_abs_err"], float(err))
        dev = ""
        if name in DEVICE_TIMED:
            dev = (f"  device fast {_ms(device_ms(torch, fast_fn, 20))}, "
                   f"exact {_ms(device_ms(torch, exact_fn, 20))}")
        print(f"[{phase}] {name:22s} {label:28s} fast {fms:9.4f} ms "
              f"{[round(r, 4) for r in fruns]}  exact {ems:9.4f} ms "
              f"{[round(r, 4) for r in eruns]}{dev}  max|err| {err:g}")


def group_cost(idx, C, n):
    """Bytes and operations of the group kernel: idx, src and centres read,
    the [B, S, K, C] output written; one subtraction per xyz element."""
    Bq, S, Kq = idx.shape
    return dict(nbytes=4 * (Bq * S * Kq + Bq * n * C + Bq * S * 3
                            + Bq * S * Kq * C),
                ops=Bq * S * Kq * 3)


def ball_query_line(torch, report, name, stage, xyz, new_xyz, radii, ks,
                    kernel_fn, plain_fn, phase, plain_reps):
    """Times a ball-query stage beside its bound and prints its geometry,
    the candidates its queries test (``ball_query_probe.walk_model`` on
    these inputs) and its two yardsticks: the bytes bound (inputs read
    once, indices written once) and the walk's candidates at the SASS's
    instructions a candidate at the issue rate. The JSON bound counts 9
    operations a candidate the walk tests."""
    from tumseg_torch.ops import kernels
    from tumseg_torch.tools.ball_query_probe import (bytes_ms, walk_model,
                                                     yardstick_ms)

    b, n, _ = xyz.shape
    s = new_xyz.shape[1]
    _, tested = walk_model(xyz.cpu().numpy(), new_xyz.cpu().numpy(), radii,
                           ks)
    ms, dms = report.add(
        torch, name, f"{stage} N={n} S={s} r={radii}", kernel_fn, plain_fn,
        0.0, nbytes=b * n * 12 + b * s * 12 + b * s * sum(ks) * 4,
        ops=9 * tested, plain_reps=plain_reps, phase=phase)
    geometry = kernels.ball_query_geometry(b, n, s, len(ks))
    print(f"[{phase}] {name} {stage} N={n} S={s} (Q, L, tile, walk) "
          f"{geometry}: event {ms:.4f} ms, "
          f"device {_ms(dms)}; {tested / (b * s):.1f} candidates tested a "
          f"query of {n} (walk model); bytes bound "
          f"{bytes_ms(b, n, s, ks):.5f} ms, yardstick "
          f"{yardstick_ms(tested):.5f} ms")


def gather_call(torch, idx, src):
    """One ``index_select`` of the rows the group kernel gathers (the
    empty-ball sentinel reads an appended zero row); it leaves out the
    centring."""
    Bq, n, C = src.shape
    flat_src = torch.cat([src, src.new_zeros(Bq, 1, C)], 1).reshape(-1, C)
    base = torch.arange(Bq, device=idx.device)[:, None, None] * (n + 1)
    flat_idx = (idx.long() + base).reshape(-1)
    return lambda: torch.index_select(flat_src, 0, flat_idx)


def fps_ties_and_starts(torch, src, npoint):
    """FPS at ``src``'s shape bitwise the plain version on a tie-heavy batch
    (a 4 x 4 x 4 integer lattice drawn with repeats: exact distances, ties
    at every step) and with random starts, as training draws them."""
    from tumseg_torch.ops import core, kernels

    rng = np.random.default_rng(SEED + 9)
    b, n, _ = src.shape
    ties = torch.as_tensor(rng.integers(0, 4, (b, n, 3)).astype(np.float32),
                           device=src.device)
    start = torch.as_tensor(rng.integers(0, n, b).astype(np.int32),
                            device=src.device)
    for what, xyz, s in (("tie-heavy", ties, None),
                         ("start-seeded", src, start)):
        if not torch.equal(kernels.farthest_point_sample(xyz, npoint, s),
                           core.farthest_point_sample(xyz, npoint, s)):
            raise AssertionError(f"fps {n}->{npoint}: the {what} batch "
                                 "differs from the plain version")
    print(f"[b] fps N={n} npoint={npoint}: tie-heavy and start-seeded "
          "batches bitwise the plain version: ok")


def phase_kernels(torch, report):
    from tumseg_torch.ops import core, kernels

    rng = np.random.default_rng(SEED)
    dev = torch.device(DEVICE)
    xyz = torch.as_tensor(facade_blocks(rng, B, N), device=dev)
    xyzs, idxs = [xyz], []
    for npoint, radius in SA:
        src = xyzs[-1]
        n = src.shape[1]
        f_k = kernels.farthest_point_sample(src, npoint)
        f_p = core.farthest_point_sample(src, npoint)
        if not torch.equal(f_k, f_p):
            raise AssertionError(f"fps {n}->{npoint}: indices "
                                 "differ from the plain version")
        fps_ties_and_starts(torch, src, npoint)
        ms, dms = report.add(
            torch, "fps", f"N={n} npoint={npoint}",
            lambda: kernels.farthest_point_sample(src, npoint),
            lambda: core.farthest_point_sample(src, npoint), 0.0,
            nbytes=B * n * 12 + B * 4 + B * npoint * 4,
            ops=B * npoint * n * 10, reps=5, plain_reps=1)
        print(f"[b] fps N={n} npoint={npoint} {kernels.fps_geometry(n)} "
              f"(threads, points): a step {ms * 1e3 / npoint:.4f} "
              f"us event, " + ("not measured" if dms is None else
                               f"{dms * 1e3 / npoint:.4f} us") + " device")

        g_k = kernels.group_points(f_k[:, :, None].contiguous(), src,
                                   torch.zeros_like(src[:, :npoint]))
        g_p = core.gather_rows(src, f_k)
        if not torch.equal(g_k[:, :, 0], g_p):
            raise AssertionError("gather_rows differs from the plain version")
        idx1 = f_k[:, :, None].contiguous()
        zc = torch.zeros(B, npoint, 3, device=dev)
        report.add(torch, "group", f"gather_rows N={n} S={npoint}",
                   lambda: kernels.group_points(idx1, src, zc),
                   lambda: core.group_points(idx1, src, zc), 0.0,
                   library_fn=gather_call(torch, idx1, src),
                   **group_cost(idx1, 3, n))
        new_xyz = g_p.contiguous()

        b_k = kernels.query_ball_point(radius, K, src, new_xyz)
        b_p = core.query_ball_point(radius, K, src, new_xyz)
        if not torch.equal(b_k, b_p):
            bad = (b_k != b_p).any(-1).float().mean().item()
            raise AssertionError(f"ball query r={radius}: {bad:.2e} of "
                                 "queries differ from the plain version")
        ball_query_line(
            torch, report, "ball_query", f"sa{len(xyzs)}", src, new_xyz,
            (radius,), (K,),
            lambda: kernels.query_ball_point(radius, K, src, new_xyz),
            lambda: core.query_ball_point(radius, K, src, new_xyz), "b", 2)
        xyzs.append(new_xyz)
        idxs.append(b_k)
    wrapper = host_us(torch, lambda: kernels.group_points(idx1, src, zc))
    library = host_us(torch, gather_call(torch, idx1, src))
    print(f"[b] host time a call at gather_rows N={n} S={npoint}: the group "
          f"wrapper {wrapper:.2f} us, index_select {library:.2f} us")

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
        for fast in (False, True):
            g_k = kernels.group_points(idx, src, ctr, fast)
            g_p = core.group_points(idx, src, ctr, fast)
            if not torch.equal(g_k, g_p):
                raise AssertionError(f"group sa{stage + 1} C={C} fast={fast} "
                                     "is not bitwise the plain version")
            if stage in (0, 3):
                sent = idx.clone()
                sent[:, :, 5] = src.shape[1]
                s_k = kernels.group_points(sent, src, ctr, fast)
                want = torch.cat(
                    [-ctr, torch.zeros_like(feats[:, :ctr.shape[1]])],
                    dim=-1).to(s_k.dtype)
                if not (torch.equal(s_k, core.group_points(sent, src, ctr,
                                                           fast))
                        and torch.equal(s_k[:, :, 5], want)):
                    raise AssertionError("group sentinel row must read as "
                                         f"zeros, fast={fast}")
        report.add(torch, "group", f"sa{stage + 1} S={idx.shape[1]} C={C}",
                   lambda: kernels.group_points(idx, src, ctr),
                   lambda: core.group_points(idx, src, ctr), 0.0,
                   library_fn=gather_call(torch, idx, src),
                   **group_cost(idx, C, src.shape[1]))

    for lvl, (xyz1, xyz2, d) in enumerate(zip(xyzs[:-1], xyzs[1:], FP_D)):
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
        # a full scan's 8 operations a distance and 3 compares into the top
        # 3 (more than the z-slab search tests: the bound is the bytes'
        # either way); the weights, then 3 multiplies and 2 adds an output
        _, dms = report.add(
            torch, "three_nn_interpolate", f"N={n1} S={s} D={d}",
            lambda: kernels.three_nn_interpolate(xyz1, xyz2, p2),
            lambda: core.three_nn_interpolate(xyz1, xyz2, p2), err,
            nbytes=4 * (B * n1 * 3 + B * s * 3 + B * s * d + B * n1 * 6
                        + B * n1 * d),
            ops=B * n1 * s * 11 + B * n1 * 10 + B * n1 * d * 5,
            plain_reps=2)
        print(f"[b] three_nn_interpolate fp{lvl + 1} N={n1} S={s} D={d} "
              f"(Q, R) {kernels.three_nn_geometry(B, n1, d)}: "
              f"device {_ms(dms)}; out bitwise the plain version "
              f"{torch.equal(ok, op)}")


def phase_forward(torch, model_name, tag):
    from tumseg_torch import models, ops
    from tumseg_torch.nn.layers import calibrate_batch_norm

    x = torch.as_tensor(facade_batch(np.random.default_rng(SEED + 1), B, N),
                        device=DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    model = models.get_module(model_name).get_model(8).to(DEVICE).eval()
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
        print(f"[{tag}] {model_name} forward B={B}x{N}: max|dlogp| {diff:g}, "
              f"argmax agree {agree:.6f}, {classes} classes predicted")
        if diff > 1e-4 or agree < 0.9999:
            raise AssertionError("kernel forward disagrees with plain")
        if classes < 2:
            raise AssertionError("constant labels: the check would be void")
        kms, kruns = time_ms(torch, kernel_fwd, 3)
        pms, pruns = time_ms(torch, plain_fwd, 1)
    print(f"[{tag}] forward kernels {kms:.3f} ms "
          f"{[round(r, 3) for r in kruns]}; plain {pms:.3f} ms "
          f"{[round(r, 3) for r in pruns]}")
    return {k: v.cpu() for k, v in model.state_dict().items()}


def phase_serve(torch, work, state_dict, model_name, tag):
    """Serves the tile ``work/data/facade.las`` through the test CLI; counts
    of zero before the run, read after it."""
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.data.dataset import TestGridDataset
    from tumseg_torch.models.convert import variables_from_state_dict
    from tumseg_torch.ops import kernels
    from tumseg_torch.train.checkpoint import save_checkpoint
    from tumseg_torch.viz.writers import read_labels_txt

    n = SCENE_POINTS
    data = work / "data"
    ckpt_dir = work / "log" / "sem_seg" / model_name / "checkpoints"
    ckpt_dir.mkdir(parents=True)
    save_checkpoint(str(ckpt_dir / "best_model.pth"), epoch=0,
                    variables=variables_from_state_dict(state_dict))

    votes = 2
    args = test_cli.parse_args([
        "--model", model_name, "--rootdir", str(data), "--test_area",
        "facade.las", "--exp_dir", str(work / "log") + "/sem_seg/",
        "--log_dir", model_name, "--num_votes", str(votes), "--batch_size",
        str(B), "--num_point", str(N), "--class8", "--RGB_OFF", "--seed",
        str(SEED)])
    kernels.reset_launches()
    out = test_cli.main(args)
    launches = dict(kernels.launches)

    if not math.isfinite(out["miou"]) or not 0.0 <= out["miou"] <= 1.0:
        raise AssertionError(f"mIoU {out['miou']} is not a finite ratio")
    txt = work / "log" / "sem_seg" / model_name / "visual" / "facade.txt"
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
    for name, per in PER_FORWARD[model_name].items():
        if (launches[name] < forwards * per) or (per == 0
                                                 and launches[name] != 0):
            raise AssertionError(f"{name}: {launches[name]} launches in the "
                                 f"serving run, expected "
                                 f"{'>= ' if per else ''}{forwards * per}")
    rate = n * votes / out["infer_seconds"]
    print(f"[{tag}] {model_name} served {n} points x {votes} votes ({blocks} "
          f"blocks/vote, {forwards} forwards) in {out['infer_seconds']:.3f} "
          f"s: {rate:.0f} scene-points/s; mIoU {out['miou']:.4f}; "
          f"launches {launches}")
    return launches


def phase_multi(torch, report):
    """The multi-radius ball query at the MSG forward's stage shapes."""
    from tumseg_torch.ops import core, kernels

    rng = np.random.default_rng(SEED + 6)
    dev = torch.device(DEVICE)
    xyz = torch.as_tensor(facade_blocks(rng, B, N), device=dev)
    xyzs = [xyz]
    for npoint, radii in MSG_SA:
        src = xyzs[-1]
        n = src.shape[1]
        new_xyz = core.gather_rows(
            src, kernels.farthest_point_sample(src, npoint)).contiguous()
        got = kernels.query_ball_point_multi(radii, MSG_K, src, new_xyz)
        want = core.query_ball_point_multi(radii, MSG_K, src, new_xyz)
        for r, k, g, w in zip(radii, MSG_K, got, want):
            if not (torch.equal(g, w) and torch.equal(
                    g, kernels.query_ball_point(r, k, src, new_xyz))):
                raise AssertionError(f"ball_query_multi N={n} r={r}: indices "
                                     "differ from the plain version or the "
                                     "single-radius kernel")
        fill = [f"{(scanned(torch, w, n) < n).float().mean().item():.3f}"
                for w in want]
        print(f"[h] N={n} S={npoint} r={radii}: share of balls that fill K "
              f"{fill}")
        ball_query_line(
            torch, report, "ball_query_multi", f"sa{len(xyzs)}", src,
            new_xyz, radii, MSG_K,
            lambda: kernels.query_ball_point_multi(radii, MSG_K, src,
                                                   new_xyz),
            lambda: core.query_ball_point_multi(radii, MSG_K, src, new_xyz),
            "h", 1)
        two, runs = time_ms(torch, lambda: [
            kernels.query_ball_point(r, k, src, new_xyz)
            for r, k in zip(radii, MSG_K)], 20)
        print(f"[h] two single-radius launches at N={n} S={npoint}: "
              f"{two:.4f} ms {[round(r, 4) for r in runs]}")
        c = MSG_CHANNELS[len(xyzs) - 1]
        feats = torch.cat([src, torch.as_tensor(rng.standard_normal(
            (B, n, c - 3)).astype(np.float32), device=dev)], dim=-1)
        for idx in got:
            for fast in (False, True):
                if not torch.equal(
                        kernels.group_points(idx, feats, new_xyz, fast),
                        core.group_points(idx, feats, new_xyz, fast)):
                    raise AssertionError(
                        f"group N={n} K={idx.shape[2]} C={c} fast={fast} "
                        "is not bitwise the plain version")
        print(f"[h] group at N={n} S={npoint} C={c}, K={MSG_K}, both modes: "
              "bitwise the plain version")
        xyzs.append(new_xyz)

    far = torch.full((1, 1, 3), 1000.0, device=dev)
    for e in kernels.query_ball_point_multi(MSG_SA[0][1], MSG_K,
                                            xyz[:1].contiguous(), far):
        if not (e == N).all():
            raise AssertionError("empty ball must give the sentinel N")
    radii, ks = (0.2, 0.05, 0.1), (8, 16, 32)  # unsorted, three radii
    got = kernels.query_ball_point_multi(radii, ks, xyz, xyzs[1])
    want = core.query_ball_point_multi(radii, ks, xyz, xyzs[1])
    for r, k, g, w in zip(radii, ks, got, want):
        if not (torch.equal(g, w) and torch.equal(
                g, kernels.query_ball_point(r, k, xyz, xyzs[1]))):
            raise AssertionError(f"unsorted radii: r={r} differs")
    print("[h] ball_query_multi empty ball -> sentinel N, unsorted radii "
          f"{radii}: ok")


def phase_backward(torch, report):
    from tumseg_torch.ops import core, kernels
    from tumseg_torch.tools.interp_backward_probe import (MSG_FP4_D,
                                                          adversarial_cases)

    rng = np.random.default_rng(SEED + 3)
    dev = torch.device(DEVICE)

    def check_group(label, idx, g, n, on_path=True, **kw):
        """The group backward bitwise its plain version on the CPU and
        itself over three runs, then timed against the plain version on
        the card."""
        group_backward_bitwise(torch, idx, g, n, False, f"e {label}")
        report.add(torch, "group_backward", label,
                   lambda: kernels.group_points_backward(idx, g, n),
                   lambda: core.group_points_backward(idx, g, n), 0.0,
                   phase="e", on_path=on_path, **kw,
                   **group_bwd_cost(idx, g.shape[-1], n))

    def index_add_call(idx, g, n):
        """One ``index_add_`` over the flattened indices into a zeroed
        [B*(n+1), C] (the sentinel lands in the extra row, which the
        kernel never writes)."""
        Bq, C = idx.shape[0], g.shape[-1]
        base = torch.arange(Bq, device=dev)[:, None, None] * (n + 1)
        flat = (idx.long() + base).reshape(-1)
        rows = g.reshape(-1, C)
        return lambda: torch.zeros(Bq * (n + 1), C, device=dev).index_add_(
            0, flat, rows)

    def sparse_call(nn_idx, w, g, s):
        """One ``torch.sparse.mm`` of W^T [B*s, B*n] with the batch's
        [B*n, D] cotangents; building W from idx and weights is left out."""
        Bq, n1 = nn_idx.shape[:2]
        rows = (nn_idx.long() + torch.arange(Bq, device=dev)[:, None, None]
                * s).reshape(-1)
        cols = (torch.arange(Bq * n1, device=dev)[:, None]
                .expand(Bq * n1, 3).reshape(-1))
        wt = torch.sparse_coo_tensor(torch.stack([rows, cols]), w.reshape(-1),
                                     (Bq * s, Bq * n1)).coalesce()
        dense = g.reshape(Bq * n1, -1)
        return lambda: torch.sparse.mm(wt, dense)

    def group_bwd_cost(idx, C, n):
        Bq, S, Kq = idx.shape
        return dict(nbytes=4 * (Bq * S * Kq + Bq * S * Kq * C + Bq * n * C),
                    ops=Bq * S * Kq * C)

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
        check_group(f"sa{stage + 1} N={n} S={idx.shape[1]} C={c}", idx, g, n,
                    library_fn=index_add_call(idx, g, n))
    n = xyzs[1].shape[1]
    idx = sentinels_and_repeats(idxs[1], n)
    g = torch.randn(*idx.shape, SA_CHANNELS[1], device=dev)
    check_group("sa2 sentinels + repeats", idx, g, n, on_path=False)

    def check_interp(label, nn_idx, w, g, s, on_path=True):
        """The interpolation backward bitwise its plain version on the CPU
        and itself over three runs, then timed against the plain version
        on the card."""
        interp_backward_bitwise(torch, nn_idx, w, g, s, False, f"e {label}")
        Bq, n1, d = g.shape
        report.add(torch, "interpolate_backward", label,
                   lambda: kernels.interpolate_backward(nn_idx, w, g, s),
                   lambda: core.interpolate_backward(nn_idx, w, g, s), 0.0,
                   library_fn=sparse_call(nn_idx, w, g, s), phase="e",
                   on_path=on_path,
                   nbytes=4 * (Bq * n1 * 6 + Bq * n1 * d + Bq * s * d),
                   ops=Bq * n1 * 3 * d * 2)

    for lvl, d in enumerate(FP_D):  # fp1..fp4 interpolate lvl+1 onto lvl
        xyz1, xyz2 = xyzs[lvl], xyzs[lvl + 1]
        n1, s = xyz1.shape[1], xyz2.shape[1]
        dists, nn_idx, _ = kernels.three_nn_interpolate(
            xyz1, xyz2, torch.zeros(TRAIN_B, s, 1, device=dev))
        w = core.interpolation_weights(dists)
        g = torch.randn(TRAIN_B, n1, d, device=dev)
        check_interp(f"fp{lvl + 1} N={n1} S={s} D={d}", nn_idx, w, g, s)
    g = torch.randn(TRAIN_B, n1, MSG_FP4_D, device=dev)
    check_interp(f"MSG fp4 N={n1} S={s} D={MSG_FP4_D}", nn_idx, w, g, s,
                 on_path=False)
    for name, case in adversarial_cases().items():
        idx, w, g = (torch.as_tensor(a, device=dev) for a in case[:3])
        for fast in (False, True):
            interp_backward_bitwise(torch, idx, w, g, case[3], fast,
                                    f"e {name} fast={fast}")
    print("[e] interpolate_backward on the adversarial inputs "
          f"({', '.join(adversarial_cases())}), both modes: bitwise the "
          "plain version on the CPU and over three runs")


def sentinels_and_repeats(idx, n):
    """A copy of ball-query indices [B, S, K] over ``n`` points with what
    the group backward must get right."""
    idx = idx.clone()
    idx[:, ::7] = n               # empty balls: every entry the sentinel
    idx[:, :, 5] = n              # a sentinel inside every other ball
    idx[:, 1::7, 8:] = idx[:, 1::7, :1]  # short balls padded with repeats
    idx[:, 2::7, 0] = 0           # one row that many balls hold
    return idx


def bitwise_three_runs(torch, call, want, what):
    """Raises unless three runs of ``call`` are bitwise equal to each other
    and to ``want``, the plain version run on the CPU."""
    runs = [call() for _ in range(3)]
    for i, got in enumerate(runs):
        if not torch.equal(got, runs[0]):
            raise AssertionError(f"{what}: run {i + 1} is not bitwise run 1")
    if not torch.equal(runs[0].cpu(), want):
        bad = (runs[0].cpu() != want).float().mean().item()
        raise AssertionError(f"{what}: {bad:.2e} of elements differ from "
                             "the plain version on the CPU")


def group_backward_bitwise(torch, idx, g, n, fast, what):
    """Raises unless three runs of the group-backward kernel are bitwise
    equal to each other and to ``core.group_points_backward`` on the CPU
    (the kernel sums each row in ascending order, as the CPU's scatter_add_
    does, with no atomics)."""
    from tumseg_torch.ops import core, kernels

    bitwise_three_runs(
        torch, lambda: kernels.group_points_backward(idx, g, n, fast=fast),
        core.group_points_backward(idx.cpu(), g.cpu(), n, fast=fast),
        f"group backward {what}")


def interp_backward_bitwise(torch, idx, w, g, s, fast, what):
    """Raises unless three runs of the interpolation-backward kernel are
    bitwise equal to each other and to ``core.interpolate_backward`` on the
    CPU (the kernel sums each source row in ascending entry order 3n + k,
    as the CPU's scatter_add_ does, with no atomics)."""
    from tumseg_torch.ops import core, kernels

    bitwise_three_runs(
        torch, lambda: kernels.interpolate_backward(idx, w, g, s, fast=fast),
        core.interpolate_backward(idx.cpu(), w.cpu(), g.cpu(), s, fast=fast),
        f"interpolation backward {what}")


def grad_gap(got, want):
    """-> (ratio, name): the largest |got - want| of a gradient over its
    layer's scale, the largest |want| of the layer's weight and bias (the
    bias of a Dense before a train-mode BN has an exact gradient of 0, the
    batch mean removes it, and carries only rounding noise); inf where not
    finite."""
    layer_max = {}
    for name, g in want.items():
        layer = name.rsplit(".", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 0.0),
                               g.abs().max().item())
    gaps = []
    for name, g in want.items():
        rel = ((got[name] - g).abs().max().item()
               / layer_max[name.rsplit(".", 1)[0]])
        gaps.append((rel if math.isfinite(rel) else math.inf, name))
    return max(gaps)


@contextlib.contextmanager
def scatter_adds_on_cpu(torch):
    """The plain training step's two backward scatter-adds
    (``core.group_points_backward`` and ``core.interpolate_backward``) run
    on the CPU inside this block, where ``scatter_add_`` is the ascending
    sequential f32 sum that the backward kernels compute bit for bit (on
    the card it adds with atomics in an order that changes from run to run,
    and under PyTorch's deterministic algorithms it sums runs of 32 or more
    equal indices as a tree); the rest of the step stays on the card."""
    from tumseg_torch.ops import core

    saved = core.group_points_backward, core.interpolate_backward

    def on_cpu(fn):
        def run(*args, **kw):
            dev = args[0].device
            return fn(*(a.cpu() if isinstance(a, torch.Tensor) else a
                        for a in args), **kw).to(dev)
        return run

    core.group_points_backward, core.interpolate_backward = map(on_cpu, saved)
    try:
        yield
    finally:
        core.group_points_backward, core.interpolate_backward = saved


def fast_step_limit(first, repeats):
    """-> (spread, limit) for comparing the gradients of a training step
    with fast gathers: the largest :func:`grad_gap` of the ``repeats`` of
    the same step from ``first``, and three times that (at least phase f's
    1e-4). Both backward kernels sum in a fixed order with no atomics, so
    the step gives the same gradients from run to run and the limit is
    1e-4; the fast backward rounds each cotangent to bf16, so a low-bit
    difference out of any op that varied from run to run would become a
    bf16 step (2^-8) at the next layer, and the spread would show it.
    Another path through the same kernels may differ from this step no
    more than the step differs from itself."""
    spread = max(grad_gap(g, first) for g in repeats)
    return spread, max(1e-4, 3 * spread[0])


def phase_train_step(torch, state_dict, model_name, tag):
    import copy

    from tumseg_torch import models, ops
    from tumseg_torch.train.loop import make_optimizer

    rng = np.random.default_rng(SEED + 4)
    x = torch.as_tensor(facade_batch(rng, TRAIN_B, N), device=DEVICE)
    # labels by height band, so the loss has something to fit
    target = (x[..., 5] * 7.999).long()
    weight = torch.as_tensor(rng.random(8).astype(np.float32) + 0.5,
                             device=DEVICE)
    base = models.get_module(model_name).get_model(8).to(DEVICE)
    base.load_state_dict(state_dict)
    base.train()

    def step(model, fast, opt=None):
        logp, _ = model(x, fast_gather=fast)
        loss = model.loss(logp, target, weight)
        if opt is not None:
            opt.zero_grad(set_to_none=True)
        loss.backward()
        if opt is not None:
            opt.step()
        return loss.detach()

    def grads(plain, fast):
        model = copy.deepcopy(base)
        if plain:
            with ops.plain(), scatter_adds_on_cpu(torch):
                loss = step(model, fast)
        else:
            loss = step(model, fast)
        return float(loss), {n: p.grad for n, p in model.named_parameters()}

    # exact gathers, then the fast ones that the training engine takes by
    # default, kernels and plain in the same mode
    for fast in (False, True):
        lk, gk = grads(False, fast)
        lp, gp = grads(True, fast)
        if not (math.isfinite(lk) and abs(lk - lp) <= 1e-5 * abs(lp)):
            raise AssertionError(f"train-step loss {lk} (kernels) vs {lp} "
                                 f"(plain), fast={fast}")
        worst, worst_name = grad_gap(gk, gp)
        limit, spread = 1e-4, ""
        if fast:
            (again, again_name), limit = fast_step_limit(
                gk, [grads(False, fast)[1] for _ in range(3)])
            spread = (f"; three more kernel steps differ from the first by "
                      f"up to {again:.3g} ({again_name}), limit {limit:.3g}")
        if worst > limit:
            raise AssertionError(f"gradient of {worst_name}: max|dg| = "
                                 f"{worst:g} x its layer's max|g|, "
                                 f"fast={fast}")
        print(f"[{tag}] {model_name} train step B={TRAIN_B}x{N} "
              f"{'fast' if fast else 'exact'} gathers: loss {lk:.6f} "
              f"(kernels) {lp:.6f} (plain); worst gradient {worst:.3g} x "
              f"max|g| ({worst_name}), {len(gk)} tensors{spread}")

    def timed(plain, fast):
        model = copy.deepcopy(base)
        opt = make_optimizer(model.parameters(), "Adam", 1e-4)

        def one():
            if plain:
                with ops.plain():
                    step(model, fast, opt)
            else:
                step(model, fast, opt)
        return time_ms(torch, one, 1)

    runs = {}
    for label, plain, fast in (
            ("plain", True, True), ("kernels exact", False, False),
            ("kernels", False, True), ("kernels", False, True),
            ("kernels exact", False, False), ("plain", True, True)):
        runs.setdefault(label, []).append(timed(plain, fast)[0])
    print(f"[{tag}] train step B={TRAIN_B}x{N} (forward + backward + Adam, "
          f"median of 3, two turns each): kernels with fast gathers "
          f"{[round(v, 3) for v in runs['kernels']]} ms, with exact gathers "
          f"{[round(v, 3) for v in runs['kernels exact']]} ms, plain (fast) "
          f"{[round(v, 3) for v in runs['plain']]} ms")


def phase_train_cli(torch, work, model_name, epochs, min_steps, tag):
    """Trains through the CLI on ``work/train_data`` (counts of zero before
    the run, read after it), then serves the best checkpoint."""
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.cli import train as train_cli
    from tumseg_torch.ops import kernels

    data = work / "train_data"
    log = work / "train_log"
    args = train_cli.parse_args([
        "--model", model_name, "--rootdir", str(data), "--test_area",
        "held_out.las", "--exp_dir", str(log), "--log_dir", model_name,
        "--epoch", str(epochs), "--batch_size", str(TRAIN_B), "--npoint",
        str(N), "--class8", "--RGB_OFF", "--seed", str(SEED)])
    blocks = int(TRAIN_POINTS / N)
    steps = epochs * (int(0.7 * blocks) // TRAIN_B)
    if steps < min_steps:
        raise AssertionError(f"only {steps} training steps")
    kernels.reset_launches()
    acc, eval_loss, iou = train_cli.main(args)
    launches = dict(kernels.launches)
    fast = dict(kernels.fast_launches)

    run = log / "sem_seg" / model_name
    text = (run / "logs" / f"{model_name}.txt").read_text()
    losses = [float(line.rsplit(":", 1)[1]) for line in text.splitlines()
              if "Training mean loss:" in line]
    rates = [line.rsplit(":", 1)[1].strip() for line in text.splitlines()
             if "Training points/sec:" in line]
    if len(losses) != epochs or not all(
            math.isfinite(v) for v in losses + list(eval_loss)):
        raise AssertionError(f"training losses {losses}, eval {eval_loss}")
    for name, per in PER_STEP[model_name].items():
        if launches[name] < steps * per:
            raise AssertionError(f"{name}: {launches[name]} launches in the "
                                 f"training run, expected >= {steps * per}")
    for name, per in FAST_PER_STEP[model_name].items():
        if fast[name] < steps * per:
            raise AssertionError(f"{name}: {fast[name]} fast launches in the "
                                 f"training run, expected >= {steps * per}")
    ckpt = run / "checkpoints" / "best_model.pth"
    if not ckpt.exists():
        raise AssertionError(f"{ckpt} was not written")
    out = test_cli.main(test_cli.parse_args([
        "--model", model_name, "--rootdir", str(data), "--test_area",
        "held_out.las", "--exp_dir", str(log / "sem_seg") + "/",
        "--log_dir", model_name, "--num_votes", "1", "--batch_size",
        str(TRAIN_B), "--num_point", str(N), "--class8", "--RGB_OFF",
        "--seed", str(SEED)]))
    if not 0.0 <= out["miou"] <= 1.0:
        raise AssertionError(f"served mIoU {out['miou']}")
    for epoch, rate in enumerate(rates):
        print(f"[{tag}] epoch {epoch + 1} Training points/sec: {rate}")
    print(f"[{tag}] {model_name} trained {steps} steps of B={TRAIN_B}x{N} "
          f"over {epochs} epochs: mean losses {losses}, eval losses "
          f"{list(eval_loss)}, best mIoU {max(iou):.4f}; best_model.pth "
          f"served with mIoU {out['miou']:.4f}; launches {launches}, of "
          f"them fast (bf16 gathers) {fast}")
    return launches


def phase_window(torch, report):
    """The z-window 3-NN kernel at fp1's shapes, against its plain version
    and against itself as the full row kernel, on guard-passing, mixed and
    all-failing inputs, and on ``three_nn_probe.window_cases()``."""
    from tumseg_torch import ops
    from tumseg_torch.ops import core, kernels
    from tumseg_torch.tools.three_nn_probe import walk_model, window_cases

    rng = np.random.default_rng(SEED + 7)
    dev = torch.device(DEVICE)
    xyz1 = torch.as_tensor(facade_blocks(rng, B, N), device=dev)
    S, d = SA[0][0], FP_D[0]
    xyz2 = core.gather_rows(
        xyz1, kernels.farthest_point_sample(xyz1, S)).contiguous()
    p2 = torch.as_tensor(rng.standard_normal((B, S, d)).astype(np.float32),
                         device=dev)
    C, tile = ops.three_nn_window(S), ops.WINDOW_N_TILE
    mixed = xyz2.clone()
    mixed[:, : S // 2, 2] = 5.0          # half the sources on one z
    flat1, flat2 = xyz1.clone(), xyz2.clone()
    flat1[..., 2] = 5.0                  # one z for all: every query fails
    flat2[..., 2] = 5.0
    nbytes = 4 * (B * N * 3 + B * S * 3 + B * S * d + B * N * 6 + B * N * d)
    ops = {}
    for label, x1, x2, on_path in (("facade", xyz1, xyz2, True),
                                   ("mixed", xyz1, mixed, False),
                                   ("one z", flat1, flat2, False)):
        for fast in (False, True):
            dk, ik, ok = kernels.three_nn_window_interpolate(x1, x2, p2, C,
                                                             tile, fast)
            dp, ip, op = core.three_nn_window_interpolate(x1, x2, p2, C,
                                                          tile, fast)
            df, i_full = kernels.three_nn_expansion(x1, x2)
            if not (torch.equal(ik, ip) and torch.equal(ik, i_full)):
                bad = (ik != ip).any(-1).float().mean().item()
                raise AssertionError(f"3-NN window ({label}): {bad:.2e} of "
                                     "queries differ from the plain version "
                                     "or the full row kernel")
            if not (torch.equal(dk, dp) and torch.equal(dk, df)):
                raise AssertionError(f"3-NN window ({label}): distances are "
                                     "not bitwise those of the plain version "
                                     "and the full row kernel")
            if not torch.equal(ok, op):
                raise AssertionError(f"3-NN window ({label}, fast={fast}): "
                                     "the interpolation is not bitwise the "
                                     "plain version's")
        fails = int((~core.window_guard(x1, x2, C, tile)).sum().item())
        if label == "mixed" and not 0 < fails < B * N:
            raise AssertionError(f"mixed input: {fails} guard failures")
        if label == "one z" and fails != B * N:
            raise AssertionError(f"one z: only {fails} guard failures")
        _, _, tested = walk_model(x1.cpu().numpy(), x2.cpu().numpy(),
                                  "expansion")
        print(f"[l] 3-NN window {label}: dists, idx and out bitwise the "
              f"plain version in both modes; {fails} of {B * N} queries "
              f"fail tumseg's window guard; the walk tests "
              f"{tested / (B * N):.1f} candidates a query (walk model)")
        # ~14 operations a candidate the walk tests (the expansion-form
        # distance and the compares into the top 3), the weights, 5 an
        # output element
        ops[label] = 14 * tested + B * N * 10 + B * N * d * 5
        report.add(torch, "three_nn_window", f"{label} N={N} S={S} C={C}",
                   lambda: kernels.three_nn_window_interpolate(
                       x1, x2, p2, C, tile),
                   lambda: core.three_nn_window_interpolate(
                       x1, x2, p2, C, tile), 0.0, nbytes=nbytes,
                   ops=ops[label], plain_reps=1, phase="l", on_path=on_path)
    # the full expansion-form row kernel (window = S): the same launch
    _, full_dms = report.add(
        torch, "three_nn_window", f"full row N={N} S={S} C={S}",
        lambda: kernels.three_nn_window_interpolate(xyz1, xyz2, p2, S),
        lambda: core.three_nn_window_interpolate(xyz1, xyz2, p2, S),
        0.0, nbytes=nbytes, ops=ops["facade"], plain_reps=1, phase="l",
        on_path=False)
    for name, a, b in window_cases():
        a, b = (torch.as_tensor(x, device=dev) for x in (a, b))
        if not all(torch.equal(g, w) for g, w in zip(
                kernels.three_nn_expansion(a, b),
                core.three_nn_expansion(a, b))):
            raise AssertionError(f"3-NN window case {name}: not bitwise the "
                                 "plain expansion form")
    print("[l] three_nn_probe.window_cases() (negative distances, far from "
          "the origin, one z, mixed, lattice ties, S past one tile): bitwise "
          "the plain expansion form")
    ms, runs = time_ms(torch, lambda: kernels.three_nn_interpolate(
        xyz1, xyz2, p2), 20)
    dms = device_ms(torch, lambda: kernels.three_nn_interpolate(
        xyz1, xyz2, p2), 20)
    print(f"[l] direct-form three_nn_interpolate at N={N} S={S} D={d}: "
          f"{ms:.4f} ms {[round(r, 4) for r in runs]}, device {_ms(dms)}; "
          f"full row kernel device {_ms(full_dms)}")
    # one call's device work by kernel: the window kernel alone, no sort
    # (a trace that recorded no device event is taken again)
    calls = 10
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                kernels.three_nn_window_interpolate(xyz1, xyz2, p2, C, tile)
            torch.cuda.synchronize()
        spans = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = ("window kernel" if "ExpansionForm" in e.name
                        else "sort" if "ort" in e.name else "other")
                spans.setdefault(name, []).append(
                    e.time_range.elapsed_us() / 1e3)
        if spans:
            break
    print(f"[l] device work of {calls} facade calls by kernel "
          f"(torch.profiler): " + ", ".join(
              f"{k} {len(v)} events of {np.mean(v):.4f} ms"
              for k, v in sorted(spans.items())))
    if set(spans) != {"window kernel"}:
        raise AssertionError(f"3-NN window: a call launched more than its "
                             f"kernel, or nothing was traced: {spans}")


def scene_dataset(path):
    from tumseg_torch.data.dataset import TestGridDataset

    return TestGridDataset(las_file_list=[str(path)], num_classes=8,
                           block_points=N, color=False, class8=True,
                           seed=SEED)


def serving_model(torch, state_dict):
    from tumseg_torch import models

    model = models.get_module("pointnet2_sem_seg").get_model(8)
    model.load_state_dict(state_dict)
    return model


def phase_serve_paths(torch, work, state_dict):
    """The tile of d served by the host path, the device path and the
    device path with the window, in turn; counts of zero before each run,
    read after it. -> the window run's launches."""
    from tumseg_torch.infer.voting import InferenceRunner, run_testing
    from tumseg_torch.ops import kernels
    from tumseg_torch.viz.writers import read_labels_txt

    path, n, votes = work / "data" / "facade.las", SCENE_POINTS, 2
    model = serving_model(torch, state_dict)
    blocks = sum(math.ceil(c[0].size / N)
                 for c in scene_dataset(path).grid_structure(0))
    forwards = votes * math.ceil(blocks / B)
    labels, window_launches = {}, None
    for name, kw in (("host", dict(device_features=False)),
                     ("device", {}), ("device+window", dict(window_ops=True))):
        ds = scene_dataset(path)
        ds.grid_structure(0)  # gridded ahead, as the prefetch stages a scene
        runner = InferenceRunner(model, 8, batch_size=B, device=DEVICE, **kw)
        if runner.device_reblock != (name != "host"):
            raise AssertionError(f"{name}: device_reblock resolved to "
                                 f"{runner.device_reblock}")
        vis = work / f"m_{name.replace('+', '_')}"
        vis.mkdir()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = run_testing(ds, runner, num_votes=votes, visual_dir=vis,
                          log_string=lambda *a: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
        labels[name] = read_labels_txt(str(vis / "facade.txt"))
        window = name == "device+window"
        want_nn = forwards * (3 if window else 4)
        if launches["three_nn_interpolate"] < want_nn:
            raise AssertionError(f"{name}: three_nn_interpolate launched "
                                 f"{launches['three_nn_interpolate']} times, "
                                 f"expected >= {want_nn}")
        if (launches["three_nn_window"] < forwards if window
                else launches["three_nn_window"] != 0):
            raise AssertionError(f"{name}: three_nn_window launched "
                                 f"{launches['three_nn_window']} times")
        if window:
            window_launches = launches
        print(f"[m] {name:13s} {n} points x {votes} votes, {forwards} "
              f"forwards: {n * votes / out['infer_seconds']:.0f} "
              f"scene-points/s, infer {out['infer_seconds']:.3f} s, wall "
              f"{wall:.3f} s; launches {launches}")
    agree = (labels["device"] == labels["device+window"]).mean()
    print(f"[m] labels, window on against off: {agree:.6f} agree "
          f"(fp1's 3-NN in another form; no threshold)")

    # the device path's vote loop fed the blocks of a host-featurized vote
    host = InferenceRunner(model, 8, batch_size=B, device=DEVICE,
                           device_features=False)
    want = host.infer_scene(scene_dataset(path), 0, 1)
    ds = scene_dataset(path)
    idx, offsets = ds.grid_indices(0)  # the draws the host vote made
    runner = InferenceRunner(model, 8, batch_size=B, device=DEVICE)
    with torch.inference_mode():
        pool = torch.zeros((n + 1) * 8, device=DEVICE)
        runner._vote(runner._scene_tensors(ds, 0),
                     torch.as_tensor(idx.astype(np.int32), device=DEVICE),
                     torch.as_tensor(offsets, device=DEVICE), pool,
                     float(ds.block_size))
        got = runner._finish(ds, 0, pool, True)
    same = (got == want).mean()
    print(f"[m] device vote loop on the host vote's blocks: labels agree on "
          f"{same:.6f} of points")
    if same < 0.9999:
        raise AssertionError("device path disagrees with the host path")
    return window_launches


def cuda_busy_seconds(torch, prof):
    """The union of the intervals of the profiler's CUDA events."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e6


def phase_scale(torch, work, state_dict):
    """A ~1M-point tile by the host and the device path: scene-points/s,
    one vote's re-blocking time and the device idle share of a vote."""
    from tumseg_torch.infer.voting import InferenceRunner, reblock_on_device

    path = work / "scale" / "facade_1m.las"
    path.parent.mkdir()
    write_facade_tile(np.random.default_rng(SEED + 8), path, SCALE_POINTS,
                      length=60.0)
    model = serving_model(torch, state_dict)
    n, votes = SCALE_POINTS, SCALE_VOTES
    for name, kw in (("host", dict(device_features=False)), ("device", {})):
        ds = scene_dataset(path)
        t0 = time.perf_counter()
        cells = ds.grid_structure(0)
        grid_s = time.perf_counter() - t0
        blocks = sum(math.ceil(c[0].size / N) for c in cells)
        runner = InferenceRunner(model, 8, batch_size=B, device=DEVICE, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.infer_scene(ds, 0, votes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

        reblock = []
        for vote in range(3):
            if name == "host":
                t0 = time.perf_counter()
                ds[0]
                reblock.append(time.perf_counter() - t0)
                continue
            flat_base, starts_pos, counts_pos, _, _, segments = \
                runner._grid_tensors(ds, 0)
            u, keys = runner.vote_draws(0, vote, flat_base.shape[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reblock_on_device(u, keys, flat_base, starts_pos, counts_pos, N,
                              segments)
            torch.cuda.synchronize()
            reblock.append(time.perf_counter() - t0)

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.infer_scene(ds, 0, 1)
            torch.cuda.synchronize()
            traced = time.perf_counter() - t0
        busy = cuda_busy_seconds(torch, prof)
        idle = ("not measured (no device events traced)" if busy == 0
                else f"{1 - busy / traced:.4f}")
        print(f"[n] {name:6s} {n} points x {votes} votes ({blocks} blocks a "
              f"vote, gridding {grid_s:.3f} s beforehand): "
              f"{n * votes / wall:.0f} scene-points/s, {wall:.3f} s; "
              f"re-blocking a vote {float(np.median(reblock)):.4f} s "
              f"{[round(r, 4) for r in reblock]}; one traced vote "
              f"{traced:.3f} s, CUDA busy {busy:.3f} s, idle share {idle}")


def stage_inputs(torch, rng, b):
    """FPS centroids, ball-query indices and [xyz, features] sources of the
    four SSG stages of facade blocks [b, N]: -> (xyzs, idxs, srcs)."""
    from tumseg_torch.ops import core, kernels

    dev = torch.device(DEVICE)
    xyzs = [torch.as_tensor(facade_blocks(rng, b, N), device=dev)]
    idxs, srcs = [], []
    for (npoint, radius), c in zip(SA, SA_CHANNELS):
        src_xyz = xyzs[-1]
        new_xyz = core.gather_rows(src_xyz, kernels.farthest_point_sample(
            src_xyz, npoint)).contiguous()
        idxs.append(kernels.query_ball_point(radius, K, src_xyz, new_xyz))
        feats = torch.as_tensor(rng.standard_normal(
            (b, src_xyz.shape[1], c - 3)).astype(np.float32), device=dev)
        srcs.append(torch.cat([src_xyz, feats], dim=-1))
        xyzs.append(new_xyz)
    return xyzs, idxs, srcs


def phase_fast(torch, report):
    """The fast modes at a B=16 x 4096 training step's shapes, each against
    its plain fast version and timed beside its exact mode."""
    from tumseg_torch import ops
    from tumseg_torch.ops import core, kernels
    from tumseg_torch.tools.interp_backward_probe import MSG_FP4_D

    rng = np.random.default_rng(SEED + 9)
    dev = torch.device(DEVICE)
    xyzs, idxs, srcs = stage_inputs(torch, rng, TRAIN_B)

    def close(got, want, what):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                                   msg=lambda m: f"{what}: {m}")
        return (got - want).abs().max().item()

    for stage, (idx, src, ctr) in enumerate(zip(idxs, srcs, xyzs[1:])):
        g_k = kernels.group_points(idx, src, ctr, fast=True)
        if g_k.dtype != torch.bfloat16 or not torch.equal(
                g_k, core.group_points(idx, src, ctr, fast=True)):
            raise AssertionError(f"fast group sa{stage + 1} is not bitwise "
                                 "the plain fast group in bf16")
        report.add_fast(torch, "group", f"sa{stage + 1} S={idx.shape[1]} "
                        f"C={src.shape[2]}",
                        lambda: kernels.group_points(idx, src, ctr, True),
                        lambda: kernels.group_points(idx, src, ctr), 0.0, "o")
    for stage in (1, 2, 3):  # the sources that need a gradient
        idx, n, c = idxs[stage], srcs[stage].shape[1], srcs[stage].shape[2]
        g32 = torch.randn(*idx.shape, c, device=dev)
        g16 = g32.bfloat16()
        for g in (g16, g32):
            group_backward_bitwise(torch, idx, g, n, True,
                                   f"o fast sa{stage + 1} {g.dtype}")
        report.add_fast(torch, "group_backward",
                        f"sa{stage + 1} N={n} C={c} bf16 cotangent",
                        lambda: kernels.group_points_backward(idx, g16, n,
                                                              True),
                        lambda: kernels.group_points_backward(idx, g32, n),
                        0.0, "o")
    n = srcs[1].shape[1]
    idx = sentinels_and_repeats(idxs[1], n)
    g32 = torch.randn(*idx.shape, srcs[1].shape[2], device=dev)
    for g in (g32.bfloat16(), g32):
        group_backward_bitwise(torch, idx, g, n, True,
                               f"o fast sa2 sentinels + repeats {g.dtype}")
    print("[o] group_backward fast, sa2-sa4 and sentinels + repeats, bf16 "
          "and f32 cotangents: bitwise the plain version on the CPU and "
          "over three runs")
    for lvl, d in enumerate(FP_D):  # fp1..fp4
        xyz1, xyz2 = xyzs[lvl], xyzs[lvl + 1]
        n1, s = xyz1.shape[1], xyz2.shape[1]
        p2 = torch.randn(TRAIN_B, s, d, device=dev)
        g = torch.randn(TRAIN_B, n1, d, device=dev)
        dk, ik, ok = kernels.three_nn_interpolate(xyz1, xyz2, p2, fast=True)
        dp, ip, op = core.three_nn_interpolate(xyz1, xyz2, p2, fast=True)
        if not (torch.equal(ik, ip) and torch.equal(dk, dp)):
            raise AssertionError(f"fast 3-NN fp{lvl + 1}: indices differ")
        err = close(ok, op, f"fast interpolation fp{lvl + 1}")
        report.add_fast(torch, "three_nn_interpolate",
                        f"fp{lvl + 1} N={n1} S={s} D={d}",
                        lambda: kernels.three_nn_interpolate(xyz1, xyz2, p2,
                                                             True),
                        lambda: kernels.three_nn_interpolate(xyz1, xyz2, p2),
                        err, "o")
        if lvl == 0:
            C, tile = ops.three_nn_window(s), ops.WINDOW_N_TILE
            err = close(kernels.three_nn_window_interpolate(
                xyz1, xyz2, p2, C, tile, True)[2],
                core.three_nn_window_interpolate(xyz1, xyz2, p2, C, tile,
                                                 True)[2],
                "fast window interpolation fp1")
            report.add_fast(torch, "three_nn_window",
                            f"fp1 N={n1} S={s} C={C}",
                            lambda: kernels.three_nn_window_interpolate(
                                xyz1, xyz2, p2, C, tile, True),
                            lambda: kernels.three_nn_window_interpolate(
                                xyz1, xyz2, p2, C, tile), err, "o")
        w = core.interpolation_weights(dk)
        interp_backward_bitwise(torch, ik, w, g, s, True,
                                f"o fast fp{lvl + 1}")
        report.add_fast(torch, "interpolate_backward",
                        f"fp{lvl + 1} N={n1} S={s} D={d}",
                        lambda: kernels.interpolate_backward(ik, w, g, s,
                                                             True),
                        lambda: kernels.interpolate_backward(ik, w, g, s),
                        0.0, "o")
    g = torch.randn(TRAIN_B, n1, MSG_FP4_D, device=dev)
    interp_backward_bitwise(torch, ik, w, g, s, True, "o fast MSG fp4")
    print(f"[o] interpolate_backward fast, fp1-fp4 and MSG fp4 (D="
          f"{MSG_FP4_D}): bitwise the plain version on the CPU and over "
          "three runs")


def fused_cost(idx, C, n, tested, fast):
    """Bytes and operations of the fused kernel: xyz, centroids and src
    read, idx and the grouped tensor written; 9 operations a candidate its
    walk tests (``tested``, by ``ball_query_probe.walk_model``, as the ball
    query's lines count theirs), one subtraction an xyz output."""
    Bq, S, Kq = idx.shape
    return dict(nbytes=Bq * n * 12 + Bq * S * 12 + Bq * n * C * 4
                + Bq * S * Kq * 4 + Bq * S * Kq * C * (2 if fast else 4),
                ops=9 * tested + Bq * S * Kq * 3)


def phase_fused(torch, report):
    """The fused ball query + group at sa1-sa4 of the B=32 x 4096 forward,
    against the split kernels and its plain version, in both modes."""
    from tumseg_torch.ops import core, kernels
    from tumseg_torch.tools.ball_query_probe import walk_model

    rng = np.random.default_rng(SEED + 10)
    xyzs, idxs, srcs = stage_inputs(torch, rng, B)
    fused_device = dict.fromkeys(
        [(k, f) for k in ("fused", "split") for f in (False, True)], 0.0)
    for stage, ((npoint, r), src, ctr) in enumerate(zip(SA, srcs, xyzs[1:])):
        xyz, n, c = xyzs[stage], srcs[stage].shape[1], srcs[stage].shape[2]
        for fast in (False, True):
            g_f, i_f = kernels.fused_ball_group(r, K, xyz, ctr, src, fast)
            i_s = kernels.query_ball_point(r, K, xyz, ctr)
            g_p, i_p = core.fused_ball_group(r, K, xyz, ctr, src, fast)
            if not (torch.equal(i_f, i_s) and torch.equal(i_f, i_p)
                    and torch.equal(g_f, kernels.group_points(i_s, src, ctr,
                                                              fast))
                    and torch.equal(g_f, g_p)):
                raise AssertionError(f"fused sa{stage + 1} fast={fast}: not "
                                     "bitwise the split kernels and the "
                                     "plain fused op")
        short = ((i_f[..., -1] == i_f[..., 0]) & (i_f[..., 0] != n)).float()
        print(f"[p] fused sa{stage + 1} N={n} S={npoint} r={r}: bitwise the "
              f"split pair and plain in both modes; short balls "
              f"{short.mean().item():.3f}")
        label = f"sa{stage + 1} N={n} S={npoint} C={c}"
        _, tested = walk_model(xyz.cpu().numpy(), ctr.cpu().numpy(), (r,),
                               (K,))
        _, fused_dms = report.add(
            torch, "fused_ball_group", label,
            lambda: kernels.fused_ball_group(r, K, xyz, ctr, src),
            lambda: core.fused_ball_group(r, K, xyz, ctr, src), 0.0,
            plain_reps=2, phase="p", **fused_cost(i_f, c, n, tested, False))
        report.add_fast(torch, "fused_ball_group", label,
                        lambda: kernels.fused_ball_group(r, K, xyz, ctr, src,
                                                         True),
                        lambda: kernels.fused_ball_group(r, K, xyz, ctr, src),
                        0.0, "p")
        fb = fused_cost(i_f, c, n, tested, True)
        bound = max(fb["nbytes"] / HBM_BYTES_PER_S,
                    fb["ops"] / F32_OPS_PER_S) * 1e3
        print(f"[p] fused {label} fast: bound {bound:.5f} ms "
              f"({fb['nbytes'] / 1e6:.2f} MB, {fb['ops'] / 1e9:.3f} Gop)")
        for fast in (False, True):
            def split_call():
                return kernels.group_points(kernels.query_ball_point(
                    r, K, xyz, ctr), src, ctr, fast)

            def fused_call():
                return kernels.fused_ball_group(r, K, xyz, ctr, src, fast)

            split, runs = time_ms(torch, split_call, 20)
            split_dms = device_ms(torch, split_call, 20)
            dms = fused_dms if not fast else device_ms(torch, fused_call, 20)
            for key, v in (("fused", dms), ("split", split_dms)):
                fused_device[key, fast] = _add(fused_device[key, fast], v)
            print(f"[p] {label} fast={fast}: fused device {_ms(dms)} against "
                  f"the split pair (ball query + group) device "
                  f"{_ms(split_dms)}, event {split:.4f} ms "
                  f"{[round(v, 4) for v in runs]}")
    for fast in (False, True):
        print(f"[p] sa1-sa4 device, fast={fast}: fused "
              f"{_ms(fused_device['fused', fast])}, split pair "
              f"{_ms(fused_device['split', fast])}")
    # balls that fill K (few facade balls do at the model's radii), then an
    # empty ball (a centroid far from every point), in both modes
    xyz, src, ctr = xyzs[0], srcs[0], xyzs[1]
    for fast in (False, True):
        g_f, i_f = kernels.fused_ball_group(0.5, K, xyz, ctr, src, fast)
        i_s = kernels.query_ball_point(0.5, K, xyz, ctr)
        if not (torch.equal(i_f, i_s) and torch.equal(
                g_f, kernels.group_points(i_s, src, ctr, fast))):
            raise AssertionError(f"fused r=0.5 fast={fast}: not bitwise the "
                                 "split kernels")
    full = (i_f[..., -1] != i_f[..., 0]).float().mean().item()
    print(f"[p] fused sa1 shapes at r=0.5: bitwise the split pair in both "
          f"modes; balls that fill K {full:.3f}")
    ctr = ctr.clone()
    ctr[:, 0] = 1000.0
    for fast in (False, True):
        g_f, i_f = kernels.fused_ball_group(0.1, K, xyz, ctr, src, fast)
        i_s = kernels.query_ball_point(0.1, K, xyz, ctr)
        want = torch.cat([-ctr[:, 0, None, :].expand(B, K, 3),
                          torch.zeros(B, K, src.shape[2] - 3,
                                      device=ctr.device)], -1)
        if not ((i_f[:, 0] == N).all() and torch.equal(i_f, i_s)
                and torch.equal(g_f, kernels.group_points(i_s, src, ctr,
                                                          fast))
                and torch.equal(g_f[:, 0].float(),
                                want.to(g_f.dtype).float())):
            raise AssertionError(f"fused empty ball fast={fast}: not the "
                                 "sentinel N and the row -centre")
    print("[p] fused empty ball -> sentinel N, row -centre, both modes: ok")


def labelled_batch(seed):
    """A B=16 x 4096 training batch of facade blocks, labelled by height
    band, and class weights: -> (points, target, weights) as numpy."""
    rng = np.random.default_rng(seed)
    points = facade_batch(rng, TRAIN_B, N)
    return (points, (points[..., 5] * 7.999).astype(np.int64),
            rng.random(8).astype(np.float32) + 0.5)


def phase_fused_switch(torch, state_dict):
    """The fused switch end to end: a forward and a training step.
    -> the launches of that run (counts of zero before it)."""
    import copy

    from tumseg_torch import models, ops
    from tumseg_torch.ops import kernels
    from tumseg_torch.train.loop import TrainEngine

    x = torch.as_tensor(facade_batch(np.random.default_rng(SEED + 1), B, N),
                        device=DEVICE)
    model = models.get_module("pointnet2_sem_seg").get_model(8).to(DEVICE)
    model.load_state_dict(state_dict)
    bx, bt, weights = labelled_batch(SEED + 11)

    def step(fused):
        eng = TrainEngine(copy.deepcopy(model), 8, weights, seed=SEED,
                          device=DEVICE)
        with ops.fused_group_enabled(fused):
            loss, _ = eng.train_batch(bx, bt, 1e-3, 0.1)
        return float(loss), {n: p.grad for n, p in
                             eng.model.named_parameters()}

    model.eval()
    with torch.inference_mode():
        kernels.reset_launches()
        off = model(x)[0]
        split = dict(kernels.launches)
    # four split-path steps: the run-to-run spread of the backward
    split_steps = [step(False) for _ in range(4)]
    lo, go = split_steps[0]
    # the fused path: the switched forward and training step
    kernels.reset_launches()
    with torch.inference_mode(), ops.fused_group_enabled():
        on = model.eval()(x)[0]
    fwd = dict(kernels.launches)
    lf, gf = step(True)
    launches = dict(kernels.launches)
    if not torch.equal(on, off):
        raise AssertionError("log-probs under the fused switch differ")
    if (fwd["fused_ball_group"] != 4
            or fwd["ball_query"] != split["ball_query"] - 4):
        raise AssertionError(f"fused switch launches {fwd}, off {split}")
    print(f"[q] SSG forward B={B}x{N} under the fused switch: log-probs "
          f"bitwise those of the split path; fused {fwd['fused_ball_group']}"
          f" launches, ball query {split['ball_query']} -> "
          f"{fwd['ball_query']}, group {split['group']} -> {fwd['group']}")
    if launches["fused_ball_group"] != 8:
        raise AssertionError(f"the switched step launched {launches}")
    # the forward has no atomics: the loss is bitwise the same
    if any(loss != lo for loss in [lf] + [v for v, _ in split_steps]):
        raise AssertionError(f"fused step loss {lf} against split "
                             f"{[v for v, _ in split_steps]}")
    bitwise = all(torch.equal(gf[n], go[n]) for n in go)
    gap, gap_name = grad_gap(gf, go)
    spread, limit = fast_step_limit(go, [g for _, g in split_steps[1:]])
    print(f"[q] train step B={TRAIN_B}x{N} (fast gathers) under the fused "
          f"switch: loss {lf!r} bitwise that of the split path; {len(go)} "
          f"gradients {'bitwise equal' if bitwise else 'not bitwise'}: the "
          f"largest difference {gap:.3g} x its layer's max|g| ({gap_name}); "
          f"three more split-path steps differ from the first by up to "
          f"{spread[0]:.3g} ({spread[1]}), limit {limit:.3g}; fused "
          f"launches in the switched forward and step "
          f"{launches['fused_ball_group']}")
    if not bitwise and gap > limit:
        raise AssertionError(f"fused step gradient {gap_name}: {gap:g} x "
                             f"its layer's max|g|, beyond {limit:g}")
    return launches


def phase_fast_vs_exact(torch, state_dict, model_name, tag):
    """One step at exact_gathers=False and at True from the same weights
    and batch: what the bf16 gathers cost, and where they ran."""
    import copy

    from tumseg_torch import models
    from tumseg_torch.ops import kernels
    from tumseg_torch.train.loop import TrainEngine

    base = models.get_module(model_name).get_model(8).to(DEVICE)
    base.load_state_dict(state_dict)
    bx, bt, weights = labelled_batch(SEED + 12)
    out = {}
    for exact in (False, True):
        eng = TrainEngine(copy.deepcopy(base), 8, weights, seed=SEED,
                          device=DEVICE, exact_gathers=exact)
        kernels.reset_launches()
        loss, _ = eng.train_batch(bx, bt, 1e-3, 0.1)
        loss = float(loss)
        fast = dict(kernels.fast_launches)
        want = FAST_PER_STEP[model_name]
        if exact and any(fast.values()):
            raise AssertionError(f"exact_gathers=True ran fast {fast}")
        if not exact and any(fast[k] != v for k, v in want.items()):
            raise AssertionError(f"fast step launched {fast}, expected "
                                 f"{want}")
        kernels.reset_launches()
        eng.eval_batch(bx, bt)
        if any(kernels.fast_launches.values()):
            raise AssertionError(f"eval ran fast {kernels.fast_launches}")
        out[exact] = (loss, {n: p.grad for n, p in
                             eng.model.named_parameters()}, fast)
    (lf, gf, fast), (le, ge, _) = out[False], out[True]
    worst, worst_name = grad_gap(gf, ge)
    print(f"[{tag}] {model_name} step B={TRAIN_B}x{N}, fast against exact "
          f"gathers: loss {lf:.7f} against {le:.7f} (difference "
          f"{lf - le:.3g}); largest gradient difference {worst:.3g} x its "
          f"layer's max|g| ({worst_name}); fast launches in the fast step "
          f"{fast}, 0 in the exact step and in eval")


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

    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    (work / "data").mkdir(parents=True)
    (work / "train_data").mkdir()
    write_facade_tile(np.random.default_rng(SEED + 2),
                      work / "data" / "facade.las", SCENE_POINTS)
    rng = np.random.default_rng(SEED + 5)
    write_facade_tile(rng, work / "train_data" / "facade.las", TRAIN_POINTS)
    write_facade_tile(rng, work / "train_data" / "held_out.las",
                      HELD_OUT_POINTS)

    ssg, msg = "pointnet2_sem_seg", "pointnet2_sem_seg_msg"
    report = Report()
    phase_kernels(torch, report)
    phase_window(torch, report)
    phase_fused(torch, report)
    state_dict = phase_forward(torch, ssg, "c")
    launches = phase_serve(torch, work, state_dict, ssg, "d")
    launches["fused_ball_group"] = phase_fused_switch(
        torch, state_dict)["fused_ball_group"]
    phase_backward(torch, report)
    phase_fast(torch, report)
    phase_train_step(torch, state_dict, ssg, "f")
    launches.update({name: n for name, n in phase_train_cli(
        torch, work, ssg, TRAIN_EPOCHS, 10, "g").items()
        if name in ("group_backward", "interpolate_backward")})

    phase_multi(torch, report)
    msg_state = phase_forward(torch, msg, "i")
    launches["ball_query_multi"] = phase_serve(
        torch, work, msg_state, msg, "j")["ball_query_multi"]
    phase_train_step(torch, msg_state, msg, "k")
    phase_train_cli(torch, work, msg, MSG_TRAIN_EPOCHS, 6, "k")
    phase_fast_vs_exact(torch, state_dict, ssg, "r")
    phase_fast_vs_exact(torch, msg_state, msg, "r")

    launches["three_nn_window"] = phase_serve_paths(
        torch, work, state_dict)["three_nn_window"]
    phase_scale(torch, work, state_dict)

    for name, k in report.kernels.items():
        k["launches"] = launches[name]
        if k["launches"] == 0:
            raise AssertionError(f"{name} was never launched on its path")
    print(json.dumps({"kernels": list(report.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
