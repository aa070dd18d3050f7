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
bn. (after e) BatchNorm + ReLU (``csrc/batch_norm.cu``) at every layer of
   the SSG: the apply at the B=32 forward's shapes bitwise the eager chain,
   the backward terms and dx at the B=16 step's bitwise their plain
   versions (autograd's ops), each timed beside its bound, its plain
   version and, for the apply, ``F.batch_norm``; then the 22 layers
   together as CUDA graphs, eager chain and autograd against the kernels
   in turns, the B=32 eval forward and the B=16 training forward and
   backward;
ct. (right after b) the card tests: ``python3 -m pytest --noconftest
   tests/test_torch_cuda.py`` in a subprocess, on the kernels a built: it
   prints the count passed and the seconds, and fails on any failure,
   error or skip, or when fewer tests pass than the file collects;
c. runs that forward with the kernels and with the plain versions: log-probs
   within 1e-4 and argmax equal on >= 99.99% of points, both timed;
d. serves a synthetic ~300K-point facade tile through
   ``tumseg_torch.cli.test.main`` (2 votes, the seeded random weights of c,
   BN statistics calibrated on facade blocks), checks the report and the
   label dump, and checks that every kernel was launched at least
   (forwards x launches per forward) times in that run. The CLI's runner
   keeps its "auto" defaults, so on the card it serves through the device
   re-blocking path, as ``tumseg``'s CLI does on its accelerator, and its
   programs as CUDA graphs (as do j, m and n; see sg);
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
   engine's default; the device pipeline, which ``--data_pipeline auto``
   picks on the card: the blocks sampled on the card from room ids, the
   6 steps of an epoch under ``--superstep 8`` going through the per-step
   calls as the epoch's tail), checks that the logged losses are finite, that
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
   ``tumseg_torch.cli.train --model pointnet2_sem_seg_msg`` (the device
   pipeline, as in g; 1 epoch, >= 6
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
s. (after r) bf16 compute (``compute_dtype=torch.bfloat16``, ``--bf16``):
   checks that ``allow_bf16_reduced_precision_reduction`` leaves a bf16
   GEMM with an f32 output unchanged; the SSG and MSG forwards at B=32 x
   4096 in bf16 with the kernels against the same forwards under
   ``ops.plain()`` (log-probs within 1e-4, argmax equal on >= 99.99% of
   points), every neighbourhood group and interpolation launched in the
   fast mode and none in the exact one (the 4 centroid gathers are
   exact); bf16 against f32 compute with the same weights (max |dlogp| and
   argmax agreement, printed beside f32 with the fast gathers alone; the
   agreement >= ``BF16_AGREE_MIN``, a guard against breakage, and >= 2
   classes); the forwards' times (median of 3, two turns each) and peak
   memory over what was held before, bf16 beside f32, the event time of a
   forward's weight casts, and a profiler breakdown of each forward's
   device time by kind of kernel; serves d's tile through
   ``tumseg_torch.cli.test`` with and without ``--bf16`` in turns (f32,
   bf16, bf16, f32; 2 votes each; fast launches only in bf16):
   scene-points/s and the agreement of the two label dumps; one bf16
   training step at B=16 x 4096 (fast gathers) with the kernels against
   plain as in f, timed beside the f32 step; and trains SSG as in g and
   MSG as in k through ``tumseg_torch.cli.train --bf16`` (the device
   pipeline), serving each ``best_model.pth`` with ``--bf16``.
t. (after n) ``pointnet_sem_seg``, which reaches no point kernel: its
   B=32 x 4096 forward from seeded weights, BN statistics calibrated on the
   facade blocks (all but the STN's fc batch norms, which normalise over
   the blocks alone): the card's f32 log-probs of two blocks within 1e-3
   of the CPU's forward of the same weights and blocks, argmax agreement
   >= 0.999, >= 2 classes; bf16 compute against f32 (max |dlogp|, argmax
   agreement; printed, not held); f32 and bf16 timed in turns (median of
   3), peak memory over what was held before and a profiler breakdown by
   kind of kernel as in s; no point kernel launched (the BatchNorm
   kernels are);
u. serves d's tile with those weights through ``tumseg_torch.cli.test
   --model pointnet_sem_seg``, f32 and ``--bf16`` in turns: scene-points/s,
   a finite mIoU, labels not constant, every point kernel's launches 0,
   bn_apply's 16 a forward;
v. one PointNet training step at B=16 x 4096 on the card and on the CPU,
   in train-mode and in eval-mode BN: loss within rtol 1e-5 of the CPU's
   (with the regularizer, > 0); gradients held against an f64 step on the
   CPU, no further from it than three times the CPU's f32 step (at least
   1e-4; see ``phase_pointnet_train``); the step timed in f32 and bf16 in
   turns; trains through ``tumseg_torch.cli.train --model
   pointnet_sem_seg`` (the device pipeline; 1 epoch, >= 6 steps, no kernel
   launched: training points/s) and serves its ``best_model.pth``;
w. the frozen variants: ``pointnet2_sem_seg_trial`` serves d's tile with
   c's weights through the CLI, with the SSG's launches per forward;
   ``pointnet2_sem_seg_original`` (9 channels, 3 of them uniform in
   [0, 1)) runs a forward with the kernels against plain as c does;
   ``pointnet_sem_seg_original`` a finite forward at 9 channels with no
   kernel launched; each variant raises ``ValueError`` on another count of
   extra channels;
x. (after g) the device training pipeline: the ``DeviceBlockSampler``
   built from g's training tile on the card and on the CPU (tables
   bitwise equal); one trial centre's acceptance rate over 4096 trial
   centres, and the chance that a row is left pending after a round of
   ``trials``; a B=16 batch from the same explicit draws on both (half its
   rows chosen to draw with replacement): centres, counts, sel, points and
   labels bitwise equal; 64 generator-drawn batches, 8 a call: every point
   inside its centre's block, every count > 1024, sel distinct where the
   count is >= 4096, the share of rows that needed a second round; the
   sampler's time a B=16 batch alone and in a call of 8 (CUDA events,
   median of 3) and its peak memory over the tables, and its time alone
   at 1, 2, 4 and 8 trial centres a round;
   ``train_batch_rooms_multi`` over 4 batches against 4
   ``train_batch_rooms`` (SSG, fast gathers, the weights of c): losses,
   corrects and parameters bitwise equal, or within 1e-4 of each layer's
   largest with the distance printed; the device's idle share over 4
   steps as one call and as 4 calls (``torch.profiler``, in turns); then
   the training CLI on g's tile
   with ``--data_pipeline host``, ``device --superstep 1`` and ``device
   --superstep 4`` in turns (two each, 2 epochs of 6 steps, so a 4-step
   superstep fills once an epoch and the tail drains), each run's
   training points/s, and each best checkpoint served.
y. (after x) the ``data`` mesh (``tumseg_torch.parallel``): in a one-rank
   NCCL group ``dryrun_multichip(1)`` and one SSG step at B=16 x 4096 (SGD,
   deterministic draws, exact gathers) held against the same step with no
   mesh (loss within 1e-5 relative, parameters within 5e-4); then two gloo
   ranks spawned on cuda:0: ``dryrun_multichip(2, device="cuda:0",
   backend="gloo")``, the same step 8 blocks a rank against the one-process
   step (the same bounds; gradient and BN-statistics distances printed),
   both ranks' parameters bitwise equal after 3 steps, 4
   ``train_batch_rooms`` bitwise one ``train_batch_rooms_multi`` of 4 on
   the device pipeline with the ranks' sampled blocks different, and d's
   tile served through the test CLI's path at B=32 (16 a rank) by device
   re-blocking: at most 0.1% of labels differ from one process's,
   scene-points/s beside one process's (two ranks share one card, so this
   is a finding, not a limit), and each of d's kernels launched on each
   rank at least as often as d's forwards need; sg's checks on the mesh:
   d's tile served (2 votes) with the serving programs as CUDA graphs and
   with ``cuda_graphs=False``, labels and pools bitwise equal on the
   one-rank NCCL mesh (and to one process's) and on each gloo rank (the
   ranks' pools equal, labels within 0.1% of one process's).
cg. (after y) the training engine's steps as CUDA graphs
   (``tumseg_torch/utils/graphs.py``, the engine's default on the card)
   against the same steps eager (``TrainEngine(cuda_graphs=False)``), on
   a 1.2M-point facade strip sampled on the card: the SSG in f32 and in
   bf16 compute (fast gathers) over room-id calls of k = 1, 1, 4, 4, 8,
   8, 1 (each shape warmed up eagerly, then captured and replayed: 3
   captures, 4 replays, 27 steps), MSG and PointNet over two single
   steps (the second replayed), eval calls of k = 4, 4, 1, 1, three
   host-pipeline train steps and two eval steps, a ``load_state`` between
   two 4-step calls and Adam's ``load_state_dict`` between two more (the
   graphs dropped and captured again): every call's losses, corrects and
   tallies and, after each sequence, every parameter, BN buffer and Adam
   tensor bitwise equal to eager; then, for k = 1, 4 and 8, graph and
   eager in turns (graph, eager, eager, graph), the CUDA-event time a step
   of a room-id call, back-to-back replays a step (the device's rate),
   peak memory over what was held and the capturing call's time over the
   warm-up's; and ``tumseg_torch.cli.train`` on the device pipeline at
   ``--superstep`` 1 and 8, graph and eager in turns (3 epochs of 12
   steps: an 8-step call and a tail of 4), Training points/sec by epoch
   and the fit logs (mean loss, accuracy, eval loss and mIoU) equal
   between graph and eager;
sg. (after cg) the serving runner's programs as CUDA graphs
   (``InferenceRunner``'s default on the card: the B=32 forward, each
   vote's chunk and its re-blocking) against ``cuda_graphs=False``,
   bitwise: ``predict_blocks`` at B=32 x 4096 (warm-up, capture and
   replay, replay) for the SSG in f32 and bf16, MSG, PointNet and
   ``pointnet2_sem_seg_trial``; d's tile served (2 votes) by the device
   re-blocking, device featurization and host paths (SSG f32), and by
   device re-blocking in bf16, with MSG, PointNet and the trial variant,
   with ``window_ops`` and under the fused switch: labels and pools
   bitwise equal, one warm-up and one capture a program, the warm-ups and
   replays one a program call (a chunk of B blocks, and on the device
   re-blocking path a re-blocking a vote); two scenes through
   ``run_testing``, the second gridded and uploaded by its prefetch while
   the first votes, label dumps and the second scene's pool bitwise
   equal, 2 captures a scene; then
   the SSG forward in f32 and bf16, graph and eager in turns (graph,
   eager, eager, graph): CUDA-event ms, the host's time to enqueue a call
   (and the graph's ``replay()`` alone) and peak memory; and d's and n's
   tiles served in turns: scene-points/s, the idle share (1 - busy /
   CUDA-event wall; busy: a vote's chunks at the back-to-back replay
   time of its first chunk, and its re-blocking's), the first call's
   seconds, captures and capture seconds, peak memory;
tl. (after sg, before the kernels' line) the port's benches, each through
   its ``main(argv)`` at its defaults (``TOOL_ARGS``: ``breakdown`` at 3
   turns, ``train_sustained`` at 1 epoch): ``voting_bench`` (graph,
   eager, eager, graph) and ``train_sustained`` (graph, eager), then
   ``sampler_probe``, ``serve_probe3``, ``breakdown`` and ``roofline``;
   each tool's first line the card's, its JSON lines checked (the keys,
   finite positive rates and times, every point of the scene voted, the
   roofline's FLOPs equal to ``roofline.model_flops``, the count from the
   layers' widths, and no split whose parts exceed their whole by more
   than the runs' spread: the SA blocks against the forward, the
   layers' gradients against the train step, FPS and the ball query
   against their stage's block, the sampler's rounds, sort and gathers
   against a whole batch, a vote without its scatter against the vote,
   the programs' busy time against a vote's wall), its seconds and
   headline printed and its output kept under ``build/chip_smoke/tools``;
z. (last) the port's end-to-end tools: ``tumseg_torch.tools.soak`` at its
   defaults (three 600K-point facade tiles, ``--class8 --bf16`` with
   colour, 3 epochs at B=16 x 4096, a 3-vote B=32 test with ``--visual``),
   its four phase lines and its gate (finite losses, mIoU > 0.3, the
   checkpoint, one label a point in ``visual/test_tile.txt``); then
   ``tumseg_torch.tools.miou_parity`` at PARITY.md's production
   configuration (300K-point facade tiles with colour, B=16 x 4096, the
   tool's default of 6 epochs, 2 votes) for seeds 0-2 in f32 and in ``--bf16``: each served
   mIoU beside ``tumseg``'s and the original PyTorch pipeline's recorded
   ones, the per-epoch eval mIoU, train and test seconds and every
   kernel's launches (at least steps x launches a step in training); the
   f32 and bf16 means and bf16 - f32 a seed. Every served mIoU must be
   > 0.3 and the f32 mean >= 0.4122, the original pipeline's.

Each kernel's time at the main path's shapes stands beside its bound: the
larger of its bytes (each input read once, each output written once) over
the H100's 3.35 TB/s and its f32 operations over 67 TFLOP/s, counted from
this run's inputs by the rules of ``tumseg_torch/tools/roofline.py``
(a ball query and the fused kernel count 9 operations
a candidate their z-slab walk tests, the window 3-NN 14), and beside one
PyTorch call that computes the same function where there is one. A kernel
with a fast mode also reports ``fast_ms``, the fast mode's time, beside
``fast_exact_ms``, the exact mode's time at the same shapes (phase o's;
phase p's for the fused kernel). Every kernel also reports ``device_ms``
and ``library_device_ms``, the profiler's device time of the calls that
``ms`` and ``library_ms`` time with CUDA events (null where no PyTorch
call computes the function; where a call's device work is
shorter than its host work, as at the K = 1 centroid gathers, the event
time is the host's time a call). Training and serving on the card run
the engine's steps and the runner's programs as CUDA graphs: a kernel
launch that a graph captured counts once each time the graph replays
(``kernels.replayed``), so the launch counts of the training and serving
runs are the kernels' runs. A JSON summary of the kernels is printed
after phases a-y, ct, cg, sg and tl and before z; the last line is
``{"ok": true, "device": {...}}``. Any failed phase raises, and the script
then exits non-zero without printing the last line (nor the kernels' line
when a phase before z failed). Without a CUDA device it exits with code 2.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import shutil
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

# the card's HBM3 bytes/s and f32 operations/s outside the tensor cores and
# the kernels' counting rules: one count for the bounds here and the tool's
from tumseg_torch.tools import roofline
from tumseg_torch.tools.roofline import F32_OPS_PER_S, HBM_BYTES_PER_S

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
# least argmax agreement of a bf16 forward with the f32 one of the same
# weights in s: the seeded random net's labels move under any bf16 rounding
# (0.71 SSG, 0.74 MSG at B=32 x 4096 on an H100, where f32 compute with the
# fast gathers alone gives 0.75, 0.76), so this guards against breakage
# only (chance is ~1/8)
BF16_AGREE_MIN = 0.5
# x: generator-drawn batches whose blocks are checked, trial centres a row
# of the explicit draws, and trial centres counted for the acceptance rate
X_BATCHES = 64
X_TRIALS = 16
X_TRIAL_CENTRES = 4096
# z: PARITY.md's production configuration of tools/miou_parity.py (the
# command it logs; its epochs are the tool's default of 6), the served mIoU
# recorded there a seed for tumseg and for the original PyTorch pipeline,
# and the gates: every served mIoU above the soak's 0.3 and the f32 mean at
# least the original pipeline's
PARITY_ARGS = ["--tile_style", "facade", "--tile_points", "300000",
               "--color", "--npoint", "4096", "--batch", "16", "--votes",
               "2"]
PARITY_SEEDS = (0, 1, 2)
PARITY_TUMSEG = {0: 0.4684, 1: 0.4863, 2: 0.4724}
PARITY_REFERENCE = {0: 0.4135, 1: 0.4614, 2: 0.3618}
PARITY_MEAN_MIN = 0.4122
SERVED_MIOU_MIN = 0.3
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
# BatchNorm + ReLU: no Pallas kernel, tumseg leaves it to XLA's fusion
BN_KERNELS = ("bn_apply", "bn_backward_terms", "bn_backward_dx")
REPLACES.update(dict.fromkeys(BN_KERNELS, "none (XLA fuses BatchNorm in "
                                          "tumseg/nn/layers.py:82-116)"))
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
SOURCES.update(dict.fromkeys(BN_KERNELS, "tumseg_torch/csrc/batch_norm.cu"))
# the kernels with a fast (single-pass bf16) mode
FAST = ("group", "three_nn_interpolate", "group_backward",
        "interpolate_backward", "three_nn_window", "fused_ball_group")
# the kernels whose lines also give the profiler's device time, and those
# of them that no single PyTorch call computes
DEVICE_TIMED = ("fps", "ball_query", "ball_query_multi", "group",
                "group_backward", "three_nn_interpolate",
                "interpolate_backward", "three_nn_window",
                "fused_ball_group") + BN_KERNELS
NO_LIBRARY = ("fps", "ball_query", "ball_query_multi", "three_nn_interpolate",
              "three_nn_window", "fused_ball_group", "bn_backward_terms",
              "bn_backward_dx")
# launches of each kernel in one forward: group runs once per set
# abstraction for the centroid gather and once per radius for the
# neighbourhoods; a model's other ball query is never launched; bn_apply
# once a BatchNorm layer
PER_FORWARD = {
    "pointnet2_sem_seg": {"fps": 4, "ball_query": 4, "ball_query_multi": 0,
                          "group": 8, "three_nn_interpolate": 4,
                          "three_nn_window": 0, "bn_apply": 22},
    "pointnet2_sem_seg_msg": {"fps": 4, "ball_query": 0,
                              "ball_query_multi": 4, "group": 12,
                              "three_nn_interpolate": 4,
                              "three_nn_window": 0, "bn_apply": 34},
}
PER_FORWARD["pointnet2_sem_seg_trial"] = PER_FORWARD["pointnet2_sem_seg"]
# PointNet reaches no point kernel: every point kernel's count stays 0 in
# its runs; its 16 BatchNorms run the apply
POINTNET = "pointnet_sem_seg"
PER_FORWARD[POINTNET] = dict(
    {k: 0 for k in SOURCES if k not in BN_KERNELS}, bn_apply=16)
# BatchNorm layers of each model: one launch of each training kernel a
# layer and step
BN_LAYERS = {"pointnet2_sem_seg": 22, "pointnet2_sem_seg_msg": 34,
             POINTNET: 16}
# the frozen variants and the extra feature channels each one pins
FROZEN = {"pointnet2_sem_seg_original": 3, "pointnet2_sem_seg_trial": 0,
          "pointnet_sem_seg_original": 3}
# backward launches of one training step: group backward where the source
# needs a gradient (sa2-sa4, once per radius), interpolation at fp1-fp4
PER_STEP = {
    "pointnet2_sem_seg": {"group_backward": 3, "interpolate_backward": 4},
    "pointnet2_sem_seg_msg": {"group_backward": 6, "interpolate_backward": 4,
                              "ball_query_multi": 4},
    POINTNET: {},
}
for _name, _layers in BN_LAYERS.items():
    PER_STEP[_name].update(dict.fromkeys(BN_KERNELS[1:], _layers))
# fast launches of one training step with fast gathers: the neighbourhood
# groups (once per radius), the interpolations and both backward kernels
FAST_PER_STEP = {
    "pointnet2_sem_seg": {"group": 4, "three_nn_interpolate": 4,
                          "group_backward": 3, "interpolate_backward": 4},
    "pointnet2_sem_seg_msg": {"group": 8, "three_nn_interpolate": 4,
                              "group_backward": 6,
                              "interpolate_backward": 4},
    POINTNET: {},
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


def model_batch(b, n, extra=0):
    """[b, n, 6 + extra] inputs of seed SEED + 1: ``facade_batch``, then
    ``extra`` channels uniform in [0, 1) (an RGB of sorts)."""
    x = facade_batch(np.random.default_rng(SEED + 1), b, n)
    if extra:
        rgb = np.random.default_rng(SEED + 6).random((b, n, extra),
                                                     dtype=np.float32)
        x = np.concatenate([x, rgb], axis=-1)
    return x


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
        _, bytes_ms, ops_ms = roofline.bound_ms(nbytes, ops)
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
        0.0, plain_reps=plain_reps, phase=phase,
        **roofline.ball_query_cost(b, n, s, ks, tested))
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
            reps=5, plain_reps=1, **roofline.fps_cost(B, n, npoint))
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
                   **roofline.group_cost(*idx1.shape, 3, n))
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
                   **roofline.group_cost(*idx.shape, C, src.shape[1]))

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
        # a full scan's operations (more than the z-slab search tests: the
        # bound is the bytes' either way)
        _, dms = report.add(
            torch, "three_nn_interpolate", f"N={n1} S={s} D={d}",
            lambda: kernels.three_nn_interpolate(xyz1, xyz2, p2),
            lambda: core.three_nn_interpolate(xyz1, xyz2, p2), err,
            plain_reps=2, **roofline.three_nn_cost(B, n1, s, d))
        print(f"[b] three_nn_interpolate fp{lvl + 1} N={n1} S={s} D={d} "
              f"(Q, R) {kernels.three_nn_geometry(B, n1, d)}: "
              f"device {_ms(dms)}; out bitwise the plain version "
              f"{torch.equal(ok, op)}")


def phase_forward(torch, model_name, tag, extra=0):
    from tumseg_torch import models, ops
    from tumseg_torch.nn.layers import calibrate_batch_norm

    x = torch.as_tensor(model_batch(B, N, extra), device=DEVICE)
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


def phase_serve(torch, work, state_dict, model_name, tag, bf16=False,
                run=""):
    """Serves the tile ``work/data/facade.las`` through the test CLI (with
    ``--bf16``: in bf16 compute, which gathers fast); counts of zero before
    the run, read after it; ``run`` tells repeated runs' log directories
    apart. -> (launches, fast launches, rate, labels)."""
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.data.dataset import TestGridDataset
    from tumseg_torch.models.convert import variables_from_state_dict
    from tumseg_torch.ops import kernels
    from tumseg_torch.train.checkpoint import save_checkpoint
    from tumseg_torch.viz.writers import read_labels_txt

    n = SCENE_POINTS
    data = work / "data"
    log_dir = model_name + ("_bf16" if bf16 else "") + run
    ckpt_dir = work / "log" / "sem_seg" / log_dir / "checkpoints"
    ckpt_dir.mkdir(parents=True)
    save_checkpoint(str(ckpt_dir / "best_model.pth"), epoch=0,
                    variables=variables_from_state_dict(state_dict))

    votes = 2
    args = test_cli.parse_args([
        "--model", model_name, "--rootdir", str(data), "--test_area",
        "facade.las", "--exp_dir", str(work / "log") + "/sem_seg/",
        "--log_dir", log_dir, "--num_votes", str(votes), "--batch_size",
        str(B), "--num_point", str(N), "--class8", "--RGB_OFF", "--seed",
        str(SEED)] + (["--bf16"] if bf16 else []))
    kernels.reset_launches()
    out = test_cli.main(args)
    launches = dict(kernels.launches)
    fast = dict(kernels.fast_launches)

    if not math.isfinite(out["miou"]) or not 0.0 <= out["miou"] <= 1.0:
        raise AssertionError(f"mIoU {out['miou']} is not a finite ratio")
    txt = work / "log" / "sem_seg" / log_dir / "visual" / "facade.txt"
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
    # bf16 compute gathers fast: every neighbourhood group and every
    # interpolation, none exact (the K = 1 centroid gathers, one a FPS,
    # always are); f32 compute none fast
    exact = {k: launches[k] - fast[k] for k in fast}
    if bf16 and PER_FORWARD[model_name]["group"] and (
            fast["group"] < forwards * (PER_FORWARD[model_name]["group"] - 4)
            or exact["group"] != launches["fps"]
            or fast["three_nn_interpolate"] < forwards * 4
            or exact["three_nn_interpolate"] != 0):
        raise AssertionError(f"bf16 serving launched {launches}, of them "
                             f"fast {fast}")
    if not bf16 and any(fast.values()):
        raise AssertionError(f"f32 serving launched fast {fast}")
    rate = n * votes / out["infer_seconds"]
    print(f"[{tag}] {model_name} served {n} points x {votes} votes ({blocks} "
          f"blocks/vote, {forwards} forwards){' in bf16' if bf16 else ''} in "
          f"{out['infer_seconds']:.3f} s: {rate:.0f} scene-points/s; mIoU "
          f"{out['miou']:.4f}; launches {launches}, of them fast {fast}")
    return launches, fast, rate, pred


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
                   **roofline.group_backward_cost(*idx.shape, g.shape[-1],
                                                  n))

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
                   **roofline.interpolate_backward_cost(Bq, n1, s, d))

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


def bn_layer_shapes(torch, model_name, b):
    """(M, C) of every BatchNorm input of one eval forward of
    ``model_name`` at b blocks of N points, in order (the same in train
    mode), from a forward on the card."""
    from tumseg_torch.models import get_module
    from tumseg_torch.nn.layers import BatchNorm

    model = get_module(model_name).get_model(8).to(DEVICE).eval()
    shapes = []
    handles = [m.register_forward_pre_hook(
        lambda bn, args: shapes.append((args[0].numel() // args[0].shape[-1],
                                        args[0].shape[-1])))
        for m in model.modules() if isinstance(m, BatchNorm)]
    x = torch.as_tensor(model_batch(b, N), device=DEVICE)
    with torch.inference_mode():
        model(x)
    for h in handles:
        h.remove()
    return shapes


def phase_batch_norm(torch, report):
    """bn. BatchNorm + ReLU (csrc/batch_norm.cu) at every layer of the SSG:
    the apply at the B=32 x 4096 forward's shapes, bitwise the eager chain;
    the backward terms and dx at the B=16 x 4096 step's shapes, bitwise
    their plain versions (``core.batch_norm_terms``, ``core.batch_norm_dx``:
    autograd's ops); each timed beside its bound, its plain version and,
    for the apply, ``F.batch_norm`` (one call, without the ReLU). Then the
    22 layers together, the eager chain and autograd (``ops.plain()``)
    against the kernels' path, each captured as a CUDA graph (as the
    serving and training programs run) and replayed in turns (plain,
    kernels, kernels, plain): the B=32 eval forward, and the B=16 training
    forward and backward."""
    import torch.nn.functional as F

    from tumseg_torch import ops
    from tumseg_torch.ops import core, kernels
    from tumseg_torch.tools.benchutil import captured

    rng = np.random.default_rng(SEED + 11)
    eps = 1e-5

    def consts(C):
        return tuple(torch.as_tensor(a.astype(np.float32), device=DEVICE)
                     for a in (rng.normal(0.3, 0.5, C),
                               rng.uniform(0.5, 2.0, C),
                               rng.uniform(0.5, 1.5, C),
                               rng.normal(0.0, 0.3, C)))

    def rand(M, C, scale=1.0, shift=0.0):
        return torch.randn(M, C, device=DEVICE) * scale + shift

    torch.manual_seed(SEED + 11)
    ssg = "pointnet2_sem_seg"
    for i, (M, C) in enumerate(bn_layer_shapes(torch, ssg, B)):
        x = rand(M, C, 1.5, 0.3)
        mean, var, w, bias = consts(C)
        inv = torch.rsqrt(var + eps) * w

        def fn():
            return kernels.bn_apply(x, mean, inv, bias, True)

        def plain():
            return torch.relu((x - mean) * inv + bias)

        if not torch.equal(fn(), plain()):
            raise AssertionError(f"[bn] apply at {M}x{C} is not bitwise")
        report.add(torch, "bn_apply", f"fwd {i:2d} {M}x{C}", fn, plain, 0.0,
                   library_fn=lambda: F.batch_norm(x, mean, var, w, bias,
                                                   False, 0.0, eps),
                   phase="bn", nbytes=8 * M * C + 12 * C, ops=4 * M * C)
        del x
    for i, (M, C) in enumerate(bn_layer_shapes(torch, ssg, TRAIN_B)):
        x, g = rand(M, C, 1.5, 0.3), rand(M, C)
        _, _, w, bias = consts(C)
        label = f"step {i:2d} {M}x{C}"
        mean = x.mean(dim=0)
        r = torch.rsqrt((x * x).mean(dim=0) - mean * mean + eps)
        inv = r * w
        terms = kernels.bn_backward_terms(g, x, mean, inv, bias, True)
        if not all(map(torch.equal, terms, core.batch_norm_terms(
                g, x, mean, inv, bias, True))):
            raise AssertionError(f"[bn] terms at {M}x{C} are not bitwise")
        report.add(torch, "bn_backward_terms", label,
                   lambda: kernels.bn_backward_terms(g, x, mean, inv, bias,
                                                     True),
                   lambda: core.batch_norm_terms(g, x, mean, inv, bias,
                                                 True), 0.0, phase="bn",
                   nbytes=20 * M * C + 12 * C, ops=6 * M * C)
        _, _, ks, kmu = core.batch_norm_grads(
            [t.sum(dim=0) for t in terms], mean, r, w, M, True)
        gzi = terms[2]
        del terms
        if not torch.equal(kernels.bn_backward_dx(gzi, x, ks, kmu),
                           core.batch_norm_dx(gzi, x, ks, kmu)):
            raise AssertionError(f"[bn] dx at {M}x{C} is not bitwise")
        report.add(torch, "bn_backward_dx", label,
                   lambda: kernels.bn_backward_dx(gzi, x, ks, kmu),
                   lambda: core.batch_norm_dx(gzi, x, ks, kmu), 0.0,
                   phase="bn", nbytes=12 * M * C + 8 * C, ops=4 * M * C)
        del x, g, gzi

    mom = torch.tensor(0.1, dtype=torch.float64, device=DEVICE)
    keep = torch.tensor(0.9, dtype=torch.float64, device=DEVICE)
    for b, train in ((B, False), (TRAIN_B, True)):
        layers = []
        for M, C in bn_layer_shapes(torch, ssg, b):
            mean, var, w, bias = consts(C)
            layers.append((rand(M, C, 1.5, 0.3).requires_grad_(train),
                           w.requires_grad_(train),
                           bias.requires_grad_(train), mean, var,
                           rand(M, C) if train else None))

        def chain(plain):
            out = []
            with ops.plain() if plain else contextlib.nullcontext():
                for x, w, bias, mean, var, g in layers:
                    y = ops.batch_norm(x, w, bias, mean, var, mom, keep, eps,
                                       train, relu=True)
                    out += torch.autograd.grad(y, (x, w, bias), g) \
                        if train else [y]
            return tuple(out)

        replays = {name: captured(torch.device(DEVICE),
                                  functools.partial(chain, name == "plain"))
                   for name in ("plain", "kernels")}
        runs = {"plain": [], "kernels": []}
        for name in ("plain", "kernels", "kernels", "plain"):
            runs[name].append(time_ms(torch, replays[name], 5)[0])
        what = (f"B={b} training forward + backward" if train
                else f"B={b} eval forward")
        print(f"[bn] SSG's {len(layers)} BatchNorm + ReLU layers, {what} "
              f"(CUDA graphs, event ms, median of 3, in turns): eager chain "
              f"{[round(v, 3) for v in runs['plain']]} ms, kernels "
              f"{[round(v, 3) for v in runs['kernels']]} ms")
        del layers, replays


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


def phase_train_step(torch, state_dict, model_name, tag, compute_dtype=None):
    """One training step with the kernels against plain: exact and fast
    gathers in f32 compute; with a ``compute_dtype``, fast gathers in that
    compute (the engine's default), timed beside the f32 step."""
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

    def step(model, fast, opt=None, dtype=compute_dtype):
        logp, aux = model(x, fast_gather=fast, compute_dtype=dtype)
        loss = model.loss(logp, target, aux, weight)
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
    # default, kernels and plain in the same mode; in bf16 compute the fast
    # ones only
    compute = ("" if compute_dtype is None else
               f" {str(compute_dtype).replace('torch.', '')} compute,")
    for fast in (False, True) if compute_dtype is None else (True,):
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
        print(f"[{tag}] {model_name} train step B={TRAIN_B}x{N}{compute} "
              f"{'fast' if fast else 'exact'} gathers: loss {lk:.6f} "
              f"(kernels) {lp:.6f} (plain); worst gradient {worst:.3g} x "
              f"max|g| ({worst_name}), {len(gk)} tensors{spread}")

    def timed(plain, fast, dtype=compute_dtype):
        model = copy.deepcopy(base)
        opt = make_optimizer(model.parameters(), "Adam", 1e-4)

        def one():
            if plain:
                with ops.plain():
                    step(model, fast, opt, dtype)
            else:
                step(model, fast, opt, dtype)
        return time_ms(torch, one, 1)

    if compute_dtype is not None:
        runs = {None: [], compute_dtype: []}
        for dtype in (None, compute_dtype, compute_dtype, None):
            runs[dtype].append(timed(False, True, dtype)[0])
        print(f"[{tag}] train step B={TRAIN_B}x{N} with the kernels, fast "
              f"gathers (forward + backward + Adam, median of 3, two turns "
              f"each):{compute} {[round(v, 3) for v in runs[compute_dtype]]}"
              f" ms; f32 compute {[round(v, 3) for v in runs[None]]} ms")
        return

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


def training_steps(train_points, npoint, batch, epochs):
    """Steps of a CLI training run: ``TrainBlockDataset`` draws one block
    a ``npoint`` points of the training tiles, 70% of them train, in whole
    batches."""
    return epochs * (int(0.7 * int(train_points / npoint)) // batch)


def phase_train_cli(torch, work, model_name, epochs, min_steps, tag,
                    bf16=False, pipeline=(), turn=0, data="train_data",
                    points=TRAIN_POINTS):
    """Trains through the CLI on ``work/train_data`` (counts of zero before
    the run, read after it), then serves the best checkpoint; with
    ``bf16``, both with ``--bf16``. The CLI's ``--data_pipeline auto``
    resolves to the device pipeline on the card (``--superstep 8``), unless
    ``pipeline`` gives other flags. A run of another ``turn`` logs apart
    (a run in the same log directory would resume). ``data`` names the
    directory of the tiles, ``points`` the training tile's points. Returns
    (launches, the epochs' logged training points/s, the run's log)."""
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.cli import train as train_cli
    from tumseg_torch.ops import kernels

    data = work / data
    log = work / "train_log"
    log_dir = "_".join([model_name] + (["bf16"] if bf16 else [])
                       + [a.strip("-") for a in pipeline]
                       + ([str(turn)] if turn else []))
    bf16_flag = ["--bf16"] if bf16 else []
    args = train_cli.parse_args([
        "--model", model_name, "--rootdir", str(data), "--test_area",
        "held_out.las", "--exp_dir", str(log), "--log_dir", log_dir,
        "--epoch", str(epochs), "--batch_size", str(TRAIN_B), "--npoint",
        str(N), "--class8", "--RGB_OFF", "--seed", str(SEED)] + bf16_flag
        + list(pipeline))
    steps = training_steps(points, N, TRAIN_B, epochs)
    if steps < min_steps:
        raise AssertionError(f"only {steps} training steps")
    kernels.reset_launches()
    acc, eval_loss, iou = train_cli.main(args)
    launches = dict(kernels.launches)
    fast = dict(kernels.fast_launches)

    run = log / "sem_seg" / log_dir
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
        "--log_dir", log_dir, "--num_votes", "1", "--batch_size",
        str(TRAIN_B), "--num_point", str(N), "--class8", "--RGB_OFF",
        "--seed", str(SEED)] + bf16_flag))
    if not 0.0 <= out["miou"] <= 1.0:
        raise AssertionError(f"served mIoU {out['miou']}")
    flags = " ".join(bf16_flag + list(pipeline))
    for epoch, rate in enumerate(rates):
        print(f"[{tag}] epoch {epoch + 1} Training points/sec: {rate}")
    print(f"[{tag}] {model_name} trained {steps} steps of B={TRAIN_B}x{N} "
          f"over {epochs} epochs{' with ' + flags if flags else ''}: mean "
          f"losses {losses}, eval losses "
          f"{list(eval_loss)}, best mIoU {max(iou):.4f}; best_model.pth "
          f"served with mIoU {out['miou']:.4f}; launches {launches}, of "
          f"them fast (bf16 gathers) {fast}")
    return launches, [float(rate) for rate in rates], text


def phase_device_pipeline(torch, work, state_dict):
    """The device training pipeline (after g): the block sampler on the
    card against the CPU's on the same explicit draws, block invariants
    over generator-drawn batches, a k-step call against k single steps,
    and the CLI on each pipeline in turns."""
    import copy

    from tumseg_torch import models
    from tumseg_torch.data.dataset import TrainBlockDataset
    from tumseg_torch.data.device_sampler import DeviceBlockSampler
    from tumseg_torch.train.loop import TrainEngine

    files = sorted(str(p) for p in (work / "train_data").glob("*.las")
                   if p.name != "held_out.las")
    ds = TrainBlockDataset(files, [], num_classes=8, num_point=N,
                           color=False, class8=True, seed=SEED)
    card = DeviceBlockSampler.from_dataset(ds, device=DEVICE)
    cpu = DeviceBlockSampler.from_dataset(ds, device="cpu")
    tables = ("_packed", "_px", "_py", "_room_start", "_room_count",
              "_room_cmin", "_room_cmax", "_room_nbx", "_room_nby",
              "_room_bin_off", "_bin_start", "_bin_count")
    for name in tables:
        if not torch.equal(getattr(card, name).cpu(), getattr(cpu, name)):
            raise AssertionError(f"sampler table {name}: card != CPU")
    limit = card.min_block_points

    # the acceptance rate of one trial centre, from explicit uniforms
    rng = np.random.default_rng(SEED + 7)
    room = int(ds.room_idxs[0])
    u = rng.random(X_TRIAL_CENTRES, dtype=np.float32)
    counts = card.trial_blocks(
        torch.full((X_TRIAL_CENTRES,), room, device=DEVICE),
        torch.as_tensor(u, device=DEVICE))[1].cpu().numpy()
    accept = float(np.mean(counts > limit))
    print(f"[x] sampler on {len(files)} room(s), {len(ds)} samples: cap "
          f"{card.cap} ({9 * card.cap} candidates a block), tables "
          f"{card.table_bytes()} bytes on the card; one trial centre of "
          f"{X_TRIAL_CENTRES} accepted at {accept:.4f} (counts min "
          f"{counts.min()}, median {int(np.median(counts))}, max "
          f"{counts.max()}); {card.trials} trials a round leave a row "
          f"pending with probability {(1 - accept) ** card.trials:.3g}")

    # the same explicit draws on the card and the CPU, the first trials
    # chosen so that half the rows draw with replacement (cnt < N)
    small = u[(counts > limit) & (counts < N)][:TRAIN_B // 2]
    big = u[counts >= N][:TRAIN_B - len(small)]
    trial_u = rng.random((TRAIN_B, X_TRIALS), dtype=np.float32)
    trial_u[:len(small) + len(big), 0] = np.concatenate([small, big])
    sel_u = rng.random((TRAIN_B, 9 * card.cap), dtype=np.float32)
    rep_u = rng.random((TRAIN_B, N), dtype=np.float32)
    ids = np.full(TRAIN_B, room, np.int32)
    got = card.sample_from_draws(ids, trial_u, sel_u, rep_u)
    want = cpu.sample_from_draws(ids, trial_u, sel_u, rep_u)
    for name, g, w in zip(("points", "labels", "centres", "counts", "sel"),
                          got, want):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"sampler {name}: card != CPU on the same "
                                 f"draws")
    print(f"[x] B={TRAIN_B} blocks from the same explicit draws: centres, "
          f"counts, sel, points and labels bitwise equal on the card and "
          f"the CPU ({int((want[3] < N).sum())} rows drawn with "
          f"replacement)")

    # block invariants over generator-drawn batches, k = 8 at a time
    card.stats = dict.fromkeys(card.stats, 0)
    below = 0
    for s in range(0, X_BATCHES, 8):
        gens = [torch.Generator(device=DEVICE).manual_seed(SEED + s + i)
                for i in range(8)]
        ids_k = rng.choice(ds.room_idxs, (8, TRAIN_B)).astype(np.int32)
        pts, lab, c, n, sel = card.sample_batches_aux(ids_k, gens)
        xyz = card._xyz[sel]
        lo = c[..., None, :2] - card._half
        hi = c[..., None, :2] + card._half
        if not ((xyz[..., :2] >= lo) & (xyz[..., :2] <= hi)).all():
            raise AssertionError("a sampled point lies outside its block")
        if not (n > limit).all():
            raise AssertionError(f"a block of {int(n.min())} points")
        srt = sel.sort(-1).values
        distinct = (srt[..., 1:] != srt[..., :-1]).all(-1)
        if not distinct[n >= N].all():
            raise AssertionError("a block of >= N points drew a point twice")
        if not (torch.isfinite(pts).all()
                and torch.equal(lab, card._labels[sel])):
            raise AssertionError("sampled points or labels")
        below += int((n < N).sum())
    st = card.stats
    print(f"[x] {X_BATCHES} batches of B={TRAIN_B} drawn by generators, 8 "
          f"at a time: every point in its block, every count > {limit}, "
          f"sel distinct where count >= {N} ({below} of {st['rows']} rows "
          f"below {N}); rows needing a second round "
          f"{st['redrawn'] / st['rows']:.4f}, {st['rounds']} rounds in "
          f"{X_BATCHES // 8} calls")

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    gens = [torch.Generator(device=DEVICE).manual_seed(SEED + i)
            for i in range(8)]
    ids_k = np.full((8, TRAIN_B), room, np.int32)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    one = time_ms(torch, lambda: card.sample_batch(ids, gen), 1)
    one_peak = torch.cuda.max_memory_allocated() - held
    torch.cuda.reset_peak_memory_stats()
    eight = time_ms(torch, lambda: card.sample_batches(ids_k, gens), 1)
    eight_peak = torch.cuda.max_memory_allocated() - held
    print(f"[x] sampler time a B={TRAIN_B}x{N} batch (CUDA events, median "
          f"of 3): {one[0]:.3f} ms alone {[round(v, 3) for v in one[1]]}, "
          f"{eight[0] / 8:.3f} ms in a call of 8 "
          f"{[round(v / 8, 3) for v in eight[1]]}; peak memory over the "
          f"tables {one_peak / 2**20:.1f} MiB (1 batch), "
          f"{eight_peak / 2**20:.1f} MiB (8 batches)")
    trials = card.trials
    by_trials = {}
    for card.trials in (1, 2, 4, 8):
        by_trials[card.trials] = round(
            time_ms(torch, lambda: card.sample_batch(ids, gen), 1)[0], 3)
    card.trials = trials
    print(f"[x] sampler ms a B={TRAIN_B} batch alone by trial centres a "
          f"round: {by_trials}")

    # a 4-step call against 4 single steps, SSG, fast gathers
    base = models.get_module("pointnet2_sem_seg").get_model(8)
    base.load_state_dict(state_dict)
    weights = np.random.default_rng(SEED + 8).random(8) + 0.5
    engines = [TrainEngine(copy.deepcopy(base), 8, weights, device=DEVICE,
                           seed=SEED, sampler=card) for _ in range(2)]
    ids_k = rng.choice(ds.room_idxs, (4, TRAIN_B)).astype(np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm, cm = engines[0].train_batch_rooms_multi(ids_k, 1e-3, 0.1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    single = [engines[1].train_batch_rooms(i, 1e-3, 0.1) for i in ids_k]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ls = torch.stack([l for l, _ in single])
    cs = torch.stack([c for _, c in single])
    pm = dict(engines[0].model.named_parameters())
    ps = dict(engines[1].model.named_parameters())
    bitwise = (torch.equal(lm, ls) and torch.equal(cm, cs)
               and all(torch.equal(pm[k], ps[k]) for k in pm))
    gap, gap_name = grad_gap({k: v.detach() for k, v in pm.items()},
                             {k: v.detach() for k, v in ps.items()})
    if not bitwise:
        dl = (lm - ls).abs().max().item()
        print(f"[x] 4-step call against 4 single steps not bitwise: max "
              f"|dloss| {dl:.3g}, corrects {cm.tolist()} vs {cs.tolist()}, "
              f"parameters {gap:.3g} x their layer's max ({gap_name})")
        if not (torch.isfinite(lm).all() and dl <= 1e-4 * ls.abs().max()
                and gap <= 1e-4):
            raise AssertionError("superstep against single steps")
    state = ("all bitwise equal" if bitwise else
             f"parameters within {gap:.3g} x their layer's max")
    print(f"[x] pointnet2_sem_seg train_batch_rooms_multi over 4 batches "
          f"against 4 train_batch_rooms: losses {lm.tolist()}, corrects "
          f"{cm.tolist()}, {state}; wall {1e3 * (t1 - t0):.1f} ms (one "
          f"call) vs {1e3 * (t2 - t1):.1f} ms (4 calls)")

    # the device's idle share over 4 steps, one call and 4 calls in turns
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    idle = {"one call": [], "4 calls": []}
    for label in ("one call", "4 calls", "4 calls", "one call"):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if label == "one call":
                engines[0].train_batch_rooms_multi(ids_k, 1e-3, 0.1)
            else:
                for i in ids_k:
                    engines[1].train_batch_rooms(i, 1e-3, 0.1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = cuda_busy_seconds(torch, prof)
        idle[label].append((round(1e3 * wall, 1), round(1e3 * busy, 1),
                            round(1 - busy / wall, 3)))
    print(f"[x] 4 device-pipeline steps, (wall ms, CUDA-busy ms, idle "
          f"share) under torch.profiler, two turns: {idle}")

    # the CLI on each pipeline, in turns
    turns = (("--data_pipeline", "host"),
             ("--data_pipeline", "device", "--superstep", "1"),
             ("--data_pipeline", "device", "--superstep", "4"))
    rates = {flags: [] for flags in turns}
    for turn, flags in enumerate(turns + turns[::-1]):
        rates[flags].append(phase_train_cli(
            torch, work, "pointnet2_sem_seg", TRAIN_EPOCHS, 10, "x",
            pipeline=flags, turn=turn)[1])
    for flags, runs in rates.items():
        print(f"[x] CLI {' '.join(flags)}: Training points/sec by epoch, "
              f"two turns: {runs}")


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
    nbytes = roofline.three_nn_cost(B, N, S, d)["nbytes"]
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
        ops[label] = roofline.window_cost(B, N, S, d, tested)["ops"]
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
            plain_reps=2, phase="p",
            **roofline.fused_cost(*i_f.shape, c, n, tested, False))
        report.add_fast(torch, "fused_ball_group", label,
                        lambda: kernels.fused_ball_group(r, K, xyz, ctr, src,
                                                         True),
                        lambda: kernels.fused_ball_group(r, K, xyz, ctr, src),
                        0.0, "p")
        fb = roofline.fused_cost(*i_f.shape, c, n, tested, True)
        bound = roofline.bound_ms(fb["nbytes"], fb["ops"])[0]
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


def bf16_gemm_check(torch):
    """Whether ``allow_bf16_reduced_precision_reduction`` changes a bf16
    GEMM with an f32 output (``aten::mm.dtype``, the bf16 ``Dense``'s) at
    sa1's and fp4's shapes: -> True where both settings give the same bits.
    The entry points leave the flag as PyTorch sets it."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_bf16_reduced_precision_reduction
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED)
    same = True
    try:
        for m, k, n in ((B * 1024 * K, 32, 32), (B * 64, 768, 256)):
            x = torch.randn(m, k, device=DEVICE, generator=g).bfloat16()
            w = torch.randn(n, k, device=DEVICE, generator=g).bfloat16()
            outs = []
            for flag in (True, False):
                matmul.allow_bf16_reduced_precision_reduction = flag
                outs.append(torch.mm(x, w.t(), out_dtype=torch.float32))
            same = same and torch.equal(*outs)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = prev
    return same


KERNEL_KINDS = (("GEMM", ("gemm", "xmma", "cutlass", "sm90", "nvjet")),
                ("point kernels", ("fps", "ball_query", "group", "three_nn",
                                   "interp")),
                ("reduction", ("reduce",)),
                ("elementwise", ("elementwise", "vectorized", "unrolled")))


def forward_breakdown(torch, fn):
    """One call of ``fn`` (after a warm-up) under ``torch.profiler``: ->
    (device ms by kind of kernel, the 6 kernels of most device time as
    (name, ms, launches), kernel events). The profiler loses events now and
    then (``device_ms``), so this is a breakdown, not a time."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = names.setdefault(e.name, [0.0, 0])
            t[0] += e.time_range.elapsed_us() / 1e3
            t[1] += 1
    kinds = {}
    for name, (ms, _) in names.items():
        kind = next((k for k, keys in KERNEL_KINDS
                     if any(w in name.lower() for w in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    top = sorted(((n[:48], round(ms, 4), c) for n, (ms, c) in names.items()),
                 key=lambda r: -r[1])[:6]
    return ({k: round(v, 4) for k, v in kinds.items()}, top,
            sum(c for _, c in names.values()))


def phase_bf16(torch, work, states):
    """bf16 compute on the card: the SSG and MSG forwards with the kernels
    against plain and against f32 compute, launches, times and peak
    memory; serving (beside f32, in turns) and training through
    ``--bf16``. ``states`` maps a model's name to its weights of c / i."""
    from tumseg_torch import models, ops
    from tumseg_torch.nn.layers import Dense
    from tumseg_torch.ops import kernels

    bf16 = torch.bfloat16
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    print(f"[s] allow_bf16_reduced_precision_reduction {flag}; a bf16 GEMM "
          f"with f32 output gives the same bits with it on and off: "
          f"{bf16_gemm_check(torch)}")
    x = torch.as_tensor(facade_batch(np.random.default_rng(SEED + 1), B, N),
                        device=DEVICE)
    for model_name, state in states.items():
        model = models.get_module(model_name).get_model(8).to(DEVICE).eval()
        model.load_state_dict(state)

        def fwd(dtype):
            return model(x, compute_dtype=dtype)[0]

        def plain_fwd():
            with ops.plain():
                return fwd(bf16)

        with torch.inference_mode():
            kernels.reset_launches()
            lk = fwd(bf16)
            launches = dict(kernels.launches)
            fast = dict(kernels.fast_launches)
            lp, l32 = plain_fwd(), fwd(None)
            # the yardstick of this random net's sensitivity: f32 compute
            # with the fast gathers alone, as the f32 train step takes them
            lf = model(x, fast_gather=True)[0]
            if lk.shape != (B, N, 8) or not torch.isfinite(lk).all():
                raise AssertionError("bf16 log-probs not finite / bad shape")
            diff = (lk - lp).abs().max().item()
            agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
            d32 = (lk - l32).abs().max().item()
            agree32 = (lk.argmax(-1) == l32.argmax(-1)).float().mean().item()
            dfast = (lf - l32).abs().max().item()
            agreefast = (lf.argmax(-1) == l32.argmax(-1)).float().mean(
                ).item()
            classes = lk.argmax(-1).unique().numel()
            print(f"[s] {model_name} bf16 forward B={B}x{N}: kernels against "
                  f"plain max|dlogp| {diff:g}, argmax agree {agree:.6f}; "
                  f"against f32 compute (same weights) max|dlogp| {d32:g}, "
                  f"argmax agree {agree32:.6f} (f32 compute with the fast "
                  f"gathers alone: max|dlogp| {dfast:g}, argmax agree "
                  f"{agreefast:.6f}); {classes} classes predicted")
            if diff > 1e-4 or agree < 0.9999:
                raise AssertionError("bf16 kernel forward disagrees with "
                                     "plain")
            # a guard against breakage only: this random net's argmax
            # moves under any bf16 rounding (the fast gathers alone move a
            # quarter of it), and a broken path agrees near chance (1/8)
            if agree32 < BF16_AGREE_MIN or classes < 2:
                raise AssertionError("bf16 forward is far from f32's")
            # every neighbourhood group and interpolation fast, none exact;
            # the 4 centroid gathers (K = 1) are exact
            exact = {k: launches[k] - fast[k] for k in fast}
            groups = PER_FORWARD[model_name]["group"] - 4
            if (fast["group"], exact["group"], fast["three_nn_interpolate"],
                    exact["three_nn_interpolate"]) != (groups, 4, 4, 0):
                raise AssertionError(f"bf16 forward launched {launches}, "
                                     f"fast {fast}")
            print(f"[s] {model_name} bf16 forward launches: group "
                  f"{fast['group']} fast + {exact['group']} exact (the "
                  f"centroid gathers), three_nn_interpolate "
                  f"{fast['three_nn_interpolate']} fast + "
                  f"{exact['three_nn_interpolate']} exact")

            times = {None: [], bf16: []}
            for dtype in (None, bf16, bf16, None):
                times[dtype].append(time_ms(torch, lambda: fwd(dtype), 3))
            peak = {}
            for dtype in (None, bf16):
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fwd(dtype)
                torch.cuda.synchronize()
                peak[dtype] = (torch.cuda.max_memory_allocated() - held) / 1e6
            weights = [m.weight for m in model.modules()
                       if isinstance(m, Dense)]
            cast_ms = time_ms(torch, lambda: [w.to(bf16) for w in weights],
                              20)[0]
            for dtype in (None, bf16):
                kinds, top, events = forward_breakdown(torch,
                                                       lambda: fwd(dtype))
                print(f"[s] {model_name} {'bf16' if dtype else 'f32'} "
                      f"forward, profiler "
                      f"device ms by kind ({events} kernel events): "
                      f"{kinds}; most: {top}")
        print(f"[s] {model_name} forward B={B}x{N} (median of 3, two turns "
              f"each): bf16 {[round(t, 3) for t, _ in times[bf16]]} ms "
              f"{[[round(r, 3) for r in runs] for _, runs in times[bf16]]}; "
              f"f32 {[round(t, 3) for t, _ in times[None]]} ms "
              f"{[[round(r, 3) for r in runs] for _, runs in times[None]]}; "
              f"peak memory over what was held before: bf16 "
              f"{peak[bf16]:.1f} MB, f32 {peak[None]:.1f} MB; the casts of "
              f"its {len(weights)} Dense weights to bf16 {cast_ms:.4f} ms "
              f"a forward (event)")

    rates, labels = {False: [], True: []}, {}
    for bf, run in ((False, "_1"), (True, "_1"), (True, "_2"),
                    (False, "_2")):
        _, _, rate, labels[bf] = phase_serve(
            torch, work, states["pointnet2_sem_seg"], "pointnet2_sem_seg",
            "s", bf16=bf, run=run)
        rates[bf].append(rate)
    print(f"[s] served labels, bf16 against f32 compute (the same weights "
          f"and votes): agree on {(labels[True] == labels[False]).mean():.6f}"
          f" of {labels[True].size} points; scene-points/s in turns (f32, "
          f"bf16, bf16, f32): bf16 {[round(r) for r in rates[True]]}, f32 "
          f"{[round(r) for r in rates[False]]}")
    phase_train_step(torch, states["pointnet2_sem_seg"], "pointnet2_sem_seg",
                     "s", compute_dtype=bf16)
    phase_train_cli(torch, work, "pointnet2_sem_seg", TRAIN_EPOCHS, 10, "s",
                    bf16=True)
    phase_train_cli(torch, work, "pointnet2_sem_seg_msg", MSG_TRAIN_EPOCHS, 6,
                    "s", bf16=True)


def no_launches(what):
    """Raises if any point kernel was launched since the counts were set to
    0 (the caller sets them); the BatchNorm kernels run in every model."""
    from tumseg_torch.ops import kernels

    launched = {k: n for k, n in kernels.launches.items()
                if n and k not in BN_KERNELS}
    if launched:
        raise AssertionError(f"{what} launched point kernels: {launched}")


def phase_pointnet_forward(torch):
    """PointNet's forward at B=32 x 4096: the card's f32 log-probs of two
    blocks against the CPU's forward of the same weights and blocks, bf16
    beside f32, times in turns and peak memory; no point kernel launched. ->
    the weights (BN calibrated on the blocks), on the CPU."""
    from tumseg_torch import models
    from tumseg_torch.nn.layers import calibrate_batch_norm
    from tumseg_torch.ops import kernels

    bf16 = torch.bfloat16
    xh = model_batch(B, N)
    x = torch.as_tensor(xh, device=DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    model = models.get_module(POINTNET).get_model(8).to(DEVICE).eval()
    calibrate_batch_norm(model, x)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    cpu = models.get_module(POINTNET).get_model(8).eval()
    cpu.load_state_dict(state)

    def fwd(dtype):
        return model(x, compute_dtype=dtype)[0]

    with torch.inference_mode():
        kernels.reset_launches()
        l32, trans_feat = model(x)
        lb = fwd(bf16)
        no_launches("the PointNet forward")
        if (l32.shape != (B, N, 8) or trans_feat.shape != (B, 64, 64)
                or not torch.isfinite(l32).all()
                or not torch.isfinite(lb).all()):
            raise AssertionError("PointNet log-probs not finite / bad shape")
        got = l32[:2].cpu()
        want = cpu(torch.as_tensor(xh[:2]))[0]
        diff = (got - want).abs().max().item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        classes = l32.argmax(-1).unique().numel()
        d32 = (lb - l32).abs().max().item()
        agree32 = (lb.argmax(-1) == l32.argmax(-1)).float().mean().item()
        print(f"[t] {POINTNET} forward B={B}x{N}: blocks 0-1 against the "
              f"CPU's forward max|dlogp| {diff:g}, argmax agree "
              f"{agree:.6f}; {classes} classes predicted; bf16 against f32 "
              f"compute (same weights) max|dlogp| {d32:g}, argmax agree "
              f"{agree32:.6f}")
        if diff > 1e-3 or agree < 0.999:
            raise AssertionError("PointNet on the card disagrees with the "
                                 "CPU")
        if classes < 2:
            raise AssertionError("constant labels: the check would be void")
        times = {None: [], bf16: []}
        for dtype in (None, bf16, bf16, None):
            times[dtype].append(time_ms(torch, lambda: fwd(dtype), 3))
        peak = {}
        for dtype in (None, bf16):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fwd(dtype)
            torch.cuda.synchronize()
            peak[dtype] = (torch.cuda.max_memory_allocated() - held) / 1e6
        for dtype in (None, bf16):
            kinds, top, events = forward_breakdown(torch, lambda: fwd(dtype))
            print(f"[t] {POINTNET} {'bf16' if dtype else 'f32'} forward, "
                  f"profiler device ms by kind ({events} kernel events): "
                  f"{kinds}; most: {top}")
    print(f"[t] {POINTNET} forward B={B}x{N} (median of 3, two turns each): "
          f"f32 {[round(t, 3) for t, _ in times[None]]} ms "
          f"{[[round(r, 3) for r in runs] for _, runs in times[None]]}; "
          f"bf16 {[round(t, 3) for t, _ in times[bf16]]} ms "
          f"{[[round(r, 3) for r in runs] for _, runs in times[bf16]]}; "
          f"peak memory over what was held before: f32 {peak[None]:.1f} MB, "
          f"bf16 {peak[bf16]:.1f} MB")
    return state


def phase_pointnet_serve(torch, work, state):
    """PointNet serves d's tile through the test CLI, f32 and ``--bf16`` in
    turns; ``phase_serve`` checks that no point kernel is launched."""
    rates, labels = {False: [], True: []}, {}
    for bf, run in ((False, "_1"), (True, "_1"), (True, "_2"),
                    (False, "_2")):
        _, _, rate, labels[bf] = phase_serve(torch, work, state, POINTNET,
                                             "u", bf16=bf, run=run)
        rates[bf].append(rate)
    print(f"[u] {POINTNET} served labels, bf16 against f32 compute: agree on "
          f"{(labels[True] == labels[False]).mean():.6f} of "
          f"{labels[True].size} points; scene-points/s in turns (f32, bf16, "
          f"bf16, f32): f32 {[round(r) for r in rates[False]]}, bf16 "
          f"{[round(r) for r in rates[True]]}")


def phase_pointnet_train(torch, work, state):
    """One PointNet training step at B=16 x 4096 on the card against the
    CPU's, in train-mode and in eval-mode BN, times of the step in f32 and
    bf16, and a short run of the training CLI.

    The loss is held to the CPU's within rtol 1e-5. The gradients are held
    to an f64 step of the same model on the CPU (BN in f64 too), which both
    f32 steps only approach: the batch's sums cancel, the STN's fc batch
    norms divide by the spread of B = 16 block features, and in train mode
    an argmax of the max over the points may move. So the card's gradients
    may lie no further from the f64 step than three times the CPU's f32
    step lies from it (``grad_gap``), and at least 1e-4, [f]'s limit."""
    import copy

    from tumseg_torch import models
    from tumseg_torch.nn.layers import feature_transform_regularizer
    from tumseg_torch.ops import kernels
    from tumseg_torch.train.loop import make_optimizer

    rng = np.random.default_rng(SEED + 4)
    xh = facade_batch(rng, TRAIN_B, N)
    target_h = (xh[..., 5] * 7.999).astype(np.int64)
    weight_h = rng.random(8).astype(np.float32) + 0.5
    base = models.get_module(POINTNET).get_model(8)
    base.load_state_dict(state)

    def inputs(device, dtype=torch.float32):
        return (torch.as_tensor(xh, device=device, dtype=dtype),
                torch.as_tensor(target_h, device=device),
                torch.as_tensor(weight_h, device=device, dtype=dtype))

    def step(model, x, target, weight, compute_dtype=None, opt=None):
        logp, trans_feat = model(x, compute_dtype=compute_dtype)
        loss = model.loss(logp, target, trans_feat, weight)
        if opt is not None:
            opt.zero_grad(set_to_none=True)
        loss.backward()
        if opt is not None:
            opt.step()
        return loss.detach(), trans_feat.detach()

    def grads(device, dtype, train):
        model = copy.deepcopy(base).to(device=device, dtype=dtype)
        loss, trans_feat = step(model.train(train), *inputs(device, dtype))
        reg = float(feature_transform_regularizer(trans_feat))
        return float(loss), reg, {n: p.grad.double().cpu()
                                  for n, p in model.named_parameters()}

    kernels.reset_launches()
    for train in (True, False):
        mode = "train" if train else "eval"
        lk, rk, gk = grads(DEVICE, torch.float32, train)
        lc, rc, gc = grads("cpu", torch.float32, train)
        l64, _, g64 = grads("cpu", torch.float64, train)
        card, card_name = grad_gap(gk, g64)
        cpu, cpu_name = grad_gap(gc, g64)
        limit = max(1e-4, 3 * cpu)
        print(f"[v] {POINTNET} step B={TRAIN_B}x{N}, {mode}-mode BN: loss "
              f"{lk:.7f} (card) {lc:.7f} (CPU) {l64:.7f} (CPU f64), with "
              f"0.001 x the regularizer {rk:.5f} (card) {rc:.5f} (CPU); "
              f"gradients against the f64 step: card {card:.3g} "
              f"({card_name}), CPU f32 {cpu:.3g} ({cpu_name}), limit "
              f"{limit:.3g}; card against CPU f32 {grad_gap(gk, gc)[0]:.3g}")
        if not (math.isfinite(lk) and abs(lk - lc) <= 1e-5 * abs(lc)):
            raise AssertionError(f"PointNet {mode} step loss {lk} (card) vs "
                                 f"{lc} (CPU)")
        if not (rk > 0.0 and math.isfinite(rk)):
            raise AssertionError(f"regularizer {rk}")
        if card > limit:
            raise AssertionError(f"gradient of {card_name}: {card:g} x its "
                                 f"layer's max|g| from the f64 step, limit "
                                 f"{limit:g}")
    no_launches("the PointNet training steps")

    def timed(dtype):
        model = copy.deepcopy(base).to(DEVICE).train()
        opt = make_optimizer(model.parameters(), "Adam", 1e-4)
        args = inputs(DEVICE)
        return time_ms(torch, lambda: step(model, *args, dtype, opt), 1)[0]

    bf16 = torch.bfloat16
    runs = {None: [], bf16: []}
    for dtype in (None, bf16, bf16, None):
        runs[dtype].append(timed(dtype))
    print(f"[v] {POINTNET} train step B={TRAIN_B}x{N} (forward + backward + "
          f"Adam, median of 3, two turns each): f32 "
          f"{[round(v, 3) for v in runs[None]]} ms, bf16 compute "
          f"{[round(v, 3) for v in runs[bf16]]} ms")
    launches = phase_train_cli(torch, work, POINTNET, 1, 6, "v")[0]
    if any(n for k, n in launches.items() if k not in BN_KERNELS):
        raise AssertionError(f"PointNet training launched {launches}")


def phase_frozen(torch, work, ssg_state):
    """The frozen variants: ``pointnet2_sem_seg_trial`` served through the
    CLI with the SSG's weights of c and launches; ``pointnet2_sem_seg_
    original`` (9 channels) held against plain as c holds the SSG;
    ``pointnet_sem_seg_original`` run at 9 channels; each rejects another
    count of extra channels."""
    from tumseg_torch import models
    from tumseg_torch.nn.layers import calibrate_batch_norm
    from tumseg_torch.ops import kernels

    phase_serve(torch, work, ssg_state, "pointnet2_sem_seg_trial", "w")
    phase_forward(torch, "pointnet2_sem_seg_original", "w", extra=3)
    x = torch.as_tensor(model_batch(B, N, 3), device=DEVICE)
    torch.manual_seed(SEED)
    model = models.get_module("pointnet_sem_seg_original").get_model(8)
    model = model.to(DEVICE).eval()
    kernels.reset_launches()
    calibrate_batch_norm(model, x)
    with torch.inference_mode():
        logp = model(x)[0]
        no_launches("pointnet_sem_seg_original")
        classes = logp.argmax(-1).unique().numel()
        if (logp.shape != (B, N, 8) or not torch.isfinite(logp).all()
                or classes < 2):
            raise AssertionError(f"pointnet_sem_seg_original: {logp.shape}, "
                                 f"{classes} classes")
    for name, fixed in FROZEN.items():
        try:
            models.get_module(name).get_model(8, fixed + 1)
        except ValueError:
            continue
        raise AssertionError(f"{name} took {fixed + 1} extra channels")
    print(f"[w] pointnet_sem_seg_original forward B={B}x{N}x9: finite, "
          f"{classes} classes, no point kernel launched; every frozen "
          f"variant rejects another extra-channel count")


# the kernels of d's list: each is launched on each rank of y's serving
MESH_KERNELS = ("fps", "ball_query", "group", "three_nn_interpolate")


def mesh_step_batch(torch):
    """The B=16 x 4096 batch, labels and weights of y's train steps."""
    rng = np.random.default_rng(SEED + 11)
    x = facade_batch(rng, TRAIN_B, N)
    target = (x[..., 5] * 7.999).astype(np.int64)
    return x, target, rng.random(8).astype(np.float32) + 0.5


def mesh_serve_args(work, state_dict, log_dir):
    """The test CLI's arguments for d's tile at B=32, 2 votes, with the
    checkpoint of ``state_dict`` under ``log_dir``."""
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.models.convert import variables_from_state_dict
    from tumseg_torch.train.checkpoint import save_checkpoint

    ckpt_dir = work / "log" / "sem_seg" / log_dir / "checkpoints"
    if not ckpt_dir.exists():
        ckpt_dir.mkdir(parents=True)
        save_checkpoint(str(ckpt_dir / "best_model.pth"), epoch=0,
                        variables=variables_from_state_dict(state_dict))
    return test_cli.parse_args([
        "--rootdir", str(work / "data"), "--test_area", "facade.las",
        "--exp_dir", str(work / "log") + "/sem_seg/", "--log_dir", log_dir,
        "--num_votes", "2", "--batch_size", str(B), "--num_point", str(N),
        "--class8", "--RGB_OFF", "--seed", str(SEED)])


# the runner's options of each vote path
SERVE_PATHS = {"reblock": dict(device_features=True, device_reblock=True),
               "features": dict(device_features=True, device_reblock=False),
               "host": dict(device_features=False)}


def mesh_serving(torch, mesh, work, state_dict, path="reblock"):
    """d's tile served by ``path`` (``SG_VOTES`` votes at B=32) on ``mesh``
    (None: one process) with graphs and eager: labels and pools bitwise
    equal on this rank. On an NCCL mesh each vote's all-reduce is a program
    of its own, ``vote_reduce``; on a gloo mesh it runs between the
    graphs. Every key is warmed up once and captured once. -> (labels,
    pool on the host, (warm-ups, captures, replays), the keys' kinds)."""
    from tumseg_torch.infer.voting import InferenceRunner

    model = serving_model(torch, state_dict)
    out = []
    for graphs in (True, False):
        runner = InferenceRunner(model, 8, batch_size=B, device=DEVICE,
                                 mesh=mesh, cuda_graphs=graphs,
                                 **SERVE_PATHS[path])
        labels = runner.infer_scene(
            scene_dataset(work / "data" / "facade.las"), 0, SG_VOTES)
        out.append((labels, runner._buffers["pool"].cpu(), runner.graphs))
    (labels, pool, g), (want, want_pool, _) = out
    if not (np.array_equal(labels, want) and torch.equal(pool, want_pool)):
        raise AssertionError(f"[y] serving graph against eager on the mesh "
                             f"{mesh}, {path} path: labels differ on "
                             f"{int(np.sum(labels != want))} points")
    kinds = sorted({key[0] for key in g.graphs})
    if not g.warmups == g.captures == len(g.graphs):
        raise AssertionError(f"[y] {path} path on {mesh}: {g.warmups} "
                             f"warm-ups and {g.captures} captures of "
                             f"{len(g.graphs)} keys {kinds}")
    reduce = mesh is not None and mesh.capturable
    if ("vote_reduce" in kinds) != reduce:
        raise AssertionError(f"[y] {path} path on {mesh}: programs {kinds}")
    return labels, pool, (g.warmups, g.captures, g.replays), kinds


MESH_ROWS = (2, 4, 8, 16)   # rows a rank of a 16-block batch on 8 .. 1 cards


def counted_graphs(graphs, what):
    """One warm-up and one capture a key of ``graphs``."""
    if not graphs.warmups == graphs.captures == len(graphs.graphs):
        raise AssertionError(f"[y] {what}: {graphs.warmups} warm-ups and "
                             f"{graphs.captures} captures of "
                             f"{len(graphs.graphs)} keys")
    return (f"(warm-ups, captures, replays) ({graphs.warmups}, "
            f"{graphs.captures}, {graphs.replays}), one and one a key")


def mesh_graph_checks(torch, work, state_dict, mesh):
    """y on the one-rank NCCL mesh: the engine's programs as CUDA graphs
    against ``cuda_graphs=False`` on the same mesh, bitwise (host-pipeline
    train steps of Adam f32 and bf16 and SGD, room-id calls of k = 1 and
    4, ``eval_batch_rooms``), every all-reduce of a capture issued on the
    capturing stream, then the per-row step table."""
    from tumseg_torch.data.dataset import TrainBlockDataset
    from tumseg_torch.data.device_sampler import DeviceBlockSampler
    from tumseg_torch.parallel import mesh as pmesh
    from tumseg_torch.utils import graphs as G

    ssg = "pointnet2_sem_seg"
    t0 = time.perf_counter()
    # every all-reduce: (inside a capture, on a capturing stream, from
    # psum's backward, which autograd runs)
    seen, within = [], {"capture": False, "backward": False}
    real = (pmesh.Mesh.all_reduce_, G.StepGraphs._capture,
            pmesh._PSum.backward)

    def all_reduce_(self, t):
        seen.append((within["capture"],
                     torch.cuda.is_current_stream_capturing(),
                     within["backward"]))
        return real[0](self, t)

    def flagged(name, fn):
        def run(*args):
            within[name] = True
            try:
                return fn(*args)
            finally:
                within[name] = False
        return run

    pmesh.Mesh.all_reduce_ = all_reduce_
    G.StepGraphs._capture = flagged("capture", real[1])
    pmesh._PSum.backward = staticmethod(flagged("backward", real[2]))
    try:
        x, target, _ = mesh_step_batch(torch)
        for label, kw in (("Adam f32", {}),
                          ("Adam bf16", dict(compute_dtype=torch.bfloat16)),
                          ("SGD f32", dict(optimizer="SGD"))):
            engines = graph_engines(torch, ssg, state_dict, None, mesh=mesh,
                                    **kw)
            losses = []
            for _ in range(3):
                out = [e.train_batch(x, target, GRAPH_LR, GRAPH_MOMENTUM)
                       for e in engines]
                same_outputs(torch, f"{label} mesh train step", out[0],
                             out[1], "y")
                losses.append(round(float(out[0][0]), 5))
            n = same_state(torch, f"{label} after 3 mesh steps", *engines,
                           tag="y")
            if engines[1].graphs is not None:
                raise AssertionError("[y] cuda_graphs=False made graphs")
            print(f"[y] one-rank NCCL mesh, {label} SSG train step "
                  f"B={TRAIN_B}x{N} (draws, fast gathers) x 3, graph against "
                  f"cuda_graphs=False: losses {losses}, every loss and "
                  f"correct count and all {n} parameter, buffer and "
                  f"optimizer tensors bitwise; "
                  f"{counted_graphs(engines[0].graphs, label)}")

        files = sorted(str(p) for p in (work / "train_data").glob("*.las")
                       if p.name != "held_out.las")
        ds = TrainBlockDataset(files, [], num_classes=8, num_point=N,
                               color=False, class8=True, seed=SEED)
        sampler = DeviceBlockSampler.from_dataset(ds, device=DEVICE)
        rooms = ds.room_idxs
        rng = np.random.default_rng(SEED + 13)
        engines = graph_engines(torch, ssg, state_dict, sampler, mesh=mesh)
        losses, _ = graph_train_calls(torch, "room-id mesh", engines, rng,
                                      rooms, (1, 1, 4, 4), tag="y")
        for _ in range(2):
            ids = rng.choice(rooms, TRAIN_B).astype(np.int32)
            out = [e.eval_batch_rooms(ids) for e in engines]
            same_outputs(torch, "eval_batch_rooms on the mesh", out[0],
                         out[1], "y")
        n = same_state(torch, "after the room-id calls", *engines, tag="y")
        print(f"[y] one-rank NCCL mesh, room-id calls of k = 1, 1, 4, 4 "
              f"(losses {[round(v, 4) for v in losses]}) and 2 "
              f"eval_batch_rooms, graph against cuda_graphs=False: outputs "
              f"and all {n} tensors bitwise; "
              f"{counted_graphs(engines[0].graphs, 'room-id calls')}")
    finally:
        pmesh.Mesh.all_reduce_, G.StepGraphs._capture = real[:2]
        pmesh._PSum.backward = staticmethod(real[2])
    captured = [c for c in seen if c[0]]
    if not captured or not all(on for _, on, _ in captured):
        raise AssertionError(f"[y] {sum(not on for _, on, _ in captured)} "
                             f"of {len(captured)} all-reduces of a capture "
                             f"ran off the capturing stream")
    backward = sum(b for _, _, b in captured)
    if not backward:
        raise AssertionError("[y] no all-reduce of a captured backward")
    print(f"[y] the captures on the mesh issued {len(captured)} "
          f"all-reduces, all on the capturing stream, {backward} of them "
          f"from psum's backward, which autograd runs; checks "
          f"{time.perf_counter() - t0:.1f} s")
    mesh_step_table(torch, state_dict, mesh, sampler, rooms)


def mesh_step_table(torch, state_dict, mesh, sampler, rooms):
    """The SSG f32 room-id step at ``MESH_ROWS`` rows a rank on the
    one-rank NCCL mesh, graph and eager in turns: CUDA-event ms a step,
    host µs to issue one, back-to-back replay ms, idle share (1 - replay /
    step) and peak memory; the kernels of one replay's trace, NCCL's
    among them; and, at ``TRAIN_B`` rows, the point kernels that one step
    launches on a rank, graph and eager."""
    from tumseg_torch.ops import kernels

    rng = np.random.default_rng(SEED + 14)
    per_step = {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    print(f"[y] SSG f32 room-id step on the one-rank NCCL mesh, fast "
          f"gathers, by rows a rank (a {TRAIN_B}-block batch on "
          f"{TRAIN_B} / rows cards); graph / eager in turns (CUDA events, "
          f"median of 3 after 2 warm-up calls):")
    for rows in MESH_ROWS:
        ids = rng.choice(rooms, (1, rows)).astype(np.int32)
        runs = {True: [], False: []}
        trace = None
        for graphs in (True, False, False, True):
            engine = graph_engines(torch, "pointnet2_sem_seg", state_dict,
                                   sampler, which=(graphs,), mesh=mesh)[0]
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            call = functools.partial(engine.train_batch_rooms_multi, ids,
                                     GRAPH_LR, GRAPH_MOMENTUM)
            for _ in range(2):     # warm-up, then the capture and a replay
                call()
            if rows == TRAIN_B and graphs not in per_step:
                torch.cuda.synchronize()
                kernels.reset_launches()
                call()
                torch.cuda.synchronize()
                per_step[graphs] = launched(kernels.launches)
                what = f"[y] a mesh step (graph {graphs})"
                check_training_launches(kernels.launches, 1, what,
                                        batch_norm=False)
                # a mesh keeps the plain BatchNorm: one call a layer
                plain = kernels.plain_calls["batch_norm_plain"]
                if plain < BN_LAYERS["pointnet2_sem_seg"]:
                    raise AssertionError(f"{what}: {plain} plain "
                                         "BatchNorms, expected >= 22")
            ms = time_ms(torch, call, 1)[0]
            us = enqueue_us(torch, call)
            peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
            replay = None
            if graphs:
                (g,) = [e.graph for e in engine.graphs.graphs.values()]
                replay = time_ms(torch, g.replay, 5)[0]
                if trace is None:
                    torch.cuda.synchronize()
                    with torch.profiler.profile(activities=acts) as prof:
                        g.replay()
                        torch.cuda.synchronize()
                    names = [e.name for e in prof.events() if e.device_type
                             == torch.autograd.DeviceType.CUDA]
                    trace = (len(names),
                             sum("nccl" in n.lower() for n in names),
                             sum("memcpy" in n.lower() for n in names))
            runs[graphs].append((ms, us, replay, peak))
            del engine, call
        graph, eager = runs[True], runs[False]
        busy = np.mean([r for _, _, r, _ in graph])

        def col(rs, i, nd):
            return [round(r[i], nd) for r in rs]
        print(f"[y]   {rows} rows: graph {col(graph, 0, 3)} ms a step, "
              f"host {col(graph, 1, 1)} us, replays {col(graph, 2, 3)} ms, "
              f"peak {col(graph, 3, 1)} MiB; eager {col(eager, 0, 3)} ms, "
              f"host {col(eager, 1, 1)} us, peak {col(eager, 3, 1)} MiB; "
              f"idle (1 - replay / step) graph "
              f"{round(1 - busy / np.mean(col(graph, 0, 6)), 3)}, eager "
              f"{round(1 - busy / np.mean(col(eager, 0, 6)), 3)}; one "
              f"replay's trace: {trace[0]} device events, {trace[1]} NCCL "
              f"kernels, {trace[2]} memcpys")
    if per_step[True] != per_step[False]:
        raise AssertionError(f"[y] a mesh step launched {per_step[True]} as "
                             f"a graph, {per_step[False]} eagerly")
    print(f"[y] point kernels one SSG step launches on a rank of the mesh, "
          f"graph and eager: {per_step[True]}")


def _mesh_rank(rank, work, state_dict, batch):
    """One of y's two gloo ranks on cuda:0: the dry run, the SSG step, the
    device pipeline and the serving run on the mesh. -> rank 0's numbers
    (every rank raises on a failed check)."""
    import copy

    import torch

    from tumseg_torch import models
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.data.dataset import TrainBlockDataset
    from tumseg_torch.data.device_sampler import DeviceBlockSampler
    from tumseg_torch.ops import build, kernels
    from tumseg_torch.parallel import dryrun
    from tumseg_torch.parallel import mesh as pmesh
    from tumseg_torch.train.loop import TrainEngine

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.library()
    mesh = pmesh.make_mesh(2, devices=DEVICE, backend="gloo")
    out = {"dryrun": dryrun.dryrun_multichip(2, device=DEVICE,
                                             backend="gloo")}

    def agree(flag):
        """Whether ``flag`` holds on every rank."""
        t = torch.tensor([float(flag)], device=DEVICE)
        return mesh.all_reduce_(t).item() == mesh.size

    def same_as_rank0(t):
        return agree(torch.equal(mesh.broadcast_(t.clone()), t))

    # the SSG step, 8 blocks a rank, deterministic draws, exact gathers
    ssg = models.get_module("pointnet2_sem_seg")
    steps = {}
    for name, k in (("mesh", 1), ("mesh3", 3)):
        model = ssg.get_model(8)
        model.load_state_dict(state_dict)
        steps[name] = dryrun.exact_step(model, *batch, mesh=mesh, steps=k,
                                        optimizer="SGD", device=DEVICE)
    out["step"] = {k: {n: v.cpu() for n, v in steps["mesh"][k].items()}
                   for k in ("grads", "params", "stats")}
    out["step"]["losses"] = steps["mesh"]["losses"]
    out["ranks_equal"] = same_as_rank0(torch.cat(
        [p.reshape(-1) for p in steps["mesh3"]["params"].values()]))
    if not out["ranks_equal"]:
        raise AssertionError("the ranks' parameters differ after 3 steps")

    # the device pipeline: 4 single room-id steps against one call of 4
    files = sorted(str(p) for p in (work / "train_data").glob("*.las")
                   if p.name != "held_out.las")
    ds = TrainBlockDataset(files, [], num_classes=8, num_point=N,
                           color=False, class8=True, seed=SEED)
    sampler = DeviceBlockSampler.from_dataset(ds, device=DEVICE)
    base = ssg.get_model(8)
    base.load_state_dict(state_dict)
    weights = np.random.default_rng(SEED + 8).random(8) + 0.5
    engines = [TrainEngine(copy.deepcopy(base), 8, weights, device=DEVICE,
                           seed=SEED, sampler=sampler, mesh=mesh)
               for _ in range(2)]
    ids_k = np.random.default_rng(SEED + 9).choice(
        ds.room_idxs, (4, TRAIN_B)).astype(np.int32)
    lm, cm = engines[0].train_batch_rooms_multi(ids_k, 1e-3, 0.1)
    single = [engines[1].train_batch_rooms(i, 1e-3, 0.1) for i in ids_k]
    ls = torch.stack([l for l, _ in single])
    cs = torch.stack([c for _, c in single])
    bitwise = agree(torch.equal(lm, ls) and torch.equal(cm, cs) and all(
        torch.equal(a, b) for a, b in zip(engines[0].model.state_dict()
                                          .values(),
                                          engines[1].model.state_dict()
                                          .values())))
    if not bitwise:
        raise AssertionError(f"4 single room-id steps {ls.tolist()} against "
                             f"one call of 4 {lm.tolist()} on the mesh")
    local = np.full(TRAIN_B // 2, ids_k[0, 0], np.int32)
    pts = sampler.sample_batch(local, engines[0]._streams(0, 1)[0])[0]
    differ = not agree(torch.equal(mesh.broadcast_(pts.clone()), pts))
    if not differ:
        raise AssertionError("both ranks sampled the same blocks")
    out["pipeline"] = dict(losses=lm.tolist(), corrects=cm.tolist())

    # serving d's tile at B=32, 16 blocks a rank a forward
    args = mesh_serve_args(work, state_dict, "y_mesh")
    torch.cuda.synchronize()
    kernels.reset_launches()
    res = test_cli._run(args, mesh)
    torch.cuda.synchronize()
    counts = torch.zeros(mesh.size, len(MESH_KERNELS), dtype=torch.int64,
                         device=DEVICE)
    counts[rank] = torch.tensor([kernels.launches[k] for k in MESH_KERNELS])
    mesh.all_reduce_(counts)
    out["serve"] = dict(seconds=res["infer_seconds"], miou=res["miou"],
                        launches=[dict(zip(MESH_KERNELS, row))
                                  for row in counts.tolist()])
    # sg's check on the mesh: the runner's graphs against eager, each rank
    labels, pool, counts, _ = mesh_serving(torch, mesh, work, state_dict)
    if not same_as_rank0(pool.to(DEVICE)):
        raise AssertionError("[y] the ranks' graph-served pools differ")
    out["graphs"] = dict(labels=labels, pool=pool, counts=counts)
    return out


def phase_mesh(torch, work, state_dict):
    """y. (after x) The ``data`` mesh: a one-rank NCCL group, then two gloo
    ranks sharing cuda:0."""
    from tumseg_torch import models
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.data.dataset import TestGridDataset
    from tumseg_torch.ops import kernels
    from tumseg_torch.parallel import dryrun
    from tumseg_torch.parallel import mesh as pmesh
    from tumseg_torch.viz.writers import read_labels_txt

    ssg = models.get_module("pointnet2_sem_seg")
    batch = mesh_step_batch(torch)

    def step(mesh, k=1):
        model = ssg.get_model(8)
        model.load_state_dict(state_dict)
        return dryrun.exact_step(model, *batch, mesh=mesh, steps=k,
                                 optimizer="SGD", device=DEVICE)

    def held(tag, got, want):
        """Holds ``got``'s step against ``want``'s: loss within 1e-5
        relative, parameters within 5e-4; prints both and the gradient
        and BN-statistics distances."""
        got = {k: ({n: t.to(DEVICE) for n, t in v.items()}
                   if isinstance(v, dict) else v) for k, v in got.items()}
        dl = abs(got["losses"][0] - want["losses"][0])
        dp = dryrun.max_distance(got["params"], want["params"])
        gap, gap_name = grad_gap(got["grads"], want["grads"])
        ds = dryrun.max_distance(got["stats"], want["stats"])
        print(f"[y] {tag}: SSG step B={TRAIN_B}x{N} (SGD, deterministic "
              f"draws, exact gathers) loss {got['losses'][0]:.7f} against "
              f"{want['losses'][0]:.7f} in one process (|d| {dl:.3g}); "
              f"parameters max|d| {dp:.3g}; gradients {gap:.3g} x their "
              f"layer's max|g| ({gap_name}); BN running statistics max|d| "
              f"{ds:.3g}")
        if not (dl <= 1e-5 * abs(want["losses"][0]) and dp < 5e-4):
            raise AssertionError(f"{tag}: mesh step against one process")

    one = step(None)
    # a one-rank NCCL group
    summary = dryrun.dryrun_multichip(1)
    print(f"[y] dryrun_multichip(1), NCCL on {DEVICE}: {summary}")
    # sg's check on the mesh: graphs against eager, and one process, on
    # each vote path
    served = {path: mesh_serving(torch, None, work, state_dict, path)
              for path in SERVE_PATHS}
    one_labels = served["reblock"][0]
    mesh = pmesh.make_mesh(1, backend="nccl")
    try:
        if not mesh.capturable:
            raise AssertionError(f"[y] {mesh}: NCCL on {DEVICE} is not "
                                 f"capturable")
        held("one-rank NCCL mesh", step(mesh), one)
        for path in SERVE_PATHS:
            labels, pool, counts, kinds = mesh_serving(torch, mesh, work,
                                                       state_dict, path)
            want, want_pool = served[path][:2]
            if not (np.array_equal(labels, want)
                    and torch.equal(pool, want_pool)):
                raise AssertionError(f"[y] the one-rank NCCL mesh's graph-"
                                     f"served labels or pool differ from "
                                     f"one process's on the {path} path")
            print(f"[y] d's tile, {SG_VOTES} votes, {path} path, serving "
                  f"programs {kinds} as CUDA graphs on the one-rank NCCL "
                  f"mesh: labels and pool bitwise equal to cuda_graphs="
                  f"False on the mesh and to one process's graphs "
                  f"((warm-ups, captures, replays) {counts}, one a key)")
        mesh_graph_checks(torch, work, state_dict, mesh)
    finally:
        pmesh.close_mesh()

    # single-process serving of d's tile, the figure beside the mesh's
    args = mesh_serve_args(work, state_dict, "y_one")
    torch.cuda.synchronize()
    kernels.reset_launches()
    res = test_cli._run(args, None)
    torch.cuda.synchronize()
    one_launches = {k: kernels.launches[k] for k in MESH_KERNELS}

    mesh_serve_args(work, state_dict, "y_mesh")  # its checkpoint, once
    t0 = time.perf_counter()
    out = pmesh.spawn(_mesh_rank, 2, (work, {k: v.cpu() for k, v in
                                             state_dict.items()}, batch),
                      backend="gloo")
    print(f"[y] two gloo ranks on {DEVICE}: spawned, checked and joined in "
          f"{time.perf_counter() - t0:.1f} s; dryrun_multichip(2) "
          f"{out['dryrun']}")
    held(f"two gloo ranks ({TRAIN_B // 2} blocks a rank)", out["step"], one)
    print(f"[y] after 3 mesh steps both ranks' parameters bitwise equal; "
          f"device pipeline on the mesh: 4 train_batch_rooms bitwise one "
          f"train_batch_rooms_multi of 4 (losses {out['pipeline']['losses']}"
          f", corrects {out['pipeline']['corrects']}), the ranks' sampled "
          f"blocks differ")

    n, votes = SCENE_POINTS, 2
    cells = TestGridDataset(las_file_list=[str(work / "data" / "facade.las")],
                            num_classes=8, block_points=N, color=False,
                            class8=True).grid_structure(0)
    forwards = votes * math.ceil(sum(math.ceil(c[0].size / N)
                                     for c in cells) / B)
    for rank, launches in enumerate(out["serve"]["launches"]):
        for name, per in PER_FORWARD["pointnet2_sem_seg"].items():
            if name in MESH_KERNELS and launches[name] < forwards * per:
                raise AssertionError(f"rank {rank}: {name} launched "
                                     f"{launches[name]} times, expected >= "
                                     f"{forwards * per}")
    labels = {k: read_labels_txt(str(work / "log" / "sem_seg" / k / "visual"
                                     / "facade.txt"))
              for k in ("y_one", "y_mesh")}
    differ = int(np.sum(labels["y_one"] != labels["y_mesh"]))
    print(f"[y] d's tile, {n} points x {votes} votes at B={B} ({B // 2} a "
          f"rank), device re-blocking: two ranks on one card "
          f"{n * votes / out['serve']['seconds']:.0f} scene-points/s "
          f"(infer {out['serve']['seconds']:.3f} s) against one process "
          f"{n * votes / res['infer_seconds']:.0f} (infer "
          f"{res['infer_seconds']:.3f} s); labels differ on {differ} of {n} "
          f"points; launches by rank {out['serve']['launches']}, one "
          f"process {one_launches} ({forwards} forwards)")
    if differ > n // 1000:
        raise AssertionError(f"mesh serving differs from one process on "
                             f"{differ} of {n} points")
    sg = out["graphs"]
    differ = int(np.sum(sg["labels"] != one_labels))
    print(f"[y] d's tile, {SG_VOTES} votes, device re-blocking, serving "
          f"programs as CUDA graphs on two gloo ranks: each rank's labels "
          f"and pool bitwise equal to cuda_graphs=False on the mesh, the "
          f"ranks' pools equal; labels differ from one process's on "
          f"{differ} of {n} points ((warm-ups, captures, replays) on rank "
          f"0 {sg['counts']})")
    if differ > n // 1000:
        raise AssertionError(f"graph-served mesh labels differ from one "
                             f"process on {differ} of {n} points")


GRAPH_TRAIN_POINTS = 1_200_000   # 12 steps an epoch: an 8-step call + 4
GRAPH_CALLS = (1, 1, 4, 4, 8, 8, 1)   # k of each call: warm, replay, ...
GRAPH_LR, GRAPH_MOMENTUM = 1e-3, 0.1
GRAPH_EPOCHS = 3   # an 8-step call warms up in epoch 1, is captured in 2


def engine_state(engine):
    """Every tensor that a step writes: parameters, buffers (BN running
    statistics and counts) and optimizer state, by name."""
    model = engine.model
    out = {f"param {n}": p.detach() for n, p in model.named_parameters()}
    out.update({f"buffer {n}": b for n, b in model.named_buffers()})
    names = {p: n for n, p in model.named_parameters()}
    for p, state in engine.optimizer.state.items():
        out.update({f"{k} {names[p]}": v for k, v in state.items()
                    if hasattr(v, "shape")})
    return out


def same_state(torch, what, graph, eager, tag="cg"):
    got, want = engine_state(graph), engine_state(eager)
    if got.keys() != want.keys():
        raise AssertionError(f"[{tag}] {what}: the engines hold different "
                             f"tensors")
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    if bad:
        raise AssertionError(f"[{tag}] {what}: graph != eager in {len(bad)} "
                             f"of {len(want)} tensors, e.g. {bad[:4]}")
    return len(want)


def same_outputs(torch, what, got, want, tag="cg"):
    """(losses, corrects) or (losses, tallies) of two calls, bitwise."""
    for g, w in zip(got, want):
        pairs = ([(g[k], w[k]) for k in w] if isinstance(w, dict)
                 else [(g, w)])
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"[{tag}] {what}: graph {got} != eager "
                                 f"{want}")


def graph_engines(torch, model_name, state_dict, sampler, compute_dtype=None,
                  which=(True, False), optimizer="Adam", mesh=None):
    """Engines from the same weights and seed, one a value of ``which``:
    CUDA graphs (True) and eager (False); on ``mesh`` when given."""
    import copy

    from tumseg_torch import models
    from tumseg_torch.train.loop import TrainEngine

    base = models.get_module(model_name).get_model(8)
    base.load_state_dict(state_dict)
    weights = np.random.default_rng(SEED + 8).random(8) + 0.5
    return [TrainEngine(copy.deepcopy(base), 8, weights, optimizer=optimizer,
                        device=DEVICE, seed=SEED, sampler=sampler,
                        compute_dtype=compute_dtype, mesh=mesh,
                        cuda_graphs=graphs)
            for graphs in which]


def graph_train_calls(torch, what, engines, rng, rooms, calls, tag="cg"):
    """The room-id calls of ``calls`` (k each) on both engines, each call's
    losses and corrects and then the whole state held bitwise."""
    losses = []
    for k in calls:
        ids = rng.choice(rooms, (k, TRAIN_B)).astype(np.int32)
        if k == 1:
            out = [e.train_batch_rooms(ids[0], GRAPH_LR, GRAPH_MOMENTUM)
                   for e in engines]
        else:
            out = [e.train_batch_rooms_multi(ids, GRAPH_LR, GRAPH_MOMENTUM)
                   for e in engines]
        same_outputs(torch, f"{what} {k}-step call", out[0], out[1], tag)
        losses += out[0][0].reshape(-1).tolist()
    n = same_state(torch, f"{what} after {sum(calls)} steps", *engines,
                   tag=tag)
    return losses, n


def phase_graphs(torch, work, states):
    """[cg] the engine's steps as CUDA graphs against the same steps eager
    (``cuda_graphs=False``), bitwise; then the time and memory of both at
    k = 1, 4 and 8, and the training CLI with each."""
    from tumseg_torch.cli import train as train_cli
    from tumseg_torch.data.dataset import TrainBlockDataset
    from tumseg_torch.data.device_sampler import DeviceBlockSampler
    from tumseg_torch.train import checkpoint as ckpt
    from tumseg_torch.train.loop import TrainEngine

    ssg, msg = "pointnet2_sem_seg", "pointnet2_sem_seg_msg"
    data = work / "graph_data"
    data.mkdir(exist_ok=True)
    rng = np.random.default_rng(SEED + 11)
    write_facade_tile(rng, data / "facade.las", GRAPH_TRAIN_POINTS)
    shutil.copy(work / "train_data" / "held_out.las", data / "held_out.las")
    ds = TrainBlockDataset([str(data / "facade.las")], [], num_classes=8,
                           num_point=N, color=False, class8=True, seed=SEED)
    sampler = DeviceBlockSampler.from_dataset(ds, device=DEVICE)
    rooms = ds.room_idxs
    t0 = time.perf_counter()

    # SSG, f32 and bf16: 1, 4 and 8-step calls, each warmed, then replayed
    for dtype in (None, torch.bfloat16):
        label = f"{ssg} {'bf16' if dtype else 'f32'}"
        engines = graph_engines(torch, ssg, states[ssg], sampler, dtype)
        losses, n = graph_train_calls(torch, label, engines, rng, rooms,
                                      GRAPH_CALLS)
        graphs = engines[0].graphs
        if engines[1].graphs is not None or graphs.replays != 4 or \
                graphs.captures != 3:
            raise AssertionError(f"[cg] {label}: {graphs.captures} captures "
                                 f"and {graphs.replays} replays, expected 3 "
                                 f"and 4")
        print(f"[cg] {label} fast gathers, calls of k = {GRAPH_CALLS} "
              f"({sum(GRAPH_CALLS)} steps; 3 graphs captured, 4 replays): "
              f"every loss and correct count and all {n} parameter, buffer "
              f"and Adam tensors bitwise equal to the eager engine's; "
              f"losses {[round(v, 4) for v in losses]}")
        if dtype is None:
            f32 = engines
    # MSG and PointNet: a step warmed, then one replayed
    for name in (msg, POINTNET):
        engines = graph_engines(torch, name, states[name], sampler)
        losses, n = graph_train_calls(torch, name, engines, rng, rooms,
                                      (1, 1))
        if engines[0].graphs.replays != 1:
            raise AssertionError(f"[cg] {name}: no replay")
        print(f"[cg] {name} two single steps (the second replayed): losses "
              f"{[round(v, 4) for v in losses]}, all {n} tensors bitwise "
              f"equal to eager")

    # eval supersteps and single calls on the f32 SSG engines
    for k in (4, 4, 1, 1):
        ids = rng.choice(rooms, (k, TRAIN_B)).astype(np.int32)
        out = [e.eval_batch_rooms_multi(ids) for e in f32]
        same_outputs(torch, f"eval {k}-call", out[0], out[1])
    # the host pipeline's train and eval steps
    brng = np.random.default_rng(SEED + 12)
    for _ in range(3):
        x = facade_batch(brng, TRAIN_B, N)
        t = (x[..., 5] * 7.999).astype(np.int64)
        out = [e.train_batch(x, t, GRAPH_LR, GRAPH_MOMENTUM) for e in f32]
        same_outputs(torch, "host-pipeline train step", out[0], out[1])
    for _ in range(2):
        out = [e.eval_batch(x, t) for e in f32]
        same_outputs(torch, "host-pipeline eval step", out[0], out[1])
    n = same_state(torch, "after the eval and host-pipeline steps", *f32)
    replays = f32[0].graphs.replays
    print(f"[cg] eval calls of k = 4, 4, 1, 1 (losses and tallies), 3 "
          f"host-pipeline train steps and 2 eval steps: bitwise equal to "
          f"eager ({replays - 4} more replays), all {n} tensors equal")

    # a checkpoint loaded between two supersteps, then Adam's state
    # replaced by load_state_dict: both rebind what the graphs captured
    path = str(work / "graphs_ckpt.pth")
    f32[0].save(path, 1)
    captures = f32[0].graphs.captures
    for e in f32:
        e.load_state(ckpt.load_checkpoint(path))
    graph_train_calls(torch, "after load_state", f32, rng, rooms, (4, 4))
    for e in f32:
        e.optimizer.load_state_dict(e.optimizer.state_dict())
    graph_train_calls(torch, "after optimizer.load_state_dict", f32, rng,
                      rooms, (4, 4))
    captured = f32[0].graphs.captures - captures
    if captured != 2:
        raise AssertionError(f"[cg] {captured} graphs captured again after "
                             f"the two rebindings, expected 2")
    print(f"[cg] load_state between two 4-step calls, then "
          f"optimizer.load_state_dict between two more: the graphs "
          f"dropped and captured again ({captured}), the state bitwise "
          f"equal to eager; checks {time.perf_counter() - t0:.1f} s")
    del f32, engines

    # time and peak memory at k = 1, 4, 8, graph and eager in turns
    print(f"[cg] step time, SSG f32 B={TRAIN_B}x{N} fast gathers, room-id "
          f"calls (CUDA events, median of 3 calls after 2 warm-up calls):")
    for k in (1, 4, 8):
        ids = rng.choice(rooms, (k, TRAIN_B)).astype(np.int32)
        runs, firsts = {True: [], False: []}, []
        for graphs in (True, False, False, True):
            engine = graph_engines(torch, ssg, states[ssg], sampler,
                                   which=(graphs,))[0]
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            call = functools.partial(engine.train_batch_rooms_multi, ids,
                                     GRAPH_LR, GRAPH_MOMENTUM)
            first = []
            for _ in range(2):     # warm-up, then the capture and a replay
                t1 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                first.append(time.perf_counter() - t1)
            wall = time_ms(torch, call, 1)[0] / k
            peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
            replay = None
            if graphs:
                g = next(g for key, g in engine.graphs.graphs.items()
                         if key[:2] == ("train_rooms", k)).graph
                replay = time_ms(torch, g.replay, 5)[0] / k
            runs[graphs].append((wall, replay, peak))
            if graphs:
                firsts.append(round(first[1] - first[0], 3))
            del engine, call
        graph, eager = runs[True], runs[False]
        busy = np.mean([r for _, r, _ in graph])
        print(f"[cg]   k={k}: graph {[round(w, 3) for w, _, _ in graph]} ms "
              f"a step, back-to-back replays "
              f"{[round(r, 3) for _, r, _ in graph]} ms a step, peak "
              f"{[round(p, 1) for _, _, p in graph]} MiB; eager "
              f"{[round(w, 3) for w, _, _ in eager]} ms a step, peak "
              f"{[round(p, 1) for _, _, p in eager]} MiB; idle share (1 - "
              f"replay / step) graph "
              f"{round(1 - busy / np.mean([w for w, _, _ in graph]), 3)}, "
              f"eager {round(1 - busy / np.mean([w for w, _, _ in eager]), 3)}"
              f"; the capturing call's s over the warm-up's {firsts}")

    # the training CLI, device pipeline, --superstep 1 and 8, graph and
    # eager in turns; the fit logs of the two equal
    made = []

    def engine_of(graphs):
        def make(*args, **kwargs):
            made.append(TrainEngine(*args, cuda_graphs=graphs, **kwargs))
            return made[-1]
        return make

    logged = ("Training mean loss", "Training accuracy", "eval mean loss",
              "eval point avg class IoU", "eval point accuracy",
              "eval point avg class acc", "Best mIoU")
    logs = {}
    real = train_cli.TrainEngine
    try:
        for turn, (graphs, k) in enumerate(((True, 1), (False, 1),
                                            (False, 8), (True, 8))):
            train_cli.TrainEngine = engine_of(graphs)
            pipeline = ("--data_pipeline", "device", "--superstep", str(k))
            launches, rates, text = phase_train_cli(
                torch, work, ssg, GRAPH_EPOCHS, 30, "cg", pipeline=pipeline,
                turn=100 + turn, data="graph_data",
                points=GRAPH_TRAIN_POINTS)
            graphs_run = made[-1].graphs
            if (graphs_run is not None) != graphs or (
                    graphs and graphs_run.replays == 0):
                raise AssertionError(f"[cg] CLI run graphs={graphs}: "
                                     f"{graphs_run}")
            messages = [line.split(" - ", 3)[-1]
                        for line in text.splitlines()]
            logs[graphs, k] = [m for m in messages if m.startswith(logged)]
            print(f"[cg] CLI --superstep {k} {'graph' if graphs else 'eager'}"
                  f": Training points/sec by epoch {rates}"
                  + (f", {graphs_run.captures} graphs, {graphs_run.replays} "
                     f"replays" if graphs else ""))
    finally:
        train_cli.TrainEngine = real
    for k in (1, 8):
        if logs[True, k] != logs[False, k] or not logs[True, k]:
            raise AssertionError(f"[cg] --superstep {k}: the graph run "
                                 f"logged {logs[True, k]}, the eager run "
                                 f"{logs[False, k]}")
    print(f"[cg] CLI fit logs of graph and eager equal at --superstep 1 and "
          f"8 ({len(logs[True, 8])} lines each: mean loss, accuracy, eval "
          f"mIoU); phase {time.perf_counter() - t0:.1f} s")


SG_VOTES = 2
SG_SECOND_POINTS = 150_000   # the second scene of sg's run_testing


def served_model(torch, name, state_dict):
    """``name``'s module with ``state_dict``'s weights, on the card."""
    from tumseg_torch import models

    model = models.get_module(name).get_model(8)
    model.load_state_dict(state_dict)
    return model.to(DEVICE).eval()


def graph_runners(torch, model, **kw):
    """Runners of one model, one a value of ``cuda_graphs``: graphs (True)
    first, then eager (False)."""
    from tumseg_torch.infer.voting import InferenceRunner

    return [InferenceRunner(model, 8, batch_size=B, device=DEVICE,
                            cuda_graphs=graphs, **kw)
            for graphs in (True, False)]


def program_calls(blocks, votes, path):
    """Program calls of ``votes`` votes over ``blocks`` blocks: a chunk of
    B blocks each, and on the device re-blocking path a re-blocking a
    vote."""
    return votes * (math.ceil(blocks / B) + (path == "device_reblock"))


def serve_graph_eager(torch, what, path, tile, runners, votes=SG_VOTES,
                      switch=None):
    """Serves scene 0 of ``tile`` on the graph runner and on the eager one
    (each on a fresh dataset of the same seed, so the host-drawn paths draw
    the same blocks; under ``switch``, an ops context, where given): labels
    and pools bitwise equal, the graph's warm-ups and replays one a program
    call. -> (blocks a vote, the graph runner's StepGraphs)."""
    out = []
    for runner in runners:
        ds = scene_dataset(tile)
        with switch() if switch else contextlib.nullcontext():
            labels = runner.infer_scene(ds, 0, votes)
        out.append((labels, runner._buffers["pool"]))
    (got, got_pool), (want, want_pool) = out
    if not (np.array_equal(got, want) and torch.equal(got_pool, want_pool)):
        raise AssertionError(f"[sg] {what}: the graph runner's labels differ "
                             f"on {int(np.sum(got != want))} points, pools "
                             f"equal {torch.equal(got_pool, want_pool)}")
    blocks = sum(math.ceil(c[0].size / N)
                 for c in scene_dataset(tile).grid_structure(0))
    graphs = runners[0].graphs
    calls = program_calls(blocks, votes, path)
    programs = 2 if path == "device_reblock" else 1
    if (graphs.warmups != programs or graphs.captures != programs
            or graphs.warmups + graphs.replays != calls):
        raise AssertionError(f"[sg] {what}: {graphs.warmups} warm-ups, "
                             f"{graphs.captures} captures and "
                             f"{graphs.replays} replays for {calls} program "
                             f"calls of {programs} programs")
    if runners[1].graphs is not None:
        raise AssertionError(f"[sg] {what}: the eager runner has graphs")
    print(f"[sg] {what}: {votes} votes of {blocks} blocks, labels and pool "
          f"bitwise equal to eager ({len(np.unique(got))} classes); "
          f"{graphs.warmups} warm-ups, {graphs.captures} captures in "
          f"{graphs.capture_seconds:.3f} s, {graphs.replays} replays")
    return blocks, graphs


def enqueue_us(torch, fn, calls=5):
    """The host's time of one call of ``fn`` from a drained device, in
    microseconds, median of ``calls``: the time to enqueue its work."""
    runs = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        runs.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return float(np.median(runs))


def event_seconds(torch, fn):
    """CUDA-event seconds of ``fn()`` on the current stream."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def phase_serve_graphs(torch, work, states):
    """[sg] (after cg) the serving runner's programs as CUDA graphs
    (``InferenceRunner``'s default on the card) against the same programs
    eager (``cuda_graphs=False``), bitwise; then the forward's and the
    serving runs' times, idle share and peak memory, graph and eager in
    turns."""
    from tumseg_torch import ops
    from tumseg_torch.infer.voting import run_testing
    from tumseg_torch.tools import voting_bench
    from tumseg_torch.viz.writers import read_labels_txt

    ssg, msg, trial = ("pointnet2_sem_seg", "pointnet2_sem_seg_msg",
                       "pointnet2_sem_seg_trial")
    tile = work / "data" / "facade.las"
    t0 = time.perf_counter()

    # the B=32 forward (predict_blocks) of every model: one replay a call
    x = model_batch(B, N)
    for name, state, dtype in ((ssg, states[ssg], None),
                               (ssg, states[ssg], torch.bfloat16),
                               (msg, states[msg], None),
                               (POINTNET, states[POINTNET], None),
                               (trial, states[ssg], None)):
        model = served_model(torch, name, state)
        graph, eager = graph_runners(torch, model, compute_dtype=dtype)
        got = [graph.predict_blocks(x) for _ in range(3)]
        want = eager.predict_blocks(x)
        if not all(np.array_equal(g, want) for g in got) or (
                graph.graphs.replays, graph.graphs.captures) != (2, 1):
            raise AssertionError(f"[sg] {name} forward: graph against eager "
                                 f"{[np.mean(g == want) for g in got]}, "
                                 f"{graph.graphs.replays} replays")
        print(f"[sg] {name}{' bf16' if dtype else ''} B={B}x{N} "
              f"predict_blocks: warm-up, capture + replay, replay: labels "
              f"bitwise equal to eager ({len(np.unique(want))} classes)")

    # the three paths, the models, bf16, the window and the fused switch
    ssg_model = served_model(torch, ssg, states[ssg])
    for path, kw in (("device_reblock", {}),
                     ("device_features", dict(device_reblock=False)),
                     ("host", dict(device_features=False))):
        serve_graph_eager(torch, f"{ssg} {path}", path, tile,
                          graph_runners(torch, ssg_model, **kw))
    for what, model, kw, switch in (
            (f"{ssg} bf16", ssg_model, dict(compute_dtype=torch.bfloat16),
             None),
            (msg, served_model(torch, msg, states[msg]), {}, None),
            (POINTNET, served_model(torch, POINTNET, states[POINTNET]), {},
             None),
            (trial, served_model(torch, trial, states[ssg]), {}, None),
            (f"{ssg} window_ops", ssg_model, dict(window_ops=True), None),
            (f"{ssg} fused switch", ssg_model, {}, ops.fused_group_enabled)):
        serve_graph_eager(torch, f"{what} device_reblock", "device_reblock",
                          tile, graph_runners(torch, model, **kw),
                          switch=switch)

    # two scenes through run_testing, the second staged by its prefetch
    # while the first votes (ungridded, so the prefetch grids and uploads)
    second = work / "data_sg" / "second.las"
    second.parent.mkdir()
    write_facade_tile(np.random.default_rng(SEED + 13), second,
                      SG_SECOND_POINTS, length=10.0)
    dumps, pools = {}, {}
    for graphs, runner in zip((True, False), graph_runners(torch,
                                                           ssg_model)):
        ds = scene_dataset(tile)
        ds2 = scene_dataset(second)
        for attr in ("file_list", "scene_points_list", "semantic_labels_list",
                     "scene_points_num", "room_coord_min", "room_coord_max",
                     "extra_features_data"):
            getattr(ds, attr).extend(getattr(ds2, attr))
        vis = work / f"sg_{'graph' if graphs else 'eager'}"
        vis.mkdir()
        run_testing(ds, runner, num_votes=SG_VOTES, visual_dir=vis,
                    log_string=lambda *a: None)
        dumps[graphs] = [read_labels_txt(str(vis / f"{name}.txt"))
                         for name in ("facade", "second")]
        pools[graphs] = runner._buffers["pool"]     # the second scene's
        if graphs:
            g = runner.graphs
            if g.captures != 4:
                raise AssertionError(f"[sg] run_testing: {g.captures} "
                                     f"captures over two scenes, expected 4")
            captured = (g.captures, g.capture_seconds, g.replays)
    if not (all(np.array_equal(a, b) for a, b in zip(dumps[True],
                                                     dumps[False]))
            and torch.equal(pools[True], pools[False])):
        raise AssertionError("[sg] run_testing over two scenes: the graph "
                             "runner's labels or pool differ from eager's")
    print(f"[sg] run_testing, two scenes ({SCENE_POINTS} + "
          f"{SG_SECOND_POINTS} points, the second gridded and uploaded by "
          f"the prefetch while the first votes): both label dumps and the "
          f"second scene's pool bitwise equal to eager's; {captured[0]} "
          f"captures (2 a scene) in "
          f"{captured[1]:.3f} s, {captured[2]} replays; checks "
          f"{time.perf_counter() - t0:.1f} s")

    # the forward: event ms, host us a call and peak memory, in turns
    xd = torch.as_tensor(x, device=DEVICE)
    for dtype in (None, torch.bfloat16):
        runs, replay_us = {True: [], False: []}, []
        for graphs in (True, False, False, True):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            runner = graph_runners(torch, ssg_model, compute_dtype=dtype)[
                0 if graphs else 1]
            fwd = functools.partial(runner._forward, xd)
            ms = float(np.median(roofline.forward_runs(runner, xd, 3)))
            us = enqueue_us(torch, fwd)
            peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
            if graphs:   # the host's time of the replay alone
                (entry,) = runner.graphs.graphs.values()
                replay_us.append(enqueue_us(torch, entry.graph.replay))
            runs[graphs].append((ms, us, peak))
            del runner, fwd
        print(f"[sg] {ssg} {'bf16' if dtype else 'f32'} forward B={B}x{N}, "
              f"graph / eager in turns: "
              + "; ".join(f"{'graph' if g else 'eager'} "
                          f"{[round(m, 3) for m, _, _ in runs[g]]} ms, host "
                          f"{[round(u, 1) for _, u, _ in runs[g]]} us a "
                          f"call, peak {[round(p, 1) for _, _, p in runs[g]]}"
                          f" MiB" for g in (True, False))
              + f"; the graph's replay() alone "
                f"{[round(u, 1) for u in replay_us]} us")

    # serving d's tile and n's: scene-points/s and idle share, in turns
    for path, n in ((tile, SCENE_POINTS),
                    (work / "scale" / "facade_1m.las", SCALE_POINTS)):
        ds = scene_dataset(path)
        blocks = sum(math.ceil(c[0].size / N) for c in ds.grid_structure(0))
        chunks = math.ceil(blocks / B)
        runs = {True: [], False: []}
        busy = []
        for graphs in (True, False, False, True):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            runner = graph_runners(torch, ssg_model)[0 if graphs else 1]
            first = event_seconds(
                torch, lambda: runner.infer_scene(ds, 0, SG_VOTES))
            wall = event_seconds(
                torch, lambda: runner.infer_scene(ds, 0, SG_VOTES))
            peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
            extra = ""
            if graphs:
                # busy: the programs' replays back to back, the chunk's on
                # the first chunk of a vote (its last, whose dump rows all
                # vote into one row, is what the capture's statics hold)
                g = runner.graphs
                vote_ms, chunk_ms, reblock_ms = voting_bench.program_busy_ms(
                    runner, voting_bench.first_chunk(runner, ds, B), chunks)
                busy.append(SG_VOTES * vote_ms / 1e3)
                extra = (f", {g.captures} captures in "
                         f"{g.capture_seconds:.3f} s, replays: a chunk "
                         f"{chunk_ms:.3f} ms, a re-blocking "
                         f"{reblock_ms:.3f} ms")
            runs[graphs].append((first, wall, peak, extra))
            del runner
        busy_s = float(np.mean(busy))
        print(f"[sg] {n} points x {SG_VOTES} votes ({blocks} blocks, "
              f"{chunks} chunks a vote), device re-blocking, busy "
              f"{busy_s:.4f} s (back-to-back replays), graph / eager in "
              f"turns:")
        for g in (True, False):
            print(f"[sg]   {'graph' if g else 'eager'}: "
                  + "; ".join(f"{n * SG_VOTES / wall:.0f} scene-points/s "
                              f"(event wall {wall:.4f} s, idle "
                              f"{1 - busy_s / wall:.4f}), first call "
                              f"{first:.3f} s{extra}, peak {peak:.1f} MiB"
                              for first, wall, peak, extra in runs[g]))
    print(f"[sg] phase {time.perf_counter() - t0:.1f} s")

CARD_TESTS = "tests/test_torch_cuda.py"


def phase_card_tests(work):
    """[ct] (right after b) the card tests, ``python3 -m pytest
    --noconftest tests/test_torch_cuda.py`` in a subprocess, on the
    kernels that [a] built: every test that the file collects passes, none
    fails, errs or skips, or this raises."""
    root = Path(__file__).resolve().parent
    report = work / "card_tests.xml"
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", CARD_TESTS, "-q",
         "-p", "no:cacheprovider", "-rfEs", f"--junitxml={report}"],
        cwd=root, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    counts = dict.fromkeys(("tests", "failures", "errors", "skipped"), 0)
    if report.exists():
        suite = ET.parse(report).getroot()
        suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
        counts = {k: int(suite.get(k, 0)) for k in counts}
    passed = (counts["tests"] - counts["failures"] - counts["errors"]
              - counts["skipped"])
    print(f"[ct] {CARD_TESTS}: {passed} passed of {counts['tests']} "
          f"collected ({counts['failures']} failed, {counts['errors']} "
          f"errors, {counts['skipped']} skipped) in {seconds:.1f} s, exit "
          f"{res.returncode}")
    if res.returncode != 0 or counts["tests"] == 0 or passed != counts[
            "tests"]:
        print(res.stdout[-6000:] + res.stderr[-3000:])
        raise AssertionError(f"[ct] the card tests did not all pass: "
                             f"{passed} of {counts['tests']}, exit "
                             f"{res.returncode}")


# the tools' defaults, but breakdown's runs (3, not 5) and train_sustained's
# epochs (1, not 2), so that the phase stays within about 4 minutes
TOOL_ARGS = {"voting_bench": [], "train_sustained": ["--epochs", "1"],
             "sampler_probe": [], "breakdown": ["--iters", "3"],
             "serve_probe3": [], "roofline": []}
# graph and --eager in turns where a tool has both
TOOL_TURNS = {"voting_bench": (False, True, True, False),
              "train_sustained": (False, True)}
VOTING_KEYS = ("metric", "scene_points", "votes", "block_batches",
               "blocks_per_vote", "wall_s", "host_grid_s_per_vote",
               "host_full_featurize_s_per_vote", "device_features",
               "device_reblock", "value", "cuda_graphs", "idle_share",
               "voted_points")
SUSTAINED_KEYS = ("mode", "steps", "batch", "npoint", "epoch_s",
                  "ms_per_step", "points_per_sec")
SAMPLER_PHASES = ("candidates_pass", "rejection_loop", "sort_u_idx", "top_k",
                  "featurize_gathers", "sample_batch_full")
ROOFLINE_KEYS = ("model", "shape", "dtype", "flops", "flops_traced", "bytes",
                 "forward_ms", "mfu", "compute_bound_ms", "hbm_bound_ms")


def run_tool(name, argv, work):
    """``tumseg_torch.tools.<name>.main(argv)``, its output kept in
    ``work/tools/``: (its JSON lines, seconds). Its first line must be the
    card's."""
    import importlib

    import torch

    mod = importlib.import_module(f"tumseg_torch.tools.{name}")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    seconds = time.perf_counter() - t0
    text = out.getvalue()
    logs = work / "tools"
    logs.mkdir(exist_ok=True)
    turn = len(list(logs.glob(f"{name}_*.log")))
    (logs / f"{name}_{turn}.log").write_text(" ".join(argv) + "\n" + text)
    lines = text.strip().splitlines()
    if rc != 0 or not lines[0].startswith(torch.cuda.get_device_name(0)):
        raise AssertionError(f"[tl] {name} {argv}: exit {rc}, first line "
                             f"{lines[0]!r}")
    return [json.loads(t) for t in lines[1:] if t.startswith("{")], seconds


def _have(what, line, keys):
    missing = [k for k in keys if k not in line]
    if missing:
        raise AssertionError(f"[tl] {what}: missing {missing} in {line}")


def _rate(what, *values):
    for v in values:
        if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0):
            raise AssertionError(f"[tl] {what}: {v!r} is not a finite "
                                 f"positive rate or time")


def _spread(*runs):
    """The runs' spread, summed over the rows: max - min of each."""
    return sum(max(r) - min(r) for r in runs)


def _split(what, parts, whole, spread):
    """Raises where the parts exceed their whole by more than the
    spread."""
    if parts > whole + spread:
        raise AssertionError(f"[tl] {what}: the parts {parts:.4f} exceed "
                             f"the whole {whole:.4f} by more than the "
                             f"spread {spread:.4f}")


def check_voting(lines, eager):
    (line,) = lines
    what = f"voting_bench{' --eager' if eager else ''}"
    _have(what, line, VOTING_KEYS)
    _rate(what, line["value"], line["wall_s"], line["host_grid_s_per_vote"],
          line["host_full_featurize_s_per_vote"], line["blocks_per_vote"])
    if line["voted_points"] != line["scene_points"]:
        raise AssertionError(f"[tl] {what}: {line['voted_points']} of "
                             f"{line['scene_points']} points voted")
    if line["cuda_graphs"] is eager or not line["device_reblock"]:
        raise AssertionError(f"[tl] {what}: graphs {line['cuda_graphs']}, "
                             f"device re-blocking {line['device_reblock']}")
    if not eager and not math.isfinite(line["idle_share"]):
        raise AssertionError(f"[tl] {what}: idle share "
                             f"{line['idle_share']}")
    return line


def check_sustained(lines, eager):
    what = f"train_sustained{' --eager' if eager else ''}"
    modes = [line["mode"] for line in lines]
    if modes != ["device_rate", "device_pipeline", "host_pipeline",
                 "superstep8", "summary"]:
        raise AssertionError(f"[tl] {what}: modes {modes}")
    for line in lines[:-1]:
        _have(what, line, SUSTAINED_KEYS)
        _rate(f"{what} {line['mode']}", line["epoch_s"], line["ms_per_step"],
              line["points_per_sec"], line["steps"])
    _rate(f"{what} summary",
          *(v for k, v in lines[-1].items() if k != "mode"))
    return {line["mode"]: line for line in lines}


def check_sampler(lines):
    if set(lines[0]) != {"cap", "cands"} or lines[0]["cands"] != 9 * lines[
            0]["cap"]:
        raise AssertionError(f"[tl] sampler_probe: {lines[0]}")
    by = {line["phase"]: line for line in lines[1:]}
    if tuple(by) != SAMPLER_PHASES:
        raise AssertionError(f"[tl] sampler_probe: phases {tuple(by)}")
    for phase, line in by.items():
        _rate(f"sampler_probe {phase}", line["ms"], *line["runs"])
    parts = ("rejection_loop", "sort_u_idx", "featurize_gathers")
    _split("sampler_probe: rejection, sort and gathers against a batch",
           sum(by[p]["ms"] for p in parts), by["sample_batch_full"]["ms"],
           _spread(*(by[p]["runs"] for p in parts + ("sample_batch_full",))))
    return by


def check_breakdown(lines):
    by = {line["name"]: line for line in lines}
    for name, line in by.items():
        _have(f"breakdown {name}", line, ("name", "ms", "compile_s", "runs"))
        _rate(f"breakdown {name}", line["ms"], *line["runs"])

    def rows(prefix, suffix):
        found = [by[k] for k in by
                 if k.startswith(prefix) and suffix in k]
        if not found:
            raise AssertionError(f"[tl] breakdown: no {prefix}*{suffix} row")
        return found

    # the FP blocks are left out: on their random clouds they and the SA
    # blocks add up to within 2% of the forward (the head is ~0.15 ms), a
    # margin that the blocks' inputs, not the card, decide
    layers = [r for i in range(1, 5) for r in rows(f"sa{i}", "_block")]
    whole = by[f"forward B{B}"]
    _split("breakdown: the SA blocks against the forward",
           sum(r["ms"] for r in layers), whole["ms"],
           _spread(whole["runs"], *(r["runs"] for r in layers)))
    grads = [r for i in range(1, 5) for p in (f"sa{i}", f"fp{i}")
             for r in rows(p, "_fwdbwd")]
    step = by[f"train_step B{TRAIN_B} bf16"]
    _split("breakdown: the layers' gradients against the train step",
           sum(r["ms"] for r in grads), step["ms"],
           _spread(step["runs"], *(r["runs"] for r in grads)))
    for i in range(1, 5):
        parts = rows(f"fps{i}", "") + rows(f"bq{i}", "")
        (block,) = rows(f"sa{i}", "_block")
        _split(f"breakdown: FPS and the ball query against sa{i}'s block",
               sum(r["ms"] for r in parts), block["ms"],
               _spread(block["runs"], *(r["runs"] for r in parts)))
    return by


def check_serve_probe(lines):
    if set(lines[0]) != {"nb", "nb_pad", "L", "n_pad"}:
        raise AssertionError(f"[tl] serve_probe3: {lines[0]}")
    by = {line["phase"]: line for line in lines[1:-1]}
    for phase, line in by.items():
        _rate(f"serve_probe3 {phase}", line["ms_per_vote"], *line["runs"])
    if "derived" not in lines[-1] or len(by) != 5:
        raise AssertionError(f"[tl] serve_probe3: phases {tuple(by)}, last "
                             f"{lines[-1]}")
    full, part = by["scan_full"], by["scan_no_scatter"]
    _split("serve_probe3: the vote without its scatter against the vote",
           part["ms_per_vote"], full["ms_per_vote"],
           _spread(full["runs"], part["runs"]))
    return by


def check_roofline(lines):
    line = lines[-1]
    _have("roofline", line, ROOFLINE_KEYS)
    B_, N_ = (int(v) for v in line["shape"][1:].split("xN"))
    widths = roofline.model_flops(line["model"], B_, N_)
    if not line["flops"] == line["flops_traced"] == widths:
        raise AssertionError(f"[tl] roofline: {line['flops']} FLOPs, "
                             f"{line['flops_traced']} traced, {widths} from "
                             f"the layers' widths")
    _rate("roofline", line["flops"], line["forward_ms"], line["mfu"],
          line["bytes"])
    for k in lines[:-1]:
        _rate(f"roofline {k['kernel']} {k['stage']}", k["nbytes"],
              k["bound_ms"])
    return line


def phase_tools(work):
    """[tl] (after sg, before the kernels' line) the port's benches on the
    card through their ``main(argv)``, at ``TOOL_ARGS``, graph and
    ``--eager`` in turns where a tool has both (``TOOL_TURNS``): each
    tool's JSON lines checked (keys, finite positive rates and times, every
    point voted, the roofline's FLOPs equal to the count from the layers'
    widths, no split whose parts exceed their whole by more than the runs'
    spread), its seconds and its headline printed."""
    t0 = time.perf_counter()
    args = dict(TOOL_ARGS)
    args["train_sustained"] = args["train_sustained"] + [
        "--workdir", str(work / "tools_sustained")]
    args["sampler_probe"] = args["sampler_probe"] + [
        "--workdir", str(work / "tools_sampler")]

    walls = {False: [], True: []}
    for eager in TOOL_TURNS["voting_bench"]:
        argv = args["voting_bench"] + (["--eager"] if eager else [])
        lines, seconds = run_tool("voting_bench", argv, work)
        line = check_voting(lines, eager)
        walls[eager].append(line["wall_s"])
        print(f"[tl] voting_bench{' --eager' if eager else ''} "
              f"({seconds:.1f} s): "
              f"{line['value']:.1f} scene-points/s ({line['scene_points']} "
              f"points x {line['votes']} votes, {line['blocks_per_vote']} "
              f"blocks, event wall {line['wall_s']:.4f} s, idle share "
              f"{line['idle_share']}, host grid "
              f"{line['host_grid_s_per_vote']:.3f} s a vote)")
        if not eager:
            spread = (max(walls[False]) - min(walls[False])) / line["wall_s"]
            _split("voting_bench: the programs' busy time against the wall",
                   1.0 - line["idle_share"], 1.0, spread)
    for eager in TOOL_TURNS["train_sustained"]:
        argv = args["train_sustained"] + (["--eager"] if eager else [])
        lines, seconds = run_tool("train_sustained", argv, work)
        by = check_sustained(lines, eager)
        print(f"[tl] train_sustained{' --eager' if eager else ''} "
              f"({seconds:.1f} s): " + "; ".join(
                  f"{m} {by[m]['points_per_sec']:.0f} points/s "
                  f"({by[m]['ms_per_step']:.3f} ms a step)"
                  for m in list(by)[:-1]))
    for name, check in (("sampler_probe", check_sampler),
                        ("serve_probe3", check_serve_probe),
                        ("breakdown", check_breakdown)):
        lines, seconds = run_tool(name, args[name], work)
        by = check(lines)
        print(f"[tl] {name} ({seconds:.1f} s): " + "; ".join(
            f"{k} {v.get('ms', v.get('ms_per_vote')):.4f} ms"
            for k, v in by.items()))
    lines, seconds = run_tool("roofline", args["roofline"], work)
    line = check_roofline(lines)
    print(f"[tl] roofline ({seconds:.1f} s): {line['model']} "
          f"{line['shape']} {line['dtype']}: {line['flops']} FLOPs "
          f"(traced {line['flops_traced']}), forward {line['forward_ms']:.4f}"
          f" ms, MFU {line['mfu']:.5f}, compute bound "
          f"{line['compute_bound_ms']:.4f} ms, HBM bound "
          f"{line['hbm_bound_ms']:.4f} ms ({line['bytes']} bytes, the point "
          f"kernels' {line['point_kernel_bytes']}), point kernels' bound "
          f"{line['point_kernel_bound_ms']:.4f} ms")
    print(f"[tl] phase {time.perf_counter() - t0:.1f} s")


def launched(launches):
    """The kernels launched at least once, with their counts."""
    return {name: n for name, n in launches.items() if n}


def check_training_launches(launches, steps, what, batch_norm=True):
    """Each SSG kernel launched at least steps x its launches a training
    step (forward and backward), as g holds them; the BatchNorm kernels
    only with ``batch_norm`` (a mesh runs the plain BatchNorm)."""
    ssg = "pointnet2_sem_seg"
    for name, per in PER_FORWARD[ssg].items():
        if name in BN_KERNELS and not batch_norm:
            continue
        want = steps * (per + PER_STEP[ssg].get(name, 0))
        if launches[name] < want:
            raise AssertionError(f"{what}: {name} launched {launches[name]} "
                                 f"times in training, expected >= {want}")


def phase_quality(torch, work):
    """z: the port's two end-to-end tools on the card. The soak at its
    defaults (``tumseg_torch/tools/soak.py``), its gate held; then
    ``tumseg_torch/tools/miou_parity.py`` at PARITY.md's production
    configuration, seeds 0-2 in f32 and in ``--bf16``: each served mIoU
    beside tumseg's and the original pipeline's, the per-epoch eval mIoU,
    seconds and launches; every served mIoU > 0.3 and the f32 mean >=
    0.4122."""
    from tumseg_torch.tools import miou_parity, soak

    t0 = time.perf_counter()
    sargs = soak.parse_args(["--workdir", str(work / "soak")])
    res = soak.run(sargs)
    steps = training_steps(2 * sargs.points, sargs.npoint, sargs.batch_size,
                           sargs.epochs)
    check_training_launches(res["train_launches"], steps, "soak")
    print(f"[z] soak: train {res['train_seconds']:.3f} s ({steps} steps), "
          f"test {res['test_seconds']:.3f} s, "
          f"{sargs.points * sargs.votes / res['test_seconds']:.0f} "
          f"scene-points/s; "
          f"served mIoU {res['miou']!r}, eval mIoU by epoch "
          f"{res['eval_mious']}; launches in training "
          f"{launched(res['train_launches'])}, in testing "
          f"{launched(res['test_launches'])}")
    if not res["ok"]:
        raise AssertionError(f"the soak's gate failed: {res}")

    served = {}
    for bf16 in (False, True):
        mode = "bf16" if bf16 else "f32"
        for seed in PARITY_SEEDS:
            args = miou_parity.parse_args(
                PARITY_ARGS + ["--seed", str(seed), "--workdir",
                               str(work / f"parity_{mode}_{seed}")]
                + (["--bf16"] if bf16 else []))
            out, det = miou_parity.run(args)
            steps = training_steps(2 * args.tile_points, args.npoint,
                                   args.batch, args.epochs)
            check_training_launches(det["train_launches"], steps,
                                    f"parity {mode} seed {seed}")
            served[mode, seed] = det["miou"]
            print(json.dumps(out))
            print(f"[z] parity {mode} seed {seed}: served mIoU "
                  f"{det['miou']!r} (tumseg {PARITY_TUMSEG[seed]}, "
                  f"reference {PARITY_REFERENCE[seed]}); eval mIoU by epoch "
                  f"{[round(v, 4) for v in det['eval_mious']]}; train "
                  f"{det['train_seconds']:.3f} s ({steps} steps), test "
                  f"{det['test_seconds']:.3f} s; launches in training "
                  f"{launched(det['train_launches'])}, in testing "
                  f"{launched(det['test_launches'])}")
    means = {mode: float(np.mean([served[mode, s] for s in PARITY_SEEDS]))
             for mode in ("f32", "bf16")}
    diffs = [round(served["bf16", s] - served["f32", s], 4)
             for s in PARITY_SEEDS]
    seconds = time.perf_counter() - t0
    print(f"[z] parity means: f32 {means['f32']:.4f}, bf16 "
          f"{means['bf16']:.4f} (tumseg "
          f"{np.mean(list(PARITY_TUMSEG.values())):.4f}, reference "
          f"{np.mean(list(PARITY_REFERENCE.values())):.4f}); bf16 - f32 by "
          f"seed {diffs}; phase {seconds:.1f} s")
    print(json.dumps({"z": {
        "soak_miou": res["miou"], "soak_ok": res["ok"],
        "served": {mode: [served[mode, s] for s in PARITY_SEEDS]
                   for mode in ("f32", "bf16")},
        "means": means, "seconds": seconds}}))
    low = {k: v for k, v in served.items() if not v > SERVED_MIOU_MIN}
    if low:
        raise AssertionError(f"served mIoU at or under {SERVED_MIOU_MIN}: "
                             f"{low}")
    if means["f32"] < PARITY_MEAN_MIN:
        raise AssertionError(f"f32 mean mIoU {means['f32']:.4f} under "
                             f"{PARITY_MEAN_MIN}")


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
    print(f"[a] kernels built and loaded in {build.build_seconds:.2f} s; "
          f"bounds at {HBM_BYTES_PER_S / 1e12} TB/s and "
          f"{F32_OPS_PER_S / 1e12} TFLOP/s (tumseg_torch/tools/roofline.py)")

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
    phase_card_tests(work)
    phase_window(torch, report)
    phase_fused(torch, report)
    state_dict = phase_forward(torch, ssg, "c")
    launches = phase_serve(torch, work, state_dict, ssg, "d")[0]
    launches["fused_ball_group"] = phase_fused_switch(
        torch, state_dict)["fused_ball_group"]
    phase_backward(torch, report)
    phase_batch_norm(torch, report)
    phase_fast(torch, report)
    phase_train_step(torch, state_dict, ssg, "f")
    launches.update({name: n for name, n in phase_train_cli(
        torch, work, ssg, TRAIN_EPOCHS, 10, "g")[0].items()
        if name in ("group_backward", "interpolate_backward")
        + BN_KERNELS[1:]})
    phase_device_pipeline(torch, work, state_dict)

    phase_multi(torch, report)
    msg_state = phase_forward(torch, msg, "i")
    launches["ball_query_multi"] = phase_serve(
        torch, work, msg_state, msg, "j")[0]["ball_query_multi"]
    phase_train_step(torch, msg_state, msg, "k")
    phase_train_cli(torch, work, msg, MSG_TRAIN_EPOCHS, 6, "k")
    phase_fast_vs_exact(torch, state_dict, ssg, "r")
    phase_fast_vs_exact(torch, msg_state, msg, "r")
    phase_bf16(torch, work, {ssg: state_dict, msg: msg_state})

    launches["three_nn_window"] = phase_serve_paths(
        torch, work, state_dict)["three_nn_window"]
    phase_scale(torch, work, state_dict)

    pointnet_state = phase_pointnet_forward(torch)
    phase_pointnet_serve(torch, work, pointnet_state)
    phase_pointnet_train(torch, work, pointnet_state)
    phase_frozen(torch, work, state_dict)
    phase_mesh(torch, work, state_dict)
    states = {ssg: state_dict, msg: msg_state, POINTNET: pointnet_state}
    phase_graphs(torch, work, states)
    phase_serve_graphs(torch, work, states)
    phase_tools(work)

    for name, k in report.kernels.items():
        k["launches"] = launches[name]
        if k["launches"] == 0:
            raise AssertionError(f"{name} was never launched on its path")
    print(json.dumps({"kernels": list(report.kernels.values())}), flush=True)
    # the quality gates come after the kernel report, so that a miss there
    # still leaves the kernels' line of this run
    phase_quality(torch, work)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
