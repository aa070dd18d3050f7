#!/usr/bin/env python
"""FLOP count, bytes, MFU and roofline times of the port's forward, the
counterpart of ``benchmarks/roofline.py``.

    python -m tumseg_torch.tools.roofline [--model pointnet2_sem_seg]
        [--B 32] [--N 4096] [--dtype bf16] [--forward-ms MS] [--gpu 0]

The original reads XLA's cost analysis of the lowered forward; PyTorch has
none, so the port counts the work itself:

- **FLOPs** of the GEMMs: ``2 * rows * in * out`` for every ``Dense`` of the
  model (the reference's 1x1 convs and linears), plus PointNet's two
  transform ``bmm``s (``2 * B * N * 3 * 3`` and ``2 * B * N * 64 * 64``).
  The rows of a layer are B * S * K at a set abstraction stage (S its
  centroids, K its ball's samples, per radius in MSG), B * N at a feature
  propagation stage (N its level's points) and at the head, B at the
  STNs' fully connected layers. :func:`model_flops` counts from the
  layers' widths; :func:`traced_flops` counts the rows that a forward
  really feeds each ``Dense``, and the two must agree.
- **The point kernels' bytes and operations**, as ``chip_smoke.py``'s
  bounds count them (the ``*_cost`` functions here, which ``chip_smoke.py``
  imports): FPS, the centroid gathers, the ball queries (9 operations a
  candidate that the z-slab walk tests, counted on this forward's own
  points by ``ball_query_probe.walk_model``), the neighbourhood groups
  and the 3-NN interpolations of this forward. A bf16 forward groups in
  the single-pass bf16 mode, so there a group's output counts 2 bytes an
  element.
- **Bytes of the GEMMs**: each ``Dense``'s input and weight read once in
  the compute dtype and its f32 output written once. With the point
  kernels' bytes this is a lower bound of the forward's memory traffic
  (the bias, BN and ReLU passes come on top).

The peaks are those of the NVIDIA H100 80GB HBM3 (SXM, 700 W): dense bf16
tensor cores 989.4 TFLOP/s, f32 without TF32 (which the port keeps off)
67 TFLOP/s, HBM3 3.35 TB/s. MFU is the FLOPs over the forward's time over
the peak of the compute dtype. Given ``--forward-ms`` it uses that time;
without it, it times the forward on the card (``--gpu``) itself: the
B-block forward of ``InferenceRunner`` (a CUDA graph on the card), CUDA
events after its warm-up and capture, ``RUNS`` runs of 10 calls, every
run, the median and the minimum, the minimum taken as the time.

Prints the card's line, then one JSON line a point kernel call
(``kernel``), then the summary line (``model``, ``flops``, ...). The
model's weights are seeded (``torch.manual_seed(0)``) and its input is
``default_rng(0).random((B, N, 6 + extra))``, as in the original.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np
import torch

from tumseg_torch.tools import benchutil

# NVIDIA H100 80GB HBM3 (SXM, 700 W): HBM3 bytes/s, f32 operations/s
# outside the tensor cores (TF32 off), dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989.4e12
PEAK_FLOPS = {"f32": F32_OPS_PER_S, "bf16": BF16_FLOPS_PER_S}
MODELS = ("pointnet2_sem_seg", "pointnet2_sem_seg_msg", "pointnet_sem_seg",
          "pointnet2_sem_seg_original", "pointnet2_sem_seg_trial",
          "pointnet_sem_seg_original")
# the timed forward's runs, each the mean of 10 calls
RUNS = 5
# what the frozen variants pin; the others take the original's 6 channels
EXTRA = {"pointnet2_sem_seg_original": 3, "pointnet_sem_seg_original": 3}


# --- the point kernels' bytes and operations (chip_smoke.py's bounds) ----

def bound_ms(nbytes: float, ops: float):
    """(bound, bytes ms, operations ms): the larger of the bytes over the
    HBM rate and the f32 operations over the f32 rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms


def fps_cost(b, n, npoint):
    """xyz read, the start and the indices written; 10 operations a point a
    step (a distance and the running minimum and maximum)."""
    return dict(nbytes=b * n * 12 + b * 4 + b * npoint * 4,
                ops=b * npoint * n * 10)


def group_cost(b, s, k, c, n, fast=False):
    """idx, src and centres read, the [B, S, K, C] output written (bf16 when
    fast); one subtraction per xyz element."""
    return dict(nbytes=4 * (b * s * k + b * n * c + b * s * 3)
                + b * s * k * c * (2 if fast else 4),
                ops=b * s * k * 3)


def ball_query_cost(b, n, s, ks, tested):
    """xyz and centroids read, the indices of every radius written; 9
    operations a candidate that the walk tests (``tested``, by
    ``ball_query_probe.walk_model``)."""
    return dict(nbytes=b * n * 12 + b * s * 12 + b * s * sum(ks) * 4,
                ops=9 * tested)


def three_nn_cost(b, n1, s, d):
    """Both clouds and points2 read, distances, indices and the [B, N1, D]
    output written; a full scan's 8 operations a distance and 3 compares
    into the top 3, the weights, then 3 multiplies and 2 adds an output."""
    return dict(nbytes=4 * (b * n1 * 3 + b * s * 3 + b * s * d + b * n1 * 6
                            + b * n1 * d),
                ops=b * n1 * s * 11 + b * n1 * 10 + b * n1 * d * 5)


def window_cost(b, n1, s, d, tested):
    """The 3-NN's bytes; ~14 operations a candidate that the expansion-form
    walk tests (``three_nn_probe.walk_model``), the weights, 5 an output
    element."""
    return dict(nbytes=three_nn_cost(b, n1, s, d)["nbytes"],
                ops=14 * tested + b * n1 * 10 + b * n1 * d * 5)


def group_backward_cost(b, s, k, c, n):
    """idx and the cotangent read, the [B, N, C] gradient written; one add
    an element."""
    return dict(nbytes=4 * (b * s * k + b * s * k * c + b * n * c),
                ops=b * s * k * c)


def interpolate_backward_cost(b, n1, s, d):
    """idx, weights and the cotangent read, the [B, S, D] gradient written;
    a multiply and an add an entry."""
    return dict(nbytes=4 * (b * n1 * 6 + b * n1 * d + b * s * d),
                ops=b * n1 * 3 * d * 2)


def fused_cost(b, s, k, c, n, tested, fast):
    """xyz, centroids and src read, idx and the grouped tensor (bf16 when
    fast) written; 9 operations a candidate the walk tests, one
    subtraction an xyz output."""
    return dict(nbytes=b * n * 12 + b * s * 12 + b * n * c * 4
                + b * s * k * 4 + b * s * k * c * (2 if fast else 4),
                ops=9 * tested + b * s * k * 3)


# --- the GEMMs ----------------------------------------------------------

def _model(name, extra=None):
    from tumseg_torch import models

    return models.get_module(name).get_model(
        8, EXTRA.get(name, 0) if extra is None else extra)


def _dense_widths(module) -> List:
    """(name, in, out) of every ``Dense`` under ``module``, in order."""
    from tumseg_torch.nn.layers import Dense

    return [(name, m.weight.shape[1], m.weight.shape[0])
            for name, m in module.named_modules() if isinstance(m, Dense)]


def gemm_layers(model, B: int, N: int):
    """(name, rows, in, out) of every ``Dense`` of ``model`` at B blocks of
    N points, its rows from its place (see the module's docstring), and
    the FLOPs of PointNet's transform ``bmm``s (0 for PointNet++)."""
    from tumseg_torch.nn.layers import (PointNetEncoder, SetAbstraction,
                                        SetAbstractionMsg)

    layers, bmm = [], 0
    if hasattr(model, "sa1"):
        levels = [N]
        for i in range(1, 5):
            sa = getattr(model, f"sa{i}")
            if isinstance(sa, SetAbstraction):
                scales = [(sa.nsample, sa.mlp_convs)]
            else:
                assert isinstance(sa, SetAbstractionMsg)
                scales = list(zip(sa.nsample_list, sa.conv_blocks))
            for s, (k, convs) in enumerate(scales):
                for name, cin, cout in _dense_widths(convs):
                    layers.append((f"sa{i}.{s}.{name}", B * sa.npoint * k,
                                   cin, cout))
            levels.append(sa.npoint)
        for i in (4, 3, 2, 1):
            for name, cin, cout in _dense_widths(getattr(model, f"fp{i}")):
                layers.append((f"fp{i}.{name}", B * levels[i - 1], cin,
                               cout))
        for head in ("conv1", "conv2"):
            w = getattr(model, head).weight
            layers.append((head, B * N, w.shape[1], w.shape[0]))
        return layers, bmm
    enc = model.feat
    assert isinstance(enc, PointNetEncoder)
    stns = [("feat.stn", enc.stn)]
    if enc.feature_transform:
        stns.append(("feat.fstn", enc.fstn))
    for prefix, stn in stns:
        for name, cin, cout in _dense_widths(stn):
            rows = B if name.startswith("fc") else B * N
            layers.append((f"{prefix}.{name}", rows, cin, cout))
    for name in ("conv1", "conv2", "conv3"):
        w = getattr(enc, name).weight
        layers.append((f"feat.{name}", B * N, w.shape[1], w.shape[0]))
    bmm = 2 * B * N * 3 * 3
    if enc.feature_transform:
        bmm += 2 * B * N * 64 * 64
    for name in ("conv1", "conv2", "conv3", "conv4"):
        w = getattr(model, name).weight
        layers.append((name, B * N, w.shape[1], w.shape[0]))
    return layers, bmm


def model_flops(name: str, B: int, N: int, extra=None) -> int:
    """The FLOPs of ``name``'s forward at B x N from its layers' widths:
    ``2 * rows * in * out`` a ``Dense`` plus the transform ``bmm``s."""
    layers, bmm = gemm_layers(_model(name, extra), B, N)
    return sum(2 * r * i * o for _, r, i, o in layers) + bmm


def gemm_bytes(layers, elem: int) -> int:
    """Each ``Dense``'s input and weight read once at ``elem`` bytes an
    element, its f32 output written once."""
    return sum(r * i * elem + i * o * elem + r * o * 4
               for _, r, i, o in layers)


class _Trace:
    """Forward hooks that record what a forward feeds each ``Dense`` (its
    rows), PointNet's encoder (its transform ``bmm``s) and each set
    abstraction and feature propagation (their clouds, for the point
    kernels' costs)."""

    def __init__(self, model):
        from tumseg_torch.nn.layers import (Dense, FeaturePropagation,
                                            PointNetEncoder, SetAbstraction,
                                            SetAbstractionMsg)

        self.flops, self.bmm, self.sa, self.fp = 0, 0, [], []
        self.handles = []
        for m in model.modules():
            hook = None
            if isinstance(m, Dense):
                hook = self._dense
            elif isinstance(m, PointNetEncoder):
                hook = self._encoder
            elif isinstance(m, (SetAbstraction, SetAbstractionMsg)):
                hook = self._sa
            elif isinstance(m, FeaturePropagation):
                hook = self._fp
            if hook is not None:
                self.handles.append(m.register_forward_hook(hook))

    def _dense(self, m, args, out):
        x = args[0]
        cout, cin = m.weight.shape[:2]
        self.flops += 2 * (x.numel() // x.shape[-1]) * cin * cout

    def _encoder(self, m, args, out):
        b, n, _ = args[0].shape
        self.bmm += 2 * b * n * 3 * 3
        if m.feature_transform:
            self.bmm += 2 * b * n * 64 * 64

    def _sa(self, m, args, out):
        xyz, points = args[0], args[1]
        c = 3 + (0 if points is None else points.shape[-1])
        self.sa.append((m, xyz.detach().float().cpu().numpy(),
                        out[0].detach().float().cpu().numpy(), c))

    def _fp(self, m, args, out):
        xyz1, xyz2, points2 = args[0], args[1], args[3]
        self.fp.append((xyz1.shape[0], xyz1.shape[1], xyz2.shape[1],
                        points2.shape[-1]))

    def remove(self):
        for h in self.handles:
            h.remove()


def kernel_costs(trace: _Trace, fast: bool = False) -> List[Dict]:
    """One line a point kernel call of the traced forward: its bytes, its
    operations and their bound. ``fast``: the neighbourhood groups ran
    their single-pass bf16 mode, which writes bf16 (the layers' default
    under a compute dtype); the centroid gathers write f32 in both."""
    from tumseg_torch.nn.layers import SetAbstraction
    from tumseg_torch.tools.ball_query_probe import walk_model

    lines = []

    def add(kernel, stage, cost):
        ms, bms, oms = bound_ms(cost["nbytes"], cost["ops"])
        lines.append({"kernel": kernel, "stage": stage,
                      "nbytes": int(cost["nbytes"]), "ops": int(cost["ops"]),
                      "bound_ms": ms,
                      "bound_by": "bytes" if bms >= oms else "operations"})

    for i, (m, xyz, new_xyz, c) in enumerate(trace.sa, start=1):
        b, n, _ = xyz.shape
        s = new_xyz.shape[1]
        stage = f"sa{i}"
        single = isinstance(m, SetAbstraction)
        radii = (m.radius,) if single else tuple(m.radius_list)
        ks = (m.nsample,) if single else tuple(m.nsample_list)
        add("fps", stage, fps_cost(b, n, s))
        add("group", f"{stage} centroids", group_cost(b, s, 1, 3, n))
        _, tested = walk_model(xyz, new_xyz, radii, ks)
        add("ball_query" if single else "ball_query_multi", stage,
            ball_query_cost(b, n, s, ks, tested))
        for k in ks:
            add("group", f"{stage} K={k}", group_cost(b, s, k, c, n, fast))
    for i, (b, n1, s, d) in zip((4, 3, 2, 1), trace.fp):
        if s > 1:
            add("three_nn_interpolate", f"fp{i}", three_nn_cost(b, n1, s, d))
    return lines


def traced_flops(model, x: torch.Tensor, compute_dtype=None):
    """(FLOPs of the Dense layers and the transform bmms that one eval
    forward of ``x`` runs, the point kernels' cost lines)."""
    trace = _Trace(model)
    try:
        with torch.inference_mode():
            model.eval()(x, compute_dtype=compute_dtype)
    finally:
        trace.remove()
    return trace.flops + trace.bmm, kernel_costs(
        trace, fast=compute_dtype is not None)


def forward_runs(runner, x: torch.Tensor, runs: int, reps: int = 10
                 ) -> List[float]:
    """Milliseconds of ``runner``'s B-block forward of ``x``
    (``InferenceRunner._forward``, a CUDA graph where the runner runs
    graphs): ``runs`` runs of the mean of ``reps`` calls after its warm-up
    and capture. ``chip_smoke.py`` [sg] times its forwards with it too."""
    def fwd():
        return runner._forward(x)

    fwd()
    fwd()        # the warm-up, then the capture and a replay
    return [benchutil.mean_ms(runner.device, fwd, reps)
            for _ in range(runs)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--forward-ms", type=float, default=None,
                    help="a measured forward time at B x N; default: time "
                         "it on the card")
    ap.add_argument("--model", default="pointnet2_sem_seg", choices=MODELS)
    ap.add_argument("--B", type=int, default=32)
    ap.add_argument("--N", type=int, default=4096)
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"),
                    help="compute dtype (the original's bf16)")
    benchutil.add_gpu_arg(ap)
    return ap.parse_args(argv)


def run(args) -> Dict:
    """Prints the card's line, the kernels' lines and the summary line;
    returns the summary."""
    device = benchutil.device_of(args.gpu)
    benchutil.print_card(device)
    extra = EXTRA.get(args.model, 0)
    torch.manual_seed(0)
    model = _model(args.model).to(device)
    compute_dtype = torch.bfloat16 if args.dtype == "bf16" else None
    x = torch.as_tensor(np.random.default_rng(0).random(
        (args.B, args.N, 6 + extra)).astype(np.float32), device=device)
    layers, bmm = gemm_layers(model, args.B, args.N)
    flops = sum(2 * r * i * o for _, r, i, o in layers) + bmm
    traced, kernels = traced_flops(model, x, compute_dtype)
    for line in kernels:
        benchutil.emit(line)
    elem = 2 if compute_dtype is not None else 4
    k_bytes = sum(k["nbytes"] for k in kernels)
    k_ops = sum(k["ops"] for k in kernels)
    nbytes = gemm_bytes(layers, elem) + k_bytes
    runs = None
    if args.forward_ms is None:
        from tumseg_torch.infer.voting import InferenceRunner

        runner = InferenceRunner(model, 8, batch_size=args.B, device=device,
                                 compute_dtype=compute_dtype)
        runs = benchutil.summary(forward_runs(runner, x, RUNS))
        ms = runs["min"]
    else:
        ms = args.forward_ms
    peak = PEAK_FLOPS[args.dtype]
    pts = args.B * args.N
    line = {
        "model": args.model, "shape": f"B{args.B}xN{args.N}",
        "dtype": args.dtype, "flops": flops, "flops_traced": traced,
        "flops_per_point": flops / pts, "bmm_flops": bmm,
        "dense_layers": len(layers), "bytes": nbytes,
        "gemm_bytes": nbytes - k_bytes, "point_kernel_bytes": k_bytes,
        "point_kernel_ops": k_ops,
        "point_kernel_bound_ms": sum(k["bound_ms"] for k in kernels),
        "forward_ms": ms, "forward_ms_measured": args.forward_ms is None,
        "forward_runs": None if runs is None else runs["runs"],
        "forward_ms_median": None if runs is None else runs["median"],
        "forward_ms_min": None if runs is None else runs["min"],
        "flops_per_s": flops / (ms / 1e3),
        "peak_flops_per_s": peak, "mfu": flops / (ms / 1e3) / peak,
        "compute_bound_ms": flops / peak * 1e3,
        "hbm_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "card_peaks": "NVIDIA H100 80GB HBM3 (SXM, 700 W)",
        "device": str(device),
    }
    return benchutil.emit(line)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
