"""The yardstick's arithmetic: the H100's peaks, the FLOPs of a PointNet++
forward and training step from the configuration's widths, and the bytes
and operations that each point-kernel launch needs, from its shapes.

Peaks: NVIDIA H100 SXM (80 GB HBM3, 700 W), dense: f32 outside the tensor
cores 67 TFLOP/s (the configurations keep TF32 off), HBM3 3.35 TB/s.

FLOPs: ``2 * rows * in * out`` a 1x1 conv; its rows are ``B * S * K`` at a
set abstraction (S centroids, K samples of a scale), ``B * N_level`` at a
feature propagation and ``B * N`` at the head. A training step adds the
weight gradient of every conv and the input gradient of every conv whose
input carries one (all but the first conv of each first-stage scale).

A launch's bound is the larger of its bytes over the HBM rate and its f32
operations over the f32 rate. Bytes count each input read once and each
output written once. Operations count only what the inputs need: FPS's 10
a point a step, a group's one subtraction an xyz output, the 3-NN's
weights and interpolation (10 a query and 5 an output element; the search
itself is data-dependent and counted as nothing), the backward passes' adds
and multiplies; a ball query counts its bytes alone.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def levels(cfg: Dict, N: int) -> List[int]:
    return [N] + [sa["npoint"] for sa in cfg["sa"]]


def widths(cfg: Dict) -> List[int]:
    """Channels of each level's features: the input, then each stage's."""
    out = [cfg["in_channels"]]
    for sa in cfg["sa"]:
        out.append(sum(m[-1] for m in sa["mlp"]))
    return out


def gemms(cfg: Dict, B: int, N: int) -> List[Tuple[str, int, int, int]]:
    """(stage, rows, in, out) of every conv of a forward at B x N."""
    lv, w = levels(cfg, N), widths(cfg)
    out = []
    for i, sa in enumerate(cfg["sa"], start=1):
        for k, mlp in zip(sa["nsample"], sa["mlp"]):
            last = w[i - 1] + 3
            for j, o in enumerate(mlp):
                out.append((f"sa{i}.{j}", B * sa["npoint"] * k, last, o))
                last = o
    for i, lvl, fp in zip((4, 3, 2, 1), (3, 2, 1, 0), cfg["fp"]):
        last = fp["in"]
        for j, o in enumerate(fp["mlp"]):
            out.append((f"fp{i}.{j}", B * lv[lvl], last, o))
            last = o
    out.append(("head.0", B * N, cfg["head"], cfg["head"]))
    out.append(("head.1", B * N, cfg["head"], cfg["num_classes"]))
    return out


def forward_flops(cfg: Dict, B: int, N: int) -> int:
    return sum(2 * r * i * o for _, r, i, o in gemms(cfg, B, N))


def step_flops(cfg: Dict, B: int, N: int) -> int:
    """Forward, weight gradients and the input gradients that are needed."""
    total = 0
    for stage, r, i, o in gemms(cfg, B, N):
        total += 2 * 2 * r * i * o
        if stage != "sa1.0":
            total += 2 * r * i * o
    return total


def _cost(kernel, nbytes, ops):
    return {"kernel": kernel, "nbytes": int(nbytes), "ops": int(ops)}


def launches(cfg: Dict, B: int, N: int, train: bool) -> List[Dict]:
    """The point-kernel launches of one forward (serving: exact gathers) or
    one training step (fast gathers, then the backward kernels)."""
    lv, w = levels(cfg, N), widths(cfg)
    gb = 2 if train else 4          # bytes of a grouped element
    out = []
    for i, sa in enumerate(cfg["sa"], start=1):
        n, s, c = lv[i - 1], sa["npoint"], w[i - 1] + 3
        out.append(_cost("fps", B * n * 12 + B * 4 + B * s * 4,
                         B * s * n * 10))
        out.append(_cost("group", 4 * (B * s + B * n * 3 + B * s * 3)
                         + B * s * 12, B * s * 3))
        ks = sa["nsample"]
        out.append(_cost("ball_query" if len(ks) == 1 else "ball_query_multi",
                         B * n * 12 + B * s * 12 + B * s * sum(ks) * 4, 0))
        for k in ks:
            out.append(_cost("group", 4 * (B * s * k + B * n * c + B * s * 3)
                             + B * s * k * c * gb, B * s * k * 3))
    fp_in = []
    d = w[-1]
    for i, lvl, fp in zip((4, 3, 2, 1), (3, 2, 1, 0), cfg["fp"]):
        n1, s = lv[lvl], lv[lvl + 1]
        out.append(_cost("three_nn_interpolate",
                         4 * (B * n1 * 3 + B * s * 3 + B * s * d + B * n1 * 6
                              + B * n1 * d), B * n1 * 10 + B * n1 * d * 5))
        fp_in.append((n1, s, d))
        d = fp["mlp"][-1]
    if train:
        for i, sa in enumerate(cfg["sa"], start=1):
            if i == 1:
                continue        # the input carries no gradient
            n, s, c = lv[i - 1], sa["npoint"], w[i - 1] + 3
            for k in sa["nsample"]:
                out.append(_cost("group_backward",
                                 4 * B * s * k + 2 * B * s * k * c
                                 + 4 * B * n * c, B * s * k * c))
        for n1, s, d in fp_in:
            out.append(_cost("interpolate_backward",
                             4 * (B * n1 * 6 + B * n1 * d + B * s * d),
                             B * n1 * 3 * d * 2))
    return out


def bound_s(costs: List[Dict]) -> float:
    """Seconds that the launches take at the least: each launch's larger of
    bytes over the HBM rate and operations over the f32 rate."""
    return sum(max(c["nbytes"] / HBM_BYTES_PER_S, c["ops"] / F32_FLOPS_PER_S)
               for c in costs)
