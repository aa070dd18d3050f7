"""What the architectures' plain references share: seeded weights from a
list of layers, the 1x1 conv and the BatchNorm.

A conv is ``F.linear`` over the last axis in f32, TF32 off, of a weight
kept in the published models' shape (``[out, in, 1, 1]``, ``[out, in, 1]``
or a Linear's ``[out, in]``). BatchNorm is ``(x - mean) * (rsqrt(var +
eps) * weight) + bias`` over the last axis: the batch's mean and ``E[x^2]
- E[x]^2`` in training, the running statistics in eval; "calibrate" first
sets the running statistics to its own input's mean and biased variance.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
from torch.nn import functional as F

EPS = 1e-5


def make_weights(convs: Sequence[Tuple[str, int, int, int]],
                 bns: Sequence[Tuple[str, int]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Seeded weights of the convs ``(name, in, out, rank)`` and the
    BatchNorms ``(name, width)`` on ``device``, in three calls of one
    generator: conv weights N(0, 2 / (in + out)), conv biases
    U(-1/sqrt(in), 1/sqrt(in)), BatchNorm scales 1 + 0.1 N(0, 1) and
    shifts 0.1 N(0, 1); running statistics 0 and 1."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n_w = sum(i * o for _, i, o, _ in convs)
    n_b = sum(o for _, _, o, _ in convs)
    n_bn = sum(o for _, o in bns)
    w_flat = torch.randn(n_w, generator=g, device=device)
    b_flat = torch.rand(n_b, generator=g, device=device) * 2 - 1
    bn_flat = torch.randn(2 * n_bn, generator=g, device=device) * 0.1
    out, wo, bo = {}, 0, 0
    for name, i, o, rank in convs:
        w = w_flat[wo:wo + i * o].view(o, i) * math.sqrt(2.0 / (i + o))
        out[f"{name}.weight"] = w.reshape(o, i, *([1] * rank))
        out[f"{name}.bias"] = b_flat[bo:bo + o] / math.sqrt(i)
        wo, bo = wo + i * o, bo + o
    off = 0
    for name, o in bns:
        out[f"{name}.weight"] = 1.0 + bn_flat[off:off + o]
        out[f"{name}.bias"] = bn_flat[n_bn + off:n_bn + off + o].clone()
        out[f"{name}.running_mean"] = torch.zeros(o, device=device)
        out[f"{name}.running_var"] = torch.ones(o, device=device)
        out[f"{name}.num_batches_tracked"] = torch.zeros(
            (), dtype=torch.long, device=device)
        off += o
    return {k: v.contiguous() for k, v in out.items()}


def leaves(weights: Dict[str, torch.Tensor]):
    """The trainable leaves' names (every weight and bias), in order."""
    return [k for k in weights if k.endswith((".weight", ".bias"))]


def conv(weights: Dict[str, torch.Tensor], name: str,
         x: torch.Tensor) -> torch.Tensor:
    w = weights[f"{name}.weight"]
    return F.linear(x, w.reshape(w.shape[0], w.shape[1]),
                    weights[f"{name}.bias"])


def batch_norm(weights: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
               mode: str) -> torch.Tensor:
    """BatchNorm ``name`` over x's last axis; ``mode`` is "eval", "train"
    or "calibrate"."""
    weight, bias = weights[f"{name}.weight"], weights[f"{name}.bias"]
    if mode == "train":
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dim=dims)
        var = (x * x).mean(dim=dims) - mean * mean
    else:
        if mode == "calibrate":
            h = x.reshape(-1, x.shape[-1])
            weights[f"{name}.running_mean"].copy_(h.mean(dim=0))
            weights[f"{name}.running_var"].copy_(h.var(dim=0, unbiased=False))
        mean = weights[f"{name}.running_mean"]
        var = weights[f"{name}.running_var"]
    return (x - mean) * (torch.rsqrt(var + EPS) * weight) + bias
