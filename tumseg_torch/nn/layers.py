"""PointNet++ layers as ``nn.Module``s, channels-last
(``tumseg/nn/layers.py:37-276``).

Weights keep the reference's conv shapes — ``[out, in, 1, 1]`` in the set
abstractions, ``[out, in, 1]`` in feature propagation and the head — so
``tools/export_torch_checkpoint.py:export_state_dict`` output and reference
``.pth`` state dicts load with ``strict=True``. The forward is a matmul over
the last axis of a 2-D view of that weight, never a cuDNN convolution, whose
default TF32 would cost the 2e-3 log-prob parity with ``tumseg``.

``fast_gather`` (default False, as ``tumseg``'s layers resolve it without a
``compute_dtype``) takes the single-pass bf16 gathers of ``tumseg_torch.ops``.
A set abstraction's grouped tensor is then bf16, and its MLP is fed
``grouped.float()``: exact, and what ``tumseg``'s ``dense`` does with a bf16
operand and f32 weights (``tumseg/nn/layers.py:62-71``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from tumseg_torch import ops


class Dense(nn.Module):
    """Pointwise linear over the last axis (the reference's 1x1 conv).

    Initialised as ``tumseg`` initialises the matching layer: the set
    abstractions' convs (``conv_rank=2``, the reference's Conv2d) get a
    Xavier-normal weight, std sqrt(2/(in+out)), and a zero bias
    (``tumseg/nn/layers.py:dense_init``); the FP and head convs
    (``conv_rank=1``, Conv1d) keep torch's default, U(+-1/sqrt(fan_in)) for
    weight and bias (``dense_init_torch_default``)."""

    def __init__(self, in_dim: int, out_dim: int, conv_rank: int):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_dim, in_dim, *([1] * conv_rank)))
        self.bias = nn.Parameter(torch.empty(out_dim))
        if conv_rank == 2:
            std = math.sqrt(2.0 / (in_dim + out_dim))
            nn.init.normal_(self.weight, std=std)
            nn.init.zeros_(self.bias)
        else:
            bound = 1.0 / math.sqrt(in_dim)
            nn.init.uniform_(self.weight, -bound, bound)
            nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.view(self.weight.shape[0], self.weight.shape[1])
        return F.linear(x, w, self.bias)


class BatchNorm(nn.Module):
    """Per-channel (last axis) batch norm with torch's parameter and buffer
    names and ``tumseg``'s formula (``tumseg/nn/layers.py:82-116``):
    ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias``. In train mode
    mean and var are the batch's, var = E[x^2] - E[x]^2, and the running
    stats become ``(1 - momentum) * running + momentum * batch`` with the
    unbiased batch var; the training engine sets ``momentum`` each step.
    ``F.batch_norm`` computes the variance another way, so it is not used.
    In eval mode the running stats are used."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            return (x - self.running_mean) * inv + self.bias
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dim=dims)
        var = (x * x).mean(dim=dims) - mean * mean
        n = x.numel() // x.shape[-1]
        with torch.no_grad():
            m = self.momentum
            unbiased = var * (n / max(n - 1, 1))
            self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1.0 - m) * self.running_var + m * unbiased)
            self.num_batches_tracked += 1
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * inv + self.bias


@torch.no_grad()
def calibrate_batch_norm(model: nn.Module, x: torch.Tensor) -> None:
    """Set every BatchNorm's running mean and (biased) variance to those of
    its own input during one eval forward of ``x``. Seeded random weights
    then give an output that depends on the input, instead of the near
    constant one that vanishing activations give."""
    def hook(bn, args):
        h = args[0].reshape(-1, args[0].shape[-1])
        bn.running_mean.copy_(h.mean(dim=0))
        bn.running_var.copy_(h.var(dim=0, unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BatchNorm)]
    try:
        model(x)
    finally:
        for h in handles:
            h.remove()


def _mlp_layers(in_dim: int, dims: Sequence[int], conv_rank: int):
    """-> (convs, bns): the ModuleLists of a [Dense -> BatchNorm] * L stack."""
    convs, bns = nn.ModuleList(), nn.ModuleList()
    last = in_dim
    for out in dims:
        convs.append(Dense(last, out, conv_rank))
        bns.append(BatchNorm(out))
        last = out
    return convs, bns


def _run_mlp(convs: nn.ModuleList, bns: nn.ModuleList,
             x: torch.Tensor) -> torch.Tensor:
    for conv, bn in zip(convs, bns):
        x = F.relu(bn(conv(x)))
    return x


class MLPStack(nn.Module):
    """[Dense -> BatchNorm -> ReLU] * L over the last axis, with the
    reference's ``mlp_convs.j`` / ``mlp_bns.j`` names."""

    def __init__(self, in_dim: int, dims: Sequence[int], conv_rank: int):
        super().__init__()
        self.mlp_convs, self.mlp_bns = _mlp_layers(in_dim, dims, conv_rank)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        return _run_mlp(self.mlp_convs, self.mlp_bns, x)


class SetAbstraction(MLPStack):
    """SSG set abstraction: xyz [B, N, 3], points [B, N, D] ->
    (new_xyz [B, npoint, 3], new_points [B, npoint, mlp[-1]]); the shared
    MLP runs on the [B, npoint, nsample, 3 + D] groups, then max over K."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_channel: int, mlp: Sequence[int]):
        super().__init__(in_channel, mlp, conv_rank=2)
        self.npoint, self.radius, self.nsample = npoint, radius, nsample

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                fps_start: Optional[torch.Tensor] = None,
                fast_gather: bool = False):
        """``fps_start`` [B] int32 seeds FPS (default index 0). The max over
        K is ``amax``, which splits the gradient evenly among tied entries,
        as ``jnp.max`` does: a short ball repeats its first hit, so ties
        are the rule."""
        new_xyz, grouped = ops.sample_and_group(
            self.npoint, self.radius, self.nsample, xyz, points,
            fps_start=fps_start, fast_gather=fast_gather)
        return new_xyz, self.mlp(grouped.float()).amax(dim=2)


class SetAbstractionMsg(nn.Module):
    """MSG set abstraction (``tumseg/nn/layers.py:201-245``): one FPS, then
    per radius a ball query, group, shared MLP and max over K, the scales
    concatenated on channels: xyz [B, N, 3], points [B, N, D] ->
    (new_xyz [B, npoint, 3], new_points [B, npoint, sum(mlp[-1])]).

    Each scale's MLP takes ``in_channel + 3`` channels in the reference's
    MSG order ``[points, centred xyz]`` and has the reference's
    ``conv_blocks.s.j`` / ``bn_blocks.s.j`` names."""

    def __init__(self, npoint: int, radius_list: Sequence[float],
                 nsample_list: Sequence[int], in_channel: int,
                 mlp_list: Sequence[Sequence[int]]):
        super().__init__()
        self.npoint = npoint
        self.radius_list = list(radius_list)
        self.nsample_list = list(nsample_list)
        self.conv_blocks, self.bn_blocks = nn.ModuleList(), nn.ModuleList()
        for mlp in mlp_list:
            convs, bns = _mlp_layers(in_channel + 3, mlp, conv_rank=2)
            self.conv_blocks.append(convs)
            self.bn_blocks.append(bns)

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                fps_start: Optional[torch.Tensor] = None,
                fast_gather: bool = False):
        """``fps_start`` [B] int32 seeds FPS (default index 0)."""
        new_xyz = ops.gather_rows(xyz, ops.farthest_point_sample(
            xyz, self.npoint, start=fps_start))
        src = torch.cat([xyz, points], dim=-1) if points is not None else xyz
        groups = ops.msg_ball_groups(self.radius_list, self.nsample_list,
                                     xyz, new_xyz, src, fast_gather)
        outs = []
        for grouped, convs, bns in zip(groups, self.conv_blocks,
                                       self.bn_blocks):
            if points is not None:  # [centred xyz, points] -> [points, xyz]
                grouped = torch.cat([grouped[..., 3:], grouped[..., :3]],
                                    dim=-1)
            outs.append(_run_mlp(convs, bns, grouped.float()).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class FeaturePropagation(MLPStack):
    """3-NN inverse-distance interpolation of points2 onto xyz1, skip
    concat with points1, then the pointwise MLP."""

    def __init__(self, in_channel: int, mlp: Sequence[int]):
        super().__init__(in_channel, mlp, conv_rank=1)

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor,
                points1: Optional[torch.Tensor], points2: torch.Tensor,
                fast_gather: bool = False) -> torch.Tensor:
        if xyz2.shape[1] == 1:
            interpolated = points2.expand(-1, xyz1.shape[1], -1)
        else:
            interpolated = ops.three_interpolate(xyz1, xyz2, points2,
                                                 fast_gather)
        if points1 is not None:
            interpolated = torch.cat([points1, interpolated], dim=-1)
        return self.mlp(interpolated)
