"""PointNet++ and PointNet layers as ``nn.Module``s, channels-last
(``tumseg/nn/layers.py:37-417``), and PointNeXt's (arXiv:2206.04670, as
openpoints builds it), which the JAX package does not have.

Weights keep the reference's conv shapes — ``[out, in, 1, 1]`` in the set
abstractions, ``[out, in, 1]`` in feature propagation and the head — so
``tools/export_torch_checkpoint.py:export_state_dict`` output and reference
``.pth`` state dicts load with ``strict=True``; PointNet's STN has Linear
``fc`` layers, ``[out, in]``. The forward is a matmul over
the last axis of a 2-D view of that weight, never a cuDNN convolution, whose
default TF32 would cost the 2e-3 log-prob parity with ``tumseg``.

``compute_dtype`` (None, or e.g. ``torch.bfloat16``) is ``tumseg``'s
compute dtype (``tumseg/nn/layers.py:62-71``, ``:147-164``): each
:class:`Dense` rounds its input and weight to it and returns f32 (an f32
accumulation, the bias added in f32), BatchNorm computes in f32, and an MLP
stores the activations between its layers in that dtype; the last layer's
output, and so the K-max of a set abstraction, stays f32. Without it every
layer computes in f32.

``fast_gather`` takes the single-pass bf16 gathers of ``tumseg_torch.ops``.
None resolves it as ``tumseg``'s layers do, to ``compute_dtype is not None``
(``tumseg/nn/layers.py:189-190``, ``:225-226``, ``:266-267``). A set
abstraction's grouped tensor is then bf16: with a compute dtype it goes to
the first ``Dense`` as it is; in f32 compute the MLP is fed
``grouped.float()``, exact, and what ``tumseg``'s ``dense`` does with a bf16
operand and f32 weights.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from tumseg_torch import ops
from tumseg_torch.parallel.mesh import psum
from tumseg_torch.utils.profiling import span


class Dense(nn.Module):
    """Pointwise linear over the last axis (the reference's 1x1 conv).

    Initialised as ``tumseg`` initialises the matching layer: ``init=
    "xavier"`` is a Xavier-normal weight, std sqrt(2/(in+out)), and a zero
    bias (``tumseg/nn/layers.py:dense_init``), the reference's Conv2d and
    Linear layers; ``"torch_default"`` is U(+-1/sqrt(fan_in)) for weight
    and bias (``dense_init_torch_default``), its Conv1d layers. The default,
    None, is "xavier" for the set abstractions' convs (``conv_rank=2``) and
    "torch_default" for the FP and head convs (``conv_rank=1``).
    ``conv_rank=0`` is a Linear's ``[out, in]`` weight. ``bias=False``
    leaves the bias out (``self.bias`` None), as PointNeXt's convs that a
    BatchNorm follows have none."""

    def __init__(self, in_dim: int, out_dim: int, conv_rank: int,
                 init: Optional[str] = None, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_dim, in_dim, *([1] * conv_rank)))
        if bias:
            self.bias = nn.Parameter(torch.empty(out_dim))
        else:
            self.register_parameter("bias", None)
        if init is None:
            init = "xavier" if conv_rank == 2 else "torch_default"
        if init == "xavier":
            std = math.sqrt(2.0 / (in_dim + out_dim))
            nn.init.normal_(self.weight, std=std)
            if bias:
                nn.init.zeros_(self.bias)
        else:
            bound = 1.0 / math.sqrt(in_dim)
            nn.init.uniform_(self.weight, -bound, bound)
            if bias:
                nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        """x [..., in] -> [..., out]. In f32, ``F.linear`` (TF32 off at the
        entry points); with a ``compute_dtype``, :class:`LowPrecisionLinear`:
        f32 output from operands rounded to that dtype."""
        w = self.weight.view(self.weight.shape[0], self.weight.shape[1])
        if compute_dtype is None:
            return F.linear(x, w, self.bias)
        return LowPrecisionLinear.apply(x, w, self.bias, compute_dtype)


def _mm_f32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ w [N, K]^T of two low-precision operands with an f32
    result. On the card, cuBLAS's GEMM with f32 accumulation and output
    (``aten::mm.dtype``); on the CPU, which has no such kernel, the f32
    product of the upcast operands: each product of two bf16 (or f16)
    values is exact in f32, so the two differ only in summation order."""
    if x.device.type == "cuda":
        return torch.mm(x, w.t(), out_dtype=torch.float32)
    return x.float() @ w.float().t()


class LowPrecisionLinear(torch.autograd.Function):
    """``tumseg``'s ``dense`` with a compute dtype and its ``jax.grad``
    (``tumseg/nn/layers.py:62-71``): x [..., in] (any float dtype), w
    [out, in] f32, b [out] f32 or None -> y [..., out] f32 =
    ``round(x) @ round(w)^T`` accumulated in f32, plus b in f32, where
    ``round`` is to ``dtype``.

    The backward is the transpose that JAX derives, not autograd's of a
    low-precision ``F.linear``: with the f32 cotangent g,
    ``dx = round(g @ round(w))`` in x's dtype, ``dw = round(g^T @ round(x))``
    as f32 and ``db = sum(g)`` in f32; both products are f32 GEMMs of the
    rounded operands (TF32 off at the entry points)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                dtype) -> torch.Tensor:
        x2 = x.reshape(-1, x.shape[-1]).to(dtype)
        w2 = w.to(dtype)
        ctx.save_for_backward(x2, w2)
        ctx.dtype, ctx.x_dtype, ctx.x_shape = dtype, x.dtype, x.shape
        y = _mm_f32_out(x2, w2)
        if b is not None:
            y.add_(b)
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x2, w2 = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = (g2 @ w2.float()).to(ctx.dtype).to(ctx.x_dtype)
            dx = dx.reshape(ctx.x_shape)
        if ctx.needs_input_grad[1]:
            dw = (g2.t() @ x2.float()).to(ctx.dtype).float()
        if ctx.needs_input_grad[2]:
            db = g2.sum(dim=0)
        return dx, dw, db, None


class BatchNorm(nn.Module):
    """Per-channel (last axis) batch norm with torch's parameter and buffer
    names and ``tumseg``'s formula (``tumseg/nn/layers.py:82-116``):
    ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias``. In train mode
    mean and var are the batch's, var = E[x^2] - E[x]^2, and the running
    stats become ``(1 - momentum) * running + momentum * batch`` with the
    unbiased batch var. ``momentum`` and ``1 - momentum`` are 0-d buffers,
    ``tumseg``'s ``jnp.float32(momentum)``: :meth:`set_momentum` fills them
    in place, so a step captured as a CUDA graph reads the value of the
    step that replays it. They are not saved in the state_dict.
    ``F.batch_norm`` computes the variance another way, so it is not used.
    In eval mode the running stats are used. It computes in f32 (f64 for an
    f64 input); ``ops.batch_norm`` runs it, on the card as the kernels of
    ``csrc/batch_norm.cu``."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        # f64, so that an f64 update reads the doubles; an f32 one rounds
        # them to f32, as it rounded the float scalars
        for name in ("momentum", "momentum_keep"):
            self.register_buffer(name, torch.tensor(0.0, dtype=torch.float64),
                                 persistent=False)
        self.set_momentum(momentum)

    def set_momentum(self, momentum: float) -> None:
        """Fills ``momentum`` and ``1 - momentum`` (computed in double) in
        place."""
        self.momentum.fill_(momentum)
        self.momentum_keep.fill_(1.0 - momentum)

    def forward(self, x: torch.Tensor, mesh=None, relu: bool = False,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """-> relu?(BatchNorm(x)) in ``dtype`` (default x's): the ReLU and
        the cast to the next layer's compute dtype fused into the
        normalisation. With a ``mesh`` (training on a sharded batch), the
        batch moments E[x] and E[x^2] are ``pmean``'d over the ranks and
        the unbiased variance counts ``n * size`` values, as ``tumseg``'s
        ``axis_name`` does."""
        if self.training:
            with torch.no_grad():
                self.num_batches_tracked += 1
        return ops.batch_norm(x, self.weight, self.bias, self.running_mean,
                              self.running_var, self.momentum,
                              self.momentum_keep, self.eps, self.training,
                              mesh=mesh, relu=relu, dtype=dtype)


@torch.no_grad()
def calibrate_batch_norm(model: nn.Module, x: torch.Tensor) -> None:
    """Set every BatchNorm's running mean and (biased) variance to those of
    its own input during one eval forward of ``x``. Seeded random weights
    then give an output that depends on the input, instead of the near
    constant one that vanishing activations give. A BatchNorm over [B, C]
    (the STN's after its max over the points) keeps its statistics: there
    a channel's B values, one a block, lie close together against their
    mean, and dividing by their spread would make the output hang on the
    last bits of its input."""
    def hook(bn, args):
        if args[0].dim() == 2:
            return
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


def _mlp_layers(in_dim: int, dims: Sequence[int], conv_rank: int,
                bias: bool = True):
    """-> (convs, bns): the ModuleLists of a [Dense -> BatchNorm] * L stack."""
    convs, bns = nn.ModuleList(), nn.ModuleList()
    last = in_dim
    for out in dims:
        convs.append(Dense(last, out, conv_rank, bias=bias))
        bns.append(BatchNorm(out))
        last = out
    return convs, bns


def _run_mlp(convs: nn.ModuleList, bns: nn.ModuleList, x: torch.Tensor,
             compute_dtype=None, mesh=None) -> torch.Tensor:
    """[Dense -> BatchNorm -> ReLU] * L; with a ``compute_dtype`` the
    activations between layers are stored in it (the next ``Dense`` would
    round them anyway) and the last layer's output stays f32. ``mesh``
    goes to every BatchNorm."""
    last = len(convs) - 1
    for i, (conv, bn) in enumerate(zip(convs, bns)):
        x = bn(conv(x, compute_dtype), mesh, relu=True,
               dtype=compute_dtype if i < last else None)
    return x


class MLPStack(nn.Module):
    """[Dense -> BatchNorm -> ReLU] * L over the last axis, with the
    reference's ``mlp_convs.j`` / ``mlp_bns.j`` names; ``bias=False``
    leaves the convs' biases out."""

    def __init__(self, in_dim: int, dims: Sequence[int], conv_rank: int,
                 bias: bool = True):
        super().__init__()
        self.mlp_convs, self.mlp_bns = _mlp_layers(in_dim, dims, conv_rank,
                                                   bias)

    def mlp(self, x: torch.Tensor, compute_dtype=None,
            mesh=None) -> torch.Tensor:
        return _run_mlp(self.mlp_convs, self.mlp_bns, x, compute_dtype, mesh)


def _mlp_input(grouped: torch.Tensor, compute_dtype) -> torch.Tensor:
    """A grouped tensor as an MLP's input: as it is with a compute dtype
    (the first ``Dense`` rounds it), else f32."""
    return grouped if compute_dtype is not None else grouped.float()


class SetAbstraction(MLPStack):
    """SSG set abstraction: xyz [B, N, 3], points [B, N, D] ->
    (new_xyz [B, npoint, 3], new_points [B, npoint, mlp[-1]]); the shared
    MLP runs on the [B, npoint, nsample, 3 + D] groups, then max over K.
    ``group_all`` (``tumseg/nn/layers.py:186-187``) groups every point
    under one centroid at the origin instead (``ops.sample_and_group_all``:
    npoint 1, nsample N); no model sets it."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_channel: int, mlp: Sequence[int],
                 group_all: bool = False):
        super().__init__(in_channel, mlp, conv_rank=2)
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all = group_all

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                fps_start: Optional[torch.Tensor] = None,
                fast_gather: Optional[bool] = None, compute_dtype=None,
                mesh=None):
        """``fps_start`` [B] int32 seeds FPS (default index 0). The max over
        K is ``amax``, which splits the gradient evenly among tied entries,
        as ``jnp.max`` does: a short ball repeats its first hit, so ties
        are the rule. ``mesh`` goes to the BatchNorms."""
        if self.group_all:
            new_xyz, grouped = ops.sample_and_group_all(xyz, points)
        else:
            if fast_gather is None:
                fast_gather = compute_dtype is not None
            new_xyz, grouped = ops.sample_and_group(
                self.npoint, self.radius, self.nsample, xyz, points,
                fps_start=fps_start, fast_gather=fast_gather)
        feat = self.mlp(_mlp_input(grouped, compute_dtype), compute_dtype,
                        mesh)
        return new_xyz, feat.amax(dim=2)


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
                fast_gather: Optional[bool] = None, compute_dtype=None,
                mesh=None):
        """``fps_start`` [B] int32 seeds FPS (default index 0); ``mesh``
        goes to the BatchNorms."""
        if fast_gather is None:
            fast_gather = compute_dtype is not None
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
            outs.append(_run_mlp(convs, bns,
                                 _mlp_input(grouped, compute_dtype),
                                 compute_dtype, mesh).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class FeaturePropagation(MLPStack):
    """3-NN inverse-distance interpolation of points2 onto xyz1, skip
    concat with points1, then the pointwise MLP (its convs without bias
    with ``bias=False``, as PointNeXt's decoder has them)."""

    def __init__(self, in_channel: int, mlp: Sequence[int],
                 bias: bool = True):
        super().__init__(in_channel, mlp, conv_rank=1, bias=bias)

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor,
                points1: Optional[torch.Tensor], points2: torch.Tensor,
                fast_gather: Optional[bool] = None,
                compute_dtype=None, mesh=None) -> torch.Tensor:
        if fast_gather is None:
            fast_gather = compute_dtype is not None
        if xyz2.shape[1] == 1:
            interpolated = points2.expand(-1, xyz1.shape[1], -1)
        else:
            interpolated = ops.three_interpolate(xyz1, xyz2, points2,
                                                 fast_gather)
        if points1 is not None:
            interpolated = torch.cat([points1, interpolated], dim=-1)
        return self.mlp(interpolated, compute_dtype, mesh)


class GroupedConv(nn.Module):
    """PointNeXt's conv over grouped neighbourhoods (openpoints'
    ``LocalAggregation`` and ``SetAbstraction`` with ``feature_type:
    dp_fj``, ``normalize_dp: True`` and the max): :meth:`reduce` takes a
    group ``[p_j - p_i, f_j]`` to ``[(p_j - p_i) / radius, f_j]``, then one
    ``Dense`` ``in + 3 -> out`` without bias, BatchNorm, ReLU and the max
    over K. :class:`LocalAggregation` and
    :class:`PointNeXtSetAbstraction` differ in the group they give it.

    The offsets are divided by the radius as f32 (a 0-d f32 buffer, so the
    card divides too: a Python float divisor would be a multiply by its
    reciprocal there), after the group, in place on the MLP's f32 input."""

    def __init__(self, in_channel: int, out_channel: int, radius: float,
                 nsample: int):
        super().__init__()
        self.radius, self.nsample = radius, nsample
        self.conv = Dense(in_channel + 3, out_channel, conv_rank=2,
                          init="torch_default", bias=False)
        self.bn = BatchNorm(out_channel)
        self.register_buffer("divisor", torch.tensor(float(radius)),
                             persistent=False)

    def reduce(self, grouped: torch.Tensor, compute_dtype,
               mesh) -> torch.Tensor:
        """[B, S, K, 3 + in] (centred offsets first) -> [B, S, out] f32."""
        g = grouped.float()     # a copy where fast gathers stored bf16
        g[..., :3].div_(self.divisor)
        h = self.bn(self.conv(g, compute_dtype), mesh, relu=True)
        return h.amax(dim=2)


class LocalAggregation(GroupedConv):
    """PointNeXt's local aggregation on a level's own points: around each
    point, the first ``nsample`` of the level's points within ``radius``
    (``ops.ball_group``), then :meth:`GroupedConv.reduce`: xyz [B, N, 3],
    points [B, N, in] -> [B, N, out] f32. Under a profiler each call is
    the span ``tumseg.model.aggregate``."""

    def forward(self, xyz: torch.Tensor, points: torch.Tensor,
                fast_gather: Optional[bool] = None, compute_dtype=None,
                mesh=None) -> torch.Tensor:
        if fast_gather is None:
            fast_gather = compute_dtype is not None
        with span("tumseg.model.aggregate"):
            grouped = ops.ball_group(self.radius, self.nsample, xyz, xyz,
                                     torch.cat([xyz, points], dim=-1),
                                     fast_gather)
            return self.reduce(grouped, compute_dtype, mesh)


class PointNeXtSetAbstraction(GroupedConv):
    """PointNeXt's strided set abstraction (openpoints' ``SetAbstraction``
    with one conv): FPS keeps N // ``stride`` points, the ball of
    ``radius`` around them over the level's points
    (``ops.sample_and_group``), then :meth:`GroupedConv.reduce`: xyz
    [B, N, 3], points [B, N, in] -> (new_xyz [B, N // stride, 3],
    new_points [B, N // stride, out]). Under a profiler each call is the
    span ``tumseg.model.aggregate``."""

    def __init__(self, stride: int, in_channel: int, out_channel: int,
                 radius: float, nsample: int):
        super().__init__(in_channel, out_channel, radius, nsample)
        self.stride = stride

    def forward(self, xyz: torch.Tensor, points: torch.Tensor,
                fps_start: Optional[torch.Tensor] = None,
                fast_gather: Optional[bool] = None, compute_dtype=None,
                mesh=None):
        """``fps_start`` [B] int32 seeds FPS (default index 0)."""
        if fast_gather is None:
            fast_gather = compute_dtype is not None
        with span("tumseg.model.aggregate"):
            new_xyz, grouped = ops.sample_and_group(
                xyz.shape[1] // self.stride, self.radius, self.nsample, xyz,
                points, fps_start=fps_start, fast_gather=fast_gather)
            return new_xyz, self.reduce(grouped, compute_dtype, mesh)


class InvResMLP(nn.Module):
    """PointNeXt's inverted residual block (openpoints' ``InvResMLP``,
    ``use_res``, two pointwise convs) on a level's own points: ``g`` the
    :class:`LocalAggregation` of radius ``radius`` around every point
    (``C -> C``), then ``relu(bn2(pw2(relu(bn1(pw1(g))))) + f)`` with
    ``pw1`` C -> ``expansion`` C and ``pw2`` back, neither with a bias;
    ``bn2`` has no ReLU of its own, the ReLU follows the residual add.
    With a ``compute_dtype`` the expanded activation is stored in it; the
    block's output stays f32. Under a profiler each call is the span
    ``tumseg.model.block``."""

    def __init__(self, channels: int, radius: float, nsample: int,
                 expansion: int):
        super().__init__()
        mid = channels * expansion
        self.aggr = LocalAggregation(channels, channels, radius, nsample)
        self.pw1 = Dense(channels, mid, conv_rank=1, bias=False)
        self.bn1 = BatchNorm(mid)
        self.pw2 = Dense(mid, channels, conv_rank=1, bias=False)
        self.bn2 = BatchNorm(channels)

    def forward(self, xyz: torch.Tensor, points: torch.Tensor,
                fast_gather: Optional[bool] = None, compute_dtype=None,
                mesh=None) -> torch.Tensor:
        with span("tumseg.model.block"):
            h = self.aggr(xyz, points, fast_gather=fast_gather,
                          compute_dtype=compute_dtype, mesh=mesh)
            h = self.bn1(self.pw1(h, compute_dtype), mesh, relu=True,
                         dtype=compute_dtype)
            h = self.bn2(self.pw2(h, compute_dtype), mesh)
            return F.relu(h + points)


class STN(nn.Module):
    """The reference's STN3d (``k=3``) and STNkd (``k=64``)
    (``tumseg/nn/layers.py:283-334``): x [B, N, channel] -> a transform
    [B, k, k]. conv1-3 (Conv1d, torch's default init) with bn1-3 and ReLU,
    the max over N, fc1-2 (Linear, Xavier-normal) with bn4-5 and ReLU,
    then fc3 plus the identity. With a ``compute_dtype`` each ``Dense``
    rounds its operands and returns f32, as in ``tumseg``; the conv
    activations that only a ``Dense`` reads are stored in it, and the one
    the max reads stays f32."""

    def __init__(self, channel: int, k: int):
        super().__init__()
        self.k = k
        self.conv1 = Dense(channel, 64, conv_rank=1)
        self.conv2 = Dense(64, 128, conv_rank=1)
        self.conv3 = Dense(128, 1024, conv_rank=1)
        self.fc1 = Dense(1024, 512, conv_rank=0, init="xavier")
        self.fc2 = Dense(512, 256, conv_rank=0, init="xavier")
        self.fc3 = Dense(256, k * k, conv_rank=0, init="xavier")
        for i, dim in enumerate([64, 128, 1024, 512, 256], start=1):
            setattr(self, f"bn{i}", BatchNorm(dim))

    def forward(self, x: torch.Tensor, compute_dtype=None,
                mesh=None) -> torch.Tensor:
        h = self.bn1(self.conv1(x, compute_dtype), mesh, relu=True,
                     dtype=compute_dtype)
        h = self.bn2(self.conv2(h, compute_dtype), mesh, relu=True,
                     dtype=compute_dtype)
        h = self.bn3(self.conv3(h, compute_dtype), mesh,
                     relu=True).amax(dim=1)
        h = self.bn4(self.fc1(h, compute_dtype), mesh, relu=True)
        h = self.bn5(self.fc2(h, compute_dtype), mesh, relu=True)
        h = self.fc3(h, compute_dtype)
        iden = torch.eye(self.k, dtype=h.dtype, device=h.device)
        return (h + iden.reshape(1, -1)).view(-1, self.k, self.k)


class PointNetEncoder(nn.Module):
    """The PointNet encoder (``tumseg/nn/layers.py:337-407``): x [B, N, C]
    (3 coordinates, then C - 3 more channels) -> (features, trans [B, 3,
    3], trans_feat [B, 64, 64] or None). The coordinates go through the
    STN's 3 x 3 transform (an f32 ``bmm``), conv1/bn1/ReLU gives the 64
    point features, which go through the 64 x 64 feature transform when
    ``feature_transform``; conv2/bn2/ReLU and conv3/bn3, with no ReLU, then
    the max over N. ``features`` is [B, 1024] when ``global_feat``, else
    [B, N, 1088]: the global 1024 at every point, then the point features.

    Both transforms and the point features stay f32 under a
    ``compute_dtype``, as in ``tumseg``, where only a ``Dense`` rounds."""

    def __init__(self, channel: int, global_feat: bool = True,
                 feature_transform: bool = False):
        super().__init__()
        self.global_feat = global_feat
        self.feature_transform = feature_transform
        self.stn = STN(channel, 3)
        self.conv1 = Dense(channel, 64, conv_rank=1)
        self.conv2 = Dense(64, 128, conv_rank=1)
        self.conv3 = Dense(128, 1024, conv_rank=1)
        self.bn1 = BatchNorm(64)
        self.bn2 = BatchNorm(128)
        self.bn3 = BatchNorm(1024)
        if feature_transform:
            self.fstn = STN(64, 64)

    def forward(self, x: torch.Tensor, compute_dtype=None, mesh=None):
        B, N, D = x.shape
        trans = self.stn(x, compute_dtype, mesh)
        h = torch.bmm(x[..., :3], trans)
        if D > 3:
            h = torch.cat([h, x[..., 3:]], dim=-1)
        h = self.bn1(self.conv1(h, compute_dtype), mesh, relu=True)
        trans_feat = None
        if self.feature_transform:
            trans_feat = self.fstn(h, compute_dtype, mesh)
            h = torch.bmm(h, trans_feat)
        pointfeat = h
        h = self.bn2(self.conv2(h, compute_dtype), mesh, relu=True,
                     dtype=compute_dtype)
        g = self.bn3(self.conv3(h, compute_dtype), mesh).amax(dim=1)
        if self.global_feat:
            return g, trans, trans_feat
        return (torch.cat([g[:, None, :].expand(B, N, -1), pointfeat],
                          dim=-1), trans, trans_feat)


def feature_transform_regularizer(trans: torch.Tensor) -> torch.Tensor:
    """mean over the batch of ||A A^T - I||_F, A = trans [B, d, d]
    (``tumseg/nn/layers.py:410-417``), in f32."""
    eye = torch.eye(trans.shape[1], dtype=trans.dtype, device=trans.device)
    gram = torch.bmm(trans, trans.transpose(1, 2))
    return (gram - eye).square().sum(dim=(1, 2)).sqrt().mean()


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """The heads' dropout: each entry kept with probability 1 - ``rate``
    (one uniform draw from ``generator`` an entry) and scaled by
    1 / (1 - rate), the others 0."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def weighted_nll_loss(log_probs: torch.Tensor, target: torch.Tensor,
                      weight: torch.Tensor, mesh=None) -> torch.Tensor:
    """``F.nll_loss(weight=...)``: sum(w[t] * -logp[t]) / sum(w[t]) over
    log_probs [M, C], target [M] (``tumseg/nn/layers.py:423-439``). With a
    ``mesh`` the numerator and the denominator are ``psum``'d, so a sharded
    batch gives the global loss on every rank."""
    if mesh is None:
        return F.nll_loss(log_probs, target.long(), weight=weight)
    target = target.long()
    w = weight[target]
    picked = log_probs.gather(1, target[:, None])[:, 0]
    return -psum((w * picked).sum(), mesh) / psum(w.sum(), mesh)
