"""The differentiable point ops as ``torch.autograd.Function``s
(``tumseg/ops/pallas/group.py:146-161``, ``interpolate.py:118-133`` and
``fusedgroup.py:320-346`` are their ``jax.custom_vjp`` counterparts). On a
CUDA tensor the forward and the backward are both hand-written kernels; on
a CPU tensor, or inside ``ops.plain()``, both are the plain versions of
``tumseg_torch.ops.core``.

The implementation module (``core`` or ``kernels``) is chosen by the caller
at forward time and kept on ``ctx``: ``ops.plain()`` is thread-local, and
autograd runs a CUDA backward on a thread of its own, so it is never looked
up again in ``backward``; so is ``fast``, the single-pass bf16 mode, which
the backward takes as its forward took it. The wrappers of ``kernels``
refuse tensors that require grad, so the forward hands them detached ones.

Only the features are differentiated: the centres of a group and the
indices and distances of the 3-NN depend on coordinates alone, which carry
no parameter upstream, and get no gradient, as in the JAX package.

:class:`BatchNormReLU` is BatchNorm (+ ReLU) on the card alone: the CPU and
``ops.plain()`` run ``core.batch_norm`` under autograd.
"""

from __future__ import annotations

from types import ModuleType
from typing import Optional

import torch

from tumseg_torch.ops import core, kernels


class GroupPoints(torch.autograd.Function):
    """(idx [B, S, K] int32, src [B, N, C], new_xyz [B, S, 3]) ->
    grouped [B, S, K, C] (bf16 when ``fast``); backward: d src by the
    group-backward scatter, which takes the bf16 cotangent as it comes."""

    @staticmethod
    def forward(ctx, idx: torch.Tensor, src: torch.Tensor,
                new_xyz: torch.Tensor, impl: ModuleType,
                fast: bool = False) -> torch.Tensor:
        ctx.impl = impl
        ctx.fast = fast
        ctx.n = src.shape[1]
        ctx.save_for_backward(idx)
        return impl.group_points(idx, src.detach(), new_xyz.detach(),
                                 fast=fast)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        dsrc = None
        if ctx.needs_input_grad[1]:
            dsrc = ctx.impl.group_points_backward(idx, grad.contiguous(),
                                                  ctx.n, fast=ctx.fast)
        return None, dsrc, None, None, None


class FusedBallGroup(torch.autograd.Function):
    """(xyz [B, N, 3], new_xyz [B, S, 3], src [B, N, C]) -> (grouped
    [B, S, K, C], idx [B, S, K] int32): ball query and group in one op; idx
    is not differentiable. Backward: d src by the group-backward scatter on
    the idx it chose, as ``fusedgroup.py:331-342`` does."""

    @staticmethod
    def forward(ctx, xyz: torch.Tensor, new_xyz: torch.Tensor,
                src: torch.Tensor, impl: ModuleType, radius: float,
                nsample: int, fast: bool = False):
        grouped, idx = impl.fused_ball_group(
            radius, nsample, xyz.detach(), new_xyz.detach(), src.detach(),
            fast=fast)
        ctx.mark_non_differentiable(idx)
        ctx.impl = impl
        ctx.fast = fast
        ctx.n = src.shape[1]
        ctx.save_for_backward(idx)
        return grouped, idx

    @staticmethod
    def backward(ctx, grad: torch.Tensor, grad_idx):
        (idx,) = ctx.saved_tensors
        dsrc = None
        if ctx.needs_input_grad[2]:
            dsrc = ctx.impl.group_points_backward(idx, grad.contiguous(),
                                                  ctx.n, fast=ctx.fast)
        return None, None, dsrc, None, None, None, None


class ThreeNNInterpolate(torch.autograd.Function):
    """(xyz1 [B, N, 3], xyz2 [B, S, 3], points2 [B, S, D]) -> (dists, idx,
    out [B, N, D]); dists and idx are not differentiable. ``window`` None
    takes the direct-form 3-NN, a width the z-window 3-NN of ``n_tile``
    queries a tile (``threenn.py:376-393`` is its zero coordinate VJP).
    Backward: d points2 = W^T g with the weights recomputed from the saved
    distances by the fused kernels' own formula
    (``core.interpolation_weights``), whichever 3-NN ran; ``fast`` rounds
    the weights and points2 (or g) to bf16 in both passes."""

    @staticmethod
    def forward(ctx, xyz1: torch.Tensor, xyz2: torch.Tensor,
                points2: torch.Tensor, impl: ModuleType,
                window: Optional[int] = None, n_tile: int = 256,
                fast: bool = False):
        args = (xyz1.detach(), xyz2.detach(), points2.detach())
        if window is None:
            dists, idx, out = impl.three_nn_interpolate(*args, fast=fast)
        else:
            dists, idx, out = impl.three_nn_window_interpolate(
                *args, window, n_tile, fast=fast)
        ctx.mark_non_differentiable(dists, idx)
        ctx.impl = impl
        ctx.fast = fast
        ctx.window = window
        ctx.s = xyz2.shape[1]
        ctx.save_for_backward(dists, idx)
        return dists, idx, out

    @staticmethod
    def backward(ctx, grad_dists, grad_idx, grad_out: torch.Tensor):
        dists, idx = ctx.saved_tensors
        dp2 = None
        if ctx.needs_input_grad[2]:
            dp2 = ctx.impl.interpolate_backward(
                idx, core.interpolation_weights(dists),
                grad_out.contiguous(), ctx.s, fast=ctx.fast)
        return None, None, dp2, None, None, None, None


class BatchNormReLU(torch.autograd.Function):
    """``core.batch_norm`` without a mesh, bitwise it and autograd's
    gradients of it, on the kernels of csrc/batch_norm.cu: x [..., C] f32
    (CUDA), weight, bias and the running stats [C] f32 -> y [..., C] in
    ``dtype`` (f32 or bf16). The statistics and every sum over the rows are
    PyTorch's reductions, as in ``core.batch_norm`` and its autograd: in
    training mean = E[x], var = E[x * x] - mean * mean, and the running
    stats are updated by ``core.update_running_stats``; in eval the running
    stats are used. ``kernels.bn_apply`` computes y.

    Backward, from the saved x (no y, no mask): ``kernels.
    bn_backward_terms`` forms the three tensors that autograd sums, their
    sums are ``torch.sum``'s, ``core.batch_norm_grads`` runs autograd's [C]
    ops, and in training ``kernels.bn_backward_dx`` adds x's four gradient
    parts in the engine's order (in eval x's gradient is gz * inv). The
    cotangent comes in y's dtype."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, running_mean: torch.Tensor,
                running_var: torch.Tensor, momentum: torch.Tensor,
                momentum_keep: torch.Tensor, eps: float, training: bool,
                relu: bool, dtype: torch.dtype) -> torch.Tensor:
        x = x.detach()
        weight, bias = weight.detach(), bias.detach()
        dims = tuple(range(x.dim() - 1))
        n = x.numel() // x.shape[-1]
        if training:
            mean = x.mean(dim=dims)
            var = (x * x).mean(dim=dims) - mean * mean
            core.update_running_stats(running_mean, running_var, momentum,
                                      momentum_keep, mean, var, n)
        else:
            mean, var = running_mean, running_var
        r = torch.rsqrt(var + eps)
        inv = r * weight
        x2 = x.reshape(n, x.shape[-1])
        y = kernels.bn_apply(x2, mean, inv, bias, relu, dtype)
        ctx.save_for_backward(x2, mean, r, weight, inv, bias)
        ctx.training, ctx.relu, ctx.x_shape = training, relu, x.shape
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x2, mean, r, weight, inv, bias = ctx.saved_tensors
        shape = ctx.x_shape
        dims = tuple(range(len(shape) - 1))
        terms = kernels.bn_backward_terms(g.reshape(x2.shape).contiguous(),
                                          x2, mean, inv, bias, ctx.relu)
        sums = [t.view(shape).sum(dim=dims) for t in terms]
        dweight, dbias, ks, kmu = core.batch_norm_grads(
            sums, mean, r, weight, x2.shape[0], ctx.training)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = terms[2] if ks is None else kernels.bn_backward_dx(
                terms[2], x2, ks, kmu)
            dx = dx.view(shape)
        return (dx, dweight, dbias) + (None,) * 8
