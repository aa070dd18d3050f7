"""The differentiable point ops as ``torch.autograd.Function``s
(``tumseg/ops/pallas/group.py:146-161`` and ``interpolate.py:118-133`` are
their ``jax.custom_vjp`` counterparts). On a CUDA tensor the forward and the
backward are both hand-written kernels; on a CPU tensor, or inside
``ops.plain()``, both are the plain versions of ``tumseg_torch.ops.core``.

The implementation module (``core`` or ``kernels``) is chosen by the caller
at forward time and kept on ``ctx``: ``ops.plain()`` is thread-local, and
autograd runs a CUDA backward on a thread of its own, so it is never looked
up again in ``backward``. The wrappers of ``kernels`` refuse tensors that
require grad, so the forward hands them detached ones.

Only the features are differentiated: the centres of a group and the
indices and distances of the 3-NN depend on coordinates alone, which carry
no parameter upstream, and get no gradient, as in the JAX package.
"""

from __future__ import annotations

from types import ModuleType

import torch

from tumseg_torch.ops import core


class GroupPoints(torch.autograd.Function):
    """(idx [B, S, K] int32, src [B, N, C], new_xyz [B, S, 3]) ->
    grouped [B, S, K, C]; backward: d src by the group-backward scatter."""

    @staticmethod
    def forward(ctx, idx: torch.Tensor, src: torch.Tensor,
                new_xyz: torch.Tensor, impl: ModuleType) -> torch.Tensor:
        ctx.impl = impl
        ctx.n = src.shape[1]
        ctx.save_for_backward(idx)
        return impl.group_points(idx, src.detach(), new_xyz.detach())

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        dsrc = None
        if ctx.needs_input_grad[1]:
            dsrc = ctx.impl.group_points_backward(idx, grad.contiguous(),
                                                  ctx.n)
        return None, dsrc, None, None


class ThreeNNInterpolate(torch.autograd.Function):
    """(xyz1 [B, N, 3], xyz2 [B, S, 3], points2 [B, S, D]) -> (dists, idx,
    out [B, N, D]); dists and idx are not differentiable. Backward:
    d points2 = W^T g with the weights recomputed from the saved distances
    by the fused kernel's own formula (``core.interpolation_weights``)."""

    @staticmethod
    def forward(ctx, xyz1: torch.Tensor, xyz2: torch.Tensor,
                points2: torch.Tensor, impl: ModuleType):
        dists, idx, out = impl.three_nn_interpolate(
            xyz1.detach(), xyz2.detach(), points2.detach())
        ctx.mark_non_differentiable(dists, idx)
        ctx.impl = impl
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
                grad_out.contiguous(), ctx.s)
        return None, None, dp2, None
