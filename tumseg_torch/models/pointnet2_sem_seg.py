"""PointNet++ (SSG) semantic segmentation
(``tumseg/models/pointnet2_sem_seg.py``): four set abstractions
(1024/256/64/16 centroids, radius .1/.2/.4/.8, K=32), four feature
propagations and a Conv(128)-BN-ReLU-Dropout(.5)-Conv(num_classes)-
log_softmax head, trained with the weighted NLL loss."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from tumseg_torch.nn.layers import (BatchNorm, Dense, FeaturePropagation,
                                    SetAbstraction, dropout,
                                    weighted_nll_loss)

SA_CFGS = [
    dict(npoint=1024, radius=0.1, nsample=32, mlp=[32, 32, 64]),
    dict(npoint=256, radius=0.2, nsample=32, mlp=[64, 64, 128]),
    dict(npoint=64, radius=0.4, nsample=32, mlp=[128, 128, 256]),
    dict(npoint=16, radius=0.8, nsample=32, mlp=[256, 256, 512]),
]
FP_CFGS = [
    dict(in_channel=768, mlp=[256, 256]),       # fp4
    dict(in_channel=384, mlp=[256, 256]),       # fp3
    dict(in_channel=320, mlp=[256, 128]),       # fp2
    dict(in_channel=128, mlp=[128, 128, 128]),  # fp1
]
DROPOUT_RATE = 0.5


class PointNet2SemSeg(nn.Module):
    fp_cfgs = FP_CFGS

    def __init__(self, num_classes: int, num_extra_features: int = 0):
        super().__init__()
        self.add_set_abstractions(6 + num_extra_features)
        for i, cfg in zip([4, 3, 2, 1], self.fp_cfgs):
            setattr(self, f"fp{i}",
                    FeaturePropagation(cfg["in_channel"], cfg["mlp"]))
        self.conv1 = Dense(128, 128, conv_rank=1)
        self.bn1 = BatchNorm(128)
        self.conv2 = Dense(128, num_classes, conv_rank=1)

    def add_set_abstractions(self, in_ch: int) -> None:
        """Registers ``sa1``..``sa4`` for ``in_ch`` input channels."""
        in_ch += 3
        for i, cfg in enumerate(SA_CFGS, start=1):
            setattr(self, f"sa{i}", SetAbstraction(
                cfg["npoint"], cfg["radius"], cfg["nsample"], in_ch,
                cfg["mlp"]))
            in_ch = cfg["mlp"][-1] + 3

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                fast_gather: Optional[bool] = None, compute_dtype=None,
                mesh=None):
        """x [B, N, 6 + extra] f32 (cols 0-2 block-relative xyz, 3-5
        room-normalized xyz, then extra features) ->
        (log_probs [B, N, num_classes], l4_points [B, 16, sa4's width]).

        With a ``generator`` (on x's device) in train mode, each stage's FPS
        starts at a drawn index in [0, N_stage) and dropout 0.5 follows the
        head's ReLU, as ``tumseg``'s ``apply`` does with ``rngs``; without
        one, FPS starts at 0 and there is no dropout, as ``apply`` does
        without ``rngs``. ``fast_gather`` takes the single-pass bf16 gathers
        in every set abstraction and feature propagation, as ``apply`` does
        with ``fast_gather=True``; None resolves to ``compute_dtype is not
        None`` in each layer. ``compute_dtype`` (e.g. ``torch.bfloat16``)
        is ``apply``'s: every ``Dense``, the head's two included, rounds its
        operands to it and returns f32; BN, ReLU, dropout and log_softmax
        run in f32. ``mesh`` (training on a sharded batch) goes to every
        BatchNorm, as ``apply``'s ``axis_name``."""
        draw = generator is not None and self.training
        B = x.shape[0]
        l_xyz = [x[..., :3].contiguous()]
        l_points = [x]
        for i in range(1, 5):
            start = None
            if draw:
                start = torch.randint(0, l_xyz[-1].shape[1], (B,),
                                      generator=generator, device=x.device,
                                      dtype=torch.int32)
            new_xyz, new_points = getattr(self, f"sa{i}")(
                l_xyz[-1], l_points[-1], fps_start=start,
                fast_gather=fast_gather, compute_dtype=compute_dtype,
                mesh=mesh)
            l_xyz.append(new_xyz)
            l_points.append(new_points)
        feat = l_points[4]
        for i, lvl in zip([4, 3, 2, 1], [3, 2, 1, 0]):
            skip = l_points[lvl] if lvl > 0 else None
            feat = getattr(self, f"fp{i}")(l_xyz[lvl], l_xyz[lvl + 1], skip,
                                           feat, fast_gather, compute_dtype,
                                           mesh)
        h = self.bn1(self.conv1(feat, compute_dtype), mesh, relu=True)
        if draw:
            h = dropout(h, DROPOUT_RATE, generator)
        return (F.log_softmax(self.conv2(h, compute_dtype), dim=-1),
                l_points[4])

    @staticmethod
    def loss(log_probs: torch.Tensor, target: torch.Tensor, aux,
             weight: torch.Tensor, mesh=None) -> torch.Tensor:
        """Weighted NLL over all points, sum(w[t] * -logp[t]) / sum(w[t])
        (``tumseg/nn/layers.py:weighted_nll_loss``), over every rank's
        points with a ``mesh``. ``aux``, the forward's second output, is
        taken as ``tumseg``'s ``loss`` takes it, and unused."""
        C = log_probs.shape[-1]
        return weighted_nll_loss(log_probs.reshape(-1, C),
                                 target.reshape(-1), weight, mesh)


def get_model(num_classes: int, num_extra_features: int = 0
              ) -> PointNet2SemSeg:
    return PointNet2SemSeg(num_classes, num_extra_features)
