"""PointNet semantic segmentation (``tumseg/models/pointnet_sem_seg.py``):
the encoder with both transforms and ``6 + extra`` input channels, a
1088 -> 512 -> 256 -> 128 head of Conv-BN-ReLU layers, then a conv to the
classes and log_softmax; the loss is the weighted NLL plus 0.001 x the
feature transform's orthogonality regularizer."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from tumseg_torch.nn.layers import (BatchNorm, Dense, PointNetEncoder,
                                    feature_transform_regularizer,
                                    weighted_nll_loss)
from tumseg_torch.parallel.mesh import pmean

MAT_DIFF_LOSS_SCALE = 0.001


class PointNetSemSeg(nn.Module):

    def __init__(self, num_classes: int, num_extra_features: int = 0):
        super().__init__()
        self.feat = PointNetEncoder(6 + num_extra_features, global_feat=False,
                                    feature_transform=True)
        self.conv1 = Dense(1088, 512, conv_rank=1)
        self.conv2 = Dense(512, 256, conv_rank=1)
        self.conv3 = Dense(256, 128, conv_rank=1)
        self.conv4 = Dense(128, num_classes, conv_rank=1)
        self.bn1 = BatchNorm(512)
        self.bn2 = BatchNorm(256)
        self.bn3 = BatchNorm(128)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                fast_gather: Optional[bool] = None, compute_dtype=None,
                mesh=None):
        """x [B, N, 6 + extra] f32 -> (log_probs [B, N, num_classes],
        trans_feat [B, 64, 64]). The model draws nothing and gathers
        nothing, so ``generator`` and ``fast_gather`` are taken, as the
        PointNet++ models take them, and unused, as ``tumseg``'s ``apply``
        leaves ``rngs`` and ``fast_gather``. ``compute_dtype`` is
        ``apply``'s: every ``Dense`` rounds its operands to it and returns
        f32; BN, ReLU, the max, both transforms and log_softmax are f32.
        ``mesh`` goes to every BatchNorm."""
        h, _, trans_feat = self.feat(x, compute_dtype, mesh)
        for i in range(1, 4):
            conv, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
            h = bn(conv(h, compute_dtype), mesh, relu=True,
                   dtype=compute_dtype)
        return (F.log_softmax(self.conv4(h, compute_dtype), dim=-1),
                trans_feat)

    @staticmethod
    def loss(log_probs: torch.Tensor, target: torch.Tensor,
             trans_feat: torch.Tensor, weight: torch.Tensor,
             mesh=None) -> torch.Tensor:
        """Weighted NLL over all points plus 0.001 x
        ``feature_transform_regularizer(trans_feat)``
        (``tumseg/models/pointnet_sem_seg.py:58-73``); with a ``mesh`` both
        are taken over every rank's blocks (the regularizer's batch mean by
        ``pmean``)."""
        C = log_probs.shape[-1]
        nll = weighted_nll_loss(log_probs.reshape(-1, C), target.reshape(-1),
                                weight, mesh)
        reg = feature_transform_regularizer(trans_feat)
        if mesh is not None:
            reg = pmean(reg, mesh)
        return nll + MAT_DIFF_LOSS_SCALE * reg


def get_model(num_classes: int, num_extra_features: int = 0
              ) -> PointNetSemSeg:
    return PointNetSemSeg(num_classes, num_extra_features)
