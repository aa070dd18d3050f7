"""PointNeXt-XL semantic segmentation (Qian et al., arXiv:2206.04670, as
openpoints builds ``cfgs/s3dis/pointnext-xl.yaml``: ``PointNextEncoder``,
``PointNextDecoder`` and ``SegHead``). The JAX package has no PointNeXt;
``gpubench/reference/pointnext.py`` is its plain reference.

- Stem: one Linear (``Dense``, with bias) from all ``6 + extra`` input
  channels to 64, with no BatchNorm and no ReLU.
- Stages 1-4: a set abstraction (FPS keeps N // stride points, the ball of
  the stage's radius around them, ``[(p_j - p_i) / r, f_j]``, one conv,
  BatchNorm, ReLU, the max over K), then ``blocks - 1`` InvResMLPs on the
  kept points at twice that radius; widths 64 doubling at each strided
  stage to 1024, ``STAGES`` below.
- Decoder: four feature propagations, ``[skip, 3-NN interpolation]`` then
  two (conv, BatchNorm, ReLU) at the skip level's width.
- Head: conv 64 -> 64, BatchNorm, ReLU, dropout 0.5, conv 64 -> classes,
  log_softmax; trained with the weighted NLL loss of the PointNet++ models.

Every conv that a BatchNorm follows has no bias. The module names are the
port's: ``stem``, ``sa{i}`` (a set abstraction), ``res{i}.{j}`` (the
InvResMLPs of stage i), ``fp{i}`` and ``conv1``/``bn1``/``conv2``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from tumseg_torch.nn.layers import (BatchNorm, Dense, FeaturePropagation,
                                    InvResMLP, PointNeXtSetAbstraction,
                                    dropout, weighted_nll_loss)

# stage 0 is the stem; stages 1-4 a set abstraction of ``radius`` and
# ``blocks - 1`` InvResMLPs of ``radius * RADIUS_SCALING`` (openpoints'
# ``_to_full_list`` from radius 0.1 and radius_scaling 2)
STAGES = [
    dict(width=64, blocks=1, stride=1, radius=0.1, nsample=32),
    dict(width=128, blocks=4, stride=4, radius=0.1, nsample=32),
    dict(width=256, blocks=7, stride=4, radius=0.2, nsample=32),
    dict(width=512, blocks=4, stride=4, radius=0.4, nsample=32),
    dict(width=1024, blocks=4, stride=4, radius=0.8, nsample=32),
]
RADIUS_SCALING = 2
EXPANSION = 4
DROPOUT_RATE = 0.5


class PointNeXtSemSeg(nn.Module):
    def __init__(self, num_classes: int, num_extra_features: int = 0):
        super().__init__()
        widths = [cfg["width"] for cfg in STAGES]
        self.stem = Dense(6 + num_extra_features, widths[0], conv_rank=1)
        for i, cfg in enumerate(STAGES[1:], start=1):
            setattr(self, f"sa{i}", PointNeXtSetAbstraction(
                cfg["stride"], widths[i - 1], cfg["width"], cfg["radius"],
                cfg["nsample"]))
            setattr(self, f"res{i}", nn.ModuleList(
                InvResMLP(cfg["width"], cfg["radius"] * RADIUS_SCALING,
                          cfg["nsample"], EXPANSION)
                for _ in range(cfg["blocks"] - 1)))
        for i in range(len(STAGES) - 1, 0, -1):
            setattr(self, f"fp{i}", FeaturePropagation(
                widths[i - 1] + widths[i], [widths[i - 1]] * 2, bias=False))
        self.conv1 = Dense(widths[0], widths[0], conv_rank=1, bias=False)
        self.bn1 = BatchNorm(widths[0])
        self.conv2 = Dense(widths[0], num_classes, conv_rank=1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                fast_gather: Optional[bool] = None, compute_dtype=None,
                mesh=None):
        """x [B, N, 6 + extra] f32 (cols 0-2 block-relative xyz, the
        positions) -> (log_probs [B, N, num_classes], the deepest level's
        features [B, N_4, 1024]). The arguments are
        ``PointNet2SemSeg.forward``'s, and so are the draws: with a
        ``generator`` in train mode each stage's FPS start in
        [0, N_stage), then the head's dropout mask."""
        draw = generator is not None and self.training
        B = x.shape[0]
        xyz = x[..., :3].contiguous()
        feat = self.stem(x, compute_dtype)
        l_xyz, l_feat = [xyz], [feat]
        for i in range(1, len(STAGES)):
            start = None
            if draw:
                start = torch.randint(0, xyz.shape[1], (B,),
                                      generator=generator, device=x.device,
                                      dtype=torch.int32)
            xyz, feat = getattr(self, f"sa{i}")(
                xyz, feat, fps_start=start, fast_gather=fast_gather,
                compute_dtype=compute_dtype, mesh=mesh)
            for block in getattr(self, f"res{i}"):
                feat = block(xyz, feat, fast_gather, compute_dtype, mesh)
            l_xyz.append(xyz)
            l_feat.append(feat)
        for i in range(len(STAGES) - 1, 0, -1):
            feat = getattr(self, f"fp{i}")(l_xyz[i - 1], l_xyz[i],
                                           l_feat[i - 1], feat, fast_gather,
                                           compute_dtype, mesh)
        h = self.bn1(self.conv1(feat, compute_dtype), mesh, relu=True)
        if draw:
            h = dropout(h, DROPOUT_RATE, generator)
        return (F.log_softmax(self.conv2(h, compute_dtype), dim=-1),
                l_feat[-1])

    @staticmethod
    def loss(log_probs: torch.Tensor, target: torch.Tensor, aux,
             weight: torch.Tensor, mesh=None) -> torch.Tensor:
        """Weighted NLL over all points, sum(w[t] * -logp[t]) / sum(w[t]),
        over every rank's points with a ``mesh``; ``aux`` unused."""
        C = log_probs.shape[-1]
        return weighted_nll_loss(log_probs.reshape(-1, C),
                                 target.reshape(-1), weight, mesh)


def get_model(num_classes: int, num_extra_features: int = 0
              ) -> PointNeXtSemSeg:
    return PointNeXtSemSeg(num_classes, num_extra_features)
