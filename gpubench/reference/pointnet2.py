"""Plain PointNet++ semantic segmentation (SSG and MSG), built from a
configuration file's sizes: arXiv:1706.02413 as the yanx27 PyTorch models
(``pointnet2_sem_seg.py``, ``pointnet2_sem_seg_msg.py``) lay it out.

Weights are a dict under the published models' state-dict names (1x1 convs
as ``[out, in, 1, 1]`` in the set abstractions, ``[out, in, 1]`` in the
feature propagations and the head); a conv is ``F.linear`` over the last
axis in f32, TF32 off. BatchNorm is ``(x - mean) * (rsqrt(var + eps) *
weight) + bias``, the batch's mean and ``E[x^2] - E[x]^2`` in training,
the running statistics in eval. A training forward with a generator draws,
in order, each stage's FPS start in [0, N_stage) and then the head's
dropout mask; the set abstractions' groups and the interpolations take the
fast (bf16) gathers when ``fast``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch
from torch.nn import functional as F

from gpubench.reference import ops

EPS = 1e-5


def layers(cfg: Dict) -> Iterator[Tuple[str, int, int, int]]:
    """(prefix, in, out, conv rank) of every conv of the configuration, in
    the published models' order; each is followed by its BatchNorm, the
    head's last conv excepted."""
    in_ch = cfg["in_channels"]
    ssg = cfg["group_order"] == "xyz_points"
    for i, sa in enumerate(cfg["sa"], start=1):
        outs = []
        for s, mlp in enumerate(sa["mlp"]):
            last = in_ch + 3
            for j, out in enumerate(mlp):
                name = (f"sa{i}.mlp_convs.{j}" if ssg
                        else f"sa{i}.conv_blocks.{s}.{j}")
                yield name, last, out, 2
                last = out
            outs.append(last)
        in_ch = sum(outs)
    for i, fp in zip((4, 3, 2, 1), cfg["fp"]):
        last = fp["in"]
        for j, out in enumerate(fp["mlp"]):
            yield f"fp{i}.mlp_convs.{j}", last, out, 1
            last = out
    yield "conv1", cfg["head"], cfg["head"], 1
    yield "conv2", cfg["head"], cfg["num_classes"], 1


def bn_name(conv: str) -> str:
    """The BatchNorm that follows ``conv``."""
    return (conv.replace("mlp_convs", "mlp_bns")
            .replace("conv_blocks", "bn_blocks").replace("conv1", "bn1"))


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded weights on ``device`` in three calls of one generator: conv
    weights N(0, 2 / (in + out)), conv biases U(-1/sqrt(in), 1/sqrt(in)),
    BatchNorm scales 1 + 0.1 N(0, 1) and shifts 0.1 N(0, 1); running
    statistics 0 and 1 (serving calibrates them)."""
    convs = list(layers(cfg))
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n_w = sum(i * o for _, i, o, _ in convs)
    n_b = sum(o for _, _, o, _ in convs)
    bns = [(bn_name(n), o) for n, _, o, _ in convs if n != "conv2"]
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


def leaves(weights: Dict[str, torch.Tensor]) -> List[str]:
    """The trainable leaves' names (every weight and bias), in order."""
    return [k for k in weights if k.endswith((".weight", ".bias"))]


class Net:
    """The forward over ``weights``. ``mode`` is "eval" (running
    statistics), "train" (batch statistics) or "calibrate" (each
    BatchNorm's running statistics set to its own input's mean and biased
    variance, then used)."""

    def __init__(self, cfg: Dict, weights: Dict[str, torch.Tensor],
                 mode: str = "eval", fast: bool = False, generator=None):
        self.cfg, self.w, self.mode = cfg, weights, mode
        self.fast, self.generator = fast, generator

    def conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w = self.w[f"{name}.weight"]
        return F.linear(x, w.reshape(w.shape[0], w.shape[1]),
                        self.w[f"{name}.bias"])

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        p = bn_name(name)
        weight, bias = self.w[f"{p}.weight"], self.w[f"{p}.bias"]
        if self.mode == "train":
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dim=dims)
            var = (x * x).mean(dim=dims) - mean * mean
        else:
            if self.mode == "calibrate":
                h = x.reshape(-1, x.shape[-1])
                self.w[f"{p}.running_mean"].copy_(h.mean(dim=0))
                self.w[f"{p}.running_var"].copy_(h.var(dim=0, unbiased=False))
            mean = self.w[f"{p}.running_mean"]
            var = self.w[f"{p}.running_var"]
        return (x - mean) * (torch.rsqrt(var + EPS) * weight) + bias

    def mlp(self, names, x):
        for name in names:
            x = F.relu(self.bn(name, self.conv(name, x)))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, N, C] (block-relative xyz, normalized xyz, extras) ->
        log-probs [B, N, num_classes]."""
        cfg = self.cfg
        convs = [n for n, _, _, _ in layers(cfg)]
        B = x.shape[0]
        ssg = cfg["group_order"] == "xyz_points"
        l_xyz, l_pts = [x[..., :3].contiguous()], [x]
        for i, sa in enumerate(cfg["sa"], start=1):
            xyz, pts = l_xyz[-1], l_pts[-1]
            start = None
            if self.generator is not None:
                start = torch.randint(0, xyz.shape[1], (B,),
                                      generator=self.generator,
                                      device=x.device, dtype=torch.int32)
            fps = ops.farthest_point_sample(xyz, sa["npoint"], start)
            new_xyz = ops.gather(xyz, fps)
            src = torch.cat([xyz, pts], dim=-1)
            idxs = ops.ball_query(sa["radius"], sa["nsample"], xyz, new_xyz)
            outs = []
            for s, idx in enumerate(idxs):
                g = ops.Group.apply(idx, src, new_xyz, self.fast).float()
                if cfg["group_order"] == "points_xyz":
                    g = torch.cat([g[..., 3:], g[..., :3]], dim=-1)
                prefix = (f"sa{i}.mlp_convs." if ssg
                          else f"sa{i}.conv_blocks.{s}.")
                names = [n for n in convs if n.startswith(prefix)]
                outs.append(self.mlp(names, g).amax(dim=2))
            l_xyz.append(new_xyz)
            l_pts.append(torch.cat(outs, dim=-1))
        feat = l_pts[-1]
        for i, lvl in zip((4, 3, 2, 1), (3, 2, 1, 0)):
            xyz1, xyz2 = l_xyz[lvl], l_xyz[lvl + 1]
            if xyz2.shape[1] == 1:
                inter = feat.expand(-1, xyz1.shape[1], -1)
            else:
                inter = ops.interpolate(xyz1, xyz2, feat, self.fast)
            if lvl > 0:
                inter = torch.cat([l_pts[lvl], inter], dim=-1)
            feat = self.mlp([n for n in convs
                             if n.startswith(f"fp{i}.")], inter)
        h = F.relu(self.bn("conv1", self.conv("conv1", feat)))
        if self.generator is not None:
            keep = 1.0 - cfg["dropout"]
            mask = torch.rand(h.shape, generator=self.generator,
                              device=h.device) < keep
            h = torch.where(mask, h / keep, 0.0)
        return F.log_softmax(self.conv("conv2", h), dim=-1)
