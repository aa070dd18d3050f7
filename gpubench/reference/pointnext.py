"""Plain PointNeXt semantic segmentation, built from a configuration file's
sizes: Qian et al., arXiv:2206.04670, as openpoints lays it out
(``cfgs/s3dis/pointnext-xl.yaml``; ``models/backbone/pointnext.py``:
``PointNextEncoder``, ``SetAbstraction``, ``InvResMLP``,
``LocalAggregation``, ``PointNextDecoder``, ``FeaturePropogation``;
``models/segmentation/base_seg.py``: ``SegHead``). The architecture module
of the configurations whose ``architecture`` is ``pointnext``
(``gpubench/README.md`` gives the contract): the reference, its loss and
its counts, and, for the CPU tests, its tiny version. It is the
repository's one plain PointNeXt; the program's CPU tests hold the port to
it.

The network. ``widths`` start at ``width`` and double at every stage whose
stride is not 1; stage 0 is the stem, one Linear with bias from every
input channel to ``width``. Each later stage is a set abstraction (FPS
keeps N // stride points; the first ``nsample`` points within its radius
around each, in index order, grouped as ``[(p_j - p_i) / r, f_j]``; one
conv, BatchNorm, ReLU, the max over K) and ``blocks - 1`` InvResMLPs on
the kept points: the same aggregation around every point at C -> C, then
``relu(bn(conv(relu(bn(conv(g)))) ) + f)`` through ``expansion`` x C, the
last BatchNorm without ReLU. Radii are openpoints' ``_to_full_list``: a
stage's set abstraction takes ``radius`` and its blocks ``radius *
radius_scaling``, and ``radius`` scales by ``radius_scaling`` after each
strided stage. The decoder: from the deepest level up, ``[skip,
3-NN interpolation]`` and ``decoder_layers`` (conv, BatchNorm, ReLU) at the
skip level's width. The head: conv, BatchNorm, ReLU, dropout, conv to the
classes (with bias), log_softmax. Convs that a BatchNorm follows have no
bias. The offsets are divided by an f32 radius tensor (a true division on
every device).

Where it departs from openpoints:

- 9 input channels (block-relative xyz, room-normalized xyz, colour) all
  feed the stem, and there are 18 classes, where openpoints' S3DIS takes 4
  channels and 13 classes;
- a training forward with a generator draws, in order, each stage's FPS
  start in [0, N_stage) (the port's draw) and then the head's dropout
  mask; openpoints' FPS starts at index 0;
- the ball query takes the points with squared distance <= r^2 (r^2
  rounded to f32 once), openpoints' ``< r^2``;
- the 3-NN interpolation weighs by inverse squared distances (the port's
  interpolation, as PointNet++'s), openpoints' by inverse distances;
- the loss is the repository's weighted NLL over log_softmax and training
  is the repository's Adam at a fixed learning rate, where openpoints
  trains with label smoothing, AdamW and a cosine schedule;
- the state-dict names are the port's: ``stem``, ``sa{i}.conv``/``.bn``,
  ``res{i}.{j}.aggr.conv``/``.bn``, ``.pw1``/``.bn1``/``.pw2``/``.bn2``,
  ``fp{i}.mlp_convs.{j}``/``mlp_bns.{j}``, ``conv1``/``bn1``/``conv2``,
  not openpoints' nested indices; the shapes are openpoints' (convs over
  grouped neighbourhoods ``[out, in, 1, 1]``, the others ``[out, in,
  1]``).

With ``fast`` the groups and the interpolations take the single-pass bf16
gathers (``reference/ops.py``).

Counts. FLOPs: ``2 * rows * in * out`` a conv; its rows are ``B * S * K``
at an aggregation (S queries, K samples), ``B * N_level`` at a pointwise
conv, a feature propagation, the stem and the head. A training step adds
every conv's weight gradient and the input gradient of every conv but the
stem (whose input is the blocks'). Point-kernel launches as PointNet++'s
module counts them (``reference/pointnet2.py``); a step's group backward
runs for every neighbourhood group, the first stage's included (its
source carries the stem's gradient). ``bn_launches`` gives the BatchNorm
kernels' launches: 8, 20 and 12 bytes an element of ``bn_apply``,
``bn_backward_terms`` and ``bn_backward_dx`` (with 12, 12 and 8 bytes a
channel) and 4, 6 and 4 operations an element.
"""

from __future__ import annotations

import copy
import re
from typing import Dict, List, Tuple

import torch
from torch.nn import functional as F

from gpubench import counting
from gpubench.reference import layers as L
from gpubench.reference import ops
from gpubench.reference.layers import leaves  # noqa: F401 (the contract)

# the strided stages' stride of the tiny version for the CPU tests: a
# 128-point block keeps 8 points at stage 4
TINY_STRIDE = 2


def widths(cfg: Dict) -> List[int]:
    """Channels of each stage's features, the stem's first."""
    out, w = [], cfg["width"]
    for stride in cfg["strides"]:
        if stride != 1:
            w *= 2
        out.append(w)
    return out


def radii(cfg: Dict) -> List[List[float]]:
    """Each stage's radius a block (its set abstraction's first)."""
    out, r = [], cfg["radius"]
    for stride, n in zip(cfg["strides"], cfg["blocks"]):
        if stride == 1:
            out.append([r] * n)
        else:
            out.append([r] + [r * cfg["radius_scaling"]] * (n - 1))
            r *= cfg["radius_scaling"]
    return out


def levels(cfg: Dict, N: int) -> List[int]:
    """Points of each stage's level."""
    out = [N]
    for stride in cfg["strides"][1:]:
        out.append(out[-1] // stride)
    return out


def layers(cfg: Dict) -> List[Tuple[str, int, int, int, bool]]:
    """(name, in, out, conv rank, BatchNorm after) of every conv, in the
    forward's order; a conv that a BatchNorm follows has no bias."""
    w, ex = widths(cfg), cfg["expansion"]
    out = [("stem", cfg["in_channels"], w[0], 1, False)]
    for i in range(1, len(w)):
        out.append((f"sa{i}.conv", w[i - 1] + 3, w[i], 2, True))
        for j in range(cfg["blocks"][i] - 1):
            p = f"res{i}.{j}"
            out += [(f"{p}.aggr.conv", w[i] + 3, w[i], 2, True),
                    (f"{p}.pw1", w[i], w[i] * ex, 1, True),
                    (f"{p}.pw2", w[i] * ex, w[i], 1, True)]
    for i in range(len(w) - 1, 0, -1):
        last = w[i - 1] + w[i]
        for j in range(cfg["decoder_layers"]):
            out.append((f"fp{i}.mlp_convs.{j}", last, w[i - 1], 1, True))
            last = w[i - 1]
    out += [("conv1", w[0], w[0], 1, True),
            ("conv2", w[0], cfg["num_classes"], 1, False)]
    return out


def bn_name(conv: str) -> str:
    """The BatchNorm that follows ``conv``."""
    head, _, last = conv.rpartition(".")
    last = {"conv": "bn", "pw1": "bn1", "pw2": "bn2",
            "conv1": "bn1"}.get(last, last)
    if ".mlp_convs." in conv:
        return conv.replace("mlp_convs", "mlp_bns")
    return f"{head}.{last}" if head else last


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded weights on ``device`` (``layers.make_weights``, whose draws
    give every conv a bias; those of the convs that a BatchNorm follows
    are dropped); running statistics 0 and 1."""
    convs = layers(cfg)
    w = L.make_weights([(n, i, o, r) for n, i, o, r, _ in convs],
                       [(bn_name(n), o) for n, _, o, _, bn in convs if bn],
                       seed, device)
    for n, _, _, _, bn in convs:
        if bn:
            del w[f"{n}.bias"]
    return w


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
                        self.w.get(f"{name}.bias"))

    def layer(self, name: str, x: torch.Tensor,
              relu: bool = True) -> torch.Tensor:
        """Conv ``name``, its BatchNorm and, with ``relu``, ReLU."""
        h = L.batch_norm(self.w, bn_name(name), self.conv(name, x),
                         self.mode)
        return F.relu(h) if relu else h

    def aggregate(self, name: str, radius: float, xyz, centres, feat):
        """The grouped conv ``name`` around ``centres`` -> [B, S, out]."""
        src = torch.cat([xyz, feat], dim=-1)
        idx = ops.ball_query([radius], [self.cfg["nsample"]], xyz,
                             centres)[0]
        g = ops.Group.apply(idx, src, centres, self.fast).float()
        r = torch.tensor(float(radius), dtype=torch.float32, device=g.device)
        g = torch.cat([g[..., :3] / r, g[..., 3:]], dim=-1)
        return self.layer(name, g).amax(dim=2)

    def forward(self, x: torch.Tensor):
        """x [B, N, C] (block-relative xyz, normalized xyz, extras) ->
        (log-probs [B, N, num_classes], None: the loss takes nothing
        else)."""
        cfg = self.cfg
        B = x.shape[0]
        xyz = x[..., :3].contiguous()
        feat = self.conv("stem", x)
        l_xyz, l_feat = [xyz], [feat]
        for i, r in enumerate(radii(cfg)[1:], start=1):
            start = None
            if self.generator is not None:
                start = torch.randint(0, xyz.shape[1], (B,),
                                      generator=self.generator,
                                      device=x.device, dtype=torch.int32)
            fps = ops.farthest_point_sample(
                xyz, xyz.shape[1] // cfg["strides"][i], start)
            new_xyz = ops.gather(xyz, fps)
            feat = self.aggregate(f"sa{i}.conv", r[0], xyz, new_xyz, feat)
            xyz = new_xyz
            for j, rj in enumerate(r[1:]):
                p = f"res{i}.{j}"
                h = self.aggregate(f"{p}.aggr.conv", rj, xyz, xyz, feat)
                h = self.layer(f"{p}.pw2", self.layer(f"{p}.pw1", h),
                               relu=False)
                feat = F.relu(h + feat)
            l_xyz.append(xyz)
            l_feat.append(feat)
        for i in range(len(l_xyz) - 1, 0, -1):
            inter = ops.interpolate(l_xyz[i - 1], l_xyz[i], feat, self.fast)
            h = torch.cat([l_feat[i - 1], inter], dim=-1)
            for j in range(cfg["decoder_layers"]):
                h = self.layer(f"fp{i}.mlp_convs.{j}", h)
            feat = h
        h = self.layer("conv1", feat)
        if self.generator is not None:
            keep = 1.0 - cfg["dropout"]
            mask = torch.rand(h.shape, generator=self.generator,
                              device=h.device) < keep
            h = torch.where(mask, h / keep, 0.0)
        return F.log_softmax(self.conv("conv2", h), dim=-1), None


def loss(cfg: Dict, log_probs: torch.Tensor, target: torch.Tensor, aux,
         class_weights: torch.Tensor) -> torch.Tensor:
    """The weighted NLL over every point."""
    C = cfg["num_classes"]
    return F.nll_loss(log_probs.reshape(-1, C), target.reshape(-1),
                      weight=class_weights)


def gemms(cfg: Dict, B: int, N: int) -> List[Tuple[str, int, int, int]]:
    """(conv, rows, in, out) of every conv of a forward at B x N."""
    lv, K = levels(cfg, N), cfg["nsample"]
    out = []
    for name, i, o, rank, _ in layers(cfg):
        stage = name.split(".")[0]
        if stage.startswith(("sa", "res")):
            n = lv[int(re.sub(r"\D", "", stage))]
            rows = B * n * K if rank == 2 else B * n
        elif stage.startswith("fp"):
            rows = B * lv[int(stage[2:]) - 1]
        else:
            rows = B * N
        out.append((name, rows, i, o))
    return out


def forward_flops(cfg: Dict, B: int, N: int) -> int:
    return sum(2 * r * i * o for _, r, i, o in gemms(cfg, B, N))


def step_flops(cfg: Dict, B: int, N: int) -> int:
    """Forward, weight gradients and the input gradients that are needed."""
    total = 0
    for name, r, i, o in gemms(cfg, B, N):
        total += 2 * 2 * r * i * o
        if name != "stem":
            total += 2 * r * i * o
    return total


def launches(cfg: Dict, B: int, N: int, train: bool) -> List[Dict]:
    """The point-kernel launches of one forward (serving: exact gathers) or
    one training step (fast gathers, then the backward kernels)."""
    cost = counting.cost
    lv, w, K = levels(cfg, N), widths(cfg), cfg["nsample"]
    gb = 2 if train else 4          # bytes of a grouped element
    out, groups = [], []

    def aggregate(n, s, c):
        out.append(cost("ball_query", B * n * 12 + B * s * 12
                        + B * s * K * 4, 0))
        out.append(cost("group", 4 * (B * s * K + B * n * c + B * s * 3)
                        + B * s * K * c * gb, B * s * K * 3))
        groups.append((n, s, c))

    for i in range(1, len(w)):
        n, s = lv[i - 1], lv[i]
        out.append(cost("fps", B * n * 12 + B * 4 + B * s * 4,
                        B * s * n * 10))
        out.append(cost("group", 4 * (B * s + B * n * 3 + B * s * 3)
                        + B * s * 12, B * s * 3))
        aggregate(n, s, w[i - 1] + 3)
        for _ in range(cfg["blocks"][i] - 1):
            aggregate(s, s, w[i] + 3)
    fp_in = []
    for i in range(len(w) - 1, 0, -1):
        n1, s, d = lv[i - 1], lv[i], w[i]
        out.append(cost("three_nn_interpolate",
                        4 * (B * n1 * 3 + B * s * 3 + B * s * d + B * n1 * 6
                             + B * n1 * d), B * n1 * 10 + B * n1 * d * 5))
        fp_in.append((n1, s, d))
    if train:
        for n, s, c in groups:
            out.append(cost("group_backward",
                            4 * B * s * K + 2 * B * s * K * c
                            + 4 * B * n * c, B * s * K * c))
        for n1, s, d in fp_in:
            out.append(cost("interpolate_backward",
                            4 * (B * n1 * 6 + B * n1 * d + B * s * d),
                            B * n1 * 3 * d * 2))
    return out


def bn_launches(cfg: Dict, B: int, N: int, train: bool) -> List[Dict]:
    """The BatchNorm kernels' launches of one forward (``bn_apply`` a
    BatchNorm) or one training step (and ``bn_backward_terms`` and
    ``bn_backward_dx`` a BatchNorm: every BatchNorm's input carries a
    gradient)."""
    cost = counting.cost
    out = []
    for name, rows, _, c in gemms(cfg, B, N):
        if name in ("stem", "conv2"):
            continue
        m = rows * c
        out.append(cost("bn_apply", 8 * m + 12 * c, 4 * m))
        if train:
            out.append(cost("bn_backward_terms", 20 * m + 12 * c, 6 * m))
            out.append(cost("bn_backward_dx", 12 * m + 8 * c, 4 * m))
    return out


def tiny(cfg: Dict):
    """The configuration shrunk for the CPU tests (stride ``TINY_STRIDE`` at
    every strided stage), and the program's sizes that match it: -> (cfg,
    [(attribute, index, key, value)]), each to set as ``<model
    module>.<attribute>[index][key] = value`` (the program's model reads
    its strides from ``STAGES``)."""
    cfg = copy.deepcopy(cfg)
    program = []
    for i, stride in enumerate(cfg["strides"]):
        if stride != 1:
            cfg["strides"][i] = TINY_STRIDE
            program.append(("STAGES", i, "stride", TINY_STRIDE))
    return cfg, program
