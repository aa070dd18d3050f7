"""Plain PointNet++ semantic segmentation (SSG and MSG), built from a
configuration file's sizes: arXiv:1706.02413 as the yanx27 PyTorch models
(``pointnet2_sem_seg.py``, ``pointnet2_sem_seg_msg.py``) lay it out. The
architecture module of the configurations whose ``architecture`` is
``pointnet2`` (``gpubench/README.md`` gives the contract): the reference,
its loss and its counts; and, for the CPU tests, its tiny version.

Weights are a dict under the published models' state-dict names (1x1 convs
as ``[out, in, 1, 1]`` in the set abstractions, ``[out, in, 1]`` in the
feature propagations and the head); convs and BatchNorms as
``reference/layers.py`` computes them. A training forward with a generator
draws, in order, each stage's FPS start in [0, N_stage) and then the head's
dropout mask; the set abstractions' groups and the interpolations take the
fast (bf16) gathers when ``fast``.

Counts. FLOPs: ``2 * rows * in * out`` a 1x1 conv; its rows are ``B * S *
K`` at a set abstraction (S centroids, K samples of a scale), ``B *
N_level`` at a feature propagation and ``B * N`` at the head. A training
step adds the weight gradient of every conv and the input gradient of
every conv whose input carries one (all but the first conv of each
first-stage scale). A point-kernel launch's bytes count each input read
once and each output written once; its operations only what the inputs
need: FPS's 10 a point a step, a group's one subtraction an xyz output, the
3-NN's weights and interpolation (10 a query and 5 an output element; the
search itself is data-dependent and counted as nothing), the backward
passes' adds and multiplies; a ball query counts its bytes alone
(``counting.bound_s`` prices them).
"""

from __future__ import annotations

import copy
from typing import Dict, Iterator, List, Tuple

import torch
from torch.nn import functional as F

from gpubench import counting
from gpubench.reference import layers as L
from gpubench.reference import ops
from gpubench.reference.layers import leaves  # noqa: F401 (the contract)

# the centroids a stage of the tiny version for the CPU tests
TINY_NPOINT = [64, 16, 8, 4]


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
    """Seeded weights on ``device`` (``layers.make_weights``); running
    statistics 0 and 1 (serving calibrates them)."""
    convs = list(layers(cfg))
    bns = [(bn_name(n), o) for n, _, o, _ in convs if n != "conv2"]
    return L.make_weights(convs, bns, seed, device)


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
        return L.conv(self.w, name, x)

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The BatchNorm that follows conv ``name``."""
        return L.batch_norm(self.w, bn_name(name), x, self.mode)

    def mlp(self, names, x):
        for name in names:
            x = F.relu(self.bn(name, self.conv(name, x)))
        return x

    def forward(self, x: torch.Tensor):
        """x [B, N, C] (block-relative xyz, normalized xyz, extras) ->
        (log-probs [B, N, num_classes], None: the loss takes nothing
        else)."""
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
        return F.log_softmax(self.conv("conv2", h), dim=-1), None


def loss(cfg: Dict, log_probs: torch.Tensor, target: torch.Tensor, aux,
         class_weights: torch.Tensor) -> torch.Tensor:
    """The weighted NLL over every point."""
    C = cfg["num_classes"]
    return F.nll_loss(log_probs.reshape(-1, C), target.reshape(-1),
                      weight=class_weights)


def levels(cfg: Dict, N: int) -> List[int]:
    return [N] + [sa["npoint"] for sa in cfg["sa"]]


def widths(cfg: Dict) -> List[int]:
    """Channels of each level's features: the input, then each stage's."""
    out = [cfg["in_channels"]]
    for sa in cfg["sa"]:
        out.append(sum(m[-1] for m in sa["mlp"]))
    return out


def gemms(cfg: Dict, B: int, N: int) -> List[Tuple[str, int, int, int]]:
    """(stage, rows, in, out) of every conv of a forward at B x N."""
    lv, w = levels(cfg, N), widths(cfg)
    out = []
    for i, sa in enumerate(cfg["sa"], start=1):
        for k, mlp in zip(sa["nsample"], sa["mlp"]):
            last = w[i - 1] + 3
            for j, o in enumerate(mlp):
                out.append((f"sa{i}.{j}", B * sa["npoint"] * k, last, o))
                last = o
    for i, lvl, fp in zip((4, 3, 2, 1), (3, 2, 1, 0), cfg["fp"]):
        last = fp["in"]
        for j, o in enumerate(fp["mlp"]):
            out.append((f"fp{i}.{j}", B * lv[lvl], last, o))
            last = o
    out.append(("head.0", B * N, cfg["head"], cfg["head"]))
    out.append(("head.1", B * N, cfg["head"], cfg["num_classes"]))
    return out


def forward_flops(cfg: Dict, B: int, N: int) -> int:
    return sum(2 * r * i * o for _, r, i, o in gemms(cfg, B, N))


def step_flops(cfg: Dict, B: int, N: int) -> int:
    """Forward, weight gradients and the input gradients that are needed."""
    total = 0
    for stage, r, i, o in gemms(cfg, B, N):
        total += 2 * 2 * r * i * o
        if stage != "sa1.0":
            total += 2 * r * i * o
    return total


def launches(cfg: Dict, B: int, N: int, train: bool) -> List[Dict]:
    """The point-kernel launches of one forward (serving: exact gathers) or
    one training step (fast gathers, then the backward kernels)."""
    cost = counting.cost
    lv, w = levels(cfg, N), widths(cfg)
    gb = 2 if train else 4          # bytes of a grouped element
    out = []
    for i, sa in enumerate(cfg["sa"], start=1):
        n, s, c = lv[i - 1], sa["npoint"], w[i - 1] + 3
        out.append(cost("fps", B * n * 12 + B * 4 + B * s * 4,
                        B * s * n * 10))
        out.append(cost("group", 4 * (B * s + B * n * 3 + B * s * 3)
                        + B * s * 12, B * s * 3))
        ks = sa["nsample"]
        out.append(cost("ball_query" if len(ks) == 1 else "ball_query_multi",
                        B * n * 12 + B * s * 12 + B * s * sum(ks) * 4, 0))
        for k in ks:
            out.append(cost("group", 4 * (B * s * k + B * n * c + B * s * 3)
                            + B * s * k * c * gb, B * s * k * 3))
    fp_in = []
    d = w[-1]
    for i, lvl, fp in zip((4, 3, 2, 1), (3, 2, 1, 0), cfg["fp"]):
        n1, s = lv[lvl], lv[lvl + 1]
        out.append(cost("three_nn_interpolate",
                        4 * (B * n1 * 3 + B * s * 3 + B * s * d + B * n1 * 6
                             + B * n1 * d), B * n1 * 10 + B * n1 * d * 5))
        fp_in.append((n1, s, d))
        d = fp["mlp"][-1]
    if train:
        for i, sa in enumerate(cfg["sa"], start=1):
            if i == 1:
                continue        # the input carries no gradient
            n, s, c = lv[i - 1], sa["npoint"], w[i - 1] + 3
            for k in sa["nsample"]:
                out.append(cost("group_backward",
                                4 * B * s * k + 2 * B * s * k * c
                                + 4 * B * n * c, B * s * k * c))
        for n1, s, d in fp_in:
            out.append(cost("interpolate_backward",
                            4 * (B * n1 * 6 + B * n1 * d + B * s * d),
                            B * n1 * 3 * d * 2))
    return out


def tiny(cfg: Dict):
    """The configuration shrunk for the CPU tests (fewer centroids a
    stage), and the program's sizes that match it: -> (cfg, [(attribute,
    index, key, value)]), each to set as ``<model module>.<attribute>
    [index][key] = value`` (the program's models read their centroid
    counts from ``SA_CFGS``)."""
    cfg = copy.deepcopy(cfg)
    program = []
    for i, (sa, n) in enumerate(zip(cfg["sa"], TINY_NPOINT)):
        sa["npoint"] = n
        program.append(("SA_CFGS", i, "npoint", n))
    return cfg, program
