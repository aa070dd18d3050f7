"""Plain PointNet semantic segmentation, built from a configuration file's
sizes: arXiv:1612.00593 as the yanx27 PyTorch model
(``pointnet_sem_seg.py``) lays it out. The architecture module of the
configurations whose ``architecture`` is ``pointnet`` (``gpubench/
README.md`` gives the contract); no cell of ``BENCHMARK.json`` runs it yet.

The encoder: an input transform (STN3d: three convs with BatchNorm and
ReLU, the max over the points, two Linear layers with BatchNorm and ReLU,
a third plus the identity) applied to the xyz channels by a ``bmm``, the
first conv, the feature transform (the same STN over its k = 64 channels)
applied by a ``bmm``, two more convs (the last without ReLU) and the max
over the points. The head: the global features at every point beside the
transformed point features (1088 channels), three convs with BatchNorm and
ReLU, a conv to the classes and log_softmax. The loss is the weighted NLL
plus ``mat_diff_loss_scale`` x the mean over the blocks of ``||A A^T -
I||_F`` of the feature transform A.

Weights are a dict under the published model's state-dict names (convs as
``[out, in, 1]``, the STN's Linear layers as ``[out, in]``); convs and
BatchNorms as ``reference/layers.py`` computes them. When calibrating, a
BatchNorm over [B, C] (the STN's after the max) keeps its running
statistics: a channel's B values, one a block, lie close together, and
dividing by their spread would make the output hang on the last bits of
its input.

Counts: ``2 * rows * in * out`` a conv, its rows ``B * N`` (``B`` for a
Linear layer), and the transforms' ``bmm``s, ``2 * B * N * k * k`` each. A
training step adds every conv's weight gradient, the input gradient of
every conv but the input transform's first (its input is the blocks'), the
input transform product's gradient of the transform, and the feature
transform product's of both operands; the regularizer's ``k^3`` products a
block (under 0.01% of a step) are not counted. PointNet launches no point
kernel.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.nn import functional as F

from gpubench.reference import layers as L
from gpubench.reference.layers import leaves  # noqa: F401 (the contract)


def _stn(prefix: str, channel: int, k: int, w: List[int]):
    return [(f"{prefix}.conv1", channel, w[0], 1),
            (f"{prefix}.conv2", w[0], w[1], 1),
            (f"{prefix}.conv3", w[1], w[2], 1),
            (f"{prefix}.fc1", w[2], w[3], 0),
            (f"{prefix}.fc2", w[3], w[4], 0),
            (f"{prefix}.fc3", w[4], k * k, 0)]


def layers(cfg: Dict) -> List[Tuple[str, int, int, int]]:
    """(name, in, out, conv rank) of every conv and Linear layer, in the
    published model's order; rank 0 is a Linear layer, over [B, in]."""
    stn, enc, seg = cfg["stn"], cfg["encoder"], cfg["seg"]
    out = _stn("feat.stn", cfg["in_channels"], 3, stn)
    last = cfg["in_channels"]
    for i, o in enumerate(enc, start=1):
        out.append((f"feat.conv{i}", last, o, 1))
        last = o
    out += _stn("feat.fstn", enc[0], enc[0], stn)
    last = enc[-1] + enc[0]
    for i, o in enumerate(seg + [cfg["num_classes"]], start=1):
        out.append((f"conv{i}", last, o, 1))
        last = o
    return out


def bn_name(conv: str) -> str:
    """The BatchNorm that follows ``conv``."""
    head, _, last = conv.rpartition(".")
    last = {"fc1": "bn4", "fc2": "bn5"}.get(last, last.replace("conv", "bn"))
    return f"{head}.{last}" if head else last


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded weights on ``device`` (``layers.make_weights``); running
    statistics 0 and 1 (serving calibrates them)."""
    convs = layers(cfg)
    last = f"conv{len(cfg['seg']) + 1}"
    bns = [(bn_name(n), o) for n, _, o, _ in convs
           if not n.endswith(".fc3") and n != last]
    return L.make_weights(convs, bns, seed, device)


class Net:
    """The forward over ``weights``. ``mode`` is "eval" (running
    statistics), "train" (batch statistics) or "calibrate". PointNet draws
    nothing and gathers nothing: ``fast`` and ``generator`` are taken, as
    the other architectures' references take them, and unused."""

    def __init__(self, cfg: Dict, weights: Dict[str, torch.Tensor],
                 mode: str = "eval", fast: bool = False, generator=None):
        self.cfg, self.w, self.mode = cfg, weights, mode

    def layer(self, name: str, x: torch.Tensor,
              relu: bool = True) -> torch.Tensor:
        """Conv ``name``, its BatchNorm and, with ``relu``, ReLU."""
        h = L.conv(self.w, name, x)
        mode = self.mode
        if mode == "calibrate" and h.dim() == 2:
            mode = "eval"
        h = L.batch_norm(self.w, bn_name(name), h, mode)
        return F.relu(h) if relu else h

    def stn(self, prefix: str, x: torch.Tensor, k: int) -> torch.Tensor:
        """x [B, N, C] -> the transform [B, k, k]."""
        h = self.layer(f"{prefix}.conv1", x)
        h = self.layer(f"{prefix}.conv2", h)
        h = self.layer(f"{prefix}.conv3", h).amax(dim=1)
        h = self.layer(f"{prefix}.fc1", h)
        h = self.layer(f"{prefix}.fc2", h)
        h = L.conv(self.w, f"{prefix}.fc3", h)
        iden = torch.eye(k, dtype=h.dtype, device=h.device)
        return (h + iden.reshape(1, -1)).view(-1, k, k)

    def forward(self, x: torch.Tensor):
        """x [B, N, C] (block-relative xyz, normalized xyz, extras) ->
        (log-probs [B, N, num_classes], the feature transform [B, k, k])."""
        B, N, _ = x.shape
        trans = self.stn("feat.stn", x, 3)
        h = torch.cat([torch.bmm(x[..., :3], trans), x[..., 3:]], dim=-1)
        h = self.layer("feat.conv1", h)
        trans_feat = self.stn("feat.fstn", h, self.cfg["encoder"][0])
        point = torch.bmm(h, trans_feat)
        h = self.layer("feat.conv2", point)
        g = self.layer("feat.conv3", h, relu=False).amax(dim=1)
        h = torch.cat([g[:, None, :].expand(B, N, -1), point], dim=-1)
        n = len(self.cfg["seg"])
        for i in range(1, n + 1):
            h = self.layer(f"conv{i}", h)
        return (F.log_softmax(L.conv(self.w, f"conv{n + 1}", h), dim=-1),
                trans_feat)


def loss(cfg: Dict, log_probs: torch.Tensor, target: torch.Tensor,
         aux: torch.Tensor, class_weights: torch.Tensor) -> torch.Tensor:
    """The weighted NLL over every point plus ``mat_diff_loss_scale`` x
    the feature transform ``aux``'s orthogonality regularizer."""
    C = cfg["num_classes"]
    nll = F.nll_loss(log_probs.reshape(-1, C), target.reshape(-1),
                     weight=class_weights)
    eye = torch.eye(aux.shape[1], dtype=aux.dtype, device=aux.device)
    gram = torch.bmm(aux, aux.transpose(1, 2))
    reg = (gram - eye).square().sum(dim=(1, 2)).sqrt().mean()
    return nll + cfg["mat_diff_loss_scale"] * reg


def gemms(cfg: Dict, B: int, N: int) -> List[Tuple[str, int, int, int]]:
    """(layer, rows, in, out) of every conv and Linear layer of a forward
    at B x N: the two transforms' layers first, then the encoder's and the
    head's, as the port's ``tools/roofline.py`` lists them."""
    rows = [(name, B if rank == 0 else B * N, i, o)
            for name, i, o, rank in layers(cfg)]
    stn = [g for g in rows if "stn." in g[0]]
    return stn + [g for g in rows if "stn." not in g[0]]


def _transforms(cfg: Dict, B: int, N: int) -> Tuple[int, int]:
    """FLOPs of the input and the feature transform's ``bmm``."""
    k = cfg["encoder"][0]
    return 2 * B * N * 3 * 3, 2 * B * N * k * k


def forward_flops(cfg: Dict, B: int, N: int) -> int:
    return (sum(2 * r * i * o for _, r, i, o in gemms(cfg, B, N))
            + sum(_transforms(cfg, B, N)))


def step_flops(cfg: Dict, B: int, N: int) -> int:
    """Forward, weight gradients and the input gradients that are needed."""
    total = 0
    for name, r, i, o in gemms(cfg, B, N):
        total += 2 * 2 * r * i * o
        if name != "feat.stn.conv1":
            total += 2 * r * i * o
    t3, tk = _transforms(cfg, B, N)
    return total + 2 * t3 + 3 * tk


def launches(cfg: Dict, B: int, N: int, train: bool) -> List[Dict]:
    """No point kernel: PointNet samples, groups and interpolates
    nothing."""
    return []

