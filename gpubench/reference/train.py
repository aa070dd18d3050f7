"""Plain training from room ids: the device pipeline's block sampling, the
train step and Adam.

Sampling (1 m x 1 m blocks of P points, ``TrainBlockDataset.sample``'s
semantics as the device pipeline draws them):

- Tables: each room's points ordered stably by a 0.6 m xy bin grid (``bx
  = clip(floor((x - min_x) / 0.6), 0, nbx - 1)``, ``nbx = floor((max_x -
  min_x) / 0.6) + 1``, bin ``bx * nby + by``), as f32; colours / 255;
  ``cap`` the largest bin (at least ceil(P / 9)) rounded up to 256, and
  ``cap`` rows at 1e9 after the last room.
- A block's candidates are the ``cap`` rows from each of the 3 x 3 bins
  around its centre (dx outer, dy inner; a bin off the grid holds none),
  its members those of them within 0.5 m of the centre in x and in y
  (f32).
- Step s of a run draws from a generator seeded with ``(w0 << 31) ^ w1``,
  ``(w0, w1) = SeedSequence([seed, s]).generate_state(2, uint32)``.
- Rejection rounds: each pending row of a call draws 4 centre uniforms
  (the rows of one step from its generator, steps in order); the centre
  is point ``min(int64(u * n), n - 1)`` of the room, a trial is accepted
  when its block has more than ``min_block_points`` members, and a row
  takes its first accepted trial; rows with none draw again.
- Selection: each step's generator draws ``[B, 9 * cap]`` uniforms, then
  ``[B, P]``; the candidates ordered stably by their uniform (2 for a non-
  member) give the first P members, or, for a block of fewer than P,
  member ``min(int64(u * n), n - 1)`` of that order.
- Features: x - cx, y - cy, z, xyz / the room's max (f32), the extras.

The step: a rotation about z by ``2 pi u`` (one uniform a block), the
training forward of the configuration's architecture (``spec.architecture``:
its draws after the rotation, the gathers fast where the configuration says
so), its loss, the gradients, and Adam (betas 0.9, 0.999, eps 1e-8, the
weight decay added to the gradient; on the card with its step count, bias
corrections and learning rate as f32 device tensors, as a CUDA graph holds
them).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from gpubench import spec
from gpubench.reference import ops

BIN_FRACTION = 0.6
CAP_GRANULE = 256
TRIALS = 4
DX = (-1, -1, -1, 0, 0, 0, 1, 1, 1)
DY = (-1, 0, 1, -1, 0, 1, -1, 0, 1)


def stream_seed(seed: int, count: int) -> int:
    words = np.random.SeedSequence([int(seed) % 2 ** 64, int(count)]
                                   ).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


class Rooms:
    """The rooms' tables on ``device`` (see the module's docstring)."""

    def __init__(self, rooms: Sequence[Dict], P: int, block_size: float,
                 min_block_points: int, device):
        self.P, self.min_pts = P, min_block_points
        w = BIN_FRACTION * block_size
        xyz, ext, lab, meta, starts, counts = [], [], [], [], [], []
        off = boff = 0
        cap = 1
        for room in rooms:
            pts = np.asarray(room["xyz"], np.float64)
            lo, hi = pts.min(0), pts.max(0)
            nbx = int(np.floor((hi[0] - lo[0]) / w)) + 1
            nby = int(np.floor((hi[1] - lo[1]) / w)) + 1
            bx = np.clip(np.floor((pts[:, 0] - lo[0]) / w).astype(np.int64),
                         0, nbx - 1)
            by = np.clip(np.floor((pts[:, 1] - lo[1]) / w).astype(np.int64),
                         0, nby - 1)
            bid = bx * nby + by
            order = np.argsort(bid, kind="stable")
            cnt = np.bincount(bid, minlength=nbx * nby)
            cap = max(cap, int(cnt.max()))
            xyz.append(pts[order].astype(np.float32))
            ext.append(np.stack([np.where(c, e / 255.0, e)[order]
                                 for e, c in zip(room["extra"],
                                                 room["color"])],
                                1).astype(np.float32))
            lab.append(np.asarray(room["labels"])[order].astype(np.float32))
            meta.append((off, pts.shape[0], lo[:2], hi, nbx, nby, boff))
            starts.append(np.concatenate([[0], np.cumsum(cnt)[:-1]]) + off)
            counts.append(cnt)
            off += pts.shape[0]
            boff += nbx * nby
        cap = max(cap, -(-P // 9))
        self.cap = int(np.ceil(cap / CAP_GRANULE) * CAP_GRANULE)
        E = ext[0].shape[1]
        xyz.append(np.full((self.cap, 3), 1e9, np.float32))
        ext.append(np.zeros((self.cap, E), np.float32))
        lab.append(np.zeros(self.cap, np.float32))

        def put(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        self.xyz = put(np.concatenate(xyz), torch.float32)
        self.ext = put(np.concatenate(ext), torch.float32)
        self.lab = put(np.concatenate(lab), torch.float32).long()
        i64 = torch.int64
        self.start = put([m[0] for m in meta], i64)
        self.count = put([m[1] for m in meta], i64)
        self.lo = put(np.stack([m[2] for m in meta]), torch.float32)
        self.hi = put(np.stack([m[3] for m in meta]), torch.float32)
        self.nbx = put([m[4] for m in meta], i64)
        self.nby = put([m[5] for m in meta], i64)
        self.boff = put([m[6] for m in meta], i64)
        self.bstart = put(np.concatenate(starts), i64)
        self.bcount = put(np.concatenate(counts), i64)
        self.w = torch.tensor(w, dtype=torch.float32, device=device)
        self.half = torch.tensor(block_size / 2.0, dtype=torch.float32,
                                 device=device)
        self.dx, self.dy = put(DX, i64), put(DY, i64)
        self.lane = torch.arange(self.cap, device=device)
        self.device = device

    def candidates(self, rid, cx, cy):
        """(rows [M, 9 * cap], member [M, 9 * cap]) of blocks centred at
        (cx, cy) in rooms rid."""
        nbx, nby = self.nbx[rid][:, None], self.nby[rid][:, None]
        bx = torch.floor((cx - self.lo[rid, 0]) / self.w)
        by = torch.floor((cy - self.lo[rid, 1]) / self.w)
        bx = torch.minimum(bx.long().clamp_min(0)[:, None], nbx - 1) + self.dx
        by = torch.minimum(by.long().clamp_min(0)[:, None], nby - 1) + self.dy
        ok = (bx >= 0) & (by >= 0) & (bx < nbx) & (by < nby)
        g = torch.where(ok, self.boff[rid][:, None] + bx * nby + by, 0)
        start = torch.where(ok, self.bstart[g], 0)
        cnt = torch.where(ok, self.bcount[g], 0)
        rows = start[..., None] + self.lane                    # [M, 9, cap]
        px, py = self.xyz[rows, 0], self.xyz[rows, 1]
        c_x, c_y = cx[:, None, None], cy[:, None, None]
        member = ((self.lane < cnt[..., None])
                  & (px >= c_x - self.half) & (px <= c_x + self.half)
                  & (py >= c_y - self.half) & (py <= c_y + self.half))
        M = rid.shape[0]
        return rows.reshape(M, -1), member.reshape(M, -1)

    def accept(self, rid: torch.Tensor, gens: List[torch.Generator]):
        """Centres [k*B, 3] and member counts [k*B] of the accepted blocks
        of the rows rid [k*B] (k = len(gens))."""
        k = len(gens)
        B = rid.shape[0] // k
        center = torch.empty(rid.shape[0], 3, device=self.device)
        cnt = torch.empty(rid.shape[0], dtype=torch.int64, device=self.device)
        pending = np.arange(rid.shape[0])
        while pending.size:
            step = pending // B
            u = torch.cat([torch.rand(int((step == i).sum()), TRIALS,
                                      generator=gens[i], device=self.device)
                           for i in np.unique(step)])
            rows = torch.as_tensor(pending, device=self.device)
            r = rid[rows].repeat_interleave(TRIALS)
            n = self.count[r]
            t = torch.minimum((u.reshape(-1) * n.float()).long(), n - 1)
            c = self.xyz[self.start[r] + t]
            members = self.candidates(r, c[:, 0], c[:, 1])[1].sum(1)
            ok = (members > self.min_pts).view(-1, TRIALS)
            first = torch.where(ok, torch.arange(TRIALS, device=self.device),
                                TRIALS).amin(1).clamp_max(TRIALS - 1)
            pick = torch.arange(rows.numel(), device=self.device) * TRIALS \
                + first
            center[rows] = c[pick]
            cnt[rows] = members[pick]
            pending = pending[~ok.any(1).cpu().numpy()]
        return center, cnt

    def select(self, rid, center, cnt, gens):
        """(points [k, B, P, 6 + E], labels [k, B, P])."""
        k, P = len(gens), self.P
        B = rid.shape[0] // k
        sel_u = torch.cat([torch.rand(B, 9 * self.cap, generator=g,
                                      device=self.device) for g in gens])
        rep_u = torch.cat([torch.rand(B, P, generator=g, device=self.device)
                           for g in gens])
        rows, member = self.candidates(rid, center[:, 0], center[:, 1])
        order = torch.sort(torch.where(member, sel_u, 2.0), dim=1,
                           stable=True).indices
        ranked = rows.gather(1, order)
        r = torch.minimum((rep_u * cnt[:, None].float()).long(),
                          cnt[:, None] - 1)
        sel = torch.where((cnt >= P)[:, None], ranked[:, :P],
                          ranked.gather(1, r))
        pts = self.xyz[sel]
        feats = torch.cat([pts[..., :2] - center[:, None, :2], pts[..., 2:3],
                           pts / self.hi[rid][:, None, :], self.ext[sel]], -1)
        return feats.view(k, B, P, -1), self.lab[sel].view(k, B, P)


def train_calls(cfg: Dict, weights: Dict[str, torch.Tensor], rooms: Rooms,
                calls: Sequence[np.ndarray], class_weights: torch.Tensor,
                seed: int, train: Dict, start: Dict = None):
    """Runs the calls (each [k, B] room ids) from ``weights`` (copied):
    -> (losses [steps], parameters and Adam's first moments after the
    calls, and the norms of the first step's gradients, each by leaf).

    Without ``start`` the run begins at step 0 with Adam's state empty.
    With ``start`` = {"step": s, "moments": {leaf: m}, "squares": {leaf:
    v}} it begins at step s (its draws and Adam's step count) with Adam's
    first and second moments m and v."""
    device = rooms.device
    arch = spec.architecture(cfg)
    params = {k: v.detach().clone() for k, v in weights.items()}
    names = arch.leaves(params)
    for n in names:
        params[n].requires_grad_(True)
    card = torch.device(device).type == "cuda"
    lr = (torch.tensor(train["lr"], device=device) if card
          else train["lr"])
    opt = torch.optim.Adam([params[n] for n in names], lr=lr,
                           betas=tuple(train["betas"]), eps=train["eps"],
                           weight_decay=train["weight_decay"],
                           capturable=card)
    step = 0
    if start is not None:
        step = int(start["step"])
        for n in names:
            opt.state[params[n]] = {
                "step": torch.tensor(float(step), dtype=torch.float32,
                                     device=device if card else "cpu"),
                "exp_avg": start["moments"][n].to(device).clone(),
                "exp_avg_sq": start["squares"][n].to(device).clone()}
    losses, first = [], None
    for ids in calls:
        k = ids.shape[0]
        gens = []
        for i in range(k):
            g = torch.Generator(device=device)
            g.manual_seed(stream_seed(seed, step + i))
            gens.append(g)
        rid = torch.as_tensor(ids.reshape(-1), device=device).long()
        center, cnt = rooms.accept(rid, gens)
        points, labels = rooms.select(rid, center, cnt, gens)
        for i, g in enumerate(gens):
            x = points[i]
            angles = torch.rand(x.shape[0], generator=g,
                                device=device) * (2 * math.pi)
            x = torch.cat([ops.rotate_z(x[..., :3], angles), x[..., 3:]], -1)
            logp, aux = arch.Net(cfg, params, "train",
                                 fast=train["fast_gather"],
                                 generator=g).forward(x)
            loss = arch.loss(cfg, logp, labels[i], aux, class_weights)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if first is None:
                first = {n: float(params[n].grad.norm()) for n in names}
            opt.step()
            losses.append(float(loss.detach()))
        step += k
    moments = {n: opt.state[params[n]]["exp_avg"] for n in names}
    return (losses, {n: params[n].detach() for n in names}, moments, first)
