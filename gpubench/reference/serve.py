"""Plain whole-tile vote inference: the sliding grid of 1 m columns at a
0.5 m stride, each vote's re-blocking from its draws, the blocks' features
and forward, and the pool of argmax votes.

- Grid: ``grid_x = ceil((max_x - min_x - size) / stride) + 1`` columns
  (the same in y); column (ix, iy) spans ``[s, e]`` with ``s = min +
  i * stride``, ``e = min(s + size, max)``, ``s = e - size``, and holds
  the points within ``padding`` of it, ascending; empty columns are
  skipped. All in f64.
- Layout: the columns ordered stably by their block count ``ceil(n /
  P)``; each takes ``count * P`` slots, its members first, then fills.
- A vote draws ``u`` (uniform f32) and then ``keys`` (integers below
  2**32) over all slots from a generator seeded with
  ``SeedSequence([seed, tile, vote]).generate_state(1, uint64)``; a fill
  slot takes member ``min(int32(u * n), n - 1)`` of its column, and each
  column's slots are ordered stably by key; every P slots are a block.
- Features in f64, rounded to f32 once: xy minus the column's centre, z,
  xyz / the tile's max, the extras (colours / 255).
- Each block's points vote for their argmax class (in eval, a block's
  output depends on it alone); the label is the argmax of a point's votes
  (ties to the lower class).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from gpubench import spec


def vote_seed(seed: int, tile: int, vote: int) -> int:
    state = np.random.SeedSequence([seed, tile, vote])
    return int(state.generate_state(1, np.uint64)[0])


def grid_columns(xyz: torch.Tensor, size: float, stride: float,
                 padding: float) -> List[Tuple[torch.Tensor, float, float]]:
    """(member indices ascending, s_x, s_y) of every non-empty column;
    ``xyz`` [n, 3] f64 on any device."""
    lo = xyz.amin(0).tolist()
    hi = xyz.amax(0).tolist()
    gx = int(np.ceil((hi[0] - lo[0] - size) / stride) + 1)
    gy = int(np.ceil((hi[1] - lo[1] - size) / stride) + 1)
    x, y = xyz[:, 0], xyz[:, 1]
    cols = []
    for iy in range(gy):
        for ix in range(gx):
            s_x = lo[0] + ix * stride
            e_x = min(s_x + size, hi[0])
            s_x = e_x - size
            s_y = lo[1] + iy * stride
            e_y = min(s_y + size, hi[1])
            s_y = e_y - size
            inside = ((x >= s_x - padding) & (x <= e_x + padding)
                      & (y >= s_y - padding) & (y <= e_y + padding))
            members = torch.nonzero(inside)[:, 0]
            if members.numel():
                cols.append((members, s_x, s_y))
    return cols


def layout(cols, P: int, device):
    """(slots' base indices, column rank, column start and count of each
    slot, each block's (s_x, s_y) f64)."""
    nb = [-(-int(m.numel()) // P) for m, _, _ in cols]
    order = sorted(range(len(cols)), key=lambda i: nb[i])
    base, rank, start, count, offs = [], [], [], [], []
    pos = 0
    for r, i in enumerate(order):
        m, s_x, s_y = cols[i]
        slots = nb[i] * P
        buf = torch.zeros(slots, dtype=torch.int64, device=device)
        buf[:m.numel()] = m
        base.append(buf)
        rank.append(torch.full((slots,), r, dtype=torch.int64, device=device))
        start.append(torch.full((slots,), pos, dtype=torch.int64,
                                device=device))
        count.append(torch.full((slots,), m.numel(), dtype=torch.int64,
                                device=device))
        offs += [(s_x, s_y)] * nb[i]
        pos += slots
    return (torch.cat(base), torch.cat(rank), torch.cat(start),
            torch.cat(count), torch.tensor(offs, dtype=torch.float64,
                                           device=device))


def reblock(lay, seed: int, tile: int, vote: int, P: int) -> torch.Tensor:
    """One vote's blocks [NB, P] of point indices."""
    base, rank, start, count, _ = lay
    L = base.numel()
    g = torch.Generator(device=base.device)
    g.manual_seed(vote_seed(seed, tile, vote))
    u = torch.rand(L, generator=g, device=base.device)
    keys = torch.randint(0, 2 ** 32, (L,), generator=g, device=base.device,
                         dtype=torch.int64)
    pick = (u * count.to(torch.int32)).to(torch.int32).long()
    pick = torch.minimum(pick, count - 1)
    pos = torch.arange(L, device=base.device) - start
    seq = torch.where(pos >= count, base[start + pick], base)
    order = torch.sort((rank << 32) | keys, stable=True).indices
    return seq[order].reshape(-1, P)


def features(xyz, extra, color, idx, offs, size) -> torch.Tensor:
    """[B, P, 6 + E] f32 of blocks idx [B, P] with corners offs [B, 2]."""
    pts = xyz[idx]
    centre = offs + size / 2.0
    parts = [pts[..., :2] - centre[:, None, :], pts[..., 2:], pts / xyz.amax(0)]
    if extra.shape[1]:
        e = extra[idx]
        parts.append(torch.where(color, e / 255.0, e))
    return torch.cat([p.float() for p in parts], dim=-1)


# blocks a reference forward takes at once: more than the program's B
# spreads FPS's sequential steps, whose launches bound a plain forward
REF_BATCH = 128


@torch.no_grad()
def vote_pool(cfg: Dict, weights, tile: Dict, seed: int, tile_index: int,
              serve: Dict) -> torch.Tensor:
    """The tile's pool [n, C] of votes over ``serve["votes"]`` votes."""
    xyz, extra, color = tile["xyz"], tile["extra"], tile["color"]
    n, C = xyz.shape[0], cfg["num_classes"]
    P, size = serve["block_points"], serve["block_size"]
    lay = layout(grid_columns(xyz, size, serve["stride"], serve["padding"]),
                 P, xyz.device)
    net = spec.architecture(cfg).Net(cfg, weights, "eval")
    pool = torch.zeros(n * C, dtype=torch.float32, device=xyz.device)
    for vote in range(serve["votes"]):
        blocks = reblock(lay, seed, tile_index, vote, P)
        for s in range(0, blocks.shape[0], REF_BATCH):
            idx, off = blocks[s:s + REF_BATCH], lay[4][s:s + REF_BATCH]
            pred = net.forward(features(xyz, extra, color, idx, off,
                                        size))[0].argmax(-1)
            flat = idx.reshape(-1) * C + pred.reshape(-1)
            pool += torch.bincount(flat, minlength=n * C).float()
    return pool.view(n, C)
