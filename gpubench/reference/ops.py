"""Plain point-cloud ops: farthest point sampling, ball query, grouping and
3-NN interpolation, with the single-pass bf16 ("fast") gathers and their
backward passes.

Distances are built in the direct form ``(dx*dx + dy*dy) + dz*dz`` with one
PyTorch op a term, so nothing contracts into an FMA; ties go to the lower
index. The fast mode rounds a group's source to bf16, centres in f32 and
stores bf16; its backward rounds the cotangent to bf16 and sums in f32. The
interpolation's fast mode rounds the weights and the features (or, going
back, the cotangent) to bf16 and multiplies and adds in f32.

The backward passes' scatter-adds run on the CPU, whose ``scatter_add_``
adds in ascending order of the flat index: each sum is then the
sequential f32 sum in a fixed order, as the port's backward kernels take
it, and not the order of a card's atomic adds, which differs from run to
run.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest, ties to even), as f32."""
    return t.to(torch.bfloat16).float()


def direct_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [B, N, 3], b [B, M, 3] -> [B, M, N] squared distances."""
    dx = a[:, None, :, 0] - b[:, :, None, 0]
    dy = a[:, None, :, 1] - b[:, :, None, 1]
    dz = a[:, None, :, 2] - b[:, :, None, 2]
    return dx * dx + dy * dy + dz * dz


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """xyz [B, N, 3] -> [B, npoint] int64: the running minimum distance
    starts at 1e10; each step takes the first index of the largest."""
    B, N, _ = xyz.shape
    far = (torch.zeros(B, dtype=torch.int64, device=xyz.device)
           if start is None else start.long())
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    out = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    ramp = torch.arange(N, device=xyz.device)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(B, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        c = xyz[rows, far]
        dx = x - c[:, None, 0]
        dy = y - c[:, None, 1]
        dz = z - c[:, None, 2]
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        far = torch.where(dist == dist.amax(dim=1, keepdim=True), ramp,
                          N).amin(dim=1)
    return out


def ball_query(radii: Sequence[float], nsamples: Sequence[int],
               xyz: torch.Tensor, new_xyz: torch.Tensor
               ) -> Tuple[torch.Tensor, ...]:
    """One [B, S, K] int64 index tensor a radius: the first K indices in
    ascending order with squared distance <= r^2 (r^2 rounded to f32 once);
    a shortfall repeats the first hit, an empty ball gives N."""
    d = direct_sqdist(xyz, new_xyz)
    N = d.shape[-1]
    ramp = torch.arange(N, device=d.device)
    out = []
    for radius, k in zip(radii, nsamples):
        r2 = torch.tensor(float(radius) * float(radius), dtype=torch.float32,
                          device=d.device)
        masked = torch.where(d <= r2, ramp, N)
        idx = torch.topk(masked, min(k, N), dim=-1, largest=False,
                         sorted=True).values
        if idx.shape[-1] < k:
            idx = torch.cat([idx, idx.new_full((*idx.shape[:2],
                                                k - idx.shape[-1]), N)], -1)
        out.append(torch.where(idx == N, idx[..., :1], idx))
    return tuple(out)


def scatter_add(idx: torch.Tensor, src: torch.Tensor, n: int) -> torch.Tensor:
    """out [B, n, C] with ``out[b, idx[b, i]] += src[b, i]``, summed in
    ascending order of i (on the CPU), on src's device."""
    B, M, C = src.shape
    out = torch.zeros(B, n, C, dtype=torch.float32)
    out.scatter_add_(1, idx.cpu().reshape(B, M, 1).expand(B, M, C),
                     src.float().cpu())
    return out.to(src.device)


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, ...] -> [B, ..., C]."""
    B, _, C = points.shape
    flat = idx.reshape(B, -1)
    out = torch.gather(points, 1, flat[..., None].expand(B, flat.shape[1], C))
    return out.reshape(*idx.shape, C)


class Group(torch.autograd.Function):
    """(idx [B, S, K], src [B, N, C], centre [B, S, 3]) -> [B, S, K, C],
    channels 0-2 relative to the centre; idx == N reads a zero row. Fast:
    bf16(src) gathered, centred in f32, stored bf16; backward the bf16
    cotangent scattered in f32."""

    @staticmethod
    def forward(ctx, idx, src, centre, fast):
        B, N, C = src.shape
        s = bf16(src) if fast else src
        padded = torch.cat([s, s.new_zeros(B, 1, C)], dim=1)
        out = gather(padded, idx) - torch.nn.functional.pad(
            centre, (0, C - 3))[:, :, None, :]
        ctx.save_for_backward(idx)
        ctx.n, ctx.fast = N, fast
        return out.to(torch.bfloat16) if fast else out

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        B, S, K, C = grad.shape
        g = bf16(grad) if ctx.fast else grad.float()
        out = scatter_add(idx.reshape(B, S * K), g.reshape(B, S * K, C),
                          ctx.n + 1)
        return None, out[:, :ctx.n], None, None


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """-> (dists [B, N, 3], idx [B, N, 3]): the three nearest of xyz2 to
    each point of xyz1, ascending by (distance, index)."""
    cand = direct_sqdist(xyz2, xyz1)                            # [B, N, S]
    S = cand.shape[-1]
    ramp = torch.arange(S, device=cand.device)
    dists, idxs = [], []
    for k in range(3):
        minv = cand.amin(dim=-1, keepdim=True)
        mi = torch.where(cand == minv, ramp, S).amin(dim=-1)
        dists.append(minv[..., 0])
        idxs.append(mi)
        if k < 2:
            cand = torch.where(ramp == mi[..., None], float("inf"), cand)
    return torch.stack(dists, -1), torch.stack(idxs, -1)


def interpolation_weights(dists: torch.Tensor) -> torch.Tensor:
    """``r = 1 / (d + 1e-8)``, ``w = r / ((r0 + r1) + r2)``."""
    r = 1.0 / (dists + 1e-8)
    return r / (r[..., 0:1] + r[..., 1:2] + r[..., 2:3])


class Interpolate(torch.autograd.Function):
    """(w [B, N, 3], idx [B, N, 3], points2 [B, S, D]) ->
    ``(w0*p[i0] + w1*p[i1]) + w2*p[i2]``; fast rounds w and points2 to bf16
    (the backward w and the cotangent), products and sums in f32."""

    @staticmethod
    def forward(ctx, w, idx, points2, fast):
        if fast:
            w, points2 = bf16(w), bf16(points2)
        nb = gather(points2, idx)                              # [B, N, 3, D]
        ctx.save_for_backward(w, idx)
        ctx.s, ctx.fast = points2.shape[1], fast
        return (nb[:, :, 0] * w[..., 0:1] + nb[:, :, 1] * w[..., 1:2]
                + nb[:, :, 2] * w[..., 2:3])

    @staticmethod
    def backward(ctx, grad):
        w, idx = ctx.saved_tensors
        B, N, D = grad.shape
        g = bf16(grad) if ctx.fast else grad
        contrib = w[..., None] * g[:, :, None, :]
        out = scatter_add(idx.reshape(B, N * 3), contrib.reshape(B, N * 3, D),
                          ctx.s)
        return None, None, out, None


def interpolate(xyz1, xyz2, points2, fast: bool):
    """The 3-NN inverse-distance interpolation of points2 onto xyz1."""
    dists, idx = three_nn(xyz1, xyz2)
    return Interpolate.apply(interpolation_weights(dists), idx, points2,
                             fast)


def rotate_z(xyz: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] rotated about z: ``xyz @ R``, R = [[c, s, 0], [-s, c, 0],
    [0, 0, 1]]."""
    c, s = torch.cos(angles), torch.sin(angles)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, s, zeros], -1),
                       torch.stack([-s, c, zeros], -1),
                       torch.stack([zeros, zeros, ones], -1)], -2)
    return torch.bmm(xyz, rot)
