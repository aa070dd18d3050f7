"""Plain PyTorch versions of the point-cloud ops and of their backward passes.

Each function here has the contract of one hand-written CUDA kernel in
``tumseg_torch/csrc`` (and of the Pallas kernel that kernel replaces), so the
CPU tests can hold the port against ``tumseg`` and ``chip_smoke.py`` can hold
every kernel against its plain version on the card.

Distances are built in the DIRECT form ``dx*dx + dy*dy + dz*dz`` (summed left
to right), as the Pallas ball-query and 3-NN kernels build them
(``tumseg/ops/pallas/ballquery.py:_bp_distances``,
``tumseg/ops/pallas/threenn.py:_threenn_kernel_t``), not with the
``|a|^2 + |b|^2 - 2a.b`` expansion of ``tumseg/ops/core.py:square_distance``.
PyTorch runs each elementwise op as its own kernel, so nothing contracts
into an FMA, and the CUDA kernels are built with ``-fmad=false``: kernel and
plain version round identically and their index outputs are held equal.

Ties always go to the lower index: arg-reductions are written as a masked
min over an index ramp, never left to ``argmax``/``topk`` tie rules.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def _direct_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [B, N, 3], b [B, M, 3] -> [B, M, N] squared distances,
    ``((dx*dx + dy*dy) + dz*dz)`` with d = a - b."""
    dx = a[:, None, :, 0] - b[:, :, None, 0]
    dy = a[:, None, :, 1] - b[:, :, None, 1]
    dz = a[:, None, :, 2] - b[:, :, None, 2]
    return dx * dx + dy * dy + dz * dz


def _first_index_where(mask: torch.Tensor, fill: int) -> torch.Tensor:
    """Lowest index along the last axis where ``mask`` holds, else ``fill``."""
    n = mask.shape[-1]
    ramp = torch.arange(n, device=mask.device, dtype=torch.int32)
    return torch.where(mask, ramp, fill).amin(dim=-1)


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """xyz [B, N, 3] f32 -> [B, npoint] int32 (``tumseg/ops/core.py:59-93``).

    Min-distance field starts at 1e10; each step records the current
    centroid, folds in its distances and moves to the first index of the
    largest remaining distance. ``start`` [B] seeds the first centroid
    (default 0). ``npoint > N`` is allowed: once every distance is 0 the
    first-index argmax returns 0."""
    B, N, _ = xyz.shape
    far = (torch.zeros(B, dtype=torch.int32, device=xyz.device)
           if start is None else start.to(torch.int32))
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    for i in range(npoint):
        out[:, i] = far
        c = torch.gather(xyz, 1, far.long()[:, None, None].expand(B, 1, 3))
        dx = x - c[..., 0]
        dy = y - c[..., 1]
        dz = z - c[..., 2]
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        far = _first_index_where(dist == dist.amax(dim=1, keepdim=True), N)
    return out


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """xyz [B, N, 3], new_xyz [B, S, 3] -> [B, S, nsample] int32.

    The first ``nsample`` indices in ascending order with squared distance
    ``<= radius**2`` (r^2 rounded to f32 once, as JAX's weak-typed scalar
    is). A shortfall repeats the first hit; an empty ball yields N in every
    slot (``tumseg/ops/core.py:96-122``, ``ballquery.py:48-86``)."""
    return _first_in_ball(_direct_sqdist(xyz, new_xyz), radius, nsample)


def query_ball_point_multi(radii: Sequence[float], nsamples: Sequence[int],
                           xyz: torch.Tensor, new_xyz: torch.Tensor
                           ) -> Tuple[torch.Tensor, ...]:
    """One ball query per radius over one distance build: -> a tuple of
    [B, S, nsamples[i]] int32, each equal to ``query_ball_point(radii[i],
    nsamples[i], xyz, new_xyz)`` (``ballquery.py:293-307,362-403``)."""
    if len(radii) != len(nsamples):
        raise ValueError(f"{len(radii)} radii but {len(nsamples)} nsamples")
    d = _direct_sqdist(xyz, new_xyz)                           # [B, S, N]
    return tuple(_first_in_ball(d, r, k) for r, k in zip(radii, nsamples))


def _first_in_ball(d: torch.Tensor, radius: float, nsample: int
                   ) -> torch.Tensor:
    """The first ``nsample`` indices along the last axis of the squared
    distances ``d`` [B, S, N] with ``d <= radius**2`` (r^2 rounded to f32
    once), shortfall and empty ball as :func:`query_ball_point`."""
    N = d.shape[-1]
    r2 = torch.tensor(float(radius) * float(radius), dtype=torch.float32,
                      device=d.device)
    ramp = torch.arange(N, device=d.device, dtype=torch.int32)
    masked = torch.where(d <= r2, ramp, N)
    k = min(nsample, N)
    idx = torch.topk(masked, k, dim=-1, largest=False, sorted=True).values
    if k < nsample:
        idx = torch.cat([idx, idx.new_full((*idx.shape[:2], nsample - k), N)],
                        dim=-1)
    return torch.where(idx == N, idx[..., :1], idx)


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, ...] int -> [B, ..., C]."""
    B, _, C = points.shape
    flat = idx.reshape(B, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(B, flat.shape[1], C))
    return out.reshape(*idx.shape, C)


def group_points(idx: torch.Tensor, src: torch.Tensor,
                 new_xyz: torch.Tensor) -> torch.Tensor:
    """idx [B, S, K] int, src [B, N, C] (xyz first), new_xyz [B, S, 3]
    -> [B, S, K, C], channels 0-2 made relative to ``new_xyz``.

    ``idx == N`` (an empty ball) reads a zero row, so its output is
    ``-center`` on channels 0-2 and 0 elsewhere, as the one-hot contraction
    of ``tumseg/ops/pallas/group.py:60-72`` gives. A zero row is appended
    because ``torch.gather`` would reject the index."""
    B, _, C = src.shape
    padded = torch.cat([src, src.new_zeros(B, 1, C)], dim=1)
    grouped = index_points(padded, idx)                        # [B, S, K, C]
    center = torch.nn.functional.pad(new_xyz, (0, C - 3))      # [B, S, C]
    return grouped - center[:, :, None, :]


def gather_rows(xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """xyz [B, N, 3], idx [B, S] -> [B, S, 3]: the centroid gather after FPS,
    the group op with K=1 and zero centers (``tumseg/ops/__init__.py:195``).
    """
    zeros = xyz.new_zeros(idx.shape[0], idx.shape[1], 3)
    return group_points(idx[:, :, None], xyz, zeros)[:, :, 0, :]


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xyz1 [B, N, 3], xyz2 [B, S, 3] -> (dists [B, N, 3] f32,
    idx [B, N, 3] int32): the three nearest sources by squared distance,
    ascending, ties to the lower index (the peel of
    ``tumseg/ops/pallas/threenn.py:70-120``)."""
    S = xyz2.shape[1]
    if S < 3:
        raise ValueError(f"three_nn needs at least 3 sources, got S={S}")
    cand = _direct_sqdist(xyz2, xyz1)                          # [B, N, S]
    ramp = torch.arange(S, device=xyz1.device, dtype=torch.int32)
    dists, idxs = [], []
    for k in range(3):
        minv = cand.amin(dim=-1, keepdim=True)
        mi = _first_index_where(cand == minv, S)
        dists.append(minv[..., 0])
        idxs.append(mi)
        if k < 2:
            cand = torch.where(ramp == mi[..., None], float("inf"), cand)
    return torch.stack(dists, dim=-1), torch.stack(idxs, dim=-1)


def interpolation_weights(dists: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weights ``r = 1/(d + 1e-8)``, ``w = r/((r0+r1)+r2)``
    (``tumseg/ops/__init__.py:323-324``), the formula the fused CUDA kernel
    uses: dists [B, N, 3] -> [B, N, 3]."""
    r = 1.0 / (dists + 1e-8)
    return r / (r[..., 0:1] + r[..., 1:2] + r[..., 2:3])


def interpolate_weighted(dists: torch.Tensor, idx: torch.Tensor,
                         points2: torch.Tensor) -> torch.Tensor:
    """``out = (w0*p[i0] + w1*p[i1]) + w2*p[i2]`` -> [B, N, D] with the
    weights of :func:`interpolation_weights`."""
    w = interpolation_weights(dists)
    nb = index_points(points2, idx)                            # [B, N, 3, D]
    return (nb[:, :, 0] * w[..., 0:1] + nb[:, :, 1] * w[..., 1:2]
            + nb[:, :, 2] * w[..., 2:3])


def three_nn_interpolate(xyz1: torch.Tensor, xyz2: torch.Tensor,
                         points2: torch.Tensor):
    """-> (dists [B, N, 3], idx [B, N, 3] int32, out [B, N, D]): 3-NN and
    the weighted interpolation that consumes it, one kernel on the card."""
    dists, idx = three_nn(xyz1, xyz2)
    return dists, idx, interpolate_weighted(dists, idx, points2)


def three_interpolate(xyz1: torch.Tensor, xyz2: torch.Tensor,
                      points2: torch.Tensor) -> torch.Tensor:
    return three_nn_interpolate(xyz1, xyz2, points2)[2]


def group_points_backward(idx: torch.Tensor, grad: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Backward of :func:`group_points` with respect to ``src``: idx
    [B, S, K] int in [0, n], grad [B, S, K, C] -> dsrc [B, n, C], the
    scatter-add ``dsrc[b, idx[b,s,k]] += grad[b,s,k]``
    (``tumseg/ops/pallas/group.py:_group_t_bwd_impl``). The sentinel
    ``idx == n`` adds into an appended row that is dropped, so it adds
    nothing."""
    B, S, K, C = grad.shape
    flat = idx.reshape(B, S * K, 1).long().expand(B, S * K, C)
    out = grad.new_zeros(B, n + 1, C)
    out.scatter_add_(1, flat, grad.reshape(B, S * K, C))
    return out[:, :n]


def interpolate_backward(idx: torch.Tensor, weight: torch.Tensor,
                         grad: torch.Tensor, s: int) -> torch.Tensor:
    """Backward of the weighted interpolation with respect to ``points2``:
    idx [B, N, 3] int in [0, s), weight [B, N, 3], grad [B, N, D] ->
    dpoints2 [B, s, D] = W^T g, i.e. ``dp2[b, idx[b,n,k]] += w[b,n,k] *
    grad[b,n]`` (``tumseg/ops/pallas/interpolate.py:_interp_bwd_impl``)."""
    B, N, D = grad.shape
    contrib = weight[..., None] * grad[:, :, None, :]          # [B, N, 3, D]
    flat = idx.reshape(B, N * 3, 1).long().expand(B, N * 3, D)
    out = grad.new_zeros(B, s, D)
    return out.scatter_add_(1, flat, contrib.reshape(B, N * 3, D))


def sample_and_group(npoint: int, radius: float, nsample: int,
                     xyz: torch.Tensor, points: Optional[torch.Tensor],
                     fps_start: Optional[torch.Tensor] = None):
    """FPS (from ``fps_start`` [B], default 0) -> centroid gather -> ball
    query -> group + center:
    -> (new_xyz [B, npoint, 3], grouped [B, npoint, nsample, 3 (+D)])."""
    new_xyz = gather_rows(xyz, farthest_point_sample(xyz, npoint,
                                                     start=fps_start))
    idx = query_ball_point(radius, nsample, xyz, new_xyz)
    src = torch.cat([xyz, points], dim=-1) if points is not None else xyz
    return new_xyz, group_points(idx, src, new_xyz)
