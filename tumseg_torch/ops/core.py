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
The one exception is the z-window 3-NN and its full fallback
(:func:`three_nn_windowed`, :func:`three_nn_expansion`), which keep the
expansion form of the Pallas kernels they answer.

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


def _peel3(cand: torch.Tensor, ids: torch.Tensor, fill: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The three smallest of ``cand`` [..., M] by (distance, id), ascending:
    -> (dists [..., 3], ids [..., 3] int32). ``ids`` (broadcastable to
    ``cand``, unique along the last axis) names each candidate; ``fill`` is
    larger than every id."""
    dists, idxs = [], []
    for k in range(3):
        minv = cand.amin(dim=-1, keepdim=True)
        mi = torch.where(cand == minv, ids, fill).amin(dim=-1)
        dists.append(minv[..., 0])
        idxs.append(mi)
        if k < 2:
            cand = torch.where(ids == mi[..., None], float("inf"), cand)
    return torch.stack(dists, dim=-1), torch.stack(idxs, dim=-1)


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
    return _peel3(cand, ramp, S)


def _sqnorm(p: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [...]: ``(x*x + y*y) + z*z``."""
    return p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2]


def _expansion_sqdist(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """q [..., Nq, 3], s [..., M, 3] -> [..., Nq, M] squared distances in
    the EXPANSION form of ``tumseg/ops/pallas/threenn.py:32-52``:
    ``(qsq + ssq) - 2*cross``, each of qsq, ssq and cross summed as
    ``(x + y) + z``. Not clamped at 0: a negative distance from
    cancellation is kept, as ``tumseg`` keeps it."""
    cross = (q[..., :, None, 0] * s[..., None, :, 0]
             + q[..., :, None, 1] * s[..., None, :, 1]
             + q[..., :, None, 2] * s[..., None, :, 2])
    return (_sqnorm(q)[..., :, None] + _sqnorm(s)[..., None, :]) - 2.0 * cross


def three_nn_expansion(xyz1: torch.Tensor, xyz2: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3-NN of :func:`three_nn` with expansion-form distances
    (``threenn.py:_threenn_kernel``, ``_three_nn_impl``): -> (dists
    [B, N, 3] f32, idx [B, N, 3] int32), ties to the lower index."""
    S = xyz2.shape[1]
    if S < 3:
        raise ValueError(f"three_nn needs at least 3 sources, got S={S}")
    ramp = torch.arange(S, device=xyz1.device, dtype=torch.int32)
    return _peel3(_expansion_sqdist(xyz1, xyz2), ramp, S)


def window_plan(n: int, s: int, window: int, n_tile: int
                ) -> Optional[Tuple[int, int]]:
    """-> (C, n_tile) of a windowed 3-NN of ``n`` queries over ``s``
    sources, or None where ``tumseg`` takes the full expansion form
    (``threenn.py:259-266``): a window of the whole row, or one that is not
    a multiple of 128, or ``s`` not a multiple of 128. ``n_tile`` becomes
    ``n`` when it does not divide ``n``."""
    c = min(window, s)
    n_tile = min(n_tile, n)
    if n % n_tile != 0:
        n_tile = n
    if c == s or c % 128 != 0 or s % 128 != 0:
        return None
    return c, n_tile


def window_starts(zs: torch.Tensor, qzs: torch.Tensor, n_tile: int, c: int
                  ) -> torch.Tensor:
    """First sorted source of each query tile's window (``threenn.py:
    282-289``): zs [B, S] and qzs [B, N] ascending -> [B, N // n_tile]
    int32, the window centred on the tile's source-rank span, rounded down
    to a multiple of 128 and clipped into [0, S - c]."""
    lo = torch.searchsorted(zs, qzs[:, ::n_tile].contiguous(), side="left")
    hi = torch.searchsorted(zs, qzs[:, n_tile - 1::n_tile].contiguous(),
                            side="left")
    mid = torch.div(lo + hi, 2, rounding_mode="floor") - c // 2
    start = torch.div(mid, 128, rounding_mode="floor") * 128
    return start.clamp(0, zs.shape[1] - c).to(torch.int32)


def sort_by_z(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """p [B, M, 3] -> (rows stably sorted by z [B, M, 3], order [B, M]
    int32 with sorted[b, i] = p[b, order[b, i]])."""
    _, order = torch.sort(p[..., 2], dim=1, stable=True)
    rows = torch.gather(p, 1, order[..., None].expand(*order.shape, 3))
    return rows, order.to(torch.int32)


def three_nn_windowed(xyz1: torch.Tensor, xyz2: torch.Tensor, window: int,
                      n_tile: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """The z-window 3-NN of ``threenn.py:_three_nn_windowed_impl``: equal to
    :func:`three_nn_expansion`, found by scanning only a window of ``C``
    z-sorted sources per tile of ``n_tile`` z-sorted queries.

    Sources and queries are sorted stably by z, each tile's window is
    placed by :func:`window_starts`, and each query keeps its three nearest
    window sources by (distance, ORIGINAL index). Its result is exact when
    the guard of ``threenn.py:319-335`` holds: its 3rd distance plus the
    slack ``8e-7 * (1 + qsq + max ssq)`` lies below the squared z-gap to
    each window edge that is not the end of the row, so no source outside
    the window is as near. A query that fails the guard takes the full
    expansion form. A pair's distance is the same arithmetic in both, so
    the result equals the full expansion form's for every query; ``tumseg``
    takes the full kernel for the whole batch when any query fails, which
    gives the same result. -> (dists [B, N, 3], idx [B, N, 3] int32) in
    the original query order."""
    B, N, _ = xyz1.shape
    plan = window_plan(N, xyz2.shape[1], window, n_tile)
    if plan is None:
        return three_nn_expansion(xyz1, xyz2)
    qs, qorder, dists, idx, ok = _window_search(xyz1, xyz2, *plan)
    if not bool(ok.all()):
        fd, fi = three_nn_expansion(qs, xyz2)
        dists = torch.where(ok[..., None], dists, fd)
        idx = torch.where(ok[..., None], idx, fi)
    return _unsort(dists, qorder), _unsort(idx, qorder)


def window_guard(xyz1: torch.Tensor, xyz2: torch.Tensor, window: int,
                 n_tile: int = 256) -> torch.Tensor:
    """[B, N] bool in the original query order: True where a query's window
    answer passes the exactness guard of :func:`three_nn_windowed` (all
    True where there is no window)."""
    B, N, _ = xyz1.shape
    plan = window_plan(N, xyz2.shape[1], window, n_tile)
    if plan is None:
        return torch.ones(B, N, dtype=torch.bool, device=xyz1.device)
    _, qorder, _, _, ok = _window_search(xyz1, xyz2, *plan)
    return _unsort(ok, qorder)


def _unsort(v: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Rows of ``v`` [B, N, ...] in sorted order back to the original order
    (``order`` [B, N] from :func:`sort_by_z`)."""
    index = order.long().reshape(*order.shape, *([1] * (v.dim() - 2)))
    return torch.empty_like(v).scatter_(1, index.expand_as(v), v)


def _window_search(xyz1: torch.Tensor, xyz2: torch.Tensor, C: int,
                   n_tile: int):
    """The windowed scan and its guard, in z-sorted query order: -> (sorted
    queries [B, N, 3], qorder [B, N], dists [B, N, 3], idx [B, N, 3],
    ok [B, N])."""
    B, N, _ = xyz1.shape
    S = xyz2.shape[1]
    T = N // n_tile
    srt, sorder = sort_by_z(xyz2)
    qs, qorder = sort_by_z(xyz1)
    zs = srt[..., 2].contiguous()
    start = window_starts(zs, qs[..., 2].contiguous(), n_tile, C)   # [B, T]
    pos = start.long()[..., None] + torch.arange(C, device=xyz1.device)
    win = torch.gather(srt, 1, pos.reshape(B, T * C, 1).expand(
        B, T * C, 3)).reshape(B, T, C, 3)
    oc = torch.gather(sorder, 1, pos.reshape(B, T * C)).reshape(B, T, 1, C)
    cand = _expansion_sqdist(qs.reshape(B, T, n_tile, 3), win)
    dists, idx = _peel3(cand, oc, S)
    dists, idx = dists.reshape(B, N, 3), idx.reshape(B, N, 3)

    zlo = torch.gather(zs, 1, start.long()).repeat_interleave(n_tile, 1)
    zhi = torch.gather(zs, 1, start.long() + C - 1).repeat_interleave(
        n_tile, 1)
    start_q = start.repeat_interleave(n_tile, 1)
    qz = qs[..., 2]
    slack = 8e-7 * ((1.0 + _sqnorm(qs)) + _sqnorm(srt).amax(1, keepdim=True))
    d3 = dists[..., 2] + slack
    left = (qz - zlo) * (qz - zlo)
    right = (zhi - qz) * (zhi - qz)
    ok = (((start_q == 0) | ((qz >= zlo) & (d3 < left)))
          & ((start_q + C == S) | ((qz <= zhi) & (d3 < right))))
    return qs, qorder, dists, idx, ok


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


def three_nn_window_interpolate(xyz1: torch.Tensor, xyz2: torch.Tensor,
                                points2: torch.Tensor, window: int,
                                n_tile: int = 256):
    """-> (dists, idx, out) of :func:`three_nn_interpolate` with the 3-NN of
    :func:`three_nn_windowed`; one kernel on the card."""
    dists, idx = three_nn_windowed(xyz1, xyz2, window, n_tile)
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
