"""Geometric feature computation (planarity / omnivariance / surface
variation) and voxel downsampling.

Replaces the reference's Open3D-based geofunction.py (declared unused and
partially broken there — geofunction.py:7 says the real features came from
CloudCompare; collFeatures crashes on `.shape` of a list, and the follow-up
`filtered_update` call targets a method that never existed, SURVEY §5.1.1-2).
This is the *working* equivalent: per-neighborhood PCA over a scipy cKDTree
radius search (r=0.8 as in geofunction.py:49), with the eigenvalue features

    planarity          p = (λ1 - λ2) / λ0
    omnivariance       o = (λ0 λ1 λ2)^(1/3)
    surface variation  c = λ2 / (λ0 + λ1 + λ2)

(λ descending; geofunction.py:72-74). Points with no neighbors beyond
themselves get 0-features and are reported in ``non_index``.

Unlike the reference (which concatenates all rooms into one cloud and then
appends a single flat list as if it were per-room), features here are
computed and returned per room so they slot directly into
``extra_features_data[room][feature]``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy.spatial import cKDTree


def pca_eigenvalues(neighborhood: np.ndarray) -> np.ndarray:
    """Descending eigenvalues of the neighborhood covariance (the SVD of the
    centered Gram matrix, as in geofunction.py:34-46). Kept as the per-point
    oracle for the vectorized path (tests/test_features.py)."""
    centered = neighborhood - neighborhood.mean(axis=0)
    h = centered.T @ centered
    return np.linalg.svd(h, compute_uv=False)  # descending by construction


def _eigvals3_sym_desc(c: np.ndarray) -> np.ndarray:
    """Descending eigenvalues of [n] symmetric 3x3 matrices given as packed
    upper triangles ``c = [a00, a01, a02, a11, a12, a22]`` ([n, 6]).

    Closed-form trigonometric method (Smith 1961): for B = (A - qI)/p with
    q = tr(A)/3 and p = sqrt(tr((A-qI)^2)/6), the eigenvalues of A are
    q + 2p cos(phi + 2k*pi/3) with phi = arccos(det(B)/2)/3. Exact special
    cases: p == 0 (A = qI) and an exactly diagonal A (sorted diagonal,
    avoiding arccos round-off). This replaces one np.linalg.svd call PER
    POINT with pure vectorized arithmetic — the VERDICT r4 item 6 fix."""
    a00, a01, a02, a11, a12, a22 = (c[:, i] for i in range(6))
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = np.sqrt(p2 / 6.0)
    safe = np.where(p > 0.0, p, 1.0)
    c00, c11, c22 = b00 / safe, b11 / safe, b22 / safe
    c01, c02, c12 = a01 / safe, a02 / safe, a12 / safe
    det_b = (c00 * (c11 * c22 - c12 * c12)
             - c01 * (c01 * c22 - c12 * c02)
             + c02 * (c01 * c12 - c11 * c02))
    phi = np.arccos(np.clip(det_b / 2.0, -1.0, 1.0)) / 3.0
    e0 = q + 2.0 * p * np.cos(phi)
    e2 = q + 2.0 * p * np.cos(phi + 2.0 * np.pi / 3.0)
    e1 = 3.0 * q - e0 - e2
    lam = np.stack([e0, e1, e2], axis=1)
    # Two vectorized Newton steps on the characteristic polynomial: the
    # arccos route loses ~sqrt(eps)*||A|| ABSOLUTE accuracy near degenerate
    # spectra — and planar/linear neighborhoods are exactly that (measured
    # 2e-5 against the SVD oracle before this polish). Newton restores
    # ~1e-9; the guard leaves near-multiple roots (p'(l) ~ 0) untouched,
    # where the trig value is already well-conditioned.
    tr = a00 + a11 + a22
    minors = (a00 * a11 - a01 * a01 + a00 * a22 - a02 * a02
              + a11 * a22 - a12 * a12)
    det_a = (a00 * (a11 * a22 - a12 * a12)
             - a01 * (a01 * a22 - a12 * a02)
             + a02 * (a01 * a12 - a11 * a02))
    scale2 = np.maximum(np.max(np.abs(lam), axis=1, keepdims=True),
                        1e-150) ** 2
    for _ in range(2):
        pv = ((tr[:, None] - lam) * lam - minors[:, None]) * lam \
            + det_a[:, None]
        dpv = (2.0 * tr[:, None] - 3.0 * lam) * lam - minors[:, None]
        safe_d = np.where(np.abs(dpv) > 1e-8 * scale2, dpv, np.inf)
        lam = lam - pv / safe_d
    lam = -np.sort(-lam, axis=1)
    diag_sorted = -np.sort(np.stack([-a00, -a11, -a22], axis=1), axis=1)
    lam = np.where((p1 == 0.0)[:, None], diag_sorted, lam)
    return np.where((p == 0.0)[:, None], q[:, None], lam)


_TILE_ENTRY_BUDGET = 4_000_000  # padded entries materialized at once


def _tile_moments(pts, chunk_q, counts, rows_e, cols_e, col_e,
                  sel, start, s1, h2):
    """Accumulate raw first/second moments for the selected rows of one
    chunk into s1/h2 (query-LOCAL via the padding-count correction below).

    Rows are padded to this tile's max count with the row's OWN global
    index; a padding slot therefore gathers the query point q itself, whose
    query-LOCAL coordinate is exactly zero — padding never contaminates the
    moments. The gram runs on local (x - q) coordinates: a raw-coordinate
    gram with an algebraic padding correction would save the subtraction
    pass, but its |x|^2*eps cancellation lands exactly on the near-zero
    lambda2 of planar neighborhoods, which cbrt amplifies ~1e-5 past the
    SVD-oracle tolerance (measured)."""
    counts_s = counts[sel]
    kb = int(counts_s.max())
    inv = np.full(counts.shape[0], -1, dtype=np.int64)
    inv[sel] = np.arange(sel.size)
    keep = inv[rows_e] >= 0
    r_k = inv[rows_e[keep]]
    c_k = cols_e[keep]
    f_k = col_e[keep]
    step = max(1, _TILE_ENTRY_BUDGET // kb)
    for r0 in range(0, sel.size, step):
        rsl = slice(r0, min(r0 + step, sel.size))
        rows_g = sel[rsl]
        pad = np.broadcast_to(
            (start + rows_g)[:, None].astype(np.int64),
            (rsl.stop - rsl.start, kb)).copy()
        # r_k is ascending (rows_e is, and inv preserves sel's order), so
        # each piece's entries are one contiguous slice — no O(E) rescan
        # per piece
        a, b = np.searchsorted(r_k, [rsl.start, rsl.stop])
        pad[r_k[a:b] - rsl.start, c_k[a:b]] = f_k[a:b]
        # flat take + reshape: numpy's fancy indexing with a 2-D index
        # array takes a ~12x slower iterator path than a 1-D contiguous
        # take (measured, geofeat_bench.py)
        local = pts.take(pad.ravel(), axis=0).reshape(pad.shape[0], kb, 3)
        local -= chunk_q[rows_g, None, :]
        s1[rows_g] = local.sum(axis=1)
        g = np.matmul(local.transpose(0, 2, 1), local)
        h2[rows_g, 0] = g[:, 0, 0]
        h2[rows_g, 1] = g[:, 0, 1]
        h2[rows_g, 2] = g[:, 0, 2]
        h2[rows_g, 3] = g[:, 1, 1]
        h2[rows_g, 4] = g[:, 1, 2]
        h2[rows_g, 5] = g[:, 2, 2]


def geometric_features(points: np.ndarray, radius: float = 0.8,
                       batch: int = 4096
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[int]]:
    """Per-point (planarity, omnivariance, surface_variation, non_index)
    for one room's [N, 3] cloud.

    Fully vectorized (no per-point Python loop), engineered against the
    measured bottlenecks (benchmarks/geofeat_bench.py keeps the honest A/B
    vs the per-point-SVD loop it replaced):

    - neighborhoods come from ONE dual-tree pass per chunk
      (``cKDTree.sparse_distance_matrix`` COO output — C-built int32
      row/col arrays; ``query_ball_point``'s Python list-of-lists costs
      ~50 ns/entry just to flatten),
    - rows are padded into [rows, k_tile] index tiles (two tiles per
      chunk when counts are bimodal) and reduced by a batched 3x3 gram
      over query-LOCAL coordinates — 9 multiply-adds per entry, no
      per-entry term materialization (an earlier ``np.add.reduceat``
      formulation wrote 9 f64 products per entry and was memory-bound —
      slower than the SVD loop at the production radius),
    - eigenvalues come from the closed-form ``_eigvals3_sym_desc``.

    Query-local coordinates are bounded by ``radius``, so the covariance
    has no catastrophic cancellation even on georeferenced UTM-scale
    tiles (pinned by tests/test_features.py; values match the SVD oracle).
    The padded gather/gram tiles are bounded by the tile entry budget; the
    per-chunk ENUMERATION arrays (COO row/col/data plus the entry-order
    vectors) still scale with ``batch x mean_k`` — lower ``batch`` for
    full-resolution dense tiles (and prefer the downsample-first flow,
    ``attach_geofeatures``, which divides mean_k itself)."""
    n = points.shape[0]
    pts = np.asarray(points, dtype=np.float64)
    pts = pts - pts.mean(axis=0)
    tree = cKDTree(pts)
    lp = np.zeros(n)
    lo = np.zeros(n)
    lc = np.zeros(n)
    bad_mask = np.zeros(n, dtype=bool)

    for start in range(0, n, batch):
        chunk = pts[start:start + batch]
        m = chunk.shape[0]
        coo = cKDTree(chunk).sparse_distance_matrix(
            tree, radius, output_type="coo_matrix")
        counts = np.bincount(coo.row, minlength=m).astype(np.int64)
        # entries grouped by query row (stable radix argsort on int32)
        order = np.argsort(coo.row, kind="stable")
        col_e = coo.col[order]
        offsets = np.zeros(m, dtype=np.int64)
        np.cumsum(counts[:-1], out=offsets[1:])
        rows_e = np.repeat(np.arange(m, dtype=np.int64), counts)
        cols_e = (np.arange(col_e.size, dtype=np.int64)
                  - np.repeat(offsets, counts))

        cnt = counts.astype(np.float64)
        s1 = np.zeros((m, 3))
        h2 = np.zeros((m, 6))
        kmax = int(counts.max()) if m else 0
        # one tile when counts are homogeneous; a small/large split when
        # bimodal (padding fill would otherwise collapse to mean/kmax)
        t = min(kmax, max(8, int(2 * col_e.size / max(m, 1))))
        groups = [np.flatnonzero(counts <= t)]
        if t < kmax:
            groups.append(np.flatnonzero(counts > t))
        for sel in groups:
            if sel.size:
                _tile_moments(pts, chunk, counts, rows_e, cols_e,
                              col_e, sel, start, s1, h2)
        mu = s1 / cnt[:, None]
        # centered second moment: H_ab = sum x_a x_b - n * mu_a mu_b
        packed = np.stack([
            h2[:, 0] - cnt * mu[:, 0] * mu[:, 0],
            h2[:, 1] - cnt * mu[:, 0] * mu[:, 1],
            h2[:, 2] - cnt * mu[:, 0] * mu[:, 2],
            h2[:, 3] - cnt * mu[:, 1] * mu[:, 1],
            h2[:, 4] - cnt * mu[:, 1] * mu[:, 2],
            h2[:, 5] - cnt * mu[:, 2] * mu[:, 2],
        ], axis=1)
        lam = np.maximum(_eigvals3_sym_desc(packed), 0.0)
        bad = (counts <= 1) | (lam[:, 0] <= 0.0)
        l0 = np.where(bad, 1.0, lam[:, 0])
        sl = lam.sum(axis=1)
        sl = np.where(sl > 0.0, sl, 1.0)
        good = ~bad
        sl_ = slice(start, start + m)
        lp[sl_] = np.where(good, (lam[:, 1] - lam[:, 2]) / l0, 0.0)
        lo[sl_] = np.where(good,
                           np.cbrt(lam[:, 0] * lam[:, 1] * lam[:, 2]), 0.0)
        lc[sl_] = np.where(good, lam[:, 2] / sl, 0.0)
        bad_mask[sl_] = bad
    return lp, lo, lc, np.flatnonzero(bad_mask).tolist()


def voxel_downsample(points: np.ndarray, labels: np.ndarray,
                     voxel_size: float = 0.05, return_inverse: bool = False):
    """Voxel-grid downsample: centroid position + majority label per voxel
    (the open3d voxel_down_sample equivalent, geofunction.py:101-118).

    With ``return_inverse=True`` also returns the [N] voxel index of each
    input point, so per-voxel quantities can be scattered back to full
    resolution."""
    keys = np.floor((points - points.min(axis=0)) / voxel_size).astype(np.int64)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True,
                                   return_counts=True)
    n_voxels = counts.shape[0]
    sums = np.zeros((n_voxels, 3))
    np.add.at(sums, inverse, points)
    centroids = sums / counts[:, None]
    # majority label per voxel
    num_classes = int(labels.max()) + 1
    votes = np.zeros((n_voxels, num_classes), dtype=np.int64)
    np.add.at(votes, (inverse, labels.astype(np.int64)), 1)
    maj = votes.argmax(axis=1).astype(labels.dtype)
    if return_inverse:
        return centroids, maj, inverse
    return centroids, maj


def cal_geofeature(dataset, downsample: bool = False, visualize: bool = False):
    """Compute per-room geometric features for a Train/Test dataset.

    Returns (lp_rooms, lo_rooms, lc_rooms, non_index) where *_rooms are
    per-room feature arrays and non_index holds (room, point) pairs with no
    neighbors — the CLI drops those rooms, fixing the reference's intended
    filtered_update behavior (sem_seg_training.py:466-470).
    """
    rooms = getattr(dataset, "room_points", None)
    if rooms is None:
        rooms = dataset.scene_points_list
    room_labels = getattr(dataset, "room_labels", None)
    if room_labels is None:
        room_labels = dataset.semantic_labels_list

    lp_rooms, lo_rooms, lc_rooms = [], [], []
    non_index = []
    for r, (pts, labels) in enumerate(zip(rooms, room_labels)):
        pts = np.asarray(pts)[:, :3]
        if downsample:
            # Feature columns must stay per-full-resolution-point (the
            # dataset gathers them with the same point indices as xyz), so
            # downsampling is a speed knob only: compute PCA features on the
            # voxel centroids, then scatter each voxel's features back to
            # every full-res point in it via the voxel inverse map.
            centroids, _, inverse = voxel_downsample(
                pts, np.asarray(labels), return_inverse=True)
            lp, lo, lc, non = geometric_features(centroids)
            if non:
                bad = np.isin(inverse, np.asarray(non))
                non = np.flatnonzero(bad).tolist()
            lp, lo, lc = lp[inverse], lo[inverse], lc[inverse]
        else:
            lp, lo, lc, non = geometric_features(pts)
        lp_rooms.append(lp)
        lo_rooms.append(lo)
        lc_rooms.append(lc)
        non_index.extend((r, i) for i in non)
    return lp_rooms, lo_rooms, lc_rooms, non_index


GEO_FEATURE_NAMES = ("Planarity", "Omnivariance", "Surface variation")


def attach_geofeatures(dataset, feature_list: Sequence[str],
                       downsample: bool = False) -> None:
    """Compute and append requested geometric features to a dataset in place
    (mirrors the CLI wiring at sem_seg_training.py:449-470, fixed to be
    per-room)."""
    wanted = [f for f in GEO_FEATURE_NAMES if f in feature_list]
    if not wanted:
        return
    lp, lo, lc, non_index = cal_geofeature(dataset, downsample)
    by_name = {"Planarity": lp, "Omnivariance": lo, "Surface variation": lc}
    for name in wanted:
        rooms_cols = by_name[name]
        for r, col in enumerate(rooms_cols):
            dataset.extra_features_data[r].append(col)
        dataset.feature_name.append(name)
        dataset.num_extra_features += 1
    dataset.non_index = sorted({r for r, _ in non_index})
    if dataset.non_index:
        dataset.filtered_update()
