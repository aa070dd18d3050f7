"""Probe of the ball-query kernels (``csrc/ball_query.cuh``, launched by
``ball_query.cu`` with one radius and ``ball_query_multi.cu`` with the MSG
layer's) on one NVIDIA GPU:

    python3 -m tumseg_torch.tools.ball_query_probe [--out DIR]
    PYTHONPATH=. python3 PATH/TO/ball_query_probe.py --stages
    PYTHONPATH=. python3 PATH/TO/ball_query_probe.py --fused [--out DIR]

from the root of a checkout (it takes the facade blocks and the timers of
that checkout's ``chip_smoke.py``). ``--stages`` only times the wrappers
``kernels.query_ball_point`` at sa1-sa4 of a B=32 x 4096 SSG forward and a
B=16 step, and ``kernels.query_ball_point_multi`` at sa1-sa4 of the MSG
forward: CUDA-event and profiler device ms a call, each stage checked
against the plain version first, and the wrapper's host time a call; run
from another checkout's root with this file's path, it times that
checkout's kernels, so two trees compare in one call. Without it the probe
prints, and writes to ``DIR/ball_query_probe.json`` (``DIR`` defaults to
``build/ball_query_probe/``):

1. ``nvcc -Xptxas -v`` on ``ball_query.cu`` and ``ball_query_multi.cu``:
   registers, shared memory and spills (and the SASS, from ``cuobjdump``,
   into ``DIR/ball_query_probe_sass.txt``);
2. the candidates the kernels test at each stage, counted by
   :func:`walk_model` (numpy, on the host) on the same facade blocks, and
   the model's indices checked against the plain version;
3. the kernels at each candidate geometry (Q, L, tile, walk) at sa1-sa4 of
   both batches, SSG and MSG: indices identical to the plain version, then
   profiler device ms, beside the geometry ``kernels.ball_query_geometry``
   picks, which is also timed at r = 0 (the tile's staging and one slab a
   query: what the staging costs).

``--fused`` probes the fused ball query + group instead
(``csrc/fused_ball_group.cu``, the same walk with a grouping epilogue;
:func:`fused_probe`), and writes ``DIR/fused_probe.json``: ``-Xptxas -v``
of ``fused_ball_group.cu`` (its SASS into ``DIR/fused_sass.txt``); at
sa1-sa4 of the B=32 forward (C = 9, 67, 131, 259), each checked bitwise
against the split pair and the plain version first in both modes, device
ms of the fused kernel (exact, fast) beside the split pair's (ball query
then group), the ball query's and the group's alone, its event ms, the
candidates its walk tests and its bound; and, where the checkout has
``kernels.fused_geometry``, each candidate geometry's device ms. Run from
another checkout's root with this file's path, it probes that checkout's
kernel (through its wrapper).

The module also holds the inputs the CPU and card tests share
(:func:`stage_inputs`, :func:`adversarial_cases`).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from tumseg_torch.ops import build, core, kernels

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "ball_query_probe"
f32 = np.float32
# (N, S, radii, K) of sa1..sa4 of a 4096-point forward
SSG_STAGES = [(4096, 1024, (0.1,), (32,)), (1024, 256, (0.2,), (32,)),
              (256, 64, (0.4,), (32,)), (64, 16, (0.8,), (32,))]
MSG_STAGES = [(4096, 1024, (0.05, 0.1), (16, 32)),
              (1024, 256, (0.1, 0.2), (16, 32)),
              (256, 64, (0.2, 0.4), (16, 32)),
              (64, 16, (0.4, 0.8), (16, 32))]
# SASS instructions a lane spends on a candidate that misses, in the walk of
# ball_query.cu (one radius; the probe dumps the SASS): the 16-byte shared
# load, three subtractions, three products, two sums, the compare and six
# of address, branch and loop bookkeeping. The yardstick is the walk
# model's candidates times this, at the issue rate
SASS_PER_CANDIDATE = 17
# 132 SMs x 4 schedulers x one warp instruction a cycle at 1.98 GHz
WARP_ISSUE_PER_S = 132 * 4 * 1.98e9


def slab_count(m: int) -> int:
    """The slabs of a tile of m sources (z_slabs.cuh's ``slab_count``)."""
    n = 1
    while (n < kernels.BALL_QUERY_MAX_SLABS
           and kernels.BALL_QUERY_SLAB_SOURCES * n < m):
        n <<= 1
    return n


def _r2(r) -> np.float32:
    """r^2 in double, rounded to f32 once (the wrappers' and the plain
    version's)."""
    return f32(float(r) * float(r))


def walk_model(xyz, new_xyz, radii, nsamples, geometry=None):
    """csrc/ball_query.cuh in numpy f32, on xyz [B, N, 3] and new_xyz
    [B, S, 3]: each tile of ``geometry``'s (default
    ``kernels.ball_query_geometry``'s) sources, walked through z-slabs by
    the kernel's f32 arithmetic or scanned; each query still short of a K
    tests its range of slabs, out to the first non-empty slab on each side
    whose nearest z gives fl(dz*dz) above the largest r^2 of its radii
    still short (a scanned tile: all of it); each radius' hits appended in
    index order up to K; a short ball filled with its first hit, an empty
    one with N. -> (one [B, S, K] int32 per radius, the candidates
    tested)."""
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    _, _, tile, walk = geometry or kernels.ball_query_geometry(
        B, N, S, len(radii))
    r2 = np.array([_r2(r) for r in radii], f32)
    Ks = np.array(nsamples, np.int64)
    R = len(radii)
    outs = [np.zeros((B, S, k), np.int32) for k in nsamples]
    tested = 0
    for b in range(B):
        held = np.zeros((S, R), np.int64)
        first = np.full((S, R), N, np.int64)
        q = new_xyz[b]
        for base in range(0, N, tile):
            src = xyz[b, base:base + tile]
            m = src.shape[0]
            short = held < Ks[None, :]                          # [S, R]
            rows = np.nonzero(short.any(1))[0]
            if rows.size == 0:
                break
            qr = q[rows]
            z = src[:, 2]
            if walk:
                n = slab_count(m)
                zmin, zmax = z.min(), z.max()
                with np.errstate(divide="ignore", over="ignore"):
                    scale = (min(f32(n) / (zmax - zmin), f32(3.402823466e38))
                             if zmax > zmin else f32(0))

                def slab_of(v):
                    with np.errstate(over="ignore", invalid="ignore"):
                        return np.fmin(np.fmax((v - zmin) * scale, f32(0)),
                                       f32(n - 1)).astype(np.int64)

                ks = slab_of(z)
                counts = np.bincount(ks, minlength=n)
                off = np.concatenate([[0], np.cumsum(counts)])
                lo = np.full(n, np.inf, f32)
                hi = np.full(n, -np.inf, f32)
                np.minimum.at(lo, ks, z)
                np.maximum.at(hi, ks, z)
                lim = np.where(short[rows], r2[None, :], -np.inf).max(1)
                lim = lim.astype(f32)
                home = slab_of(qr[:, 2])
                k = np.arange(n)
                with np.errstate(invalid="ignore", over="ignore"):
                    dz_up = lo[None, :] - qr[:, 2:3]
                    dz_dn = hi[None, :] - qr[:, 2:3]
                    stop_up = ((counts > 0)[None, :] & (k > home[:, None])
                               & (dz_up * dz_up > lim[:, None]))
                    stop_dn = ((counts > 0)[None, :] & (k < home[:, None])
                               & (dz_dn * dz_dn > lim[:, None]))
                up = np.where(stop_up.any(1), stop_up.argmax(1), n)
                down = np.where(stop_dn.any(1),
                                n - 1 - stop_dn[:, ::-1].argmax(1), -1)
                tested += int((off[up] - off[down + 1]).sum())
                in_range = ((ks[None, :] > down[:, None])
                            & (ks[None, :] < up[:, None]))
            else:
                tested += m * rows.size
                in_range = np.ones((rows.size, m), bool)
            diff = src[None, :, :] - qr[:, None, :]
            sq = diff * diff
            dist = (sq[..., 0] + sq[..., 1]) + sq[..., 2]        # [rows, m]
            for r in range(R):
                open_r = short[rows, r]
                hit = in_range & (dist <= r2[r]) & open_r[:, None]
                pos = held[rows, r][:, None] + np.cumsum(hit, 1) - 1
                take = hit & (pos < Ks[r])
                qi, ji = np.nonzero(take)
                outs[r][b, rows[qi], pos[qi, ji]] = base + ji
                got = hit.any(1)
                start = got & (held[rows, r] == 0)
                first[rows[start], r] = base + hit[start].argmax(1)
                held[rows, r] += hit.sum(1)
        for r in range(R):
            kk = Ks[r]
            fill = np.where(held[:, r] == 0, N, first[:, r])
            slot = np.arange(kk)[None, :]
            outs[r][b] = np.where(slot < np.minimum(held[:, r], kk)[:, None],
                                  outs[r][b], fill[:, None]).astype(np.int32)
    return tuple(outs), tested


def yardstick_ms(tested: int) -> float:
    """The walk's candidates at ``SASS_PER_CANDIDATE`` instructions a lane,
    32 lanes a warp instruction, at the card's issue rate."""
    return tested * SASS_PER_CANDIDATE / 32 / WARP_ISSUE_PER_S * 1e3


def bytes_ms(B, N, S, nsamples) -> float:
    """Inputs read once, indices written once, at 3.35 TB/s."""
    return (12 * B * N + 12 * B * S + 4 * B * S * sum(nsamples)) / 3.35e12 \
        * 1e3


# --- inputs the CPU and card tests share -----------------------------------

def facade(rng, B, N):
    """[B, N, 3] f32: 1 m x 1 m x 10 m columns, 70% on a wall plane (2 cm
    noise), the blocks the model serves."""
    wall = rng.random((B, N)) < 0.7
    return np.stack([rng.uniform(-0.5, 0.5, (B, N)),
                     np.where(wall, rng.normal(0.0, 0.02, (B, N)),
                              rng.uniform(-0.5, 0.5, (B, N))),
                     rng.uniform(0.0, 10.0, (B, N))], -1).astype(f32)


def stage_inputs(B, stage, seed=0, msg=False):
    """(xyz, new_xyz, radii, K) of sa``stage + 1`` (SSG or MSG) on facade
    blocks, the queries a random subset of the points (FPS picks points of
    the cloud too)."""
    N, S, radii, Ks = (MSG_STAGES if msg else SSG_STAGES)[stage]
    rng = np.random.default_rng(seed + stage)
    xyz = facade(rng, B, N)
    pick = np.stack([rng.permutation(N)[:S] for _ in range(B)])
    return xyz, np.take_along_axis(xyz, pick[..., None], 1), radii, Ks


def _boundary(rng, B, N, S, r):
    """Facade blocks where each query has sources straight above and below
    it (dx = dy = 0, so the distance is fl(dz*dz)) at fl(qz +- r) and one
    ulp either side: membership and the walk's stop decided at the last
    bit."""
    xyz = facade(rng, B, N)
    q = xyz[:, :S].copy()
    at = S
    for sign in (1.0, -1.0):
        edge = (q[..., 2] + f32(sign * r)).astype(f32)
        for z in (edge, np.nextafter(edge, f32(np.inf)),
                  np.nextafter(edge, f32(-np.inf))):
            xyz[:, at:at + S, :2] = q[..., :2]
            xyz[:, at:at + S, 2] = z
            at += S
    return xyz, q


def adversarial_cases():
    """[(name, xyz [B, N, 3], new_xyz [B, S, 3], radii, K)] f32, small:
    points at |dz| = r exactly and one ulp either side (r = 0.1 and the
    exact 0.125), every point at one z (the walk becomes a full scan),
    duplicated points on a grid, an empty ball, balls with more than K hits,
    N past one tile (5000), N one past it (4097), N = FPS_MAX_N, fewer
    queries than a block, and several radii unsorted (R = 1-4)."""
    rng = np.random.default_rng(11)
    cases = []
    for r in (0.1, 0.125):
        xyz, q = _boundary(rng, 2, 600, 40, r)
        cases.append((f"boundary_r{r}", xyz, q, (r,), (32,)))
    flat = rng.random((2, 700, 3)).astype(f32)
    flat[..., 2] = f32(1.5)
    cases.append(("one_z", flat, flat[:, :50].copy(), (0.2,), (32,)))
    grid = (rng.integers(0, 16, (2, 512, 3)) / 16).astype(f32)
    for at in (3, 100, 257, 511):
        grid[:, at] = grid[:, 0]
    qg = grid[:, :64].copy()
    qg[:, :4] = grid[:, :1]
    cases.append(("duplicates", grid, qg, (0.25,), (8,)))
    far = facade(rng, 2, 800)
    qf = far[:, :30].copy()
    qf[:, 0] = f32(1000.0)
    qf[1, 5:9] = f32(-50.0)
    cases.append(("empty", far, qf, (0.2,), (32,)))
    dense = (rng.normal(0.0, 0.03, (2, 300, 3))).astype(f32)
    cases.append(("overfull", dense, dense[:, :40].copy(), (0.2,), (16,)))
    past = {}
    for n in (5000, 4097):
        big = facade(rng, 1, n)
        past[n] = big, big[:, rng.permutation(n)[:96]].copy()
        cases.append((f"past_tile_{n}", *past[n], (0.2,), (32,)))
    huge = facade(rng, 1, kernels.FPS_MAX_N)
    cases.append(("fps_max_n", huge, huge[:, :48].copy(), (0.1,), (32,)))
    few = facade(rng, 3, 700)
    cases.append(("few_queries", few, few[:, :3].copy(), (0.3,), (32,)))
    multi = facade(rng, 2, 1024)
    qm = multi[:, :128].copy()
    for radii, ks in (((0.3,), (8,)), ((0.2, 0.05), (32, 16)),
                      ((0.2, 0.05, 0.1), (8, 16, 32)),
                      ((0.4, 0.1, 0.8, 0.2), (16, 8, 32, 4))):
        cases.append((f"multi_R{len(radii)}", multi, qm, radii, ks))
    cases.append(("multi_boundary", *_boundary(rng, 2, 608, 32, 0.1),
                  (0.1, 0.05), (32, 16)))
    cases.append(("multi_past_tile", *past[5000], (0.05, 0.2), (16, 32)))
    return cases


# --- the card --------------------------------------------------------------

def levels(dev, B, msg=False):
    """[(xyz, new_xyz, radii, K)] of sa1..sa4 of a B x 4096 facade batch,
    each stage's queries the FPS centroids of its points (as chip_smoke.py
    [b] and [h] build them)."""
    from chip_smoke import K, MSG_K, MSG_SA, SA, facade_blocks

    rng = np.random.default_rng(6 if msg else 0)
    xyz = torch.as_tensor(facade_blocks(rng, B, 4096), device=dev)
    out = []
    for npoint, radius in (MSG_SA if msg else SA):
        new_xyz = core.gather_rows(
            xyz, kernels.farthest_point_sample(xyz, npoint)).contiguous()
        radii = tuple(radius) if msg else (radius,)
        out.append((xyz, new_xyz, radii, MSG_K if msg else (K,)))
        xyz = new_xyz
    return out


def query(xyz, new_xyz, radii, ks, geometry=None, msg=False):
    """The kernel of ``msg`` (multi-radius) or one radius, through its
    wrapper or, with ``geometry``, at that (Q, L, tile, walk)."""
    if geometry is None:
        if msg:
            return kernels.query_ball_point_multi(radii, ks, xyz, new_xyz)
        return (kernels.query_ball_point(radii[0], ks[0], xyz, new_xyz),)
    import ctypes

    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    dev = xyz.device
    outs = tuple(torch.empty((B, S, k), dtype=torch.int32, device=dev)
                 for k in ks)
    if not msg:
        kernels._launch("ball_query", "tumseg_ball_query", dev,
                        xyz.data_ptr(), new_xyz.data_ptr(),
                        outs[0].data_ptr(), B, N, S, ks[0],
                        float(radii[0]) * float(radii[0]), *geometry)
        return outs
    params = kernels._MultiRadii(len(radii))
    for i, (r, k, o) in enumerate(zip(radii, ks, outs)):
        params.r2[i] = float(r) * float(r)
        params.K[i] = k
        params.out[i] = o.data_ptr()
    kernels._launch("ball_query_multi", "tumseg_ball_query_multi", dev,
                    xyz.data_ptr(), new_xyz.data_ptr(),
                    ctypes.c_void_p(ctypes.addressof(params)), B, N, S,
                    *geometry)
    return outs


def check(got, xyz, new_xyz, radii, ks, what):
    want = core.query_ball_point_multi(radii, ks, xyz, new_xyz)
    for r, g, w in zip(radii, got, want):
        if not torch.equal(g, w):
            bad = (g != w).any(-1).float().mean().item()
            raise AssertionError(f"{what} r={r}: {bad:.2e} of queries "
                                 "differ from the plain version")


def stages(dev) -> None:
    from chip_smoke import device_ms, host_us, time_ms

    def ms(t):
        return "not measured" if t is None else f"{t:.4f} ms"

    for msg, batches in ((False, (32, 16)), (True, (32,))):
        name = "ball_query_multi" if msg else "ball_query"
        for B in batches:
            total = [0.0, 0.0]
            for lvl, (xyz, new_xyz, radii, ks) in enumerate(
                    levels(dev, B, msg)):
                def call():
                    return query(xyz, new_xyz, radii, ks, msg=msg)
                check(call(), xyz, new_xyz, radii, ks,
                      f"{name} sa{lvl + 1} B={B}")
                ev, runs = time_ms(torch, call, 20)
                dv = device_ms(torch, call, 20)
                total = [total[0] + ev,
                         None if dv is None or total[1] is None
                         else total[1] + dv]
                print(f"[stages] {name} B={B} sa{lvl + 1} "
                      f"N={xyz.shape[1]} S={new_xyz.shape[1]} r={radii} "
                      f"K={ks}: event {ev:.4f} ms "
                      f"{[round(r, 4) for r in runs]}, device {ms(dv)}")
            host = host_us(torch, call)
            print(f"[stages] {name} B={B} sa1-sa4: event {total[0]:.4f} ms, "
                  f"device {ms(total[1])}; host time a call of the wrapper "
                  f"at sa4 {host:.2f} us")


def candidates(B, N, S, R):
    """The helper's geometry; Q from a quarter to four times it, and L
    halved and doubled, as far as the threads and the shared memory allow;
    and the other of walk and scan."""
    Q, L, tile, walk = chosen = kernels.ball_query_geometry(B, N, S, R)
    out = [chosen]
    for q in (Q // 4, Q // 2, Q * 2, Q * 4):
        if 1 <= q <= kernels.BALL_QUERY_THREADS:
            lanes = max(8, min(32, kernels.BALL_QUERY_THREADS // q))
            out.append((q, lanes, tile, walk))
    out += [(Q, lanes, tile, walk) for lanes in (L // 2, L * 2)
            if 1 <= lanes <= 32]
    out.append((Q, L, tile, 1 - walk))
    fits = [g for g in out if kernels.ball_query_smem(
        g[2], g[0], g[1], R) <= kernels.BALL_QUERY_SMEM]
    return list(dict.fromkeys(fits))


def ptxas_report(names=("ball_query", "ball_query_multi")) -> str:
    OUT.mkdir(parents=True, exist_ok=True)
    report = ""
    for name in names:
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
               "-o", str(OUT / f"{name}.o"), str(build.CSRC / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
        report += res.stdout + res.stderr
    return report


def fused_at(xyz, new_xyz, src, r, K, geometry, fast=False):
    """The fused kernel at an explicit (Q, L, tile, walk, magic)."""
    B, N, _ = xyz.shape
    S, C = new_xyz.shape[1], src.shape[2]
    dev = xyz.device
    grouped = torch.empty((B, S, K, C), device=dev,
                          dtype=torch.bfloat16 if fast else torch.float32)
    idx = torch.empty((B, S, K), dtype=torch.int32, device=dev)
    kernels._launch("fused_ball_group", "tumseg_fused_ball_group", dev,
                    xyz.data_ptr(), new_xyz.data_ptr(), src.data_ptr(),
                    grouped.data_ptr(), idx.data_ptr(), B, N, S, K, C,
                    float(r) * float(r), *geometry, fast=fast)
    return grouped, idx


def fused_candidates(B, N, S, C):
    """:func:`candidates` of one radius, each with its magic
    (``kernels.fused_geometry``'s rule)."""
    out = []
    for Q, L, tile, walk in candidates(B, N, S, 1):
        chunk = kernels.fused_chunk(tile, Q, L)
        magic = 2 ** 32 // C + 1 if (chunk * C - 1) * C < 2 ** 32 else 0
        out.append((Q, L, tile, walk, magic))
    return out


def fused_probe(dev, dump) -> None:
    """``--fused`` (the module docstring)."""
    from chip_smoke import SA_CHANNELS, device_ms, time_ms

    def ms(t):
        return "not measured" if t is None else f"{t:.4f} ms"

    result = {"stages": [], "geometry": []}
    report = ptxas_report(("fused_ball_group",))
    print("[ptxas]\n" + "\n".join(
        line for line in report.splitlines()
        if "registers" in line or "spill" in line or "Compiling" in line))
    build.library()
    sweep = hasattr(kernels, "fused_geometry")
    rng = np.random.default_rng(3)
    total = {}
    B = 32
    for lvl, (xyz, new_xyz, radii, ks) in enumerate(levels(dev, B)):
        N, S, C = xyz.shape[1], new_xyz.shape[1], SA_CHANNELS[lvl]
        r, K = radii[0], ks[0]
        src = torch.cat([xyz, torch.as_tensor(rng.standard_normal(
            (B, N, C - 3)).astype(np.float32), device=dev)], -1)
        stage = f"sa{lvl + 1} N={N} S={S} C={C}"

        def split(fast):
            return kernels.group_points(kernels.query_ball_point(
                r, K, xyz, new_xyz), src, new_xyz, fast)

        for fast in (False, True):
            g, i = kernels.fused_ball_group(r, K, xyz, new_xyz, src, fast)
            pg, pi = core.fused_ball_group(r, K, xyz, new_xyz, src, fast)
            if not (torch.equal(i, pi) and torch.equal(g, pg)
                    and torch.equal(g, split(fast))):
                raise AssertionError(f"fused {stage} fast={fast}: not "
                                     "bitwise the split pair and plain")
        _, tested = walk_model(xyz.cpu().numpy(), new_xyz.cpu().numpy(),
                               radii, ks)
        nbytes = 4 * (B * N * 3 + B * S * 3 + B * N * C + B * S * K
                      + B * S * K * C)
        bound = max(nbytes / 3.35e12, (9 * tested + 3 * B * S * K)
                    / 67e12) * 1e3
        idx = kernels.query_ball_point(r, K, xyz, new_xyz)
        ev, runs = time_ms(torch, lambda: kernels.fused_ball_group(
            r, K, xyz, new_xyz, src), 20)
        row = dict(stage=f"sa{lvl + 1}", event_ms=ev, bound_ms=bound,
                   tested=tested)
        for key, fn in (
                ("fused_ms", lambda: kernels.fused_ball_group(
                    r, K, xyz, new_xyz, src)),
                ("fused_fast_ms", lambda: kernels.fused_ball_group(
                    r, K, xyz, new_xyz, src, True)),
                ("split_ms", lambda: split(False)),
                ("split_fast_ms", lambda: split(True)),
                ("ball_query_ms", lambda: kernels.query_ball_point(
                    r, K, xyz, new_xyz)),
                ("group_ms", lambda: kernels.group_points(
                    idx, src, new_xyz)),
                ("group_fast_ms", lambda: kernels.group_points(
                    idx, src, new_xyz, True))):
            row[key] = device_ms(torch, fn, 20)
            total[key] = (None if row[key] is None or total.get(key, 0.0)
                          is None else total.get(key, 0.0) + row[key])
        result["stages"].append(row)
        print(f"[fused] B={B} {stage}: fused device {ms(row['fused_ms'])} "
              f"(fast {ms(row['fused_fast_ms'])}), event {ev:.4f} ms "
              f"{[round(v, 4) for v in runs]}; split pair "
              f"{ms(row['split_ms'])} (fast {ms(row['split_fast_ms'])}) = "
              f"ball query {ms(row['ball_query_ms'])} + group "
              f"{ms(row['group_ms'])} (fast {ms(row['group_fast_ms'])}); "
              f"{tested / (B * S):.1f} candidates a query, bound "
              f"{bound:.5f} ms ({nbytes / 1e6:.1f} MB)")
        if not sweep:
            continue
        chosen = kernels.fused_geometry(B, N, S, C)
        for geometry in fused_candidates(B, N, S, C):
            for fast in (False, True):
                g, i = fused_at(xyz, new_xyz, src, r, K, geometry, fast)
                if not (torch.equal(i, idx) and torch.equal(g, split(fast))):
                    raise AssertionError(f"fused {stage} {geometry}: not "
                                         "bitwise the split pair")
            dms = device_ms(torch, lambda: fused_at(
                xyz, new_xyz, src, r, K, geometry), 20)
            fms = device_ms(torch, lambda: fused_at(
                xyz, new_xyz, src, r, K, geometry, True), 20)
            mark = " <- fused_geometry" if geometry == chosen else ""
            print(f"[geometry] fused {stage} (Q, L, tile, walk, magic) "
                  f"{geometry}: device {ms(dms)}, fast {ms(fms)}{mark}")
            result["geometry"].append(dict(
                stage=f"sa{lvl + 1}", geometry=list(geometry),
                device_ms=dms, fast_ms=fms, chosen=bool(mark)))
    result["total"] = total
    print("[fused] B=32 sa1-sa4 device: " + ", ".join(
        f"{k} {ms(v)}" for k, v in total.items()))
    dump.mkdir(parents=True, exist_ok=True)
    (dump / "fused_probe.json").write_text(json.dumps(result, indent=1))
    (dump / "fused_ptxas.txt").write_text(report)
    cuobjdump = str(Path(build._nvcc()).with_name("cuobjdump"))
    (dump / "fused_sass.txt").write_text(subprocess.run(
        [cuobjdump, "-sass", str(OUT / "fused_ball_group.o")],
        capture_output=True, text=True).stdout)
    print("ball_query_probe --fused: ok")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ball_query_probe needs a CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    args = sys.argv[1:]
    dump = Path(args[args.index("--out") + 1]) if "--out" in args else OUT
    if "--stages" in args:
        stages(dev)
        return 0
    if "--fused" in args:
        fused_probe(dev, dump)
        return 0
    from chip_smoke import device_ms

    result = {"card": smi, "geometry": [], "walk": []}
    report = ptxas_report()
    print("[ptxas]\n" + "\n".join(
        line for line in report.splitlines()
        if "registers" in line or "spill" in line or "Compiling" in line))
    build.library()
    for msg, batches in ((False, (32, 16)), (True, (32, 16))):
        name = "ball_query_multi" if msg else "ball_query"
        for B in batches:
            for lvl, (xyz, new_xyz, radii, ks) in enumerate(
                    levels(dev, B, msg)):
                N, S = xyz.shape[1], new_xyz.shape[1]
                stage = f"{name} B={B} sa{lvl + 1} N={N} S={S}"
                want = core.query_ball_point_multi(radii, ks, xyz, new_xyz)
                model, tested = walk_model(xyz.cpu().numpy(),
                                           new_xyz.cpu().numpy(), radii, ks)
                for m, w in zip(model, want):
                    if not np.array_equal(m, w.cpu().numpy()):
                        raise AssertionError(f"{stage}: the walk model "
                                             "differs from the plain version")
                print(f"[walk] {stage}: {tested} candidates tested of "
                      f"{B * N * S} ({tested / (B * S):.1f} a query); bytes "
                      f"{bytes_ms(B, N, S, ks):.5f} ms, yardstick "
                      f"{yardstick_ms(tested):.5f} ms")
                result["walk"].append(dict(kernel=name, B=B,
                                           stage=f"sa{lvl + 1}",
                                           tested=tested, full=B * N * S))
                chosen = kernels.ball_query_geometry(B, N, S, len(ks))
                for geometry in candidates(B, N, S, len(ks)):
                    got = query(xyz, new_xyz, radii, ks, geometry, msg)
                    check(got, xyz, new_xyz, radii, ks, f"{stage} {geometry}")
                    dms = device_ms(torch, lambda: query(
                        xyz, new_xyz, radii, ks, geometry, msg), 20)
                    mark = ""
                    if geometry == chosen:   # and the tile's staging alone
                        zero = device_ms(torch, lambda: query(
                            xyz, new_xyz, (0.0,) * len(radii), ks, geometry,
                            msg), 20)
                        mark = (" <- ball_query_geometry; at r = 0 (staging"
                                " and the home slab) " + ("not measured"
                                if zero is None else f"{zero:.4f} ms"))
                    print(f"[geometry] {stage} (Q, L, tile, walk) {geometry}: "
                          "device " + ("not measured" if dms is None
                                       else f"{dms:.4f} ms") + mark)
                    result["geometry"].append(dict(
                        kernel=name, B=B, stage=f"sa{lvl + 1}",
                        geometry=list(geometry), device_ms=dms,
                        chosen=bool(mark)))

    dump.mkdir(parents=True, exist_ok=True)
    (dump / "ball_query_probe.json").write_text(json.dumps(result, indent=1))
    (dump / "ball_query_probe_ptxas.txt").write_text(report)
    cuobjdump = str(Path(build._nvcc()).with_name("cuobjdump"))
    sass = "".join(subprocess.run([cuobjdump, "-sass", str(OUT / f"{n}.o")],
                                  capture_output=True, text=True).stdout
                   for n in ("ball_query", "ball_query_multi"))
    (dump / "ball_query_probe_sass.txt").write_text(sass)
    print("ball_query_probe: ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
