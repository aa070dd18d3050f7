"""Probe of the 3-NN + interpolation kernels (``csrc/three_nn.cuh``: the
direct form, ``three_nn_interpolate.cu``, and the expansion form,
``three_nn_window.cu``) on one NVIDIA GPU:

    python3 -m tumseg_torch.tools.three_nn_probe [--out DIR]
    PYTHONPATH=. python3 PATH/TO/three_nn_probe.py --stages
    PYTHONPATH=. python3 PATH/TO/three_nn_probe.py --window [--out DIR]
    python3 -m tumseg_torch.tools.three_nn_probe --sass-against OTHER_ROOT

from the root of a checkout (it takes the facade blocks and the timers of
that checkout's ``chip_smoke.py``). ``--stages`` only times the wrapper of
the ``tumseg_torch`` on the path at fp1-fp4 of a B=32 x 4096 forward and a
B=16 step: CUDA-event and profiler device ms of the exact call, device ms
of the fast call and of the search alone (D = 0, nothing to interpolate),
each stage checked against the plain version first; run from another
checkout's root with this file's path, it times that checkout's kernel, so
two trees compare in one call. Without it the probe prints, and writes to
``DIR/three_nn_probe.json`` (``DIR`` defaults to ``build/three_nn_probe/``):

1. ``nvcc -Xptxas -v`` on ``csrc/three_nn_interpolate.cu``: each
   instance's registers, shared memory and spills (and its SASS, from
   ``cuobjdump``, into ``DIR/three_nn_probe_sass.txt``);
2. the kernel at each candidate geometry (Q, R) at fp1-fp4 of both
   batches, on facade blocks and on an integer lattice (a field of ties):
   indices and distances identical to the plain version and ``out``
   within rtol 1e-5 / atol 1e-6, then profiler device ms of the exact
   call and of the search alone, beside the geometry
   ``kernels.three_nn_geometry`` picks;
3. the candidates the kernel's search tests at each stage, counted by
   :func:`walk_model` (numpy, on the host) on the same facade blocks: the
   work of the search on these inputs, for its bound.

``--window`` probes the expansion form instead (``window_probe``), and
writes ``DIR/three_nn_window_probe.json``: ``-Xptxas -v`` of
``three_nn_window.cu`` (its SASS into ``DIR/three_nn_window_sass.txt``);
the candidates its walk tests at fp1-fp4 of B=32 beside the direct form's
(:func:`walk_model`, checked against the plain expansion form); at each
stage the kernel through ``kernels.three_nn_window_interpolate`` (the
window ``ops`` takes at fp1, the full row elsewhere), checked bitwise
against the plain version first, with CUDA-event and device ms, fast and
search-alone (D = 0) device ms beside the direct-form kernel's device ms,
and the wrapper's host time a call; and every input of
:func:`window_cases` bitwise. Run from another checkout's root with this
file's path, it probes that checkout's kernel.

``--sass-against OTHER_ROOT`` compiles the kernels that share
``three_nn.cuh``, ``ball_query.cuh`` and ``common.cuh``'s grouping code
(``three_nn_interpolate.cu``, ``ball_query.cu``, ``ball_query_multi.cu``,
``group.cu``) in this checkout and in the one at OTHER_ROOT, and prints for
each file whether every kernel's SASS, names stripped, is the same
(:func:`sass_bodies`), with each side's ``-Xptxas -v`` registers and
spills: a refactor of shared code that must leave a kernel unchanged is
checked so.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from tumseg_torch.ops import build, core, kernels

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "three_nn_probe"


def levels(dev, B):
    """[(xyz1, xyz2, D)] of fp1..fp4 of a B x 4096 facade batch: each
    stage's sources the FPS centroids of its queries."""
    from chip_smoke import FP_D, SA, facade_blocks

    xyz = torch.as_tensor(facade_blocks(np.random.default_rng(0), B, 4096),
                          device=dev)
    xyzs = [xyz]
    for npoint, _ in SA:
        src = xyzs[-1]
        xyzs.append(core.gather_rows(
            src, kernels.farthest_point_sample(src, npoint)).contiguous())
    return list(zip(xyzs[:-1], xyzs[1:], FP_D))


def check(got, want, what):
    """Indices and distances identical, ``out`` within rtol 1e-5 / atol
    1e-6; -> whether ``out`` is bitwise equal too."""
    (dk, ik, ok), (dp, ip, op) = got, want
    if not (torch.equal(ik, ip) and torch.equal(dk, dp)):
        raise AssertionError(f"{what}: indices or distances differ from "
                             "the plain version")
    torch.testing.assert_close(ok, op, rtol=1e-5, atol=1e-6)
    return torch.equal(ok, op)


def stages(dev) -> None:
    from chip_smoke import device_ms, host_us, time_ms

    def ms(t):
        return "not measured" if t is None else f"{t:.4f} ms"

    for B in (32, 16):
        total = [0.0, 0.0]
        rng = np.random.default_rng(1)
        for lvl, (xyz1, xyz2, d) in enumerate(levels(dev, B)):
            p2 = torch.as_tensor(rng.standard_normal(
                (B, xyz2.shape[1], d)).astype(np.float32), device=dev)
            none = p2[..., :0].contiguous()
            for fast in (False, True):
                check(kernels.three_nn_interpolate(xyz1, xyz2, p2, fast),
                      core.three_nn_interpolate(xyz1, xyz2, p2, fast),
                      f"fp{lvl + 1} B={B} fast={fast}")
            ev, runs = time_ms(torch, lambda: kernels.three_nn_interpolate(
                xyz1, xyz2, p2), 20)
            dv = device_ms(torch, lambda: kernels.three_nn_interpolate(
                xyz1, xyz2, p2), 20)
            fv = device_ms(torch, lambda: kernels.three_nn_interpolate(
                xyz1, xyz2, p2, True), 20)
            sv = device_ms(torch, lambda: kernels.three_nn_interpolate(
                xyz1, xyz2, none), 20)
            total = [total[0] + ev,
                     None if dv is None or total[1] is None
                     else total[1] + dv]
            print(f"[stages] B={B} fp{lvl + 1} N={xyz1.shape[1]} "
                  f"S={xyz2.shape[1]} D={d}: event {ev:.4f} ms "
                  f"{[round(r, 4) for r in runs]}, device {ms(dv)}; fast "
                  f"device {ms(fv)}; search alone (D=0) device {ms(sv)}")
        host = host_us(torch, lambda: kernels.three_nn_interpolate(
            xyz1, xyz2, p2))
        print(f"[stages] B={B} fp1-fp4: event {total[0]:.4f} ms, device "
              f"{ms(total[1])}; host time a call of the wrapper at fp4 "
              f"{host:.2f} us")


def three_nn_at(xyz1, xyz2, points2, geometry, fast=False):
    """The kernel at an explicit geometry (the wrapper takes
    ``kernels.three_nn_geometry``'s)."""
    B, N, _ = xyz1.shape
    S, D = xyz2.shape[1], points2.shape[2]
    dev = xyz1.device
    dists = torch.empty((B, N, 3), dtype=torch.float32, device=dev)
    idx = torch.empty((B, N, 3), dtype=torch.int32, device=dev)
    out = torch.empty((B, N, D), dtype=torch.float32, device=dev)
    kernels._launch("three_nn_interpolate", "tumseg_three_nn_interpolate",
                    dev, xyz1.data_ptr(), xyz2.data_ptr(),
                    points2.data_ptr(), dists.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), B, N, S, D, *geometry, fast=fast)
    return dists, idx, out


def candidates(B, N, D):
    """The helper's geometry and its neighbours: Q down to a quarter and
    up to double, R half and double."""
    Q, R = chosen = kernels.three_nn_geometry(B, N, D)
    out = [chosen] + [(q, R) for q in (Q // 4, Q // 2, Q * 2)
                      if 1 <= q <= kernels.THREE_NN_MAX_QUERIES]
    out += [(Q, r) for r in (R // 2, R * 2)
            if 1 <= r <= kernels.THREE_NN_THREADS]
    return list(dict.fromkeys(out))


def _slabs(m):
    """The slabs of a tile of m sources: a power of two, about m /
    ``THREE_NN_SLAB_SOURCES``, at most ``THREE_NN_MAX_SLABS``."""
    n = 1
    while (n < kernels.THREE_NN_MAX_SLABS
           and kernels.THREE_NN_SLAB_SOURCES * n < m):
        n <<= 1
    return n


def _top3(d, ids):
    """The three smallest (distance, id) of d, ids [N, M] in lexicographic
    order (ids unique in a row)."""
    out_d, out_i = [], []
    for _ in range(3):
        dmin = d.min(1, keepdims=True)
        imin = np.where(d == dmin, ids, np.iinfo(np.int64).max).min(
            1, keepdims=True)
        out_d.append(dmin)
        out_i.append(imin)
        d = np.where(ids == imin, np.float32(np.inf), d)
        ids = np.where(ids == imin, np.iinfo(np.int64).max, ids)
    return np.concatenate(out_d, 1), np.concatenate(out_i, 1)


def _sqnorm(p):
    """[..., 3] f32 -> (x*x + y*y) + z*z, every product rounded."""
    return (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]) \
        + p[..., 2] * p[..., 2]


# the expansion form's walk stops where fl(dz*dz) > d2 + slack, slack =
# ((1 + qsq) + the largest ssq of the tiles so far) * 2^-19 (three_nn.cuh)
SLACK = np.float32(2.0 ** -19)


def walk_model(xyz1, xyz2, form="direct"):
    """csrc/three_nn.cuh's search in numpy f32, in the direct form
    (three_nn_interpolate.cu) or the expansion form (three_nn_window.cu):
    each tile of ``THREE_NN_TILE`` sources split into z-slabs by the
    kernel's f32 arithmetic, each query testing its own slab, then the
    slabs above and below in turn, each direction stopping at the first
    non-empty slab whose nearest z gives fl(dz*dz) above the query's
    limit (its third distance; in the expansion form plus the slack of
    :data:`SLACK`), entries kept by (distance, index). -> (dists [B, N, 3]
    f32, idx [B, N, 3] int32, the candidates tested)."""
    B, N, _ = xyz1.shape
    S = xyz2.shape[1]
    f32 = np.float32
    expansion = form == "expansion"
    if form not in ("direct", "expansion"):
        raise ValueError(f"form is direct or expansion, got {form!r}")
    dists = np.empty((B, N, 3), f32)
    idx = np.empty((B, N, 3), np.int32)
    tested = 0
    for b in range(B):
        q = xyz1[b]
        qsq = _sqnorm(q)
        ssq_max = f32(0)
        bd = np.full((N, 3), np.inf, f32)
        bi = np.tile(np.arange(S, S + 3), (N, 1))        # unfilled: past S
        for base in range(0, S, kernels.THREE_NN_TILE):
            tile = xyz2[b, base:base + kernels.THREE_NN_TILE]
            m, n = tile.shape[0], _slabs(tile.shape[0])
            z = tile[:, 2]
            zmin, zmax = z.min(), z.max()
            with np.errstate(divide="ignore", over="ignore"):
                scale = (min(f32(n) / (zmax - zmin), f32(3.402823466e38))
                         if zmax > zmin else f32(0))

            def slab_of(v):
                return np.minimum(np.maximum((v - zmin) * scale, f32(0)),
                                  f32(n - 1)).astype(np.int64)

            ks = slab_of(z)
            count = np.bincount(ks, minlength=n)
            lo = np.full(n, np.inf, f32)
            hi = np.full(n, -np.inf, f32)
            np.minimum.at(lo, ks, z)
            np.maximum.at(hi, ks, z)
            if expansion:
                ssq = _sqnorm(tile)
                ssq_max = max(ssq_max, ssq.max())
                slack = ((f32(1) + qsq) + ssq_max) * SLACK
                cross = ((q[:, None, 0] * tile[None, :, 0]
                          + q[:, None, 1] * tile[None, :, 1])
                         + q[:, None, 2] * tile[None, :, 2])
                dist = (qsq[:, None] + ssq[None, :]) - f32(2) * cross
            else:
                slack = f32(0)
                diff = tile[None, :, :] - q[:, None, :]      # [N, m, 3]
                sq = diff * diff
                dist = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
            ids = base + np.arange(m)
            masked = 2 * S + 8 + np.arange(m)   # unique, never chosen

            def visit(slab, take):
                rows = np.nonzero(take)[0]
                mask = ks[None, :] == slab[rows, None]
                counted = int(mask.sum())
                if counted:
                    bd[rows], bi[rows] = _top3(
                        np.concatenate([bd[rows], np.where(
                            mask, dist[rows], np.inf)], 1),
                        np.concatenate([bi[rows], np.where(
                            mask, ids, masked)], 1))
                return counted

            home = slab_of(q[:, 2])
            tested += visit(home, np.ones(N, bool))
            walk = {1: home + 1, -1: home - 1}
            go = {1: walk[1] < n, -1: walk[-1] >= 0}
            while go[1].any() or go[-1].any():
                for step, edge in ((1, lo), (-1, hi)):
                    at = np.clip(walk[step], 0, n - 1)
                    full = go[step] & (count[at] > 0)
                    dz = edge[at] - q[:, 2]
                    limit = bd[:, 2] + slack if expansion else bd[:, 2]
                    stop = full & (dz * dz > limit)
                    tested += visit(at, full & ~stop)
                    go[step] &= ~stop
                    walk[step] = np.where(go[step], walk[step] + step,
                                          walk[step])
                    go[step] &= (walk[step] >= 0) & (walk[step] < n)
        dists[b], idx[b] = bd, bi
    return dists, idx, tested


def bf16_round(a):
    """f32 -> nearest bf16 (ties to even) -> f32, as __float2bfloat16_rn."""
    u = a.astype(np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def interpolation_model(dists, idx, points2, fast):
    """csrc/three_nn.cuh's weights (once a query) and row sums in numpy
    f32, both modes: -> out [B, N, D]."""
    eps = np.float32(1e-8)
    r = np.float32(1) / (dists + eps)
    w = r / ((r[..., 0:1] + r[..., 1:2]) + r[..., 2:3])
    p = points2
    if fast:
        w, p = bf16_round(w), bf16_round(p)
    rows = np.take_along_axis(p[:, None, :, :], idx[..., None].astype(
        np.int64), axis=2)                   # [B, N, 3, D]
    return ((rows[:, :, 0] * w[..., 0:1] + rows[:, :, 1] * w[..., 1:2])
            + rows[:, :, 2] * w[..., 2:3])


def window_cases():
    """[(name, xyz1 [B, N, 3], xyz2 [B, S, 3])] f32, small, the inputs the
    expansion form's walk must survive (tests/test_torch_window_walk.py and
    the card tests share them): facade blocks; half the sources on one z
    (tumseg's "mixed": some of its tiles fail the window guard); every point
    on one z (all fail; the walk becomes a full scan); queries on top of
    sources a few metres from the origin, one of them at three indices
    (expansion distances below 0, the third among them); coordinates tens
    of metres out (qsq ~ 1e3, where the slack matters); an integer lattice
    (ties everywhere); sources past one tile (S = 1100 and 2100, d2
    carried across tiles)."""
    rng = np.random.default_rng(21)

    def facade(b, n, z0=0.0):
        wall = rng.random((b, n)) < 0.7
        return np.stack([rng.uniform(-0.5, 0.5, (b, n)),
                         np.where(wall, rng.normal(0.0, 0.02, (b, n)),
                                  rng.uniform(-0.5, 0.5, (b, n))),
                         z0 + rng.uniform(0.0, 10.0, (b, n))],
                        -1).astype(np.float32)

    def pick(xyz, s):
        return np.ascontiguousarray(xyz[:, rng.permutation(xyz.shape[1])[:s]])

    cases = []
    x1 = facade(2, 512)
    cases.append(("facade", x1, pick(x1, 256)))
    x2 = pick(x1, 256).copy()
    x2[:, :128, 2] = np.float32(5.0)
    cases.append(("mixed", x1, x2))
    flat = rng.random((2, 300, 3)).astype(np.float32)
    flat[..., 2] = np.float32(2.5)
    cases.append(("one_z", flat, np.ascontiguousarray(flat[:, :130])))
    src = (rng.random((2, 200, 3)) * 4 + np.float32(3.0)).astype(np.float32)
    src[:, 8:10] = src[:, 7:8]        # one source at three indices
    on = np.concatenate([src[:, :60], (src[:, :60] + rng.normal(
        0, 1e-4, (2, 60, 3))).astype(np.float32)], 1)
    cases.append(("negative", on, src))
    far = facade(2, 400) + np.float32(20.0)
    cases.append(("far", far, pick(far, 160)))
    lattice = rng.integers(0, 4, (2, 300, 3)).astype(np.float32)
    cases.append(("lattice", lattice, rng.integers(0, 4, (2, 100, 3)).astype(
        np.float32)))
    for s in (1100, 2100):
        big = facade(1, 3 * s // 2)
        cases.append((f"past_tile_{s}", pick(big, 300), pick(big, s)))
    return cases


def ptxas_report(name="three_nn_interpolate") -> str:
    OUT.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
           str(OUT / f"{name}.o"), str(build.CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def _ptxas_lines(report):
    return "\n".join(line for line in report.splitlines()
                     if "registers" in line or "spill" in line
                     or "Compiling" in line)


SHARED = ("three_nn_interpolate", "ball_query", "ball_query_multi", "group")


def sass_bodies(sass: str) -> list:
    """``cuobjdump -sass`` text -> the sorted instruction lists of its
    kernels, names and addresses stripped."""
    funcs, cur = [], None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = []
            funcs.append(cur)
        elif cur is not None and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line.split(";")[0])
            if ins.strip():
                cur.append(ins.strip())
    return sorted(funcs)


def sass_against(other: Path) -> None:
    """``--sass-against`` (the module docstring)."""
    from concurrent.futures import ThreadPoolExecutor

    OUT.mkdir(parents=True, exist_ok=True)
    cuobjdump = str(Path(build._nvcc()).with_name("cuobjdump"))

    def compile_(side, csrc, name):
        obj = OUT / f"{side}_{name}.o"
        res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas",
                              "-v", "-c", "-o", str(obj),
                              str(csrc / f"{name}.cu")],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
        sass = subprocess.run([cuobjdump, "-sass", str(obj)],
                              capture_output=True, text=True).stdout
        return res.stdout + res.stderr, sass_bodies(sass)

    jobs = [(side, csrc, name) for name in SHARED
            for side, csrc in (("this", build.CSRC),
                               ("other", other / "tumseg_torch" / "csrc"))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = dict(zip(jobs, pool.map(lambda j: compile_(*j), jobs)))
    for name in SHARED:
        (mine, a), (theirs, b) = (done[side, csrc, name] for side, csrc, n
                                  in jobs if n == name)
        print(f"[sass] {name}.cu: {len(a)} kernels, SASS the same as "
              f"{other}'s: {a == b}")
        for side, report in (("this", mine), ("other", theirs)):
            print(f"  {side}: " + "; ".join(
                line.split(":", 1)[-1].strip() for line in report.splitlines()
                if "registers" in line or "spill" in line))


def window_probe(dev, dump) -> None:
    """``--window``: the expansion-form kernel (the module docstring)."""
    from chip_smoke import device_ms, host_us, time_ms
    from tumseg_torch import ops

    def ms(t):
        return "not measured" if t is None else f"{t:.4f} ms"

    result = {"walk": [], "stages": [], "cases": []}
    report = ptxas_report("three_nn_window")
    print("[ptxas]\n" + _ptxas_lines(report))
    build.library()
    B = 32
    rng = np.random.default_rng(3)
    for lvl, (xyz1, xyz2, d) in enumerate(levels(dev, B)):
        N, S = xyz1.shape[1], xyz2.shape[1]
        stage = f"fp{lvl + 1}"
        x1, x2 = xyz1.cpu().numpy(), xyz2.cpu().numpy()
        md, mi, tested = walk_model(x1, x2, "expansion")
        _, _, direct = walk_model(x1, x2, "direct")
        want_d, want_i = core.three_nn_expansion(xyz1, xyz2)
        if not (np.array_equal(md, want_d.cpu().numpy())
                and np.array_equal(mi, want_i.cpu().numpy())):
            raise AssertionError(f"{stage}: the expansion walk model differs "
                                 "from the plain version")
        print(f"[walk] B={B} {stage} N={N} S={S}: expansion {tested} "
              f"candidates ({tested / (B * N):.1f} a query), direct {direct} "
              f"({direct / (B * N):.1f})")
        result["walk"].append(dict(stage=stage, expansion=tested,
                                   direct=direct, full=B * N * S))
        p2 = torch.as_tensor(rng.standard_normal((B, S, d)).astype(
            np.float32), device=dev)
        none = p2[..., :0].contiguous()
        window = (ops.three_nn_window(S) if S >= 1024 and S % 128 == 0
                  else S)
        tile = ops.WINDOW_N_TILE
        for fast in (False, True):
            got = kernels.three_nn_window_interpolate(xyz1, xyz2, p2, window,
                                                      tile, fast)
            want = core.three_nn_window_interpolate(xyz1, xyz2, p2, window,
                                                    tile, fast)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{stage} fast={fast}: not bitwise the "
                                     "plain version")

        def call(points2=p2, fast=False):
            return kernels.three_nn_window_interpolate(
                xyz1, xyz2, points2, window, tile, fast)

        ev, runs = time_ms(torch, call, 20)
        row = dict(stage=stage, window=window, event_ms=ev,
                   device_ms=device_ms(torch, call, 20),
                   fast_ms=device_ms(torch, lambda: call(fast=True), 20),
                   search_ms=device_ms(torch, lambda: call(none), 20),
                   direct_ms=device_ms(torch, lambda: kernels.
                                       three_nn_interpolate(xyz1, xyz2, p2),
                                       20))
        result["stages"].append(row)
        print(f"[window] B={B} {stage} N={N} S={S} D={d} window={window}: "
              f"event {ev:.4f} ms {[round(r, 4) for r in runs]}, device "
              f"{ms(row['device_ms'])}, fast {ms(row['fast_ms'])}, search "
              f"alone {ms(row['search_ms'])}; direct form "
              f"{ms(row['direct_ms'])}; bitwise both modes")
    xyz1, xyz2, d = levels(dev, B)[0]
    p2 = torch.as_tensor(rng.standard_normal((B, xyz2.shape[1], d)).astype(
        np.float32), device=dev)
    host = host_us(torch, lambda: kernels.three_nn_window_interpolate(
        xyz1, xyz2, p2, ops.three_nn_window(xyz2.shape[1]),
        ops.WINDOW_N_TILE))
    result["host_us"] = host
    print(f"[window] host time a call of the wrapper at fp1: {host:.2f} us")
    for name, x1, x2 in window_cases():
        a, b = (torch.as_tensor(x, device=dev) for x in (x1, x2))
        got = kernels.three_nn_expansion(a, b)
        want = core.three_nn_expansion(a, b)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        result["cases"].append(dict(case=name, bitwise=same))
        print(f"[cases] {name}: bitwise {same}")
        if not same:
            raise AssertionError(f"window case {name}: not bitwise")
    dump.mkdir(parents=True, exist_ok=True)
    (dump / "three_nn_window_probe.json").write_text(
        json.dumps(result, indent=1))
    (dump / "three_nn_window_ptxas.txt").write_text(report)
    sass = subprocess.run([str(Path(build._nvcc()).with_name("cuobjdump")),
                           "-sass", str(OUT / "three_nn_window.o")],
                          capture_output=True, text=True)
    (dump / "three_nn_window_sass.txt").write_text(sass.stdout + sass.stderr)
    print("three_nn_probe --window: ok")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("three_nn_probe needs a CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    args = sys.argv[1:]
    dump = Path(args[args.index("--out") + 1]) if "--out" in args else OUT
    if "--sass-against" in args:
        sass_against(Path(args[args.index("--sass-against") + 1]))
        return 0
    if "--stages" in args:
        stages(dev)
        return 0
    if "--window" in args:
        window_probe(dev, dump)
        return 0
    from chip_smoke import device_ms

    result = {"card": smi, "three_nn": [], "walk": []}
    report = ptxas_report()
    print("[ptxas]\n" + _ptxas_lines(report))
    build.library()
    rng = np.random.default_rng(2)
    for B in (32, 16):
        for lvl, (xyz1, xyz2, d) in enumerate(levels(dev, B)):
            N, S = xyz1.shape[1], xyz2.shape[1]
            p2 = torch.as_tensor(rng.standard_normal((B, S, d)).astype(
                np.float32), device=dev)
            none = p2[..., :0].contiguous()
            ties = [torch.as_tensor(rng.integers(0, 6, x.shape).astype(
                np.float32), device=dev) for x in (xyz1, xyz2)]
            want = core.three_nn_interpolate(xyz1, xyz2, p2)
            want_ties = core.three_nn_interpolate(*ties, p2)
            md, mi, tested = walk_model(xyz1.cpu().numpy(),
                                        xyz2.cpu().numpy())
            if not (np.array_equal(md, want[0].cpu().numpy())
                    and np.array_equal(mi, want[1].cpu().numpy())):
                raise AssertionError(f"fp{lvl + 1} B={B}: the walk model "
                                     "differs from the plain version")
            print(f"[walk] B={B} fp{lvl + 1} N={N} S={S}: {tested} "
                  f"candidates tested of {B * N * S} ({tested / (B * N):.1f} "
                  "a query)")
            result["walk"].append(dict(B=B, stage=f"fp{lvl + 1}",
                                       tested=tested, full=B * N * S))
            chosen = kernels.three_nn_geometry(B, N, d)
            for geometry in candidates(B, N, d):
                what = f"fp{lvl + 1} B={B} {geometry}"
                bitwise = check(three_nn_at(xyz1, xyz2, p2, geometry), want,
                                what)
                check(three_nn_at(*ties, p2, geometry), want_ties,
                      f"{what} lattice")
                dms = device_ms(torch, lambda: three_nn_at(
                    xyz1, xyz2, p2, geometry), 20)
                sms = device_ms(torch, lambda: three_nn_at(
                    xyz1, xyz2, none, geometry), 20)
                mark = " <- three_nn_geometry" if geometry == chosen else ""
                print(f"[three_nn] B={B} fp{lvl + 1} N={N} S={S} D={d} "
                      f"(Q, R) {geometry}: device "
                      + ("not measured" if dms is None else f"{dms:.4f} ms")
                      + ", search alone " + ("not measured" if sms is None
                                             else f"{sms:.4f} ms")
                      + f"; out bitwise {bitwise}{mark}")
                result["three_nn"].append(dict(
                    B=B, stage=f"fp{lvl + 1}", geometry=list(geometry),
                    device_ms=dms, search_ms=sms, bitwise=bitwise,
                    chosen=bool(mark)))

    dump.mkdir(parents=True, exist_ok=True)
    (dump / "three_nn_probe.json").write_text(json.dumps(result, indent=1))
    (dump / "three_nn_probe_ptxas.txt").write_text(report)
    sass = subprocess.run([str(Path(build._nvcc()).with_name("cuobjdump")),
                           "-sass", str(OUT / "three_nn_interpolate.o")],
                          capture_output=True, text=True)
    (dump / "three_nn_probe_sass.txt").write_text(sass.stdout + sass.stderr)
    print("three_nn_probe: ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
