"""Probe of the 3-NN + interpolation kernel (``csrc/three_nn_interpolate.cu``)
on one NVIDIA GPU:

    python3 -m tumseg_torch.tools.three_nn_probe [--out DIR]
    PYTHONPATH=. python3 PATH/TO/three_nn_probe.py --stages

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


def walk_model(xyz1, xyz2):
    """csrc/three_nn_interpolate.cu's search in numpy f32: each tile of
    ``THREE_NN_TILE`` sources split into z-slabs by the kernel's f32
    arithmetic, each query testing its own slab, then the slabs above and
    below in turn, each direction stopping at the first non-empty slab
    whose nearest z gives fl(dz*dz) above the query's third distance,
    entries kept by (distance, index). -> (dists [B, N, 3] f32, idx
    [B, N, 3] int32, the candidates tested)."""
    B, N, _ = xyz1.shape
    S = xyz2.shape[1]
    f32 = np.float32
    dists = np.empty((B, N, 3), f32)
    idx = np.empty((B, N, 3), np.int32)
    tested = 0
    for b in range(B):
        q = xyz1[b]
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
            diff = tile[None, :, :] - q[:, None, :]          # [N, m, 3]
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
                    stop = full & (dz * dz > bd[:, 2])
                    tested += visit(at, full & ~stop)
                    go[step] &= ~stop
                    walk[step] = np.where(go[step], walk[step] + step,
                                          walk[step])
                    go[step] &= (walk[step] >= 0) & (walk[step] < n)
        dists[b], idx[b] = bd, bi
    return dists, idx, tested


def ptxas_report() -> str:
    OUT.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
           str(OUT / "three_nn_interpolate.o"),
           str(build.CSRC / "three_nn_interpolate.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("three_nn_probe needs a CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    if "--stages" in sys.argv[1:]:
        stages(dev)
        return 0
    from chip_smoke import device_ms

    result = {"card": smi, "three_nn": [], "walk": []}
    report = ptxas_report()
    print("[ptxas]\n" + "\n".join(
        line for line in report.splitlines()
        if "registers" in line or "spill" in line or "Compiling" in line))
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

    args = sys.argv[1:]
    dump = Path(args[args.index("--out") + 1]) if "--out" in args else OUT
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
