"""Probe of the interpolation-backward kernel
(``csrc/interpolate_backward.cu``) on one NVIDIA GPU:

    python3 -m tumseg_torch.tools.interp_backward_probe [--out DIR]
    PYTHONPATH=. python3 PATH/TO/interp_backward_probe.py --stages

from the root of a checkout (it takes the facade blocks and the timers of
that checkout's ``chip_smoke.py``). ``--stages`` only times the wrapper
``kernels.interpolate_backward`` at fp1-fp4 of a B=16 x 4096 training step
and at the MSG model's fp4 (D = 1024): CUDA-event and profiler device ms of
the exact call and device ms of the fast one, each stage first held within
rtol 1e-5 / atol 1e-4 of the plain version run on the CPU (and whether it is
bitwise that is printed), and the wrapper's host time a call; run from
another checkout's root with this file's path, it times that checkout's
kernel, so two trees compare in one call. Without it the probe prints, and
writes to ``DIR/interp_backward_probe.json`` (``DIR`` defaults to
``build/interp_backward_probe/``):

1. ``nvcc -Xptxas -v`` on ``csrc/interpolate_backward.cu``: each
   instance's registers, shared memory and spills (and the SASS, from
   ``cuobjdump``, into ``DIR/interp_backward_probe_sass.txt``);
2. the adversarial inputs (:func:`adversarial_cases`) at the tiles of
   :func:`adversarial_tiles`, both modes bitwise the plain version on the
   CPU and the same over three runs;
3. the kernel at each candidate geometry (threads, T, CT) at each stage,
   bitwise the plain version on the CPU and the same over three runs, then
   profiler device ms, beside the geometry
   ``kernels.interpolate_backward_tiles`` picks, which is also checked and
   timed in the fast mode and timed at D = 4 (the scan, the sort and the
   chain of loads a row, with almost no bytes: what does not scale with
   the width);
4. at the chosen geometry, the split of a block's time into its scan, its
   sort and its sum (SM clocks each block records in the probe's own build
   of the kernel, :func:`phase_library`), and the
   device time with no entry in any tile (the scan and the zero rows);
   the same for each variant of the sum loop in ``VARIANTS`` (entries in
   flight, loads through L2 only, one bf16 conversion a value), in both
   modes, each checked bitwise first;
5. whether the cotangent rows that the gather form reads three times hit
   the L2: each of fp1 and fp2 rebuilt as 3N queries of one entry each
   (every row read once: all of the reads reach device memory) and as 3N
   queries of which every third holds the original three entries (every
   row read three times), the same scan and the same sums bitwise, timed
   beside the original.

The module also holds the inputs that the CPU and card tests share
(:func:`adversarial_cases`, :func:`adversarial_tiles`,
:func:`stage_inputs`).
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from tumseg_torch.ops import build, core, kernels

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "interp_backward_probe"
MSG_FP4_D = 1024  # the MSG model's fp4 points2 channels
STAGES = ("fp1", "fp2", "fp3", "fp4", "msg fp4")
# geometries whose phases the probe also splits, beside the helper's
PHASE_TILES = {"fp1": [(256, 32, 128), (256, 8, 128)],
               "fp2": [(256, 8, 256)]}


def stage_inputs(dev, B=16, seed=3):
    """[(stage, idx, w, g, S)] of fp1..fp4 of a B x 4096 facade batch and
    the MSG model's fp4: each stage's sources the FPS centroids of its
    queries, idx and w their 3-NN and weights (the kernels on the card, the
    plain versions on the CPU), g unit normal."""
    from chip_smoke import FP_D, N, SA, facade_blocks

    ops = kernels if dev.type == "cuda" else core
    rng = np.random.default_rng(seed)
    xyzs = [torch.as_tensor(facade_blocks(rng, B, N), device=dev)]
    for npoint, _ in SA:
        src = xyzs[-1]
        xyzs.append(core.gather_rows(
            src, ops.farthest_point_sample(src, npoint)).contiguous())
    out = []
    for lvl, d in enumerate(FP_D + [MSG_FP4_D]):
        xyz1, xyz2 = xyzs[min(lvl, 3)], xyzs[min(lvl, 3) + 1]
        s = xyz2.shape[1]
        dists, idx, _ = ops.three_nn_interpolate(
            xyz1, xyz2, torch.zeros(B, s, 1, device=dev))
        g = torch.as_tensor(rng.standard_normal(
            (B, xyz1.shape[1], d)).astype(np.float32), device=dev)
        out.append((STAGES[lvl], idx, core.interpolation_weights(dists), g,
                    s))
    return out


def _case(rng, B, N, S, D):
    """Random indices, weights over six decades and cotangent rows over
    five, so the order of the sums shows in the low bits."""
    idx = rng.integers(0, S, (B, N, 3)).astype(np.int32)
    w = (rng.random((B, N, 3)) * 10.0 ** rng.integers(-3, 3, (B, N, 3))
         ).astype(np.float32)
    g = (rng.standard_normal((B, N, D))
         * 10.0 ** rng.integers(-3, 2, (B, N, 1))).astype(np.float32)
    return idx, w, g


def adversarial_cases():
    """{name: (idx [B, N, 3] i32, w [B, N, 3] f32, g [B, N, D] f32, S)} in
    numpy: what the kernel's lists, sorts and flushes must get right."""
    cases = {}
    idx, w, g = _case(np.random.default_rng(40), 2, 500, 130, 40)
    idx[..., 0] = 129                      # one source in every query
    cases["source in every query D=40"] = (idx, w, g, 130)
    idx, w, g = _case(np.random.default_rng(41), 2, 300, 50, 7)
    idx[:, ::3] = idx[:, ::3, :1]          # all three entries on one source
    idx[:, 1::3, 1] = idx[:, 1::3, 0]      # two of three on one source
    cases["three on one D=7"] = (idx, w, g, 50)
    idx, w, g = _case(np.random.default_rng(42), 2, 4096, 1024, 128)
    idx[1] = 17                            # 12288 entries on one row
    cases["batch row on one source fp1"] = (idx, w, g, 1024)
    cases["S=3 D=7"] = (*_case(np.random.default_rng(43), 1, 70, 3, 7), 3)
    cases["ragged N=4099"] = (*_case(np.random.default_rng(44), 2, 4099,
                                     1024, 128), 1024)
    cases["msg fp4 D=1024"] = (*_case(np.random.default_rng(45), 16, 64, 16,
                                      MSG_FP4_D), 16)
    return cases


def backward_at(idx, w, g, s, tiles, fast=False):
    """The kernel at an explicit (threads, T, CT) (the wrapper takes
    ``kernels.interpolate_backward_tiles``'s)."""
    B, N, _ = idx.shape
    D = g.shape[2]
    out = torch.empty((B, s, D), dtype=torch.float32, device=g.device)
    kernels._launch("interpolate_backward", "tumseg_interpolate_backward",
                    g.device, idx.data_ptr(), w.data_ptr(), g.data_ptr(),
                    out.data_ptr(), B, N, s, D, *tiles, fast=fast)
    return out


def adversarial_tiles(B, S, D):
    """The helper's geometry, then the most rows a block takes (a list
    that fills and is summed in rounds), a ragged T and one-slice column
    tiles, across the block sizes."""
    return [kernels.interpolate_backward_tiles(B, S, D), (1024, 128, D),
            (256, 128, D), (1024, 5, D), (256, 3, kernels.INTERP_BWD_SLICE)]


def check_bitwise(call, want, what):
    """Raises unless three runs of ``call`` are bitwise equal to each other
    and to ``want`` (the plain version on the CPU)."""
    runs = [call() for _ in range(3)]
    for i, got in enumerate(runs):
        if not torch.equal(got, runs[0]):
            raise AssertionError(f"{what}: run {i + 1} is not bitwise run 1")
    if not torch.equal(runs[0].cpu(), want):
        bad = (runs[0].cpu() != want).float().mean().item()
        raise AssertionError(f"{what}: {bad:.2e} of elements differ from "
                             "the plain version on the CPU")


def bound_ms(B, N, S, D) -> float:
    """Bytes over 3.35 TB/s: idx and w read once, g read once, dp2 written
    once (chip_smoke.py [e]'s count; the operations are far below)."""
    return 4 * (B * N * 6 + B * N * D + B * S * D) / 3.35e12 * 1e3


def _ms(t):
    return "not measured" if t is None else f"{t:.4f} ms"


def stages(dev) -> None:
    from chip_smoke import device_ms, host_us, time_ms

    total = [0.0, 0.0, 0.0, 0.0]
    for stage, idx, w, g, s in stage_inputs(dev):
        B, N, D = g.shape
        want = core.interpolate_backward(idx.cpu(), w.cpu(), g.cpu(), s)
        got = kernels.interpolate_backward(idx, w, g, s)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)
        same = torch.equal(got.cpu(), want)
        ev, runs = time_ms(torch, lambda: kernels.interpolate_backward(
            idx, w, g, s), 20)
        dv = device_ms(torch, lambda: kernels.interpolate_backward(
            idx, w, g, s), 20)
        fv = device_ms(torch, lambda: kernels.interpolate_backward(
            idx, w, g, s, True), 20)
        if stage != "msg fp4":
            total = [total[0] + ev] + [
                None if t is None or v is None else t + v
                for t, v in ((total[1], dv), (total[2], fv))] + [
                total[3] + bound_ms(B, N, s, D)]
        print(f"[stages] B={B} {stage} N={N} S={s} D={D}: event {ev:.4f} ms "
              f"{[round(r, 4) for r in runs]}, device {_ms(dv)}; fast "
              f"device {_ms(fv)}; bound {bound_ms(B, N, s, D):.4f} ms; "
              f"bitwise the plain version on the CPU: {same}")
    host = host_us(torch, lambda: kernels.interpolate_backward(idx, w, g, s))
    print(f"[stages] B=16 fp1-fp4: event {total[0]:.4f} ms, device "
          f"{_ms(total[1])}, fast device {_ms(total[2])}, bound "
          f"{total[3]:.4f} ms; host time a call of the wrapper at msg fp4 "
          f"{host:.2f} us")


def candidates(B, S, D):
    """(threads, T, CT): each block size the kernel is built for, every
    power-of-two T up to its limit below 2S, with CT = D and each halving
    of it in whole slices; the helper's choice first."""
    out = [kernels.interpolate_backward_tiles(B, S, D)]
    for threads in kernels.INTERP_BWD_THREADS:
        T = 1
        while T <= kernels.INTERP_BWD_MAX_ROWS and T < 2 * S:
            ct = D
            while True:
                out.append((threads, T, ct))
                if ct <= kernels.INTERP_BWD_SLICE:
                    break
                ct = -(-ct // (2 * kernels.INTERP_BWD_SLICE)) \
                    * kernels.INTERP_BWD_SLICE
            T *= 2
    return list(dict.fromkeys(out))


def reuse_variants(idx, w, g):
    """-> (no reuse, reuse): each an (idx, w, g) of 3N queries whose sums
    are bitwise those of (idx, w, g). "No reuse": query 3n + k holds entry
    k of query n alone (its other two point at no source) and its own copy
    of g[n], so every cotangent row is read once. "Reuse": query 3n holds
    query n's three entries and g[n], the other two nothing. The index
    ranges, the scans and the sums are the same; only the rereads of a
    row differ."""
    B, N, D = g.shape
    dev = g.device
    none_i = torch.full((B, N, 3, 3), -1, dtype=torch.int32, device=dev)
    none_w = torch.zeros((B, N, 3, 3), device=dev)
    one_i, one_w = none_i.clone(), none_w.clone()
    one_i[..., 0] = idx
    one_w[..., 0] = w
    g3 = g[:, :, None].expand(B, N, 3, D).reshape(B, 3 * N, D).contiguous()
    three_i, three_w = none_i.clone(), none_w.clone()
    three_i[:, :, 0] = idx
    three_w[:, :, 0] = w
    g1 = torch.zeros((B, N, 3, D), device=dev)
    g1[:, :, 0] = g
    return ((one_i.reshape(B, 3 * N, 3), one_w.reshape(B, 3 * N, 3), g3),
            (three_i.reshape(B, 3 * N, 3), three_w.reshape(B, 3 * N, 3),
             g1.reshape(B, 3 * N, D)))


# variants of the sum loop the probe builds beside the kernel as it is:
# (old text, new text) substitutions in csrc/interpolate_backward.cu
VARIANTS = {
    "as is": [],
    "batch 2": [("constexpr int kBatch = 4;", "constexpr int kBatch = 2;")],
    "batch 8": [("constexpr int kBatch = 4;", "constexpr int kBatch = 8;")],
    "cotangent through L2 only (ld.global.cg)": [
        ("? *reinterpret_cast<const float4*>(p + 4 * lane)",
         "? __ldcg(reinterpret_cast<const float4*>(p + 4 * lane))")],
    "fast: a conversion a value": [
        ("for (int i = 0; i < kBatch; i += 2) bf16_round2(wv[i], wv[i + 1]);",
         "for (int i = 0; i < kBatch; ++i) "
         "wv[i] = tumseg::bf16_round(wv[i]);"),
        ("""          bf16_round2(g[i].v[0], g[i].v[1]);
          bf16_round2(g[i].v[2], g[i].v[3]);""",
         """          for (int j = 0; j < 4; ++j) {
            g[i].v[j] = tumseg::bf16_round(g[i].v[j]);
          }""")],
}


# What the probe's own builds add to the kernel: each block's SM clock at
# entry, after its scan, after its last sort and at exit, and its
# globaltimer at entry and exit, into a device table that an extra C
# function copies out; (anchor, text with the anchor) substitutions
PHASE_TIMES = r"""
constexpr int kTimedBlocks = 1 << 16;
__device__ long long phase_times[kTimedBlocks][6];

__device__ __forceinline__ void mark(int phase) {
  const unsigned block =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (threadIdx.x != 0 || block >= kTimedBlocks) return;
  phase_times[block][phase] = clock64();
  if (phase == 0 || phase == 3) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    phase_times[block][4 + (phase == 3)] = t;
  }
}
"""
PHASE_TIMES_COPY = r"""
TUMSEG_API int tumseg_interpolate_backward_phase_times(long long* out,
                                                       int blocks) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, phase_times, sizeof(long long) * 6 * blocks));
}
"""
PHASE_MARKS = [
    ("namespace {\n", "namespace {\n" + PHASE_TIMES),
    ("  const int b = blockIdx.z;", "  mark(0);\n  const int b = blockIdx.z;"),
    ("  __syncthreads();  // the list and the counts are complete\n",
     "  __syncthreads();  // the list and the counts are complete\n"
     "  mark(1);\n"),
    ("  sort_by_row(k, list, sorted, count, rows);\n  add_rows",
     "  sort_by_row(k, list, sorted, count, rows);\n  mark(2);\n  add_rows"),
    ("                                  first);\n}",
     "                                  first);\n  mark(3);\n}"),
]


def phase_library(name="as is"):
    """This checkout's ``csrc/interpolate_backward.cu``, with the
    substitutions of ``VARIANTS[name]`` and the phase clocks of
    ``PHASE_MARKS``, built on its own into ``OUT``."""
    import ctypes

    OUT.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "interpolate_backward.cu").read_text()
    for old, new in VARIANTS[name] + PHASE_MARKS:
        if old not in text:
            raise RuntimeError(f"variant {name!r}: {old!r} not in the source")
        text = text.replace(old, new, 1)
    tag = "".join(c if c.isalnum() else "_" for c in name)
    src = OUT / f"interpolate_backward_{tag}.cu"
    src.write_text(text + PHASE_TIMES_COPY)
    lib = OUT / f"libinterp_bwd_{tag}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-shared", "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.tumseg_interpolate_backward.argtypes = build.SIGNATURES[
        "tumseg_interpolate_backward"]
    dll.tumseg_interpolate_backward.restype = ctypes.c_int
    dll.tumseg_interpolate_backward_phase_times.argtypes = (ctypes.c_void_p,
                                                            ctypes.c_int)
    dll.tumseg_interpolate_backward_phase_times.restype = ctypes.c_int
    return dll


def phase_split(dll, idx, w, g, s, tiles, fast=False):
    """-> {phase: (median, max) over the blocks} of one launch at
    ``tiles`` through :func:`phase_library`: the SM cycles of the scan,
    the sort and the sum, and the block's and the launch's ns (first
    entry to last exit, globaltimer)."""
    B, N, _ = idx.shape
    D = g.shape[2]
    out = torch.empty((B, s, D), dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(3):
        err = dll.tumseg_interpolate_backward(
            idx.data_ptr(), w.data_ptr(), g.data_ptr(), out.data_ptr(), B, N,
            s, D, *tiles, int(fast), stream)
        if err:
            raise RuntimeError(f"phase-timed launch failed: CUDA error {err}")
    torch.cuda.synchronize()
    blocks = B * -(-s // tiles[1]) * -(-D // tiles[2])
    t = np.zeros((min(blocks, 1 << 16), 6), np.int64)
    if dll.tumseg_interpolate_backward_phase_times(t.ctypes.data, len(t)):
        raise RuntimeError("phase times copy failed")
    parts = {"scan_cycles": t[:, 1] - t[:, 0],
             "sort_cycles": t[:, 2] - t[:, 1],
             "sum_cycles": t[:, 3] - t[:, 2], "block_ns": t[:, 5] - t[:, 4]}
    out = {k: (float(np.median(v)), float(v.max())) for k, v in parts.items()}
    out["launch_ns"] = (float(t[:, 5].max() - t[:, 4].min()),) * 2
    return out


def ptxas_report() -> str:
    OUT.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
           str(OUT / "interpolate_backward.o"),
           str(build.CSRC / "interpolate_backward.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("interp_backward_probe needs a CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    if "--stages" in sys.argv[1:]:
        stages(dev)
        return 0
    from chip_smoke import device_ms

    result = {"card": smi, "geometry": [], "l2": [], "phases": [],
              "variants": []}
    report = ptxas_report()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # one nvcc each
        libs = dict(zip(VARIANTS, pool.map(phase_library, VARIANTS)))
    phases = libs["as is"]
    print("[ptxas]\n" + "\n".join(
        line for line in report.splitlines()
        if "registers" in line or "spill" in line or "Compiling" in line))
    build.library()

    for name, (idx, w, g, s) in adversarial_cases().items():
        idx, w, g = (torch.as_tensor(a, device=dev) for a in (idx, w, g))
        B, _, D = g.shape
        for fast in (False, True):
            want = core.interpolate_backward(idx.cpu(), w.cpu(), g.cpu(), s,
                                             fast=fast)
            for tiles in adversarial_tiles(B, s, D):
                check_bitwise(lambda: backward_at(idx, w, g, s, tiles, fast),
                              want, f"{name} {tiles} fast={fast}")
        print(f"[adversarial] {name} B={B} N={idx.shape[1]} S={s} D={D}: "
              "bitwise the plain version on the CPU over three runs, both "
              f"modes, at (threads, T, CT) {adversarial_tiles(B, s, D)}")

    for stage, idx, w, g, s in stage_inputs(dev):
        B, N, D = g.shape
        want = {fast: core.interpolate_backward(idx.cpu(), w.cpu(), g.cpu(),
                                                s, fast=fast)
                for fast in (False, True)}
        chosen = kernels.interpolate_backward_tiles(B, s, D)
        for tiles in candidates(B, s, D):
            check_bitwise(lambda: backward_at(idx, w, g, s, tiles),
                          want[False], f"{stage} {tiles}")
            dms = device_ms(torch, lambda: backward_at(idx, w, g, s, tiles),
                            20)
            mark = ""
            if tiles == chosen:
                check_bitwise(lambda: backward_at(idx, w, g, s, tiles, True),
                              want[True], f"{stage} {tiles} fast")
                fms = device_ms(torch, lambda: backward_at(
                    idx, w, g, s, tiles, True), 20)
                narrow = g[..., :4].contiguous()
                nms = device_ms(torch, lambda: backward_at(
                    idx, w, narrow, s, (*tiles[:2], 4)), 20)
                mark = (f" <- interpolate_backward_tiles; fast {_ms(fms)}; "
                        f"at D = 4 {_ms(nms)}")
            print(f"[geometry] B={B} {stage} N={N} S={s} D={D} (threads, "
                  f"T, CT) {tiles}: device {_ms(dms)}; bound "
                  f"{bound_ms(B, N, s, D):.4f} ms{mark}")
            result["geometry"].append(dict(stage=stage, B=B, tiles=list(tiles),
                                           device_ms=dms, chosen=bool(mark)))

        for tiles in dict.fromkeys([chosen] + PHASE_TILES.get(stage, [])):
            split = phase_split(phases, idx, w, g, s, tiles)
            none = torch.full_like(idx, -1)
            scan = device_ms(torch, lambda: backward_at(none, w, g, s, tiles),
                             20)
            print(f"[phases] B={B} {stage} {tiles}: " + ", ".join(
                f"{k} median {a:.0f} max {b:.0f}" for k, (a, b)
                in split.items()) + f"; no entry in any tile (the scan and "
                f"the zero rows) device {_ms(scan)}")
            result["phases"].append(dict(stage=stage, tiles=list(tiles),
                                         scan_only_ms=scan, **split))

        for (name, dll), fast in itertools.product(libs.items(),
                                                   (False, True)):
            def call():
                out = torch.empty((B, s, D), device=dev)
                dll.tumseg_interpolate_backward(
                    idx.data_ptr(), w.data_ptr(), g.data_ptr(),
                    out.data_ptr(), B, N, s, D, *chosen, int(fast),
                    torch.cuda.current_stream().cuda_stream)
                return out
            check_bitwise(call, want[fast], f"{stage} variant {name}")
            vms = device_ms(torch, call, 20)
            split = phase_split(dll, idx, w, g, s, chosen, fast)
            print(f"[variant] B={B} {stage} {chosen} {name} "
                  f"{'fast' if fast else 'exact'}: device {_ms(vms)}; "
                  + ", ".join(f"{k} median {a:.0f} max {b:.0f}"
                              for k, (a, b) in split.items()))
            result["variants"].append(dict(stage=stage, variant=name,
                                           fast=fast, device_ms=vms,
                                           **split))

        if stage in ("fp1", "fp2"):
            tiles = chosen
            base = device_ms(torch, lambda: backward_at(idx, w, g, s, tiles),
                             20)
            line = dict(stage=stage, original_ms=base)
            for label, (i3, w3, g3) in zip(("no_reuse", "reuse"),
                                           reuse_variants(idx, w, g)):
                check_bitwise(lambda: backward_at(i3, w3, g3, s, tiles),
                              want[False], f"{stage} {label}")
                line[f"{label}_ms"] = device_ms(torch, lambda: backward_at(
                    i3, w3, g3, s, tiles), 20)
            hbm = 4 * 3 * B * N * D / 3.35e12 * 1e3
            print(f"[l2] B={B} {stage}: original {_ms(base)}; as 3N queries, "
                  f"every cotangent row read once {_ms(line['no_reuse_ms'])},"
                  f" every row read three times {_ms(line['reuse_ms'])}; the "
                  f"three reads from device memory alone {hbm:.4f} ms")
            result["l2"].append(line)

    args = sys.argv[1:]
    dump = Path(args[args.index("--out") + 1]) if "--out" in args else OUT
    dump.mkdir(parents=True, exist_ok=True)
    (dump / "interp_backward_probe.json").write_text(
        json.dumps(result, indent=1))
    (dump / "interp_backward_probe_ptxas.txt").write_text(report)
    cuobjdump = str(Path(build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass",
                           str(OUT / "interpolate_backward.o")],
                          capture_output=True, text=True).stdout
    (dump / "interp_backward_probe_sass.txt").write_text(sass)
    print("interp_backward_probe: ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
