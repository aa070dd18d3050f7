"""Probe of the FPS kernel (``csrc/fps.cu``) on one NVIDIA GPU:

    python3 -m tumseg_torch.tools.fps_probe [--out DIR]
    PYTHONPATH=. python3 PATH/TO/fps_probe.py --stages

from the root of a checkout (it takes the facade blocks and the timers of
that checkout's ``chip_smoke.py``). ``--stages`` only times the FPS wrapper
of the ``tumseg_torch`` on the path at sa1-sa4 of a B=32 x 4096 forward,
event and profiler device ms and us a step, checked against the plain
version first; run from another checkout's root with this file's path, it
times that checkout's kernel, so two trees compare in one call. Without it
the probe prints, and writes to ``DIR/fps_probe.json`` (``DIR`` defaults
to ``build/fps_probe/``):

1. ``nvcc -Xptxas -v`` on ``csrc/fps.cu``: each instance's registers,
   shared memory and spills (and its SASS, from ``cuobjdump``, into
   ``DIR/fps_probe_sass.txt``);
2. the step's synchronisation floor: a kernel built here, under
   ``build/fps_probe/``, that runs FPS's per-step chain with no distance
   work (one centroid load, the warp argmax, a slot store, the exchange,
   the slot reads and the second warp argmax), in us a step, at sa1's B=32
   rows for each threads x cluster: one CTA's barrier, and five ways for a
   cluster (barrier.cluster, or 64-bit slots stamped with the step, stored
   into each CTA or pulled from it, and polled);
3. the FPS kernel at each geometry (threads, points a thread)
   at sa1-sa4 of a B=32 x 4096 forward and sa1-sa2 of a B=16 step on facade
   blocks, bitwise against the plain version and on an integer lattice (a
   field of ties): CUDA-event and profiler device ms a call and us a step,
   beside the geometry ``kernels.fps_geometry`` picks.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from tumseg_torch.ops import build, core, kernels

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "fps_probe"

SYNC_FLOOR_CU = r"""
#include <cooperative_groups.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ uint2 warp_argmax(unsigned v, unsigned i) {
  const unsigned m = __reduce_max_sync(0xffffffffu, v);
  return make_uint2(m, __reduce_min_sync(0xffffffffu, v == m ? i : ~0u));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned peer_addr(unsigned local, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(local), "r"(rank));
  return out;
}

// The exchange of one step between the slots of a row (mode):
// 0 one CTA: a slot store, one barrier, the slot loads;
// 1 cluster barrier: stores into every CTA's slots, barrier.cluster;
// 2 stamped, volatile generic stores into every CTA, local volatile polls;
// 3 stamped, st.relaxed.cluster.shared::cluster, ld.relaxed.cluster polls;
// 4 stamped, weak st.shared::cluster, local volatile polls;
// 5 pull: a volatile store into its own slot, peers poll it with
//   ld.relaxed.cluster.shared::cluster
// each thread offers its own index (below N), valued by the centroid's x,
// so the chain of steps stays dependent
template <int C, int kMode>
__global__ void sync_floor(const float* xyz, int* out, int N, int steps) {
  extern __shared__ float sx[];
  __shared__ uint2 slots[2][32];
  __shared__ unsigned long long stamped[2][32];
  const int T = blockDim.x;
  int rank = 0;
  if constexpr (C > 1) rank = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.x / C, lane = threadIdx.x & 31, W = T >> 5;
  const int nslots = W * C, slot = rank * W + (threadIdx.x >> 5);
  const unsigned g = rank * T + threadIdx.x;
  const unsigned mask = N > 1 ? (1u << (31 - __clz(N - 1))) - 1 : 0u;
  for (int i = threadIdx.x; i < N; i += T) sx[i] = xyz[((size_t)b * N + i) * 3];
  for (int i = threadIdx.x; i < 64; i += T) (&stamped[0][0])[i] = ~0ull;
  __syncthreads();
  if constexpr (C > 1) cg::this_cluster().sync();
  int far = 0;
  for (int it = 0; it < steps; ++it) {
    if (g == 0) out[(size_t)b * steps + it] = far;
    const float cx = sx[far];
    uint2 w = warp_argmax(__float_as_uint(fabsf(cx)) ^ g, g & mask);
    const unsigned stamp = (unsigned)it & 0x3ffffu;
    const unsigned long long word =
        ((unsigned long long)w.x << 32) | (stamp << 14) | w.y;
    unsigned long long s = 0ull;
    if constexpr (kMode == 0) {
      if (nslots > 1) {
        if (lane == 0) slots[it & 1][slot] = w;
        __syncthreads();
        const uint2 v = lane < nslots ? slots[it & 1][lane] : make_uint2(0u, ~0u);
        w = warp_argmax(v.x, v.y);
      }
    } else if constexpr (kMode == 1) {
      if (lane < C)
        *cg::this_cluster().map_shared_rank(&slots[it & 1][slot], lane) = w;
      cg::this_cluster().sync();
      const uint2 v = lane < nslots ? slots[it & 1][lane] : make_uint2(0u, ~0u);
      w = warp_argmax(v.x, v.y);
    } else {
      if constexpr (kMode == 5) {
        if (lane == 0)
          *(volatile unsigned long long*)&stamped[it & 1][slot] = word;
        if (lane < nslots) {
          const unsigned a = peer_addr(smem_addr(&stamped[it & 1][lane]),
                                       lane / W);
          do {
            asm volatile("ld.relaxed.cluster.shared::cluster.u64 %0, [%1];"
                         : "=l"(s) : "r"(a) : "memory");
          } while (((unsigned)s >> 14) != stamp);
        }
      } else {
        if (lane < C) {
          if constexpr (kMode == 2) {
            volatile unsigned long long* peer =
                cg::this_cluster().map_shared_rank(&stamped[it & 1][slot], lane);
            *peer = word;
          } else {
            const unsigned a = peer_addr(smem_addr(&stamped[it & 1][slot]), lane);
            if constexpr (kMode == 3)
              asm volatile("st.relaxed.cluster.shared::cluster.u64 [%0], %1;"
                           :: "r"(a), "l"(word) : "memory");
            else
              asm volatile("st.shared::cluster.u64 [%0], %1;"
                           :: "r"(a), "l"(word) : "memory");
          }
        }
        if (lane < nslots) {
          const unsigned a = smem_addr(&stamped[it & 1][lane]);
          do {
            if constexpr (kMode == 3)
              asm volatile("ld.relaxed.cluster.shared::cta.u64 %0, [%1];"
                           : "=l"(s) : "r"(a) : "memory");
            else
              s = *(const volatile unsigned long long*)&stamped[it & 1][lane];
          } while (((unsigned)s >> 14) != stamp);
        }
      }
      w = warp_argmax((unsigned)(s >> 32),
                      lane < nslots ? (unsigned)s & 0x3fffu : ~0u);
    }
    far = (int)w.y;
  }
  if constexpr (C > 1) cg::this_cluster().sync();
}

template <int C, int kMode>
int launch(const float* xyz, int* out, int B, int N, int steps, int threads,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * N;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = C;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = C > 1 ? 1 : 0;
  cudaLaunchKernelEx(&cfg, sync_floor<C, kMode>, xyz, out, N, steps);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch_mode(const float* xyz, int* out, int B, int N, int steps,
                int threads, int cluster, cudaStream_t s) {
  switch (cluster) {
    case 2: return launch<2, kMode>(xyz, out, B, N, steps, threads, s);
    case 4: return launch<4, kMode>(xyz, out, B, N, steps, threads, s);
    case 8: return launch<8, kMode>(xyz, out, B, N, steps, threads, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int probe_sync_floor(const float* xyz, int* out, int B, int N,
                                int steps, int threads, int cluster, int mode,
                                void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (cluster == 1)
    return mode == 0 ? launch<1, 0>(xyz, out, B, N, steps, threads, s)
                     : (int)cudaErrorInvalidValue;
  switch (mode) {
    case 1: return launch_mode<1>(xyz, out, B, N, steps, threads, cluster, s);
    case 2: return launch_mode<2>(xyz, out, B, N, steps, threads, cluster, s);
    case 3: return launch_mode<3>(xyz, out, B, N, steps, threads, cluster, s);
    case 4: return launch_mode<4>(xyz, out, B, N, steps, threads, cluster, s);
    case 5: return launch_mode<5>(xyz, out, B, N, steps, threads, cluster, s);
  }
  return (int)cudaErrorInvalidValue;
}
"""

# (N, npoint, B): sa1-sa4 of a B=32 forward, sa1-sa2 of a B=16 step
STAGES = [(4096, 1024, 32), (1024, 256, 32), (256, 64, 32), (64, 16, 32),
          (4096, 1024, 16), (1024, 256, 16)]
# geometries (threads, points) tried at each N
CANDIDATES = {
    4096: [(1024, 4), (512, 8), (256, 16)],
    1024: [(1024, 1), (512, 2), (256, 4), (128, 8), (64, 16)],
    256: [(256, 1), (128, 2), (64, 4), (32, 8)],
    64: [(64, 1), (32, 2)],
}
# (threads, cluster, exchange mode of the floor kernel), modes as in
# SYNC_FLOOR_CU
FLOOR_MODES = {0: "CTA barrier", 1: "cluster barrier",
               2: "stamped, volatile generic", 3: "stamped, relaxed.cluster",
               4: "stamped, weak st.shared::cluster", 5: "stamped, pulled"}
SYNC_FLOOR = ([(t, 1, 0) for t in (1024, 512, 256, 128, 64, 32)]
              + [(t, c, m) for m in (1, 2, 3, 4, 5)
                 for t, c in ((256, 2), (128, 4), (64, 8))])


def ptxas_report() -> str:
    OUT.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
           str(OUT / "fps.o"), str(build.CSRC / "fps.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return res.stdout + res.stderr


def sync_floor_library() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "sync_floor.cu"
    src.write_text(SYNC_FLOOR_CU)
    lib = OUT / "libsync_floor.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.probe_sync_floor.argtypes = (ctypes.c_void_p, ctypes.c_void_p) + (
        ctypes.c_int,) * 6 + (ctypes.c_void_p,)
    dll.probe_sync_floor.restype = ctypes.c_int
    return dll


def fps_at(xyz, start, npoint, geometry):
    """The FPS kernel at an explicit geometry (the wrapper takes
    ``kernels.fps_geometry``'s)."""
    B, N, _ = xyz.shape
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    kernels._launch("fps", "tumseg_fps", xyz.device, xyz.data_ptr(),
                    start.data_ptr(), out.data_ptr(), B, N, npoint,
                    *geometry)
    return out


def lattice(rng, b, n, device):
    """[b, n, 3] points of a 6 x 6 x 6 integer lattice, drawn with
    repeats: exact distances and ties everywhere."""
    pts = rng.integers(0, 6, (b, n, 3)).astype(np.float32)
    return torch.as_tensor(pts, device=device)


def stages(dev) -> None:
    """The FPS wrapper at sa1-sa4 of a B=32 x 4096 forward on facade
    blocks, each stage's input the previous stage's centroids."""
    from chip_smoke import SA, device_ms, facade_blocks, time_ms

    xyz = torch.as_tensor(facade_blocks(np.random.default_rng(0), 32, 4096),
                          device=dev)
    total = [0.0, 0.0]
    for npoint, _ in SA:
        got = kernels.farthest_point_sample(xyz, npoint)
        if not torch.equal(got, core.farthest_point_sample(xyz, npoint)):
            raise AssertionError(f"fps N={xyz.shape[1]} differs from the "
                                 "plain version")
        ms, runs = time_ms(torch, lambda: kernels.farthest_point_sample(
            xyz, npoint), 20)
        dms = device_ms(torch, lambda: kernels.farthest_point_sample(
            xyz, npoint), 20)
        total = [total[0] + ms, None if dms is None or total[1] is None
                 else total[1] + dms]
        print(f"[stages] N={xyz.shape[1]} npoint={npoint}: event {ms:.4f} ms "
              f"{[round(r, 4) for r in runs]}, device "
              f"{'not measured' if dms is None else f'{dms:.4f} ms'}; a step "
              f"{ms * 1e3 / npoint:.4f} us event"
              + ("" if dms is None else f", {dms * 1e3 / npoint:.4f} us "
                 "device"))
        xyz = core.gather_rows(xyz, got).contiguous()
    print(f"[stages] sa1-sa4: event {total[0]:.4f} ms, device "
          + ("not measured" if total[1] is None else f"{total[1]:.4f} ms"))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("fps_probe needs a CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    if "--stages" in sys.argv[1:]:
        stages(dev)
        return 0
    from chip_smoke import device_ms, facade_blocks, time_ms

    result = {"card": smi, "sync_floor": [], "fps": []}
    report = ptxas_report()
    print("[ptxas]\n" + "\n".join(
        line for line in report.splitlines()
        if "registers" in line or "spill" in line or "Compiling" in line))
    build.library()

    rng = np.random.default_rng(0)
    xyz32 = torch.as_tensor(facade_blocks(rng, 32, 4096), device=dev)
    floor = sync_floor_library()
    stream = torch.cuda.current_stream().cuda_stream
    steps = 1024
    out = torch.empty((32, steps), dtype=torch.int32, device=dev)
    for threads, cluster, mode in SYNC_FLOOR:
        def run():
            err = floor.probe_sync_floor(xyz32.data_ptr(), out.data_ptr(),
                                         32, 4096, steps, threads, cluster,
                                         mode, stream)
            if err:
                raise RuntimeError(f"sync floor launch failed: {err}")
        ms, runs = time_ms(torch, run, 10)
        us = ms * 1e3 / steps
        print(f"[floor] threads {threads:4d} cluster {cluster} "
              f"({FLOOR_MODES[mode]}): {us:.4f} us a step "
              f"{[round(r, 4) for r in runs]}")
        result["sync_floor"].append(dict(threads=threads, cluster=cluster,
                                         exchange=FLOOR_MODES[mode],
                                         us_per_step=us, ms=ms, runs=runs))

    inputs = {32: [xyz32], 16: [xyz32[:16].contiguous()]}
    for N, npoint, B in STAGES:
        xyz = inputs[B][-1]
        if xyz.shape[1] != N:
            raise AssertionError("stages out of order")
        zero = torch.zeros(B, dtype=torch.int32, device=dev)
        want = core.farthest_point_sample(xyz, npoint)
        ties = lattice(rng, B, N, dev)
        want_ties = core.farthest_point_sample(ties, npoint)
        chosen = kernels.fps_geometry(N)
        for geometry in CANDIDATES[N]:
            got = fps_at(xyz, zero, npoint, geometry)
            if not (torch.equal(got, want) and torch.equal(
                    fps_at(ties, zero, npoint, geometry), want_ties)):
                raise AssertionError(f"fps N={N} B={B} {geometry} differs "
                                     "from the plain version")
            ms, runs = time_ms(torch, lambda: fps_at(xyz, zero, npoint,
                                                     geometry), 20)
            dms = device_ms(torch, lambda: fps_at(xyz, zero, npoint,
                                                  geometry), 20)
            mark = " <- fps_geometry" if tuple(geometry) == chosen else ""
            dev_us = "not measured" if dms is None else \
                f"{dms * 1e3 / npoint:.4f} us"
            print(f"[fps] B={B} N={N} npoint={npoint} threads x points "
                  f"{geometry}: event {ms:.4f} ms "
                  f"{[round(r, 4) for r in runs]}, device "
                  f"{'not measured' if dms is None else f'{dms:.4f} ms'}; "
                  f"a step {ms * 1e3 / npoint:.4f} us event, {dev_us} "
                  f"device{mark}")
            result["fps"].append(dict(B=B, N=N, npoint=npoint,
                                      geometry=list(geometry), ms=ms,
                                      runs=runs, device_ms=dms,
                                      chosen=bool(mark)))
        inputs[B].append(core.gather_rows(xyz, want).contiguous())

    args = sys.argv[1:]
    dump = Path(args[args.index("--out") + 1]) if "--out" in args else OUT
    dump.mkdir(parents=True, exist_ok=True)
    (dump / "fps_probe.json").write_text(json.dumps(result, indent=1))
    (dump / "fps_probe_ptxas.txt").write_text(report)
    sass = subprocess.run([str(Path(build._nvcc()).with_name("cuobjdump")),
                           "-sass", str(OUT / "fps.o")], capture_output=True,
                          text=True)
    (dump / "fps_probe_sass.txt").write_text(sass.stdout + sass.stderr)
    print("fps_probe: ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
