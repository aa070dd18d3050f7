// Farthest point sampling: xyz [B, N, 3] f32, start [B] i32 -> [B, npoint] i32.
//
// Replaces tumseg/ops/pallas/fps.py:_fps_kernel. Same iteration as
// tumseg/ops/core.py:farthest_point_sample: the min-distance field starts at
// 1e10; step i records the current centroid, folds in its squared distances
// and moves to the first index of the largest remaining distance.
//
// What bounds it: npoint dependent steps, each a pass over N points and a
// block-wide argmax. It is latency-bound, not bandwidth-bound: at sa1
// (N=4096, npoint=1024) a step touches 64 KB that never leave the SM.
// Design: one block per batch row. The row's coordinates and its distance
// field live in dynamic shared memory (16*N bytes: 64 KB at N=4096, above the
// 48 KB static limit, so the launcher opts in). Each step reduces
// (value, index) pairs with warp shuffles and one cross-warp pass, ties to
// the lower index, and broadcasts the winner through shared memory.
// B blocks fill only B of the card's SMs (32 of 132 at B=32); splitting a row
// over a cluster is later work.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void argmax_step(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    argmax_step(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int* __restrict__ out, int N, int npoint) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + N;
  float* sz = sy + N;
  float* sd = sz + N;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_far;

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    sx[i] = p[3 * i];
    sy[i] = p[3 * i + 1];
    sz[i] = p[3 * i + 2];
    sd[i] = 1e10f;
  }
  int far = start[b];
  int* o = out + static_cast<size_t>(b) * npoint;
  __syncthreads();

  for (int it = 0; it < npoint; ++it) {
    if (threadIdx.x == 0) o[it] = far;
    if (it + 1 == npoint) break;
    const float cx = sx[far], cy = sy[far], cz = sz[far];
    // distances are >= 0, so -1 loses to every real point
    float best = -1.0f;
    int besti = N;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const float m = fminf(sd[i], tumseg::sqdist(sx[i], sy[i], sz[i],
                                                  cx, cy, cz));
      sd[i] = m;
      if (m > best) {  // i ascends within a thread: strict > keeps the first
        best = m;
        besti = i;
      }
    }
    warp_argmax(best, besti);
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = besti;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? red_v[lane] : -1.0f;
      besti = lane < nwarps ? red_i[lane] : N;
      warp_argmax(best, besti);
      if (lane == 0) s_far = besti;
    }
    __syncthreads();
    far = s_far;
  }
}

}  // namespace

TUMSEG_API int tumseg_fps(const float* xyz, const int* start, int* out,
                          int B, int N, int npoint, void* stream) {
  if (B == 0 || npoint == 0) return 0;
  const size_t smem = 4 * sizeof(float) * static_cast<size_t>(N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = (N + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  fps_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, start, out, N, npoint);
  return tumseg::last_error();
}
