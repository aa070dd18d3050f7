// Farthest point sampling: xyz [B, N, 3] f32, start [B] i32 -> [B, npoint] i32.
//
// Replaces tumseg/ops/pallas/fps.py:_fps_kernel. Same iteration as
// tumseg/ops/core.py:farthest_point_sample: the min-distance field starts at
// 1e10; step i records the current centroid, folds in its squared distances
// with fminf and moves to the first index of the largest remaining distance.
//
// What bounds it: npoint dependent steps (1360 over sa1-sa4), each a pass
// over the row's N points and an argmax over the row. A step's work is small
// (4096 distances at sa1), so the latency of a step bounds the kernel, not
// bytes or operations: the issue slots of the distance pass, then the
// synchronisation that ends it.
//
// Design, one CTA per batch row (kernels.fps_geometry picks its T threads
// and P points a thread for each N):
// - thread t owns points j * T + t, j < P; their coordinates and running
//   minimum live in registers (for N above 8192, at P = 16 with more than
//   512 threads, the coordinates stay in shared memory and only the minima
//   in registers). The CTA also keeps the row's coordinates in shared
//   memory, 12 B a point, only to look up the next centroid. Points past N
//   are zeros at distance +0: they lose to every real point, and to a real
//   +0 by their larger index;
// - the argmax runs in hardware: distances are >= +0, so their bit patterns
//   order as unsigned ints. __reduce_max_sync gives a warp's maximum and
//   __reduce_min_sync over the lanes that hold it the first index; within a
//   thread, a strict > over its ascending indices keeps the first;
// - one barrier a step: each warp writes its (maximum, index) to its slot of
//   a buffer that alternates with the step's parity, and after one barrier
//   every warp reduces all the slots itself, so no second barrier
//   broadcasts the winner. A row of one warp has no barrier at all.
// A row is not split over a cluster of CTAs: exchanging a step's winners
// between SMs (barrier.cluster, or stamped slots in distributed shared
// memory) costs 0.53-0.79 us a step on the H100, more than a whole step of
// one CTA (tumseg_torch/tools/fps_probe.py measures both).
#include "common.cuh"

namespace {

constexpr int kMaxSlots = 32;  // warps of a CTA
constexpr size_t kSlotBytes = 2 * kMaxSlots * sizeof(uint2);

// -> (the largest v over the warp, the least i among the lanes holding it)
__device__ __forceinline__ uint2 warp_argmax(unsigned v, unsigned i) {
  const unsigned m = __reduce_max_sync(0xffffffffu, v);
  return make_uint2(m, __reduce_min_sync(0xffffffffu, v == m ? i : ~0u));
}

// threads of a CTA that keeps its P points' coordinates in registers: at
// P = 8, a bound of 512 threads (128 registers) ran sa1 5% faster than one
// of 1024 (tumseg_torch/tools/fps_probe.py)
template <int P>
constexpr int max_threads() {
  return P <= 4 ? 1024 : 512;
}

template <int P, bool kShared>
__global__ void __launch_bounds__(kShared ? 1024 : max_threads<P>())
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int* __restrict__ out, int N, int npoint) {
  extern __shared__ float smem[];
  __shared__ uint2 slots[2][kMaxSlots];

  const int T = blockDim.x;
  const int L = P * T;  // points the row holds: N, then padding
  float* sx = smem;
  float* sy = sx + L;
  float* sz = sy + L;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int nslots = T >> 5;

  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  for (int i = t; i < L; i += T) {
    const bool real = i < N;
    sx[i] = real ? p[3 * i] : 0.0f;
    sy[i] = real ? p[3 * i + 1] : 0.0f;
    sz[i] = real ? p[3 * i + 2] : 0.0f;
  }
  __syncthreads();
  float px[kShared ? 1 : P], py[kShared ? 1 : P], pz[kShared ? 1 : P];
  float pd[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if constexpr (!kShared) {
      px[j] = sx[j * T + t];
      py[j] = sy[j * T + t];
      pz[j] = sz[j * T + t];
    }
    pd[j] = j * T + t < N ? 1e10f : 0.0f;
  }
  int far = start[b];
  int* o = out + static_cast<size_t>(b) * npoint;
  uint2* const put = &slots[0][t >> 5];  // + kMaxSlots on odd steps
  const uint2* const get = &slots[0][lane];

  for (int it = 0; it < npoint; ++it) {
    if (t == 0) o[it] = far;
    if (it + 1 == npoint) break;
    const float cx = sx[far], cy = sy[far], cz = sz[far];
    float best = 0.0f;
    int bj = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float x, y, z;
      if constexpr (kShared) {
        x = sx[j * T + t];
        y = sy[j * T + t];
        z = sz[j * T + t];
      } else {
        x = px[j];
        y = py[j];
        z = pz[j];
      }
      const float m = fminf(pd[j], tumseg::sqdist(x, y, z, cx, cy, cz));
      pd[j] = m;
      if (j == 0 || m > best) {
        best = m;
        bj = j;
      }
    }
    uint2 w = warp_argmax(__float_as_uint(best),
                          static_cast<unsigned>(bj * T + t));
    if (nslots > 1) {
      const int parity = (it & 1) * kMaxSlots;
      if (lane == 0) put[parity] = w;
      __syncthreads();
      const uint2 s = lane < nslots ? get[parity] : make_uint2(0u, ~0u);
      w = warp_argmax(s.x, s.y);
    }
    far = static_cast<int>(w.y);
  }
}

template <int P, bool kShared>
int launch(const float* xyz, const int* start, int* out, int B, int N,
           int npoint, int threads, cudaStream_t stream) {
  if (threads > (kShared ? 1024 : max_threads<P>()))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 3 * sizeof(float) * P * static_cast<size_t>(threads);
  // above 48 KB, static slots included, only after opting in
  if (smem + kSlotBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<P, kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return tumseg::last_error();
  }
  fps_kernel<P, kShared><<<B, threads, smem, stream>>>(xyz, start, out, N,
                                                       npoint);
  return tumseg::last_error();
}

}  // namespace

// threads: the CTA's, a multiple of 32, at most kMaxSlots warps; points: P,
// each thread's; threads * points >= N. Any other geometry returns
// cudaErrorInvalidValue.
TUMSEG_API int tumseg_fps(const float* xyz, const int* start, int* out,
                          int B, int N, int npoint, int threads, int points,
                          void* stream) {
  if (B == 0 || npoint == 0) return 0;
  if (threads < 32 || threads % 32 != 0 || threads > 32 * kMaxSlots ||
      static_cast<long long>(threads) * points < N)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define TUMSEG_FPS(P, SHARED) \
  launch<P, SHARED>(xyz, start, out, B, N, npoint, threads, s)
  switch (points) {
    case 1: return TUMSEG_FPS(1, false);
    case 2: return TUMSEG_FPS(2, false);
    case 4: return TUMSEG_FPS(4, false);
    case 8: return TUMSEG_FPS(8, false);
    case 16:
      return threads > max_threads<16>() ? TUMSEG_FPS(16, true)
                                          : TUMSEG_FPS(16, false);
  }
#undef TUMSEG_FPS
  return static_cast<int>(cudaErrorInvalidValue);
}
