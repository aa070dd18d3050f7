// Ball query and neighbourhood grouping in one pass:
// xyz [B, N, 3], new_xyz [B, S, 3], src [B, N, C] f32 (xyz first) ->
//   grouped [B, S, K, C] (f32, or bf16 in the fast mode), idx [B, S, K] i32,
// where idx is ball_query.cu's answer (the first K candidates in index order
// with (dx*dx + dy*dy) + dz*dz <= r2, a shortfall repeating the first pick,
// an empty ball N in every slot) and grouped is group.cu's answer for that
// idx (the sentinel N reads a zero row, so an empty ball's row is -centre),
// both bit for bit.
//
// Replaces tumseg/ops/pallas/fusedgroup.py:_fused_kernel and
// _fused_gridk_kernel, which differ only in how Mosaic was made to compile
// them (the k loop unrolled, or one k a grid step). On the MXU they turn the
// first-K selection into a cumsum by triangular matmuls whose equality with
// k+1 is the gather's one-hot; that trick has no job on this card. Here one
// warp selects its centroid's K candidates with a ballot, as ball_query.cu
// does, and then writes the K x C rows itself, so the index never makes a
// round trip through device memory before the gather.
//
// What bounds it at sa1 of the B=32 x 4096 forward (S=1024, K=32, C=9,
// r=0.1), the larger of two times. Bytes: at least B*S*K*C output
// elements at 4 bytes (37.7 MB; 2 bytes, 18.9 MB, in the fast mode),
// B*S*K*4 bytes of idx (4.2 MB) and one read of xyz, new_xyz and src
// (6.7 MB): 48.6 MB, 0.0145 ms at 3.35 TB/s (29.8 MB, 0.0089 ms fast).
// Operations: 9 a candidate (8 for the distance, one compare), up to
// B*S*N = 134M candidates before the early exit; on facade blocks few sa1
// balls fill K, so nearly all are tested: 1.21 Gop, 0.018 ms at
// 67 TFLOP/s. So the stage is operations-bound, at ~0.018 ms.
// The split path runs ball_query.cu then group.cu at the same stage; over
// all four stages of one forward they take 0.3079 and 0.4006 ms (PERF.md,
// NVIDIA H100 80GB HBM3, 700 W).
// Design: one warp per centroid scans candidates 32 at a time and
// compacts hits with __ballot_sync/__popc into the next free slots, stopping
// once K are held; the slots go to idx, and after __syncwarp (which orders
// the warp's global stores for its own lanes) the warp reads them back and
// writes the centroid's K*C outputs with lanes over (k, c), c fastest, so
// stores coalesce. Each value goes through common.cuh's store_grouped, the
// same code as group.cu's.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_ball_group_kernel(const float* __restrict__ xyz,
                        const float* __restrict__ new_xyz,
                        const float* __restrict__ src, T* __restrict__ out,
                        int* idx, int N, int total_queries, int S, int K,
                        int C, float r2) {
  const int query = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (query >= total_queries) return;  // uniform across the warp
  const int b = query / S;
  const float qx = new_xyz[3 * static_cast<size_t>(query)];
  const float qy = new_xyz[3 * static_cast<size_t>(query) + 1];
  const float qz = new_xyz[3 * static_cast<size_t>(query) + 2];
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  int* o = idx + static_cast<size_t>(query) * K;

  int count = 0;
  int first = N;
  for (int base = 0; base < N && count < K; base += 32) {
    const int j = base + lane;
    bool hit = false;
    if (j < N) {
      hit = tumseg::sqdist(p[3 * j], p[3 * j + 1], p[3 * j + 2],
                           qx, qy, qz) <= r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask != 0u) {
      if (count == 0) first = base + __ffs(mask) - 1;
      const int pos = count + __popc(mask & ((1u << lane) - 1u));
      if (hit && pos < K) o[pos] = j;
      count += __popc(mask);
    }
  }
  const int fill = count == 0 ? N : first;
  for (int k = (count < K ? count : K) + lane; k < K; k += 32) o[k] = fill;
  __syncwarp();

  const float* rows = src + static_cast<size_t>(b) * N * C;
  T* g = out + static_cast<size_t>(query) * K * C;
  for (int t = lane; t < K * C; t += 32) {
    const int k = t / C;
    const int c = t - k * C;
    const int n = o[k];
    const float v = n < N ? rows[static_cast<size_t>(n) * C + c] : 0.0f;
    const float centre = c == 0 ? qx : c == 1 ? qy : c == 2 ? qz : 0.0f;
    tumseg::store_grouped(g + t, v, centre);
  }
}

template <typename T>
int launch(const float* xyz, const float* new_xyz, const float* src,
           void* out, int* idx, int N, int total, int S, int K, int C,
           float r2, cudaStream_t stream) {
  const int blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_ball_group_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      xyz, new_xyz, src, static_cast<T*>(out), idx, N, total, S, K, C, r2);
  return tumseg::last_error();
}

}  // namespace

// out is f32, or bf16 when fast != 0.
TUMSEG_API int tumseg_fused_ball_group(const float* xyz, const float* new_xyz,
                                       const float* src, void* out, int* idx,
                                       int B, int N, int S, int K, int C,
                                       float r2, int fast, void* stream) {
  const int total = B * S;
  if (total == 0 || K == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch<__nv_bfloat16>(xyz, new_xyz, src, out, idx, N, total,
                                      S, K, C, r2, s)
              : launch<float>(xyz, new_xyz, src, out, idx, N, total, S, K, C,
                              r2, s);
}
