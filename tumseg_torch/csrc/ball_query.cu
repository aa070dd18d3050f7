// Fixed-K ball query: xyz [B, N, 3], new_xyz [B, S, 3] f32 -> [B, S, K] i32.
//
// Replaces the whole ball-query family of tumseg/ops/pallas/ballquery.py:
// _ballquery_kernel, _ballquery_kernel_t, _ballquery_kernel_bp (with
// _bp_pack_and_peel) and _ballquery_window_kernel(_t). Those variants differ
// only in TPU layout (row, transposed, bit-packed, z-windowed); all compute
// the first K indices, in ascending order, whose squared distance is <= r^2;
// a shortfall repeats the first hit and an empty ball gives N in every slot.
//
// What bounds it: reading candidates. A query stops once it holds K hits,
// so it reads only as far as its K-th neighbour's index; the row's
// coordinates (48 KB at N=4096) stay in L1/L2 for the queries of that row.
// Design: one warp per query scans candidates 32 at a time in index order,
// tests membership with the direct distance form, and compacts the hits with
// __ballot_sync/__popc into the next free output slots, so the output is in
// index order without any sort or peel.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ new_xyz, int* __restrict__ out,
                  int N, int total_queries, int S, int K, float r2) {
  const int query = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (query >= total_queries) return;  // uniform across the warp
  const int b = query / S;
  const float qx = new_xyz[3 * static_cast<size_t>(query)];
  const float qy = new_xyz[3 * static_cast<size_t>(query) + 1];
  const float qz = new_xyz[3 * static_cast<size_t>(query) + 2];
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  int* o = out + static_cast<size_t>(query) * K;

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
}

}  // namespace

TUMSEG_API int tumseg_ball_query(const float* xyz, const float* new_xyz,
                                 int* out, int B, int N, int S, int K,
                                 float r2, void* stream) {
  const int total = B * S;
  if (total == 0 || K == 0) return 0;
  const int blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ball_query_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, out, N, total, S, K, r2);
  return tumseg::last_error();
}
