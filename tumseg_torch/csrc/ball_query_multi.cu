// Multi-radius ball query: xyz [B, N, 3], new_xyz [B, S, 3] f32 -> one
// [B, S, K_r] i32 output per radius r, all in one launch.
//
// Replaces _ballquery_kernel_bp_multi (tumseg/ops/pallas/ballquery.py:293,
// with its per-radius _bp_pack_and_peel, :198), the MSG layer's query: the
// same (xyz, new_xyz) pair asked once per radius. Each output keeps the
// single-radius contract of ball_query.cu: the first K_r indices in ascending
// order with squared distance <= r^2, a shortfall repeating the first hit,
// an empty ball giving N in every slot.
//
// What bounds it: distance evaluations, B*S*N in the worst case, since a
// query stops only when every radius holds its K_r hits. At MSG sa1
// (r = 0.05, K = 16 over 4096 facade points) the small ball rarely fills, so
// most queries scan all 4096 candidates. The design does what the TPU kernel
// does about it: one distance per candidate, computed once and shared by all
// radii (the TPU kernel builds the [N, S_t] distance tile once and packs one
// mask per radius). As in ball_query.cu, one warp per query walks the
// candidates 32 at a time in index order; per radius one __ballot_sync and
// one __popc compaction append the hits to the next free output slots, so
// each output is in index order without a sort or peel. Each radius keeps
// its own count and first hit; a radius that is full casts no more ballots,
// and the radii need not be sorted.
#include "common.cuh"

namespace tumseg {

constexpr int kMaxRadii = 4;

// Passed by value as a kernel parameter: R radii, r^2 rounded to f32, K and
// the output of each. The wrapper's ctypes structure has the same layout.
struct MultiRadii {
  int R;
  float r2[kMaxRadii];
  int K[kMaxRadii];
  int* out[kMaxRadii];
};

}  // namespace tumseg

namespace {

using tumseg::kMaxRadii;
using tumseg::MultiRadii;

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ball_query_multi_kernel(const float* __restrict__ xyz,
                        const float* __restrict__ new_xyz, int N,
                        int total_queries, int S, const MultiRadii radii) {
  const int query = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (query >= total_queries) return;  // uniform across the warp
  const int b = query / S;
  const float qx = new_xyz[3 * static_cast<size_t>(query)];
  const float qy = new_xyz[3 * static_cast<size_t>(query) + 1];
  const float qz = new_xyz[3 * static_cast<size_t>(query) + 2];
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  const unsigned below = (1u << lane) - 1u;

  // counts are warp-uniform (each lane adds the same __popc), so the
  // branches on them below never split the warp
  int count[kMaxRadii];
  int first[kMaxRadii];
#pragma unroll
  for (int r = 0; r < kMaxRadii; ++r) {
    count[r] = 0;
    first[r] = N;
  }
  bool open = true;
  for (int base = 0; base < N && open; base += 32) {
    const int j = base + lane;
    float d = 0.0f;
    if (j < N) d = tumseg::sqdist(p[3 * j], p[3 * j + 1], p[3 * j + 2],
                                  qx, qy, qz);
    open = false;
#pragma unroll
    for (int r = 0; r < kMaxRadii; ++r) {
      if (r >= radii.R || count[r] >= radii.K[r]) continue;
      const bool hit = j < N && d <= radii.r2[r];
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (mask != 0u) {
        if (count[r] == 0) first[r] = base + __ffs(mask) - 1;
        const int pos = count[r] + __popc(mask & below);
        if (hit && pos < radii.K[r]) {
          radii.out[r][static_cast<size_t>(query) * radii.K[r] + pos] = j;
        }
        count[r] += __popc(mask);
      }
      open = open || count[r] < radii.K[r];
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxRadii; ++r) {
    if (r >= radii.R) continue;
    const int K = radii.K[r];
    int* o = radii.out[r] + static_cast<size_t>(query) * K;
    const int fill = count[r] == 0 ? N : first[r];
    for (int k = (count[r] < K ? count[r] : K) + lane; k < K; k += 32) {
      o[k] = fill;
    }
  }
}

}  // namespace

// `radii` points to a host MultiRadii, copied into the launch's parameters.
TUMSEG_API int tumseg_ball_query_multi(const float* xyz, const float* new_xyz,
                                       const tumseg::MultiRadii* radii, int B,
                                       int N, int S, void* stream) {
  const int total = B * S;
  if (total == 0) return 0;
  if (radii->R < 1 || radii->R > tumseg::kMaxRadii) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ball_query_multi_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, N, total, S, *radii);
  return tumseg::last_error();
}
