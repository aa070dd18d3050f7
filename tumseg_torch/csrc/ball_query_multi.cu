// Multi-radius ball query: xyz [B, N, 3], new_xyz [B, S, 3] f32 -> one
// [B, S, K_r] i32 output per radius r (1 to 4 radii, in any order), all in
// one launch.
//
// Replaces _ballquery_kernel_bp_multi (tumseg/ops/pallas/ballquery.py:293,
// with its per-radius _bp_pack_and_peel, :198), the MSG layer's query: the
// same (xyz, new_xyz) pair asked once per radius. Each output keeps the
// single-radius contract of ball_query.cu. As the TPU kernel builds its
// distance tile once and packs one mask per radius, ball_query.cuh computes
// one distance a candidate, within the largest radius still short of its K,
// and keeps one mask per radius; each radius keeps its own count and first
// hit.
#include "ball_query.cuh"

// `radii` points to a host MultiRadii, copied into the launch's parameters.
// Geometry as tumseg_ball_query's.
TUMSEG_API int tumseg_ball_query_multi(const float* xyz, const float* new_xyz,
                                       const tumseg::MultiRadii* radii, int B,
                                       int N, int S, int Q, int L,
                                       int tile, int walk, void* stream) {
  return launch_ball_query<tumseg::kMaxRadii>(xyz, new_xyz, *radii, B, N, S,
                                              Q, L, tile, walk, stream);
}
