// Fixed-K ball query, one radius: xyz [B, N, 3], new_xyz [B, S, 3] f32 ->
// [B, S, K] i32, the first K indices in ascending order whose squared
// distance is <= r^2, a shortfall repeating the first hit, an empty ball N
// in every slot.
//
// Replaces the whole ball-query family of tumseg/ops/pallas/ballquery.py:
// _ballquery_kernel, _ballquery_kernel_t, _ballquery_kernel_bp (with
// _bp_pack_and_peel) and _ballquery_window_kernel(_t). Those variants differ
// only in TPU layout (row, transposed, bit-packed, z-windowed); all compute
// this function. The kernel, its bound and its design are ball_query.cuh's,
// here with one radius.
#include "ball_query.cuh"

// Geometry (Q queries a block, L lanes a query, tiles of `tile` sources,
// walked or scanned) from kernels.ball_query_geometry.
TUMSEG_API int tumseg_ball_query(const float* xyz, const float* new_xyz,
                                 int* out, int B, int N, int S, int K,
                                 float r2, int Q, int L, int tile,
                                 int walk,
                                 void* stream) {
  tumseg::MultiRadii radii = {};
  radii.R = 1;
  radii.r2[0] = r2;
  radii.K[0] = K;
  radii.out[0] = out;
  return launch_ball_query<1>(xyz, new_xyz, radii, B, N, S, Q, L, tile,
                              walk, stream);
}
