// Ball query and neighbourhood grouping in one launch:
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
// k+1 is the gather's one-hot; that trick has no job on this card. Here the
// kernel is ball_query.cuh's z-slab walk with one radius and its grouping
// epilogue: each block, once its queries' idx rows are filled, writes their
// [nq, K, C] region of grouped with group.cu's store code, reading the rows
// back from L1/L2, so the idx never makes a round trip through a second
// launch.
//
// What bounds it: the ball query's and the group's, added. At sa1 of the
// B=32 x 4096 forward (S=1024, K=32, C=9, r=0.1): B*S*K*C outputs at 4 bytes
// (37.7 MB; 2 bytes, 18.9 MB, in the fast mode), the idx (4.2 MB) and one
// read of xyz, new_xyz and src (6.7 MB); 9 operations for each candidate
// the walk tests (~88 a query there, 2.9M in all), far below. Over sa1-sa4
// the grouped output is 159 MB in f32: ~0.06 ms at 3.35 TB/s, bytes-bound.
#include <stdint.h>

#include "ball_query.cuh"

// out is f32, or bf16 when fast != 0, and 16-byte aligned (torch.empty
// is). Geometry (Q, L, tile, walk) and c_magic (t / C over the epilogue's
// chunk) from kernels.fused_geometry.
TUMSEG_API int tumseg_fused_ball_group(const float* xyz, const float* new_xyz,
                                       const float* src, void* out, int* idx,
                                       int B, int N, int S, int K, int C,
                                       float r2, int Q, int L, int tile,
                                       int walk, int c_magic, int fast,
                                       void* stream) {
  if (C < 3 || !pow2(L) || L > 32 || tile < 1 || tile > kTile ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  tumseg::MultiRadii radii = {};
  radii.R = 1;
  radii.r2[0] = r2;
  radii.K[0] = K;
  radii.out[0] = idx;
  const unsigned magic = static_cast<unsigned>(c_magic);
  if (fast) {
    const GroupRows<__nv_bfloat16> epi = {
        src, static_cast<__nv_bfloat16*>(out), C, magic};
    return launch_ball_query<1>(xyz, new_xyz, radii, B, N, S, Q, L, tile,
                                walk, stream, epi);
  }
  const GroupRows<float> epi = {src, static_cast<float*>(out), C, magic};
  return launch_ball_query<1>(xyz, new_xyz, radii, B, N, S, Q, L, tile, walk,
                              stream, epi);
}
