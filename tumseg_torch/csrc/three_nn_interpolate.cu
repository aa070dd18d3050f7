// 3-NN search fused with the inverse-distance interpolation that consumes it,
// direct-form distances: xyz1 [B, N, 3], xyz2 [B, S, 3], points2 [B, S, D]
// f32 -> dists [B, N, 3] f32, idx [B, N, 3] i32, out [B, N, D] f32.
//
// Replaces tumseg/ops/pallas/threenn.py:_threenn_kernel_t (3-NN, direct
// distances (dx*dx + dy*dy) + dz*dz, ties to the lower index) and
// tumseg/ops/pallas/interpolate.py:_interp_fwd_kernel (one-hot weight matrix
// contracted on the MXU) in one pass. The kernel, its bound and its design
// (z-slab search, interpolation tail, fast mode) are three_nn.cuh's, here in
// the direct form; three_nn_window.cu launches the expansion form.
#include "three_nn.cuh"

// Q queries a block (one a thread), R lanes a row in the interpolation: see
// kernels.three_nn_geometry. Returns cudaErrorInvalidValue for a geometry
// the kernel cannot run.
TUMSEG_API int tumseg_three_nn_interpolate(
    const float* xyz1, const float* xyz2, const float* points2, float* dists,
    int* idx, float* out, int B, int N, int S, int D, int Q, int R, int fast,
    void* stream) {
  return launch_three_nn<DirectForm>(xyz1, xyz2, points2, dists, idx, out, B,
                                     N, S, D, Q, R, fast, stream);
}
