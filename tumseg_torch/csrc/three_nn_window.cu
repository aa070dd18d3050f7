// 3-NN in the expansion form fused with the inverse-distance interpolation
// that consumes it: xyz1 [B, N, 3], xyz2 [B, S, 3], points2 [B, S, D] f32 ->
//   dists [B, N, 3] f32, idx [B, N, 3] i32, out [B, N, D] f32.
//
// Replaces both Pallas kernels of tumseg's windowed path:
//   tumseg/ops/pallas/threenn.py:_threenn_window_kernel (a z-window scan in
//     the expansion form, ties to the lower ORIGINAL index, with the
//     post-hoc exactness guard of _three_nn_windowed_impl and its lax.cond
//     fallback, threenn.py:320-350);
//   tumseg/ops/pallas/threenn.py:_threenn_kernel (the full expansion-form
//     row kernel, the guard's fallback).
// Windowed or not, the answer is the full row's: a query that passes the
// guard has no source outside its window at or below its third distance,
// and a pair's distance is the same arithmetic inside and outside the
// window, so its windowed three are the full kernel's; a query that fails
// takes the full kernel. So this is one kernel with no window: the z-slab
// search and interpolation tail of three_nn.cuh in the expansion form,
// (qsq + ssq) - 2*cross, each of qsq, ssq and cross summed as (x + y) + z,
// not clamped at 0 (tumseg_torch/ops/core.py: three_nn_expansion, to which
// the windowed plain version is equal bit for bit). three_nn.cuh derives
// the slack that keeps its walk exact in this form. The wrapper does no
// sort, search or reduction: one launch, nothing before it.
//
// Bound at fp1 (B=32, N=4096, S=1024, D=128): bytes, as for
// three_nn_interpolate.cu: points2 [32, 1024, 128] read and out
// [32, 4096, 128] written, ~89 MB, 0.027 ms at 3.35 TB/s; the search tests
// a few dozen candidates a query (~13 operations each), far below it.
#include "three_nn.cuh"

// Geometry (Q, R) as tumseg_three_nn_interpolate's
// (kernels.three_nn_geometry).
TUMSEG_API int tumseg_three_nn_window(
    const float* xyz1, const float* xyz2, const float* points2, float* dists,
    int* idx, float* out, int B, int N, int S, int D, int Q, int R, int fast,
    void* stream) {
  return launch_three_nn<ExpansionForm>(xyz1, xyz2, points2, dists, idx, out,
                                        B, N, S, D, Q, R, fast, stream);
}
