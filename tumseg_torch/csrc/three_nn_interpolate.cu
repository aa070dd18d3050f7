// 3-NN search fused with the inverse-distance interpolation that consumes it:
// xyz1 [B, N, 3], xyz2 [B, S, 3], points2 [B, S, D] f32 ->
//   dists [B, N, 3] f32, idx [B, N, 3] i32, out [B, N, D] f32.
//
// Replaces tumseg/ops/pallas/threenn.py:_threenn_kernel_t (3-NN, direct
// distances, ties to the lower index) and
// tumseg/ops/pallas/interpolate.py:_interp_fwd_kernel (one-hot weight matrix
// contracted on the MXU) in one pass. Weights follow
// tumseg/ops/__init__.py:323-324: r = 1/(d + 1e-8), w = r / ((r0 + r1) + r2);
// out = (w0*p[i0] + w1*p[i1]) + w2*p[i2]. Divisions are IEEE (no fast math).
//
// What bounds it: the search is N*S distance evaluations (fp1: 134M at B=32),
// the interpolation B*N*D gathered reads and stores (fp1: 16.8M). Neither
// needs the [N, S] weight matrix the TPU kernel builds.
// Design: a block owns 256 queries of one batch row, one thread per query.
// Sources stream through shared memory in tiles of 256 and each thread keeps
// its best three by insertion with strict '<' in index order, so an equal
// distance never displaces a lower index. The block then writes its
// [256, D] output tile through the interpolation tail of common.cuh, which
// the z-window 3-NN kernel (three_nn_window.cu) shares.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
three_nn_interpolate_kernel(const float* __restrict__ xyz1,
                            const float* __restrict__ xyz2,
                            const float* __restrict__ points2,
                            float* __restrict__ dists, int* __restrict__ idx,
                            float* __restrict__ out, int N, int S, int D) {
  __shared__ float sx[kThreads], sy[kThreads], sz[kThreads];
  __shared__ tumseg::NeighbourTile<kThreads> tile;

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kThreads;
  const int n = n0 + threadIdx.x;
  const bool valid = n < N;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (valid) {
    const float* q = xyz1 + (static_cast<size_t>(b) * N + n) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }

  float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY;
  int i0 = 0, i1 = 0, i2 = 0;
  const float* src = xyz2 + static_cast<size_t>(b) * S * 3;
  for (int base = 0; base < S; base += kThreads) {
    const int j = base + threadIdx.x;
    if (j < S) {
      sx[threadIdx.x] = src[3 * j];
      sy[threadIdx.x] = src[3 * j + 1];
      sz[threadIdx.x] = src[3 * j + 2];
    }
    __syncthreads();
    const int m = S - base < kThreads ? S - base : kThreads;
    for (int t = 0; t < m; ++t) {
      const float d = tumseg::sqdist(sx[t], sy[t], sz[t], qx, qy, qz);
      const int jt = base + t;
      if (d < d0) {
        d2 = d1; i2 = i1;
        d1 = d0; i1 = i0;
        d0 = d;  i0 = jt;
      } else if (d < d1) {
        d2 = d1; i2 = i1;
        d1 = d;  i1 = jt;
      } else if (d < d2) {
        d2 = d;  i2 = jt;
      }
    }
    __syncthreads();
  }

  const int nq = N - n0 < kThreads ? N - n0 : kThreads;
  tumseg::three_nn_interpolate_tail<kThreads>(
      tile, valid, static_cast<long long>(b) * N + n, d0, d1, d2, i0, i1, i2,
      points2 + static_cast<size_t>(b) * S * D, dists, idx, out, nq, D);
}

}  // namespace

TUMSEG_API int tumseg_three_nn_interpolate(const float* xyz1,
                                           const float* xyz2,
                                           const float* points2, float* dists,
                                           int* idx, float* out, int B, int N,
                                           int S, int D, void* stream) {
  if (B == 0 || N == 0) return 0;
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  three_nn_interpolate_kernel<<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      xyz1, xyz2, points2, dists, idx, out, N, S, D);
  return tumseg::last_error();
}
