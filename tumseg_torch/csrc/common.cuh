// Shared by the point-op kernels of tumseg_torch.
//
// Every kernel sits behind a plain C launcher (no PyTorch headers, so nvcc
// builds the whole library in seconds) that launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError(): a refused launch
// never runs, and only this return value reports it. The Python wrappers in
// tumseg_torch/ops/kernels.py check shapes, types and contiguity before the
// call and raise on a nonzero return.
//
// The library is built with -fmad=false: distances are (dx*dx + dy*dy) +
// dz*dz with every product rounded, the form of the Pallas kernels and of the
// plain PyTorch versions in tumseg_torch/ops/core.py, so radius membership
// and neighbour order match them exactly.
#pragma once

#include <cuda_runtime.h>

#define TUMSEG_API extern "C" __attribute__((visibility("default")))

namespace tumseg {

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = ax - bx;
  const float dy = ay - by;
  const float dz = az - bz;
  return dx * dx + dy * dy + dz * dz;
}

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

// The block's neighbour table for the interpolation tail below: one row per
// thread.
template <int kThreads>
struct NeighbourTile {
  int idx[kThreads][3];
  float w[kThreads][3];
  long long row[kThreads];
};

// The tail shared by the 3-NN kernels. Each thread of the block holds one
// query's three nearest sources (d0 <= d1 <= d2, indices i0..i2); `row` is
// the query's row b*N + n in the outputs and the block's queries are its
// threads 0..nq-1. Writes dists [.., 3] and idx [.., 3] at that row, then
// the inverse-distance interpolation of the batch row's points2 `p2` [S, D]
// into out [.., D], d fastest so stores coalesce and each gathered source
// row is read contiguously. Weights follow tumseg/ops/__init__.py:323-324:
// r = 1/(d + 1e-8), w = r / ((r0 + r1) + r2); out = (w0*p[i0] + w1*p[i1]) +
// w2*p[i2], IEEE divisions. Every thread of the block must call it.
template <int kThreads>
__device__ __forceinline__ void three_nn_interpolate_tail(
    NeighbourTile<kThreads>& tile, bool valid, long long row, float d0,
    float d1, float d2, int i0, int i1, int i2, const float* __restrict__ p2,
    float* __restrict__ dists, int* __restrict__ idx, float* __restrict__ out,
    int nq, int D) {
  const float eps = static_cast<float>(1e-8);  // f32 rounding of the double
  const float r0 = 1.0f / (d0 + eps);
  const float r1 = 1.0f / (d1 + eps);
  const float r2 = 1.0f / (d2 + eps);
  const float norm = (r0 + r1) + r2;
  tile.idx[threadIdx.x][0] = i0;
  tile.idx[threadIdx.x][1] = i1;
  tile.idx[threadIdx.x][2] = i2;
  tile.w[threadIdx.x][0] = r0 / norm;
  tile.w[threadIdx.x][1] = r1 / norm;
  tile.w[threadIdx.x][2] = r2 / norm;
  tile.row[threadIdx.x] = row;
  if (valid) {
    dists[row * 3] = d0;
    dists[row * 3 + 1] = d1;
    dists[row * 3 + 2] = d2;
    idx[row * 3] = i0;
    idx[row * 3 + 1] = i1;
    idx[row * 3 + 2] = i2;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < nq * D; t += kThreads) {
    const int q = t / D;
    const int c = t - q * D;
    const float a =
        p2[static_cast<size_t>(tile.idx[q][0]) * D + c] * tile.w[q][0] +
        p2[static_cast<size_t>(tile.idx[q][1]) * D + c] * tile.w[q][1];
    out[tile.row[q] * D + c] =
        a + p2[static_cast<size_t>(tile.idx[q][2]) * D + c] * tile.w[q][2];
  }
}

}  // namespace tumseg
