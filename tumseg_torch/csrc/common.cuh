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
//
// The fast (single-pass bf16) modes round with __float2bfloat16_rn, round to
// nearest with ties to even, as torch's .bfloat16() and jnp's astype do.
#pragma once

#include <cuda_bf16.h>
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

// v rounded to bf16 and back: the operand of a single-pass bf16 product.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One element of a grouped tensor: the gathered source value minus the
// centre (0 on channels 3+). An f32 output stores it as it is. A bf16 output
// is the fast mode of tumseg/ops/pallas/group.py:33-48,104-107: the source is
// rounded to bf16 (its one-hot contraction is then exact), the centre
// subtracted in f32, and the difference stored rounded to bf16. group.cu
// (through grouped_value, in 16-byte vectors) and fused_ball_group.cu
// (through store_grouped) both compute it here.
template <typename T>
__device__ T grouped_value(float v, float centre);
template <>
__device__ __forceinline__ float grouped_value<float>(float v, float centre) {
  return v - centre;
}
template <>
__device__ __forceinline__ __nv_bfloat16
grouped_value<__nv_bfloat16>(float v, float centre) {
  return __float2bfloat16_rn(bf16_round(v) - centre);
}
template <typename T>
__device__ __forceinline__ void store_grouped(T* out, float v, float centre) {
  *out = grouped_value<T>(v, centre);
}

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
// w2*p[i2], IEEE divisions. `fast` is the single bf16 MXU pass of
// tumseg/ops/pallas/interpolate.py:136-148 at Precision.DEFAULT: w and p are
// rounded to bf16 first, so each product is exact and the sum is f32. Every
// thread of the block must call it.
template <int kThreads>
__device__ __forceinline__ void three_nn_interpolate_tail(
    NeighbourTile<kThreads>& tile, bool valid, long long row, float d0,
    float d1, float d2, int i0, int i1, int i2, const float* __restrict__ p2,
    float* __restrict__ dists, int* __restrict__ idx, float* __restrict__ out,
    int nq, int D, bool fast) {
  const float eps = static_cast<float>(1e-8);  // f32 rounding of the double
  const float r0 = 1.0f / (d0 + eps);
  const float r1 = 1.0f / (d1 + eps);
  const float r2 = 1.0f / (d2 + eps);
  const float norm = (r0 + r1) + r2;
  float w0 = r0 / norm, w1 = r1 / norm, w2 = r2 / norm;
  if (fast) {
    w0 = bf16_round(w0);
    w1 = bf16_round(w1);
    w2 = bf16_round(w2);
  }
  tile.idx[threadIdx.x][0] = i0;
  tile.idx[threadIdx.x][1] = i1;
  tile.idx[threadIdx.x][2] = i2;
  tile.w[threadIdx.x][0] = w0;
  tile.w[threadIdx.x][1] = w1;
  tile.w[threadIdx.x][2] = w2;
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
    float p[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = p2[static_cast<size_t>(tile.idx[q][k]) * D + c];
      if (fast) p[k] = bf16_round(p[k]);
    }
    out[tile.row[q] * D + c] =
        (p[0] * tile.w[q][0] + p[1] * tile.w[q][1]) + p[2] * tile.w[q][2];
  }
}

}  // namespace tumseg
