// A tile of one batch row's sources staged in shared memory in z-slabs:
// the staging shared by three_nn_interpolate.cu and the ball queries
// (ball_query.cuh).
//
// The tile's sources, float4 records (x, y, z, index), are grouped into n
// slabs of equal height between the tile's lowest and highest z (n a power
// of two, about m / `per` sources a slab) by a counting sort: shared-memory
// atomics give each source a slot in its slab (the order within a slab is
// immaterial), an exclusive scan gives the slabs' offsets, and each slab
// keeps its actual lowest and highest z. src[off[k], off[k + 1]) then holds
// slab k, whose z lie in [unordered(lo[k]), unordered(hi[k])].
//
// Why a walk over the slabs is exact: slab_of is monotone in z in f32
// (fl(z - zmin), a product by scale >= 0, a clamp and a truncation each
// are), so every source of a slab above the query's own lies above the
// query, and its fl(z - qz) is at least that of the slab's lowest z, and
// fl(dz*dz) with it. A distance (dx*dx + dy*dy) + dz*dz, every product
// rounded (-fmad=false), is never below its fl(dz*dz): a sum of
// non-negative terms never rounds below its last term. So once a slab's
// nearest z gives fl(dz*dz) above a query's limit, nothing in it or past it
// can be within the limit. The bounds are each slab's actual z range, not
// its nominal edges, so no rounding of the edges enters the argument.
#pragma once

#include <math.h>

#include "common.cuh"

namespace tumseg {

constexpr unsigned kFull = 0xffffffffu;

// z as an int whose signed order is the float order (atomicMin/Max).
__device__ __forceinline__ int ordered(float z) {
  const int i = __float_as_int(z);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int o) {
  return __int_as_float(o >= 0 ? o : o ^ 0x7fffffff);
}

// The tile's slab map; slab_of is monotone in z.
struct Slabs {
  float zmin, scale;
  int n;
  __device__ __forceinline__ int slab_of(float z) const {
    return static_cast<int>(
        fminf(fmaxf((z - zmin) * scale, 0.0f), static_cast<float>(n - 1)));
  }
};

// The slabs of a tile of m sources: a power of two, about m / per, at most
// max_slabs.
__device__ __forceinline__ int slab_count(int m, int per, int max_slabs) {
  int n = 1;
  while (n < max_slabs && per * n < m) n <<= 1;
  return n;
}

// Stages sources [base, base + m) of the row `s` ([., 3] f32), m <=
// kThreads * kPerThread, in n slabs (n <= kMaxSlabs, kMaxSlabs a multiple
// of 32): src, off[0..n], lo[0..n), hi[0..n) as above; count and range are
// scratch. Every thread of the block must call it; it begins by writing the
// tables (so the caller's last reads of them must be behind a barrier) and
// ends with a barrier, after which the tables are ready.
template <int kThreads, int kPerThread, int kMaxSlabs>
__device__ __forceinline__ Slabs stage_z_slabs(
    const float* __restrict__ s, int base, int m, int n, float4* src,
    int* off, int* count, int* lo, int* hi, float (*range)[kThreads / 32]) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  Slabs slabs;
  slabs.n = n;

  // this thread's sources j = t + u * kThreads, and the tile's z range
  float4 rec[kPerThread];
  float zmin = INFINITY, zmax = -INFINITY;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int j = t + u * kThreads;
    if (j < m) {
      const float* c = s + 3 * (base + j);
      rec[u] = make_float4(c[0], c[1], c[2], __int_as_float(base + j));
      zmin = fminf(zmin, rec[u].z);
      zmax = fmaxf(zmax, rec[u].z);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    zmin = fminf(zmin, __shfl_xor_sync(kFull, zmin, o));
    zmax = fmaxf(zmax, __shfl_xor_sync(kFull, zmax, o));
  }
  if (lane == 0) {
    range[0][t >> 5] = zmin;
    range[1][t >> 5] = zmax;
  }
  for (int k = t; k < n; k += kThreads) {
    count[k] = 0;
    lo[k] = ordered(INFINITY);
    hi[k] = ordered(-INFINITY);
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    zmin = fminf(zmin, range[0][w]);
    zmax = fmaxf(zmax, range[1][w]);
  }
  // FLT_MAX for a range too small to divide: slabs 0 and n - 1 only
  slabs.zmin = zmin;
  slabs.scale = zmax > zmin
                    ? fminf(static_cast<float>(n) / (zmax - zmin),
                            3.402823466e38f)
                    : 0.0f;

  // counting sort: a slot within the slab (low 16 bits) and the slab
  int where[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    if (t + u * kThreads < m) {
      const int k = slabs.slab_of(rec[u].z);
      where[u] = (k << 16) | atomicAdd(&count[k], 1);
      atomicMin(&lo[k], ordered(rec[u].z));
      atomicMax(&hi[k], ordered(rec[u].z));
    }
  }
  __syncthreads();
  if (t < 32) {  // exclusive scan of count, kMaxSlabs / 32 slabs a lane
    constexpr int kLaneSlabs = kMaxSlabs / 32;
    int c[kLaneSlabs], sum = 0;
#pragma unroll
    for (int u = 0; u < kLaneSlabs; ++u) {
      const int k = kLaneSlabs * t + u;
      c[u] = k < n ? count[k] : 0;
      sum += c[u];
    }
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (t >= o) incl += v;
    }
    int run = incl - sum;
#pragma unroll
    for (int u = 0; u < kLaneSlabs; ++u) {
      const int k = kLaneSlabs * t + u;
      if (k < n) off[k] = run;
      run += c[u];
    }
    if (t == 31) off[n] = incl;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPerThread; ++u)
    if (t + u * kThreads < m)
      src[off[where[u] >> 16] + (where[u] & 0xffff)] = rec[u];
  __syncthreads();
  return slabs;
}

}  // namespace tumseg
