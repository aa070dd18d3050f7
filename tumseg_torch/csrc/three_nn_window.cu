// z-window 3-NN in the expansion form, fused with the inverse-distance
// interpolation that consumes it:
//   xyz1 [B, N, 3], xyz2 [B, S, 3], points2 [B, S, D] f32 ->
//   dists [B, N, 3] f32, idx [B, N, 3] i32, out [B, N, D] f32.
//
// Replaces both Pallas kernels of the windowed path:
//   tumseg/ops/pallas/threenn.py:_threenn_window_kernel (z-window scan,
//     expansion form, ties to the lower ORIGINAL index, with the post-hoc
//     exactness guard of _three_nn_windowed_impl);
//   tumseg/ops/pallas/threenn.py:_threenn_kernel (the full expansion-form
//     row kernel, the guard's fallback): this same kernel with one window of
//     all S sources (no sort, start 0, C = S).
// Distance: (qsq + ssq) - 2*cross, each of qsq, ssq and cross summed as
// (x + y) + z; not clamped at 0. Built with -fmad=false, so every distance
// rounds as in the plain version (tumseg_torch/ops/core.py:
// three_nn_windowed) and indices and distances are held equal bit for bit.
//
// What the wrapper does (tumseg_torch/ops/kernels.py): the stable z-sorts of
// sources and queries, searchsorted and the window starts, and the largest
// source norm per batch row, in torch on the device. These are index ops
// over [B, S] and [B, N].
//
// Design: a block owns up to 256 z-sorted queries of one tile of n_tile
// queries in one batch row, one thread per query; the tile's window of C
// sorted sources (x, y, z, |s|^2, original index) streams through shared
// memory and each thread keeps its best three by (distance, original index).
// The guard is per query, in the kernel: the 3rd distance plus the slack
// 8e-7 * (1 + qsq + max ssq) must lie below the squared z-gap to each window
// edge that is not the end of the row. A thread whose query fails it rescans
// all S sources (in index order, through shared memory) from scratch.
// Why that equals tumseg, which takes the full kernel for the WHOLE batch
// when any query fails (lax.cond, threenn.py:337-350): a query that passes
// has no source outside its window at or below its 3rd distance, and a
// source's distance to it is the same arithmetic inside and outside the
// window, so its windowed three are the full kernel's three; a query that
// fails gets the full scan itself. No host sync decides anything. Results
// are written at the query's ORIGINAL index, so nothing is unpermuted.
// The interpolation tail is common.cuh's, shared with
// three_nn_interpolate.cu: one launch an FP stage.
//
// Bound at fp1 (B=32, N=4096, S=1024, D=128, C=384): operations ~10 a
// candidate x B*N*C = 50.3M candidates, ~0.0075 ms at 67 TFLOP/s, plus S
// candidates for each query that fails the guard; bytes: points2
// [32, 1024, 128] read and out [32, 4096, 128] written, ~89 MB, 0.027 ms at
// 3.35 TB/s. So the fused kernel is bytes-bound, like three_nn_interpolate.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // queries of a block
constexpr int kTile = 256;     // sources staged in shared memory at a time

struct Staged {
  float x[kTile], y[kTile], z[kTile], sq[kTile];
  int id[kTile];
};

__device__ __forceinline__ bool before(float d, int j, float dk, int ik) {
  return d < dk || (d == dk && j < ik);
}

// Keeps (d0, i0) <= (d1, i1) <= (d2, i2), the best three by (distance, id).
__device__ __forceinline__ void insert3(float d, int j, float& d0, int& i0,
                                       float& d1, int& i1, float& d2,
                                       int& i2) {
  if (!before(d, j, d2, i2)) return;
  if (before(d, j, d1, i1)) {
    d2 = d1;
    i2 = i1;
    if (before(d, j, d0, i0)) {
      d1 = d0;
      i1 = i0;
      d0 = d;
      i0 = j;
    } else {
      d1 = d;
      i1 = j;
    }
  } else {
    d2 = d;
    i2 = j;
  }
}

// Scans `count` sources from position `begin` of one batch row `src`
// [S, 3] (ids order[p], or p without an order) for every thread with
// `active`. Every thread of the block must call it.
__device__ void scan(Staged& st, const float* __restrict__ src,
                     const int* __restrict__ order, int begin, int count,
                     bool active, float qx, float qy, float qz, float qsq,
                     float& d0, int& i0, float& d1, int& i1, float& d2,
                     int& i2) {
  for (int base = 0; base < count; base += kTile) {
    const int m = count - base < kTile ? count - base : kTile;
    __syncthreads();  // the previous tile is consumed
    for (int t = threadIdx.x; t < m; t += kThreads) {
      const int p = begin + base + t;
      const float x = src[3 * p];
      const float y = src[3 * p + 1];
      const float z = src[3 * p + 2];
      st.x[t] = x;
      st.y[t] = y;
      st.z[t] = z;
      st.sq[t] = x * x + y * y + z * z;
      st.id[t] = order != nullptr ? order[p] : p;
    }
    __syncthreads();
    if (active) {
      for (int t = 0; t < m; ++t) {
        const float cross = qx * st.x[t] + qy * st.y[t] + qz * st.z[t];
        const float d = (qsq + st.sq[t]) - 2.0f * cross;
        insert3(d, st.id[t], d0, i0, d1, i1, d2, i2);
      }
    }
  }
}

// grid (T tiles, blocks per tile, B); srt/sorder/qorder/starts/ssq_max are
// null for the full row kernel (C = S, n_tile = N).
__global__ void __launch_bounds__(kThreads)
three_nn_window_kernel(const float* __restrict__ xyz1,
                       const float* __restrict__ xyz2,
                       const float* __restrict__ srt,
                       const int* __restrict__ sorder,
                       const int* __restrict__ qorder,
                       const int* __restrict__ starts,
                       const float* __restrict__ ssq_max,
                       const float* __restrict__ points2,
                       float* __restrict__ dists, int* __restrict__ idx,
                       float* __restrict__ out, int N, int S, int D, int C,
                       int n_tile) {
  __shared__ Staged st;
  __shared__ tumseg::NeighbourTile<kThreads> tile;

  const int t = blockIdx.x;
  const int b = blockIdx.z;
  const int p0 = t * n_tile + blockIdx.y * kThreads;  // first sorted query
  const int left_in_tile = (t + 1) * n_tile - p0;
  const int nq = left_in_tile < kThreads ? left_in_tile : kThreads;
  const bool valid = static_cast<int>(threadIdx.x) < nq;
  const bool windowed = srt != nullptr;

  int n = 0;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (valid) {
    const int p = p0 + threadIdx.x;
    n = windowed ? qorder[static_cast<size_t>(b) * N + p] : p;
    const float* q = xyz1 + (static_cast<size_t>(b) * N + n) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  const float qsq = qx * qx + qy * qy + qz * qz;

  float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY;
  int i0 = INT_MAX, i1 = INT_MAX, i2 = INT_MAX;
  const float* row = xyz2 + static_cast<size_t>(b) * S * 3;
  const int start = windowed ? starts[static_cast<size_t>(b) * gridDim.x + t]
                             : 0;
  if (windowed) {
    const float* srow = srt + static_cast<size_t>(b) * S * 3;
    scan(st, srow, sorder + static_cast<size_t>(b) * S, start, C, valid, qx,
         qy, qz, qsq, d0, i0, d1, i1, d2, i2);
    const float zlo = srow[3 * start + 2];
    const float zhi = srow[3 * (start + C - 1) + 2];
    const float slack = 8e-7f * ((1.0f + qsq) + ssq_max[b]);
    const float d3 = d2 + slack;
    const bool left_ok =
        start == 0 || (qz >= zlo && d3 < (qz - zlo) * (qz - zlo));
    const bool right_ok =
        start + C == S || (qz <= zhi && d3 < (zhi - qz) * (zhi - qz));
    const bool redo = valid && !(left_ok && right_ok);
    if (__syncthreads_or(redo)) {
      if (redo) {
        d0 = d1 = d2 = INFINITY;
        i0 = i1 = i2 = INT_MAX;
      }
      scan(st, row, nullptr, 0, S, redo, qx, qy, qz, qsq, d0, i0, d1, i1, d2,
           i2);
    }
  } else {
    scan(st, row, nullptr, 0, S, valid, qx, qy, qz, qsq, d0, i0, d1, i1, d2,
         i2);
  }

  tumseg::three_nn_interpolate_tail<kThreads>(
      tile, valid, static_cast<long long>(b) * N + n, d0, d1, d2, i0, i1, i2,
      points2 + static_cast<size_t>(b) * S * D, dists, idx, out, nq, D);
}

}  // namespace

TUMSEG_API int tumseg_three_nn_window(
    const float* xyz1, const float* xyz2, const float* srt, const int* sorder,
    const int* qorder, const int* starts, const float* ssq_max,
    const float* points2, float* dists, int* idx, float* out, int B, int N,
    int S, int D, int C, int n_tile, void* stream) {
  if (B == 0 || N == 0) return 0;
  const dim3 grid(N / n_tile, (n_tile + kThreads - 1) / kThreads, B);
  three_nn_window_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      xyz1, xyz2, srt, sorder, qorder, starts, ssq_max, points2, dists, idx,
      out, N, S, D, C, n_tile);
  return tumseg::last_error();
}
