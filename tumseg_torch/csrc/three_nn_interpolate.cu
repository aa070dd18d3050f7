// 3-NN search fused with the inverse-distance interpolation that consumes it:
// xyz1 [B, N, 3], xyz2 [B, S, 3], points2 [B, S, D] f32 ->
//   dists [B, N, 3] f32, idx [B, N, 3] i32, out [B, N, D] f32.
//
// Replaces tumseg/ops/pallas/threenn.py:_threenn_kernel_t (3-NN, direct
// distances, ties to the lower index) and
// tumseg/ops/pallas/interpolate.py:_interp_fwd_kernel (one-hot weight matrix
// contracted on the MXU) in one pass. Weights follow
// tumseg/ops/__init__.py:317-329: r = 1/(d + 1e-8), w = r / ((r0 + r1) + r2);
// out = (w0*p[i0] + w1*p[i1]) + w2*p[i2]. Divisions are IEEE (no fast math).
// `fast` rounds w and points2 to bf16 before the f32 products, the single
// bf16 pass of interpolate.py:136-148.
//
// What bounds it on an H100: a full scan is B*N*S distance evaluations
// (fp1 at B=32: 134M), each ~8 f32 instructions under -fmad=false plus a
// top-3 insertion that some lane of a warp takes at most steps: ~25
// instructions a candidate at the issue rate, ~0.1 ms at fp1. The z-slab
// search below tests ~40 candidates a query there instead of 1024 (5.3M at
// fp1), so what is left is the interpolation's bytes (B*N*D outputs, fp1
// 67 MB, and three source rows gathered from L2 for each) and the latency
// of the search's dependent shared-memory loads and barriers.
//
// Design (geometry from tumseg_torch/ops/kernels.py:three_nn_geometry):
// - A block of 256 threads owns Q queries of one batch row, one a thread, Q
//   chosen so that every stage gives each SM at least two blocks.
// - Search: the row's sources are staged in shared memory as float4
//   records (x, y, z, index) in tiles of 1024, grouped into up to 128
//   z-slabs of about 8 sources by z_slabs.cuh's counting sort, each slab
//   keeping its lowest and highest z. A query tests every source of its own
//   slab, then walks the slabs above and below, stopping a direction at the
//   first non-empty slab whose nearest z gives fl(dz*dz) > d2, its third
//   distance: by z_slabs.cuh's argument nothing there can enter. Facade
//   blocks are 1 m x 1 m columns metres tall, so a query tests a few dozen
//   sources, not S. The walk does not visit in index order, so entries
//   compare by (distance, index) in lexicographic order: first-index ties
//   exactly. A query's unfilled slots are +inf with index S and never win.
//   On data flat in z everything falls in a few slabs and the search
//   tends to the full scan; the result is exact either way.
// - Interpolation: the weights and the three source rows of a query are
//   computed once, into shared memory. R lanes own a query's output row
//   and run across D in float4 loads from the three source rows and
//   float4 stores, two columns a lane at a time (six independent loads in
//   flight), with no per-element division. Where D % 4 != 0 or a base
//   pointer is not 16-byte aligned, the same loop runs on scalars.
// - 64 registers a thread (__launch_bounds__(256, 4)): four blocks an SM,
//   so a stage's blocks run in one wave.
// The z-window kernel (three_nn_window.cu) keeps its own tail in
// common.cuh.
#include <math.h>
#include <stdint.h>

#include "z_slabs.cuh"

namespace {

using tumseg::Slabs;
using tumseg::unordered;

constexpr int kThreads = 256;
constexpr int kMaxQueries = 256;  // kernels.THREE_NN_MAX_QUERIES
constexpr int kTile = 1024;       // sources staged at a time (THREE_NN_TILE)
constexpr int kPerThread = kTile / kThreads;
constexpr int kMaxSlabs = 128;    // kernels.THREE_NN_MAX_SLABS
constexpr int kSlabSources = 8;   // sources a slab (THREE_NN_SLAB_SOURCES)

// A query's best three candidates, ascending by (distance, index).
struct Best3 {
  float d0, d1, d2;
  int i0, i1, i2;
};

// Puts candidate (d, j), which precedes the third entry, in its place: c1
// where it precedes the second entry, c0 where it precedes the first.
__device__ __forceinline__ void place(Best3& b, float d, int j, bool c0,
                                      bool c1) {
  b.d2 = c1 ? b.d1 : d;
  b.i2 = c1 ? b.i1 : j;
  b.d1 = c0 ? b.d0 : (c1 ? d : b.d1);
  b.i1 = c0 ? b.i0 : (c1 ? j : b.i1);
  b.d0 = c0 ? d : b.d0;
  b.i0 = c0 ? j : b.i0;
}

// (d, j) before (e, k) in lexicographic order.
__device__ __forceinline__ bool before(float d, int j, float e, int k) {
  return d < e || (d == e && j < k);
}

__device__ __forceinline__ void insert(Best3& b, float d, int j) {
  if (before(d, j, b.d2, b.i2))
    place(b, d, j, before(d, j, b.d0, b.i0), before(d, j, b.d1, b.i1));
}

// Tests source record c (x, y, z, index bits) against query q.
__device__ __forceinline__ void visit(Best3& b, float4 c, float qx, float qy,
                                      float qz) {
  const float dx = c.x - qx;
  const float dy = c.y - qy;
  const float dz = c.z - qz;
  insert(b, dx * dx + dy * dy + dz * dz, __float_as_int(c.w));
}

// The next slab k of a walk away from query q: stops (-> false) where its
// nearest z, `edge` (ordered), gives fl(dz*dz) > the third distance, else
// tests all its sources. An empty slab bounds nothing: the walk goes on.
__device__ __forceinline__ bool walk(Best3& b, const float4* src,
                                     const int* off, int k, int edge,
                                     float qx, float qy, float qz) {
  const int p0 = off[k], p1 = off[k + 1];
  if (p0 == p1) return true;
  const float dz = unordered(edge) - qz;
  if (dz * dz > b.d2) return false;
  for (int p = p0; p < p1; ++p) visit(b, src[p], qx, qy, qz);
  return true;
}

template <bool kFast>
__device__ __forceinline__ float operand(float v) {
  return kFast ? tumseg::bf16_round(v) : v;
}

template <bool kFast>
__device__ __forceinline__ float combine(float a, float b, float c,
                                         float w0, float w1, float w2) {
  return (operand<kFast>(a) * w0 + operand<kFast>(b) * w1) +
         operand<kFast>(c) * w2;
}

template <bool kFast>
__device__ __forceinline__ float4 combine4(float4 a, float4 b, float4 c,
                                           float w0, float w1, float w2) {
  return make_float4(combine<kFast>(a.x, b.x, c.x, w0, w1, w2),
                     combine<kFast>(a.y, b.y, c.y, w0, w1, w2),
                     combine<kFast>(a.z, b.z, c.z, w0, w1, w2),
                     combine<kFast>(a.w, b.w, c.w, w0, w1, w2));
}

// One query's output row over `cols` columns of T (float4 or float): lane
// lr of the row's R lanes takes columns lr, lr + R, ..., two at a time,
// loading all six before storing.
template <bool kFast, typename T>
__device__ __forceinline__ void interpolate_row(
    const T* __restrict__ a, const T* __restrict__ b,
    const T* __restrict__ c, T* __restrict__ o, int cols, int lr, int R,
    float w0, float w1, float w2) {
  for (int c0 = lr; c0 < cols; c0 += 2 * R) {
    T va[2], vb[2], vc[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int col = c0 + u * R;
      if (col < cols) {
        va[u] = __ldg(a + col);
        vb[u] = __ldg(b + col);
        vc[u] = __ldg(c + col);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int col = c0 + u * R;
      if (col < cols) {
        if constexpr (sizeof(T) == 16)
          o[col] = combine4<kFast>(va[u], vb[u], vc[u], w0, w1, w2);
        else
          o[col] = combine<kFast>(va[u], vb[u], vc[u], w0, w1, w2);
      }
    }
  }
}

// Q queries a block, R lanes a row in the interpolation; `vec` when rows
// are 16-byte aligned.
template <bool kFast>
__global__ void __launch_bounds__(kThreads, 4)
three_nn_interpolate_kernel(const float* __restrict__ xyz1,
                            const float* __restrict__ xyz2,
                            const float* __restrict__ points2,
                            float* __restrict__ dists, int* __restrict__ idx,
                            float* __restrict__ out, int N, int S, int D,
                            int Q, int R, bool vec) {
  __shared__ float4 src[kTile];
  __shared__ int off[kMaxSlabs + 1];
  __shared__ int count[kMaxSlabs], lo[kMaxSlabs], hi[kMaxSlabs];
  __shared__ float range[2][kThreads / 32];
  __shared__ int nb[kMaxQueries][3];
  __shared__ float wt[kMaxQueries][3];

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * Q;
  const int nq = N - n0 < Q ? N - n0 : Q;
  const int t = threadIdx.x;
  const bool searching = t < nq;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (searching) {
    const float* qp = xyz1 + (static_cast<size_t>(b) * N + n0 + t) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  Best3 r = {INFINITY, INFINITY, INFINITY, S, S, S};

  const float* s = xyz2 + static_cast<size_t>(b) * S * 3;
  for (int base = 0; base < S; base += kTile) {
    const int m = S - base < kTile ? S - base : kTile;
    const Slabs slabs =
        tumseg::stage_z_slabs<kThreads, kPerThread, kMaxSlabs>(
            s, base, m, tumseg::slab_count(m, kSlabSources, kMaxSlabs), src,
            off, count, lo, hi, range);

    if (searching) {
      const int home = slabs.slab_of(qz);
      for (int p = off[home]; p < off[home + 1]; ++p)
        visit(r, src[p], qx, qy, qz);
      int up = home + 1, down = home - 1;
      bool go_up = up < slabs.n, go_down = down >= 0;
      while (go_up || go_down) {
        if (go_up)
          go_up = walk(r, src, off, up, lo[up], qx, qy, qz) &&
                  ++up < slabs.n;
        if (go_down)
          go_down = walk(r, src, off, down, hi[down], qx, qy, qz) &&
                    --down >= 0;
      }
    }
    __syncthreads();
  }

  const float eps = static_cast<float>(1e-8);  // f32 rounding of the double
  if (searching) {
    const size_t row = static_cast<size_t>(b) * N + n0 + t;
    dists[row * 3] = r.d0;
    dists[row * 3 + 1] = r.d1;
    dists[row * 3 + 2] = r.d2;
    idx[row * 3] = r.i0;
    idx[row * 3 + 1] = r.i1;
    idx[row * 3 + 2] = r.i2;
    const float r0 = 1.0f / (r.d0 + eps);
    const float r1 = 1.0f / (r.d1 + eps);
    const float r2 = 1.0f / (r.d2 + eps);
    const float norm = (r0 + r1) + r2;
    wt[t][0] = operand<kFast>(r0 / norm);
    wt[t][1] = operand<kFast>(r1 / norm);
    wt[t][2] = operand<kFast>(r2 / norm);
    // an index past S (only where a distance is not below +inf) reads row
    // S - 1, so no gather leaves points2
    nb[t][0] = r.i0 < S ? r.i0 : S - 1;
    nb[t][1] = r.i1 < S ? r.i1 : S - 1;
    nb[t][2] = r.i2 < S ? r.i2 : S - 1;
  }
  __syncthreads();

  const int rg = t / R;
  const int lr = t - rg * R;
  const int F = kThreads / R;  // rows in flight
  const float* p2 = points2 + static_cast<size_t>(b) * S * D;
  float* o = out + (static_cast<size_t>(b) * N + n0) * D;
  for (int q = rg; q < nq; q += F) {
    const float* a = p2 + static_cast<size_t>(nb[q][0]) * D;
    const float* bb = p2 + static_cast<size_t>(nb[q][1]) * D;
    const float* c = p2 + static_cast<size_t>(nb[q][2]) * D;
    float* oq = o + static_cast<size_t>(q) * D;
    const float w0 = wt[q][0], w1 = wt[q][1], w2 = wt[q][2];
    if (vec)
      interpolate_row<kFast>(reinterpret_cast<const float4*>(a),
                             reinterpret_cast<const float4*>(bb),
                             reinterpret_cast<const float4*>(c),
                             reinterpret_cast<float4*>(oq), D >> 2, lr, R, w0,
                             w1, w2);
    else
      interpolate_row<kFast>(a, bb, c, oq, D, lr, R, w0, w1, w2);
  }
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

// Q queries a block (one a thread), R lanes a row in the interpolation: see
// kernels.three_nn_geometry. Returns cudaErrorInvalidValue for a geometry
// the kernel cannot run.
TUMSEG_API int tumseg_three_nn_interpolate(
    const float* xyz1, const float* xyz2, const float* points2, float* dists,
    int* idx, float* out, int B, int N, int S, int D, int Q, int R, int fast,
    void* stream) {
  if (B == 0 || N == 0) return 0;
  if (Q < 1 || Q > kMaxQueries || !pow2(R) || R > kThreads || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(points2) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((N + Q - 1) / Q, B);
  const auto s = static_cast<cudaStream_t>(stream);
  if (fast)
    three_nn_interpolate_kernel<true><<<grid, kThreads, 0, s>>>(
        xyz1, xyz2, points2, dists, idx, out, N, S, D, Q, R, vec);
  else
    three_nn_interpolate_kernel<false><<<grid, kThreads, 0, s>>>(
        xyz1, xyz2, points2, dists, idx, out, N, S, D, Q, R, vec);
  return tumseg::last_error();
}
