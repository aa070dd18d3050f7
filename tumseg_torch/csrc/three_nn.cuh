// 3-NN search on z-slabs fused with the inverse-distance interpolation that
// consumes it: xyz1 [B, N, 3], xyz2 [B, S, 3], points2 [B, S, D] f32 ->
//   dists [B, N, 3] f32, idx [B, N, 3] i32, out [B, N, D] f32,
// in one of two distance forms, each launched by its own file:
// - three_nn_interpolate.cu, the DIRECT form (dx*dx + dy*dy) + dz*dz of
//   tumseg/ops/pallas/threenn.py:_threenn_kernel_t;
// - three_nn_window.cu, the EXPANSION form (qsq + ssq) - 2*cross of
//   _threenn_kernel and _threenn_window_kernel, each of qsq, ssq and cross
//   summed as (x + y) + z, not clamped at 0.
// Every product rounded (-fmad=false), so the distances are those of the
// plain versions (tumseg_torch/ops/core.py: three_nn, three_nn_expansion)
// bit for bit; ties go to the lower index in both.
//
// Weights follow tumseg/ops/__init__.py:317-329: r = 1/(d + 1e-8),
// w = r / ((r0 + r1) + r2); out = (w0*p[i0] + w1*p[i1]) + w2*p[i2].
// Divisions are IEEE (no fast math). `fast` rounds w and points2 to bf16
// before the f32 products, the single bf16 pass of
// tumseg/ops/pallas/interpolate.py:136-148.
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
//   first non-empty slab whose nearest z gives fl(dz*dz) above its limit:
//   the third distance d2 in the direct form (by z_slabs.cuh's argument
//   nothing there can enter), d2 plus a slack in the expansion form (below).
//   Facade blocks are 1 m x 1 m columns metres tall, so a query tests a few
//   dozen sources, not S. The walk does not visit in index order, so
//   entries compare by (distance, index) in lexicographic order: first-index
//   ties exactly. A query's unfilled slots are +inf with index S and never
//   win. On data flat in z everything falls in a few slabs and the search
//   tends to the full scan; the result is exact either way.
// - Interpolation: the weights and the three source rows of a query are
//   computed once, into shared memory. R lanes own a query's output row
//   and run across D in float4 loads from the three source rows and
//   float4 stores, two columns a lane at a time (six independent loads in
//   flight), with no per-element division. Where D % 4 != 0 or a base
//   pointer is not 16-byte aligned, the same loop runs on scalars.
// - 64 registers a thread (__launch_bounds__(256, 4)): four blocks an SM,
//   so a stage's blocks run in one wave.
//
// Why the expansion form's walk is exact. Its distance E can fall below the
// true squared distance D = |q - s|^2, and below 0, so z_slabs.cuh's
// argument (a distance is never below its fl(dz*dz)) does not hold for it.
// Write u = 2^-24, a = |q|^2, b = |s|^2, and let B be the largest computed
// ssq of the tiles staged so far (a block reduction as each tile is staged;
// it covers every source of the tile and the source that holds d2).
// - Rounding of E: qsq and ssq are sums of three non-negative products,
//   within 3u of a and b; cross is within 3u of sum |q_i s_i| <= (a + b)/2;
//   2*cross is exact. So (qsq + ssq) - 2*cross, before its last rounding, is
//   D + e with |e| <= 7u(a + b), and E >= D(1 - u) - 7u(a + b) to first
//   order.
// - Rounding of the stop: for a slab past the query's own, every source s
//   in it or beyond lies at least g = |zedge - qz| from the query in z
//   (slab_of is monotone), so D(s) >= g^2 >= G/(1 + u)^3 >= G(1 - 3u),
//   G = fl(fl(zedge - qz)^2).
// - The walk stops where G > L = fl(d2 + slack), slack =
//   ((1 + qsq) + B) * 2^-19 (a power of two: the product is exact), so
//   slack >= 32u(1 + a + B)(1 - 5u). A negative d2 is above -7u(a + B) (D
//   >= 0), so d2 + slack > 0 and L >= (d2 + slack)(1 - u).
// - Then E(s) >= (d2 + slack)(1 - 5u) - 7u(a + B), which exceeds d2 when
//   slack(1 - 5u) > 5u*d2 + 7u(a + B). d2, the expansion distance of some
//   source, is at most D(1 + u) + 7u(a + B) <= (2 + 9u)(a + B) (D <=
//   2(a + b)), so the right side is at most 17.1u(a + B) against the slack's
//   32u(1 + a + B)(1 - 10u): every source past the stop has E(s) > d2
//   strictly, and neither a smaller distance nor a tie with a lower index
//   is missed. (tumseg's window guard, 8e-7 = 13.4u, covers its own
//   cancellation but not the 5u*d2 of this bound when d2 nears 2(a + B).)
// - Where d2 is still +inf, L is +inf and nothing stops the walk.
#pragma once

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

// The distance forms (a template argument, so each form is one kernel).
struct DirectForm {
  static constexpr bool kExpansion = false;
};
struct ExpansionForm {
  static constexpr bool kExpansion = true;
};

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

// |s|^2 of a staged record, (x*x + y*y) + z*z: core._sqnorm's rounding.
__device__ __forceinline__ float sqnorm(float4 c) {
  return c.x * c.x + c.y * c.y + c.z * c.z;
}

// What a query of the expansion form keeps besides its coordinates: |q|^2
// and the slack of its walk's stop (the header's comment). The direct form
// keeps nothing.
template <typename Form>
struct Extra {
  float qsq, slack;
};
template <>
struct Extra<DirectForm> {};

// Tests source record c (x, y, z, index bits) against query q.
template <typename Form>
__device__ __forceinline__ void visit(Best3& b, float4 c, float qx, float qy,
                                      float qz, const Extra<Form>& e) {
  if constexpr (Form::kExpansion) {
    const float cross = qx * c.x + qy * c.y + qz * c.z;
    insert(b, (e.qsq + sqnorm(c)) - 2.0f * cross, __float_as_int(c.w));
  } else {
    const float dx = c.x - qx;
    const float dy = c.y - qy;
    const float dz = c.z - qz;
    insert(b, dx * dx + dy * dy + dz * dz, __float_as_int(c.w));
  }
}

// The stop test of a walk: fl(dz*dz) above the query's limit.
template <typename Form>
__device__ __forceinline__ bool past(float dz, const Best3& b,
                                     const Extra<Form>& e) {
  if constexpr (Form::kExpansion)
    return dz * dz > b.d2 + e.slack;
  else
    return dz * dz > b.d2;
}

// The next slab k of a walk away from query q: stops (-> false) where its
// nearest z, `edge` (ordered), is past the query's limit, else tests all
// its sources. An empty slab bounds nothing: the walk goes on.
template <typename Form>
__device__ __forceinline__ bool walk(Best3& b, const float4* src,
                                     const int* off, int k, int edge,
                                     float qx, float qy, float qz,
                                     const Extra<Form>& e) {
  const int p0 = off[k], p1 = off[k + 1];
  if (p0 == p1) return true;
  if (past(unordered(edge) - qz, b, e)) return false;
  for (int p = p0; p < p1; ++p) visit(b, src[p], qx, qy, qz, e);
  return true;
}

// The largest sqnorm of the m records staged in src, in every thread
// (`part` is scratch; begins and ends with nothing else pending on it).
__device__ __forceinline__ float tile_sqnorm_max(const float4* src, int m,
                                                 float* part) {
  float top = 0.0f;
  for (int p = threadIdx.x; p < m; p += kThreads)
    top = fmaxf(top, sqnorm(src[p]));
  for (int o = 16; o > 0; o >>= 1)
    top = fmaxf(top, __shfl_xor_sync(tumseg::kFull, top, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = top;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) top = fmaxf(top, part[w]);
  return top;
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
template <typename Form, bool kFast>
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
  Extra<Form> e;
  if constexpr (Form::kExpansion) {
    e.qsq = qx * qx + qy * qy + qz * qz;
    e.slack = 0.0f;
  }

  const float* s = xyz2 + static_cast<size_t>(b) * S * 3;
  for (int base = 0; base < S; base += kTile) {
    const int m = S - base < kTile ? S - base : kTile;
    const Slabs slabs =
        tumseg::stage_z_slabs<kThreads, kPerThread, kMaxSlabs>(
            s, base, m, tumseg::slab_count(m, kSlabSources, kMaxSlabs), src,
            off, count, lo, hi, range);
    if constexpr (Form::kExpansion) {
      // range is free again: the staging's last reads of it are behind its
      // barriers, and the next tile's first writes behind the one below.
      // Rounding is monotone, so the largest slack of the tiles so far is
      // the slack of their largest ssq, and that need not be kept.
      e.slack = fmaxf(e.slack, ((1.0f + e.qsq) +
                                tile_sqnorm_max(src, m, range[0])) *
                                   0x1p-19f);
    }

    if (searching) {
      const int home = slabs.slab_of(qz);
      for (int p = off[home]; p < off[home + 1]; ++p)
        visit(r, src[p], qx, qy, qz, e);
      int up = home + 1, down = home - 1;
      bool go_up = up < slabs.n, go_down = down >= 0;
      while (go_up || go_down) {
        if (go_up)
          go_up = walk(r, src, off, up, lo[up], qx, qy, qz, e) &&
                  ++up < slabs.n;
        if (go_down)
          go_down = walk(r, src, off, down, hi[down], qx, qy, qz, e) &&
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

// Launches the kernel of `Form` at geometry (Q, R) (see
// kernels.three_nn_geometry) on `stream`; cudaErrorInvalidValue for a
// geometry the kernel cannot run.
template <typename Form>
int launch_three_nn(const float* xyz1, const float* xyz2,
                    const float* points2, float* dists, int* idx, float* out,
                    int B, int N, int S, int D, int Q, int R, int fast,
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
    three_nn_interpolate_kernel<Form, true><<<grid, kThreads, 0, s>>>(
        xyz1, xyz2, points2, dists, idx, out, N, S, D, Q, R, vec);
  else
    three_nn_interpolate_kernel<Form, false><<<grid, kThreads, 0, s>>>(
        xyz1, xyz2, points2, dists, idx, out, N, S, D, Q, R, vec);
  return tumseg::last_error();
}

}  // namespace
