// Backward of neighbourhood grouping with respect to the source rows:
// idx [B, S, K] i32 in [0, N], grad [B, S, K, C] f32 -> dsrc [B, N, C] f32,
//   dsrc[b, n, c] = sum over rows r = s*K + k with idx[b, s, k] == n of
//                   grad[b, s, k, c],
// each sum taken in f32 in ascending r from 0.0, which is what the plain
// version's scatter_add_ computes on the CPU: the result is bitwise that,
// and the same from run to run. No floating-point atomics. The fast mode
// (the backward of group.cu's bf16 output) takes a bf16 or an f32 cotangent
// and rounds each element to bf16 before the f32 add, as the fast
// _group_bwd_kernel's single bf16 pass does. Every dsrc element is written
// once (0 where no row holds it), so the caller need not zero it. The
// empty-ball sentinel idx == N (and any index outside [0, N)) adds nothing,
// as it matches no one-hot column on the TPU. The centres get no gradient,
// as in tumseg/ops/pallas/group.py:155-158.
//
// Replaces tumseg/ops/pallas/group.py:_group_bwd_kernel, which contracts the
// transposed cotangent with an [R, N] one-hot on the MXU and accumulates the
// R tiles of its sequential grid into one [C, N] block (exact=True through a
// 3-way bf16 split, exact=False in one bf16 pass): a fixed order, so
// deterministic.
//
// What bounds it: bytes, the cotangent read once (sa2 of a B=16 step: 8.8M
// elements, 35 MB in f32) and dsrc written once; 0.021 ms over sa2-sa4 at
// 3.35 TB/s. Atomic adds would serialise in L2 on a row that many balls
// hold, need a zeroed dsrc (a launch) and commit in an order, so low bits,
// that changes from run to run; here every sum has one owner.
// Design: a block owns a tile of T source rows (and, where C is wider than
// 6144, a slice of columns) of one batch row and sums it in a [T, C] f32
// accumulator in shared memory; no two threads ever add into one element.
// 1. It scans the batch row's S*K indices 1024 at a time (4 a thread, one
//    16-byte load, the next pass's in flight) and appends the rows that
//    fall in its tile to a list in row order: each thread's hits in order,
//    placed by a warp prefix sum and the warps' totals in warp order.
// 2. It sorts the list by tile row, stably (a counting sort: integer
//    counts, their prefix sums, then each entry placed by its rank among
//    its warp's entries of the same row, __match_any_sync, after the
//    counts of the warps before it), so each tile row's rows lie together
//    in ascending order.
// 3. A warp takes (tile row, 128-column slice) items in turn and sums the
//    row's entries in order in registers, lanes over columns, loading 8
//    entries' cotangents at a time (up to 32 loads in flight a lane)
//    before adding them. On facade blocks a short ball repeats its first
//    hit up to K times, so one tile row holds up to ~32 rows that must be
//    summed one after another; batching their loads keeps that chain off
//    the memory latency.
// The list holds 2048 entries; a tile with more (all S*K rows on one
// source) is sorted, summed into the accumulator and emptied as it fills,
// and the next round continues from the partial sums. Then the tile is
// written once, coalesced. T (ops/kernels.py:group_backward_tiles) is the
// largest power of two up to 64 that leaves each SM two blocks and T x C
// within 6144 floats; every block rereads its batch row's indices, from L2
// (sa2: 16 MB in all).
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;  // load_indices reads one int4
constexpr int kChunk = kPerThread * kThreads;  // index rows a pass scans
constexpr int kListCap = 2 * kChunk;  // tile entries held before a flush
constexpr int kTileBits = 6;          // an entry is r << kTileBits | t
constexpr int kMaxTileRows = 1 << kTileBits;  // GROUP_BWD_MAX_ROWS
constexpr int kMaxAcc = 6144;  // ops/kernels.py:GROUP_BWD_MAX_ACC
constexpr int kBatch = 8;      // a row's entries whose loads are in flight
constexpr int kLaneCols = 4;   // columns a lane sums: a slice is 128
constexpr int kSlice = 32 * kLaneCols;
constexpr unsigned kFull = 0xffffffffu;

// *p where `ok`, else 0: a predicated load, so a batch's loads are all in
// flight before the first of them is used.
__device__ __forceinline__ float load_or_zero(const float* p, bool ok) {
  return ok ? *p : 0.0f;
}
__device__ __forceinline__ __nv_bfloat16 load_or_zero(const __nv_bfloat16* p,
                                                      bool ok) {
  return ok ? *p : __ushort_as_bfloat16(0);
}

template <typename G>
__device__ __forceinline__ float cotangent(G raw, bool fast) {
  const float g = tumseg::to_float(raw);
  return fast ? tumseg::bf16_round(g) : g;
}

// idx[b, first .. first + kPerThread), -1 past R: one 16-byte load where
// the rows are whole and aligned.
__device__ __forceinline__ void load_indices(int (&n)[kPerThread],
                                             const int* __restrict__ ib,
                                             int first, int R) {
  const int* p = ib + first;
  if (first + kPerThread <= R &&
      (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    n[0] = v.x, n[1] = v.y, n[2] = v.z, n[3] = v.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    n[e] = first + e < R ? p[e] : -1;
  }
}

struct Buckets {
  int list[kListCap];    // the tile's entries in row order
  int sorted[kListCap];  // the same by tile row, then row order
  int start[kMaxTileRows];
  int count[kMaxTileRows];
  int cursor[kMaxTileRows];
  int warp_count[kWarps][kMaxTileRows + 1];
  int warp_hits[2][kWarps];
};

// Sorts the list's first `count` entries by tile row into `sorted`,
// stably: counts, their prefix sums, then each round of 256 entries placed
// by the rank of an entry among its warp's entries of the same row and the
// counts of the warps before it. Ends after a barrier.
__device__ void sort_by_row(Buckets& k, int count, int rows) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int t = threadIdx.x; t < kMaxTileRows; t += kThreads) k.count[t] = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < count; e += kThreads) {
    atomicAdd(&k.count[k.list[e] & (kMaxTileRows - 1)], 1);  // integers
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix sums of up to 64 counts
    const int c0 = k.count[lane];
    const int c1 = k.count[lane + 32];
    int s0 = c0, s1 = c1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v0 = __shfl_up_sync(kFull, s0, d);
      const int v1 = __shfl_up_sync(kFull, s1, d);
      if (lane >= d) s0 += v0, s1 += v1;
    }
    const int low = __shfl_sync(kFull, s0, 31);
    k.start[lane] = k.cursor[lane] = s0 - c0;
    k.start[lane + 32] = k.cursor[lane + 32] = low + s1 - c1;
  }
  __syncthreads();
  for (int e0 = 0; e0 < count; e0 += kThreads) {
    const int e = e0 + threadIdx.x;
    const int entry = e < count ? k.list[e] : -1;
    const int t = entry >= 0 ? entry & (kMaxTileRows - 1) : kMaxTileRows;
    const unsigned peers = __match_any_sync(kFull, t);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (rank == 0) k.warp_count[warp][t] = __popc(peers);
    __syncthreads();
    if (entry >= 0) {
      int pos = k.cursor[t] + rank;
      for (int w = 0; w < warp; ++w) pos += k.warp_count[w][t];
      k.sorted[pos] = entry;
    }
    __syncthreads();
    if (threadIdx.x < rows) {
      int n = 0;
      for (int w = 0; w < kWarps; ++w) {
        n += k.warp_count[w][threadIdx.x];
        k.warp_count[w][threadIdx.x] = 0;
      }
      k.cursor[threadIdx.x] += n;
    }
    __syncthreads();
  }
}

// Adds the sorted entries into acc. A warp takes (tile row, 128-column
// slice) items in turn; for its row it loads kBatch entries' cotangents
// at a time (lanes over columns, up to 32 loads in flight a lane) and adds
// them in row order to the partial sums in its registers.
template <typename G>
__device__ void add_rows(const Buckets& k, float* acc, const G* __restrict__ gb,
                         int rows, int cols, int C, int tile_cols,
                         bool fast) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slices = (cols + kSlice - 1) / kSlice;
  for (int item = warp; item < rows * slices; item += kWarps) {
    const int t = item / slices;
    const int lo = k.start[t];
    const int hi = lo + k.count[t];
    if (lo == hi) continue;
    const int c_lane = (item - t * slices) * kSlice + lane;
    float* a_row = acc + t * tile_cols;
    float a[kLaneCols];
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) {
      const int c = c_lane + 32 * j;
      a[j] = c < cols ? a_row[c] : 0.0f;
    }
    for (int e0 = lo; e0 < hi; e0 += kBatch) {
      G v[kBatch][kLaneCols];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const bool valid = e0 + i < hi;
        const G* p = gb + static_cast<size_t>(
            valid ? k.sorted[e0 + i] >> kTileBits : 0) * C;
#pragma unroll
        for (int j = 0; j < kLaneCols; ++j) {
          const int c = c_lane + 32 * j;
          v[i][j] = load_or_zero(p + c, valid && c < cols);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (e0 + i < hi) {
#pragma unroll
          for (int j = 0; j < kLaneCols; ++j) a[j] += cotangent(v[i][j], fast);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) {
      const int c = c_lane + 32 * j;
      if (c < cols) a_row[c] = a[j];
    }
  }
  __syncthreads();
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
group_backward_kernel(const int* __restrict__ idx, const G* __restrict__ grad,
                      float* __restrict__ dsrc, int N, int R, int C,
                      int tile_rows, int tile_cols, bool fast) {
  extern __shared__ float acc[];  // [tile_rows][tile_cols]
  __shared__ Buckets k;

  const int b = blockIdx.z;
  const int n0 = blockIdx.x * tile_rows;
  const int c0 = blockIdx.y * tile_cols;
  const int rows = min(tile_rows, N - n0);
  const int cols = min(tile_cols, C - c0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < rows * tile_cols; i += kThreads) {
    acc[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < kWarps * (kMaxTileRows + 1); i += kThreads) {
    (&k.warp_count[0][0])[i] = 0;
  }
  const int* ib = idx + static_cast<size_t>(b) * R;
  const G* gb = grad + static_cast<size_t>(b) * R * C + c0;

  int n[kPerThread];
  load_indices(n, ib, kPerThread * threadIdx.x, R);
  int count = 0;  // entries in the list, the same in every thread
  int parity = 0;
  for (int base = 0; base < R; base += kChunk, parity ^= 1) {
    if (count + kChunk > kListCap) {  // uniform: sum and empty the list
      __syncthreads();
      sort_by_row(k, count, rows);
      add_rows(k, acc, gb, rows, cols, C, tile_cols, fast);
      count = 0;
    }
    const int first = base + kPerThread * threadIdx.x;
    int hits = 0;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      hits += n[e] >= n0 && n[e] < n0 + rows;
    }
    int incl = hits;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) k.warp_hits[parity][warp] = incl;
    __syncthreads();
    int pos = count + incl - hits;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int h = k.warp_hits[parity][w];
      if (w < warp) pos += h;
      count += h;
    }
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      if (n[e] >= n0 && n[e] < n0 + rows) {
        k.list[pos++] = (first + e) << kTileBits | (n[e] - n0);
      }
    }
    load_indices(n, ib, first + kChunk, R);
  }
  __syncthreads();  // the list is written and acc is zero
  sort_by_row(k, count, rows);
  add_rows(k, acc, gb, rows, cols, C, tile_cols, fast);

  float* out = dsrc + (static_cast<size_t>(b) * N + n0) * C + c0;
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int t = i / cols;
    const int c = i - t * cols;
    out[static_cast<size_t>(t) * C + c] = acc[t * tile_cols + c];
  }
}

}  // namespace

// grad is bf16 when grad_bf16 != 0 (fast mode only), else f32. tile_rows
// and tile_cols come from ops/kernels.py:group_backward_tiles(B, N, C).
TUMSEG_API int tumseg_group_backward(const int* idx, const void* grad,
                                     float* dsrc, int B, int N, int S, int K,
                                     int C, int tile_rows, int tile_cols,
                                     int grad_bf16, int fast, void* stream) {
  if (static_cast<long long>(B) * N * C == 0) return 0;
  const long long R = static_cast<long long>(S) * K;
  if (R >= (1LL << (31 - kTileBits)) - 2 * kChunk || tile_rows < 1 ||
      tile_rows > kMaxTileRows || tile_cols < 1 ||
      static_cast<long long>(tile_rows) * tile_cols > kMaxAcc || B > 65535 ||
      (C + static_cast<long long>(tile_cols) - 1) / tile_cols > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + tile_rows - 1) / tile_rows,
                  (C + tile_cols - 1) / tile_cols, B);
  const size_t smem = sizeof(float) * tile_rows * tile_cols;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grad_bf16) {
    group_backward_kernel<<<grid, kThreads, smem, s>>>(
        idx, static_cast<const __nv_bfloat16*>(grad), dsrc, N,
        static_cast<int>(R), C, tile_rows, tile_cols, fast != 0);
  } else {
    group_backward_kernel<<<grid, kThreads, smem, s>>>(
        idx, static_cast<const float*>(grad), dsrc, N, static_cast<int>(R),
        C, tile_rows, tile_cols, fast != 0);
  }
  return tumseg::last_error();
}
