// Backward of the inverse-distance interpolation with respect to points2:
// idx [B, N, 3] i32 in [0, S), w [B, N, 3] f32, grad [B, N, D] f32 ->
// dp2 [B, S, D] f32 = W^T g, i.e.
//   dp2[b, s, d] = sum over entries r = 3n + k with idx[b, n, k] == s of
//                  w[b, n, k] * grad[b, n, d],
// each product rounded to f32 and each sum taken in f32 in ascending r from
// 0.0, which is what the plain version's scatter_add_ computes on the CPU:
// the result is bitwise that, and the same from run to run. No
// floating-point atomics. Two entries of one query that name the same
// source are two products and two adds. The fast mode rounds w and grad to
// bf16 before the product, as the single bf16 pass of
// tumseg/ops/pallas/interpolate.py:136-148 does. Every dp2 element is
// written once (0 where no entry names its row), so the caller need not
// zero it. The weights and indices are constants of the coordinates and get
// no gradient, as in tumseg/ops/pallas/interpolate.py:127-131.
//
// Replaces tumseg/ops/pallas/interpolate.py:_interp_bwd_kernel, which builds
// the [N_t, S] weight matrix of each query tile in VMEM and accumulates
// W^T g on the MXU over the tiles of its sequential grid: a fixed order, so
// deterministic.
//
// What bounds it: bytes, the indices, weights and cotangent read once and
// dp2 written once (fp1 of a B=16 step: 43.5 MB, 0.013 ms at 3.35 TB/s).
// The gather form below reads each cotangent row once for each of its
// query's three sources, 100 MB at fp1; the rereads hit the 50 MB L2 (the
// probe's L2 test), so the sum runs at the L2's rate, not the HBM's.
// Scatter-adds would serialise in L2 at a row that many queries name (~12
// on facade blocks, up to 48), need a zeroed dp2 (a launch) and commit in
// an order, so low bits, that changes from run to run; here every sum has
// one owner.
// Design: a block owns a tile of T source rows (and a slice of CT columns
// where the grid wants more blocks) of one batch row; the sums live in
// registers, so any width fits.
// 1. It scans the batch row's 3N indices 16 a thread a pass (four 16-byte
//    loads in flight; 4096 a pass in a block of 256 threads, 16384 in one
//    of 1024, so fp1's 12288 in one pass) and lists the entries that fall
//    in its tile in r order: each thread's hits in order after those of
//    the threads before it (a block prefix sum of the threads' hit
//    counts), counting each tile row's entries with integer atomics.
// 2. It sorts the list by tile row, stably (a counting sort: the counts'
//    prefix sums, then each round of kThreads entries placed by its rank
//    among its warp's entries of the same row, __match_any_sync, after the
//    entries of the warps before it), so each tile row's entries lie
//    together in ascending r.
// 3. A warp takes (tile row, 128-column slice) items in turn, lanes over
//    columns (four consecutive ones, one 16-byte load, where D is a
//    multiple of 4), and for each loads 4 entries' weights and cotangent
//    rows at a time before adding their products in r order in registers,
//    then writes the row's slice once, coalesced. (2 entries in flight
//    run no faster and 8 run slower: the probe's variants.)
// The list holds a pass's indices (4096 or 16384 entries, in dynamic
// shared memory); a tile whose entries would overflow it (all 3N entries
// on one source) is sorted, summed into dp2 and emptied, and the next
// round continues from those partial sums, which the block's own threads
// wrote. The block size, T and CT come from
// ops/kernels.py:interpolate_backward_tiles: at fp1 of a B=16 step one
// block of 1024 threads an SM takes 128 rows, so 8 blocks scan each batch
// row's indices; small stages take blocks of 256 threads, a (row, slice)
// item a warp.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kPerThread = 16;  // indices a thread scans a pass: 4 int4
constexpr int kTileBits = 7;    // an entry is r << kTileBits | t
constexpr int kMaxTileRows = 1 << kTileBits;  // INTERP_BWD_MAX_ROWS
constexpr int kRowsPerLane = kMaxTileRows / 32;
constexpr int kBatch = 4;    // a row's entries whose loads are in flight
constexpr int kSlice = 128;  // columns a warp sums: 4 a lane
constexpr unsigned kFull = 0xffffffffu;

// idx[b, first .. first + kPerThread), -1 past R: four 16-byte loads where
// the entries are whole and aligned.
__device__ __forceinline__ void load_indices(int (&s)[kPerThread],
                                             const int* __restrict__ ib,
                                             int first, int R) {
  const int* p = ib + first;
  if (first + kPerThread <= R && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int v = 0; v < kPerThread / 4; ++v) {
      const int4 q = reinterpret_cast<const int4*>(p)[v];
      s[4 * v] = q.x, s[4 * v + 1] = q.y, s[4 * v + 2] = q.z,
      s[4 * v + 3] = q.w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) s[e] = first + e < R ? p[e] : -1;
}

__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += x;
  }
  return v;
}

// The block's tables in static shared memory; the list and its sorted copy
// (kCap entries each) are dynamic.
template <int kThreads>
struct Tables {
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kCap = kPerThread * kThreads;  // a pass's indices
  int start[kMaxTileRows + 1];  // a tile row's first entry in `sorted`
  int count[kMaxTileRows];      // its entries in the list (integer atomics)
  int cursor[kMaxTileRows];
  int warp_count[kWarps][kMaxTileRows + 1];  // a sort round's, by warp
  int warp_pos[kWarps][kMaxTileRows];  // where a warp's entries of a row go
  int warp_base[kWarps + 1];                 // a pass's hits before a warp
};

// Sorts the list's first `count` entries by tile row into `sorted`,
// stably: the rows' counts (taken as the entries were listed) to prefix
// sums, which also empties the counts for the next round; then each round
// of kThreads entries placed by the rank of an entry among its warp's
// entries of the same row (__match_any_sync) after the entries of the
// warps before it (a prefix sum over the warps, a thread a row). Starts
// after a barrier that follows the listing; ends after a barrier.
template <int kThreads>
__device__ void sort_by_row(Tables<kThreads>& k, const int* list,
                            int* sorted, int count, int rows) {
  constexpr int kWarps = Tables<kThreads>::kWarps;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {  // exclusive prefix sums of the counts, 4 a lane
    int c[kRowsPerLane];
    int total = 0;
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      c[j] = k.count[lane * kRowsPerLane + j];
      k.count[lane * kRowsPerLane + j] = 0;
      total += c[j];
    }
    int run = warp_inclusive_sum(total) - total;
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      k.start[lane * kRowsPerLane + j] = k.cursor[lane * kRowsPerLane + j] =
          run;
      run += c[j];
    }
    if (lane == 31) k.start[kMaxTileRows] = run;
  }
  __syncthreads();
  for (int e0 = 0; e0 < count; e0 += kThreads) {
    const int e = e0 + threadIdx.x;
    const int entry = e < count ? list[e] : -1;
    const int t = entry >= 0 ? entry & (kMaxTileRows - 1) : kMaxTileRows;
    const unsigned peers = __match_any_sync(kFull, t);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (rank == 0) k.warp_count[warp][t] = __popc(peers);
    __syncthreads();
    if (threadIdx.x < rows) {  // a row's counts to positions, warp by warp
      int run = k.cursor[threadIdx.x];
      for (int w = 0; w < kWarps; ++w) {
        k.warp_pos[w][threadIdx.x] = run;
        run += k.warp_count[w][threadIdx.x];
      }
      k.cursor[threadIdx.x] = run;
    }
    __syncthreads();
    if (entry >= 0) sorted[k.warp_pos[warp][t] + rank] = entry;
    if (rank == 0) k.warp_count[warp][t] = 0;  // read only before the barrier
    __syncwarp();
  }
  __syncthreads();
}

// a and b rounded to bf16 (to nearest, ties to even) and back, both in
// one conversion: tumseg::bf16_round twice, in fewer instructions.
__device__ __forceinline__ void bf16_round2(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  a = __low2float(h);
  b = __high2float(h);
}

// A lane's four columns of a 128-column slice: four consecutive ones (one
// 16-byte access) where kVec, else lane + 32j.
template <bool kVec>
struct Lane4 {
  float v[4];

  static __device__ __forceinline__ int col(int lane, int j) {
    return kVec ? 4 * lane + j : lane + 32 * j;
  }
  // p[col(lane, j)] where `valid` and the column is below `cols`, else 0.
  __device__ __forceinline__ void load(const float* p, int lane, int cols,
                                       bool valid) {
    if (kVec) {
      const float4 q = valid && col(lane, 0) < cols
                           ? *reinterpret_cast<const float4*>(p + 4 * lane)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
      return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = valid && col(lane, j) < cols ? p[col(lane, j)] : 0.0f;
    }
  }
  __device__ __forceinline__ void store(float* p, int lane, int cols) const {
    if (kVec) {
      if (col(lane, 0) < cols) {
        *reinterpret_cast<float4*>(p + 4 * lane) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (col(lane, j) < cols) p[col(lane, j)] = v[j];
    }
  }
};

// Adds the sorted entries' products into the tile's rows of dp2 (`ob`,
// row stride D). A warp takes (tile row, 128-column slice) items in turn;
// for its row it loads kBatch entries' weights and cotangent rows at a time
// and adds their products in r order to the sums in its registers, which
// start from 0 in the first round (`first`: every item is written, 0 where
// the row has no entry) and from the row's partial sums in dp2 after a
// flush. Products and sums are rounded as written: no FMA. Ends after a
// barrier.
template <int kThreads, bool kVec, bool kFast>
__device__ void add_rows(const Tables<kThreads>& k, const int* sorted,
                         const float* __restrict__ wb,
                         const float* __restrict__ gb, float* ob, int rows,
                         int cols, int D, bool first) {
  constexpr int kWarps = Tables<kThreads>::kWarps;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slices = (cols + kSlice - 1) / kSlice;
  for (int item = warp; item < rows * slices; item += kWarps) {
    const int t = item / slices;
    const int lo = k.start[t];
    const int hi = k.start[t + 1];
    if (!first && lo == hi) continue;
    const int c0 = (item - t * slices) * kSlice;
    const int c_left = cols - c0;
    float* out = ob + static_cast<size_t>(t) * D + c0;
    Lane4<kVec> a;
    a.load(out, lane, c_left, !first);
    for (int e0 = lo; e0 < hi; e0 += kBatch) {
      float wv[kBatch];
      Lane4<kVec> g[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const bool valid = e0 + i < hi;
        const unsigned r =
            valid ? static_cast<unsigned>(sorted[e0 + i]) >> kTileBits : 0u;
        wv[i] = valid ? wb[r] : 0.0f;
        g[i].load(gb + static_cast<size_t>(r / 3u) * D + c0, lane, c_left,
                  valid);
      }
      if (kFast) {  // the operands to bf16, two to a conversion
#pragma unroll
        for (int i = 0; i < kBatch; i += 2) bf16_round2(wv[i], wv[i + 1]);
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          bf16_round2(g[i].v[0], g[i].v[1]);
          bf16_round2(g[i].v[2], g[i].v[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (e0 + i < hi) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a.v[j] = __fadd_rn(a.v[j], __fmul_rn(wv[i], g[i].v[j]));
          }
        }
      }
    }
    a.store(out, lane, c_left);
  }
  __syncthreads();
}

template <int kThreads, bool kVec, bool kFast>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
interpolate_backward_kernel(const int* __restrict__ idx,
                            const float* __restrict__ w,
                            const float* __restrict__ grad, float* dp2, int N,
                            int S, int D, int tile_rows, int tile_cols) {
  using T = Tables<kThreads>;
  __shared__ T k;
  extern __shared__ int lists[];  // list [kCap], then sorted [kCap]
  int* const list = lists;
  int* const sorted = lists + T::kCap;

  const int b = blockIdx.z;
  const int s0 = blockIdx.x * tile_rows;
  const int c0 = blockIdx.y * tile_cols;
  const int rows = min(tile_rows, S - s0);
  const int cols = min(tile_cols, D - c0);
  const int R = 3 * N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < T::kWarps * (kMaxTileRows + 1);
       i += kThreads) {
    (&k.warp_count[0][0])[i] = 0;
  }
  for (int t = threadIdx.x; t < kMaxTileRows; t += kThreads) k.count[t] = 0;
  const int* ib = idx + static_cast<size_t>(b) * R;
  const float* wb = w + static_cast<size_t>(b) * R;
  const float* gb = grad + static_cast<size_t>(b) * N * D + c0;
  float* ob = dp2 + (static_cast<size_t>(b) * S + s0) * D + c0;

  // The scan: each pass, thread t takes entries base + 16t .. + 15, all
  // four loads in flight at once, and lists its hits after those of the
  // threads before it (a block prefix sum of the threads' hit counts).
  int count = 0;  // entries in the list, the same in every thread
  bool first = true;  // no round has written dp2 yet
  for (int base = 0; base < R; base += T::kCap) {
    const int first_r = base + kPerThread * threadIdx.x;
    int s[kPerThread];
    load_indices(s, ib, first_r, R);
    int hits = 0;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      hits += s[e] >= s0 && s[e] < s0 + rows;
    }
    const int incl = warp_inclusive_sum(hits);
    if (lane == 31) k.warp_base[warp] = incl;
    __syncthreads();  // also: the previous pass is listed
    if (warp == 0) {
      const int v = lane < T::kWarps ? k.warp_base[lane] : 0;
      const int x = warp_inclusive_sum(v);
      if (lane < T::kWarps) k.warp_base[lane] = x - v;
      if (lane == 31) k.warp_base[T::kWarps] = x;
    }
    __syncthreads();
    const int total = k.warp_base[T::kWarps];
    int pos = k.warp_base[warp] + incl - hits;
    if (count + total > T::kCap) {  // uniform: sum and empty the list
      sort_by_row(k, list, sorted, count, rows);
      add_rows<kThreads, kVec, kFast>(k, sorted, wb, gb, ob, rows, cols, D,
                                      first);
      first = false;
      count = 0;
      load_indices(s, ib, first_r, R);  // again: not held over the flush
    }
    pos += count;
    count += total;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int t = s[e] - s0;
      if (t >= 0 && t < rows) {
        list[pos++] = (first_r + e) << kTileBits | t;
        atomicAdd(&k.count[t], 1);  // integers
      }
    }
  }
  __syncthreads();  // the list and the counts are complete
  sort_by_row(k, list, sorted, count, rows);
  add_rows<kThreads, kVec, kFast>(k, sorted, wb, gb, ob, rows, cols, D,
                                  first);
}

template <int kThreads, bool kVec, bool kFast>
int launch_instance(dim3 grid, cudaStream_t st, const int* idx,
                    const float* w, const float* grad, float* dp2, int N,
                    int S, int D, int tile_rows, int tile_cols) {
  const size_t smem = 2 * sizeof(int) * Tables<kThreads>::kCap;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        interpolate_backward_kernel<kThreads, kVec, kFast>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  interpolate_backward_kernel<kThreads, kVec, kFast>
      <<<grid, kThreads, smem, st>>>(idx, w, grad, dp2, N, S, D, tile_rows,
                                     tile_cols);
  return tumseg::last_error();
}

template <int kThreads>
int launch(dim3 grid, cudaStream_t st, bool vec, bool fast, const int* idx,
           const float* w, const float* grad, float* dp2, int N, int S,
           int D, int tile_rows, int tile_cols) {
  if (vec && fast) {
    return launch_instance<kThreads, true, true>(
        grid, st, idx, w, grad, dp2, N, S, D, tile_rows, tile_cols);
  }
  if (vec) {
    return launch_instance<kThreads, true, false>(
        grid, st, idx, w, grad, dp2, N, S, D, tile_rows, tile_cols);
  }
  if (fast) {
    return launch_instance<kThreads, false, true>(
        grid, st, idx, w, grad, dp2, N, S, D, tile_rows, tile_cols);
  }
  return launch_instance<kThreads, false, false>(
      grid, st, idx, w, grad, dp2, N, S, D, tile_rows, tile_cols);
}

}  // namespace

// threads (256 or 1024), tile_rows and tile_cols come from
// ops/kernels.py:interpolate_backward_tiles(B, S, D).
TUMSEG_API int tumseg_interpolate_backward(const int* idx, const float* w,
                                           const float* grad, float* dp2,
                                           int B, int N, int S, int D,
                                           int threads, int tile_rows,
                                           int tile_cols, int fast,
                                           void* stream) {
  if (static_cast<long long>(B) * S * D == 0) return 0;
  const long long R = 3LL * N;
  if (N < 0 || R >= (1LL << (31 - kTileBits)) - 8 * 1024 ||
      tile_rows < 1 || tile_rows > kMaxTileRows || tile_cols < 1 ||
      (tile_cols < D && tile_cols % kSlice != 0) || B > 65535 ||
      (D + static_cast<long long>(tile_cols) - 1) / tile_cols > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((S + tile_rows - 1) / tile_rows,
                  (D + tile_cols - 1) / tile_cols, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(grad) |
                     reinterpret_cast<uintptr_t>(dp2)) & 15) == 0;
  if (threads == 256) {
    return launch<256>(grid, st, vec, fast != 0, idx, w, grad, dp2, N, S, D,
                       tile_rows, tile_cols);
  }
  if (threads == 1024) {
    return launch<1024>(grid, st, vec, fast != 0, idx, w, grad, dp2, N, S, D,
                        tile_rows, tile_cols);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
