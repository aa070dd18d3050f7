// Ball query: xyz [B, N, 3], new_xyz [B, S, 3] f32 -> for each of R radii
// (1 to kMaxRadii, in any order) one output [B, S, K_r] i32 holding the
// first K_r indices, in ascending order, whose squared distance
// (dx*dx + dy*dy) + dz*dz (every product rounded: -fmad=false) is <= r^2
// rounded to f32; a shortfall repeats the first hit and an empty ball gives
// N in every slot. ball_query.cu launches it with one radius, the answer to
// tumseg/ops/pallas/ballquery.py's _ballquery_kernel (:48), _t (:119), _bp
// (:279, with _bp_pack_and_peel :198) and _window(_t) (:433, :466), which
// differ only in TPU layout; ball_query_multi.cu with the MSG layer's radii,
// the answer to _ballquery_kernel_bp_multi (:293), one distance a candidate
// shared by every radius. Both equal tumseg_torch/ops/core.py's
// query_ball_point(_multi) bit for bit. fused_ball_group.cu launches it with
// one radius and a grouping epilogue (below), the answer to
// tumseg/ops/pallas/fusedgroup.py's _fused_kernel and _fused_gridk_kernel.
//
// What bounds it on an H100. Bytes: xyz and new_xyz read once, the indices
// written once (sa1 of the B=32 x 4096 forward: 6.2 MB, 0.0018 ms at
// 3.35 TB/s). Operations: the candidates a query must test. A scan in
// index order stops only once a ball holds K, and at sa1 a ball of r = 0.1
// on a facade block holds ~9 points, so it tests all N = 4096: 134M
// candidates a forward, ~0.1 ms at the issue rate. Only candidates within r
// of the query in z can be hits, and a block spans ~10 m of z, so ~90 of
// the 4096 need a test.
//
// Design (geometry from tumseg_torch/ops/kernels.py:ball_query_geometry):
// - A block of kThreads threads owns Q queries of one batch row and stages
//   the row's sources in tiles of up to kTile, in index order: "walked"
//   tiles by z_slabs.cuh's counting sort into z-slabs of about
//   kSlabSources (four sources a thread, the 3-NN kernel's staging),
//   "scanned" ones (small N, where the sort saves nothing) as they are.
//   The queries' coordinates are staged beside them.
// - A group of L lanes (L a power of two, 8 to 32) takes a query, the
//   block's kThreads / L groups in turn, so that a block's queries are in
//   flight at once, or nearly, across its 32 warps. A query's limit is the
//   largest r^2 of its radii still short of their K. Each lane walks out
//   from the query's slab to, not including, the first non-empty slab on
//   each side whose nearest z gives fl(dz*dz) > limit (exact by
//   z_slabs.cuh's argument); the slabs between are contiguous in the
//   staged tile, and the group tests that range L candidates at a time
//   with the same distance as the plain version.
// - Index order without a sort: each hit sets its bit, by its index in the
//   tile, in the group's mask of that radius (tile bits), and the word's
//   bit in a 128-bit summary. The group then takes the non-zero words in
//   index order, one a lane by rank in the summary (__fns), counts their
//   bits with __popc, places them by a prefix sum over its lanes, appends
//   the first K - held to the output, and clears the words: ~9 words a
//   query at sa1, not the tile's 128. Tiles run in index order, so the
//   first hit appended is the smallest index, the fill of a short ball; a
//   block stops staging tiles once every query holds its K. Any K, any
//   number of hits.
// - Tried and dropped (PERF.md): a warp a query in blocks of 512,
//   reading the whole mask (~250 warp instructions a query); a thread a
//   query with sorted lists (eight warps an SM at sa1, each a latency-bound
//   chain, rows written a thread each); masks read whole by L lanes, padded
//   or not (the passes over 128 words a query were half the walk).
// - Short balls are filled at the end by the whole block, its rows being
//   one contiguous region of the output, in coalesced stores (filled a
//   group a row, four rows a warp store, they ran at about one element a
//   cycle).
// - Shared memory: the tile (16 bytes a source), the groups' masks, each
//   query's counts and coordinates; at sa1 (Q = 256, L = 8) 138 KB, one
//   block an SM, in one wave.
// - The grouping epilogue (a template argument: the ball queries take
//   none, and their code is the same as without it). After the fill and a
//   barrier, which makes the block's idx rows visible to the whole block,
//   the block reads its [nq, K] rows back (from L1/L2) into the shared
//   memory the tile and the masks held, in chunks of (source row, query)
//   pairs, and writes its contiguous [nq, K, C] region of the grouped
//   output with common.cuh's write_grouped_span, group.cu's code: 16 bytes
//   a store where the span allows, each element grouped_value of the
//   gathered source and the query's centre (staged with the queries), the
//   stores marked evict-first (an output of 17-70 MB a stage would
//   otherwise push the gathered sources out of the L2). The idx never
//   makes a round trip through a second launch, and the epilogue takes no
//   shared memory of its own. Tried and dropped (PERF.md): each
//   group grouping its query as soon as its row is final, so that groups
//   write while others walk (lost where a block has few queries, sa3-sa4),
//   and two or four vectors a thread in flight (no gain).
#pragma once

#include <math.h>

#include <type_traits>

#include "z_slabs.cuh"

namespace tumseg {

constexpr int kMaxRadii = 4;  // kernels.BALL_QUERY_MAX_RADII

// Passed by value as a kernel parameter: R radii, r^2 rounded to f32, K and
// the output of each. The wrapper's ctypes structure has the same layout.
struct MultiRadii {
  int R;
  float r2[kMaxRadii];
  int K[kMaxRadii];
  int* out[kMaxRadii];
};

// The ball queries' epilogue: none.
struct NoGroup {};

// The fused ball query + group's epilogue: the grouped tensor out
// [B, S, K, C] (f32, or bf16 in the fast mode) of radius 0's idx, from src
// [B, N, C] (xyz first). magic gives t / C over a chunk's span (div_c), or
// is 0 where it would not be exact (kernels.fused_geometry).
template <typename T>
struct GroupRows {
  using Out = T;
  const float* src;
  T* out;
  int C;
  unsigned magic;
};

}  // namespace tumseg

namespace {

using tumseg::GroupRows;
using tumseg::kFull;
using tumseg::MultiRadii;
using tumseg::NoGroup;
using tumseg::Slabs;

constexpr int kThreads = 1024;  // kernels.BALL_QUERY_THREADS
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;  // kernels.BALL_QUERY_TILE
constexpr int kMaxSlabs = 512;   // kernels.BALL_QUERY_MAX_SLABS
constexpr int kSlabSources = 8;  // kernels.BALL_QUERY_SLAB_SOURCES
constexpr int kSmemPerBlock = 232448;  // the most a block may opt in to
constexpr int kMaxDevices = 64;

// Words a group keeps for one radius over a tile of `tile` sources: a
// 128-bit summary (bit w: word w of the mask is not zero), then the mask
// of the tile's bits, rounded to whole uint4s (kernels.ball_query_smem).
__host__ __device__ inline int radius_words(int tile) {
  return 4 + ((tile + 31) / 32 + 3) / 4 * 4;
}

// Dynamic shared memory of a block (kernels.ball_query_smem): the tile, the
// groups' masks, the Q queries' counts and coordinates.
__host__ __device__ inline size_t smem_bytes(int tile, int Q, int L, int R) {
  return 16 * static_cast<size_t>(tile) +
         4 * static_cast<size_t>(kThreads / L) * R * radius_words(tile) +
         4 * static_cast<size_t>(Q) * (R + 3);
}

// The staged sources [a, e) a query at qz must test: its own slab and the
// slabs out to, not including, the first non-empty slab on each side whose
// nearest z gives fl(dz*dz) > lim.
__device__ __forceinline__ int2 walk_range(const int* off, const int* lo,
                                           const int* hi, const Slabs& slabs,
                                           float qz, float lim) {
  const int home = slabs.slab_of(qz);
  int up = home + 1;
  for (; up < slabs.n; ++up) {
    if (off[up + 1] == off[up]) continue;
    const float dz = tumseg::unordered(lo[up]) - qz;
    if (dz * dz > lim) break;
  }
  int down = home - 1;
  for (; down >= 0; --down) {
    if (off[down + 1] == off[down]) continue;
    const float dz = tumseg::unordered(hi[down]) - qz;
    if (dz * dz > lim) break;
  }
  return make_int2(off[down + 1], off[up]);
}

// Appends the set bits of `bits` (tile indices j0 + 0..31) at o[pos..],
// below K.
__device__ __forceinline__ void append_bits(int* o, int& pos, int K,
                                            unsigned bits, int j0) {
  while (bits != 0u && pos < K) {
    o[pos++] = j0 + __ffs(bits) - 1;
    bits &= bits - 1u;
  }
}

// Rows of the grouping epilogue staged at a time in the shared memory that
// the tile and the groups' masks held: a source row and a query, 8 bytes
// (kernels.fused_chunk).
__device__ __forceinline__ int group_chunk(int tile, int L) {
  return (16 * tile + 4 * (kThreads / L) * radius_words(tile)) / 8;
}

// The grouping epilogue of the block's nq queries of row b, their K idx
// rows at `rows` (global, written by this block before a barrier: plain
// loads, never the read-only path), their coordinates at qs; `stage` is
// the freed shared memory, `chunk` rows of it.
template <typename T>
__device__ __forceinline__ void group_rows(const GroupRows<T>& g,
                                           const int* rows, const float* qs,
                                           int* stage, int chunk, int nq,
                                           int K, int N, int b,
                                           long long first_row) {
  const int C = g.C;
  const float* __restrict__ src = g.src + static_cast<size_t>(b) * N * C;
  int* row_src = stage;          // n, or -1: the row reads zeros
  int* row_query = stage + chunk;
  const int total = nq * K;
  for (int r0 = 0; r0 < total; r0 += chunk) {
    const int nr = total - r0 < chunk ? total - r0 : chunk;
    if (r0 > 0) __syncthreads();  // the previous chunk is written
    for (int i = threadIdx.x; i < nr; i += kThreads) {
      const int n = rows[r0 + i];
      row_src[i] = n >= 0 && n < N ? n : -1;
      row_query[i] = (r0 + i) / K;
    }
    __syncthreads();
    const long long base = (first_row + r0) * C;
    tumseg::write_grouped_span<true>(
        g.out + base, base, nr * C, C, g.magic, threadIdx.x, kThreads,
        [&](int row, int c) {
          const int n = row_src[row];
          const float v = n >= 0 ? src[static_cast<size_t>(n) * C + c] : 0.0f;
          return tumseg::grouped_value<T>(
              v, c < 3 ? qs[3 * row_query[row] + c] : 0.0f);
        });
  }
}

// Q queries a block, from blockIdx.x * Q of row blockIdx.y, a group of L
// lanes a query; sources in tiles of `tile`, walked through z-slabs or
// scanned. kR bounds radii.R. The kernels below are this and their
// epilogue.
template <int kR, typename Epilogue>
__device__ __forceinline__ void ball_query_block(
    const float* __restrict__ xyz, const float* __restrict__ new_xyz, int N,
    int S, int Q, int L, int tile, bool walk, const MultiRadii& radii,
    const Epilogue& epi) {
  extern __shared__ float4 dyn[];
  __shared__ int off[kMaxSlabs + 1];
  __shared__ int count[kMaxSlabs], lo[kMaxSlabs], hi[kMaxSlabs];
  __shared__ float range[2][kThreads / 32];

  const int R = kR == 1 ? 1 : radii.R;
  const int G = kThreads / L;  // groups, each on one query at a time
  const int rw = radius_words(tile);
  float4* src = dyn;
  unsigned* masks = reinterpret_cast<unsigned*>(dyn + tile);  // [G][R][rw]
  int* held = reinterpret_cast<int*>(masks + G * R * rw);     // [Q][R]
  float* qs = reinterpret_cast<float*>(held + Q * R);         // [Q][3]

  const int b = blockIdx.y;
  const int s0 = blockIdx.x * Q;
  const int nq = S - s0 < Q ? S - s0 : Q;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int g = t / L;
  const int i = t & (L - 1);  // lane within the group
  const unsigned gmask =
      L == 32 ? kFull : ((1u << L) - 1u) << (lane & ~(L - 1));
  for (int j = t; j < 3 * nq; j += kThreads)
    qs[j] = new_xyz[3 * (static_cast<size_t>(b) * S + s0) + j];
  for (int j = t; j < G * R * rw; j += kThreads) masks[j] = 0u;
  for (int j = t; j < nq * R; j += kThreads) held[j] = 0;
  unsigned* gm = masks + g * R * rw;  // this group's masks, [R][rw]

  const float* s = xyz + static_cast<size_t>(b) * N * 3;
  for (int base = 0; base < N; base += tile) {
    const int m = N - base < tile ? N - base : tile;
    Slabs slabs = {0.0f, 0.0f, 1};
    if (walk) {
      slabs = tumseg::stage_z_slabs<kThreads, kPerThread, kMaxSlabs>(
          s, base, m, tumseg::slab_count(m, kSlabSources, kMaxSlabs), src,
          off, count, lo, hi, range);
    } else {
      for (int j = t; j < m; j += kThreads) {
        const float* c = s + 3 * (base + j);
        src[j] = make_float4(c[0], c[1], c[2], __int_as_float(base + j));
      }
      __syncthreads();
    }

    bool short_after = false;  // some query of this group short of a K
    for (int q = g; q < nq; q += G) {  // uniform within the group
      const float qx = qs[3 * q], qy = qs[3 * q + 1], qz = qs[3 * q + 2];
      int cnt[kR];
      bool open[kR];
      bool any = false;
      float lim = -INFINITY;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        open[r] = false;
        if (r < R) {
          cnt[r] = held[q * R + r];
          open[r] = cnt[r] < radii.K[r];
          if (open[r]) lim = fmaxf(lim, radii.r2[r]);
          any = any || open[r];
        }
      }
      if (!any) continue;

      // mark the hits of each open radius in the group's masks
      int a = 0, e = m;
      if (walk) {
        const int2 ae = walk_range(off, lo, hi, slabs, qz, lim);
        a = ae.x;
        e = ae.y;
      }
      const float4* __restrict__ staged = src;  // apart from the masks
#pragma unroll 4
      for (int p = a + i; p < e; p += L) {
        const float4 c = staged[p];
        const float d = tumseg::sqdist(c.x, c.y, c.z, qx, qy, qz);
        const int jt = __float_as_int(c.w) - base;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (open[r] && d <= radii.r2[r]) {
            unsigned* mk = gm + r * rw;
            atomicOr(&mk[4 + (jt >> 5)], 1u << (jt & 31));
            atomicOr(&mk[jt >> 10], 1u << ((jt >> 5) & 31));
          }
        }
      }
      __syncwarp(gmask);

      // append each open radius' hits to the query's output row in index
      // order: the group's lanes take the mask's non-zero words by rank (the
      // summary's set bits), L at a time, and place their bits by a prefix
      // sum; words and summary are cleared behind them
      const size_t query = static_cast<size_t>(b) * S + s0 + q;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (!open[r]) continue;
        unsigned* mk = gm + r * rw;
        const uint4 sum = *reinterpret_cast<const uint4*>(mk);
        const int n0 = __popc(sum.x), n1 = __popc(sum.y), n2 = __popc(sum.z);
        const int nz = n0 + n1 + n2 + __popc(sum.w);
        if (nz == 0) continue;  // uniform within the group
        const int K = radii.K[r];
        int* o = radii.out[r] + query * K;
        int got = 0;  // this tile's hits placed so far
        for (int k0 = 0; k0 < nz; k0 += L) {
          const int k = k0 + i;
          unsigned bits = 0u;
          int j0 = 0;  // the tile index of the word's bit 0
          if (k < nz) {
            int kk = k, word;
            unsigned s32;
            if (kk < n0) {
              word = 0, s32 = sum.x;
            } else if ((kk -= n0) < n1) {
              word = 32, s32 = sum.y;
            } else if ((kk -= n1) < n2) {
              word = 64, s32 = sum.z;
            } else {
              kk -= n2, word = 96, s32 = sum.w;
            }
            word += __fns(s32, 0, kk + 1);
            bits = mk[4 + word];
            mk[4 + word] = 0u;
            j0 = base + 32 * word;
          }
          const int c = __popc(bits);
          int incl = c;
          for (int step = 1; step < L; step <<= 1) {
            const int v = __shfl_up_sync(gmask, incl, step, L);
            if (i >= step) incl += v;
          }
          int pos = cnt[r] + got + incl - c;
          append_bits(o, pos, K, bits, j0);
          got += __shfl_sync(gmask, incl, L - 1, L);
        }
        *reinterpret_cast<uint4*>(mk) = make_uint4(0u, 0u, 0u, 0u);
        cnt[r] += got;
        if (i == 0) held[q * R + r] = cnt[r];
      }
#pragma unroll
      for (int r = 0; r < kR; ++r)
        short_after = short_after || (r < R && cnt[r] < radii.K[r]);
      __syncwarp(gmask);
    }
    // a barrier either way: the next tile overwrites the staged sources
    if (!__syncthreads_or(short_after)) break;
  }

  // the rest of the block's rows of each radius, one contiguous [nq, K]
  // region of the output, in coalesced stores: a short ball repeats its
  // first (smallest) hit, read back from the row (the barrier above makes
  // the block's stores visible), an empty one holds N
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r >= R) continue;
    const int K = radii.K[r];
    int* o = radii.out[r] + (static_cast<size_t>(b) * S + s0) * K;
    for (int e = t; e < nq * K; e += kThreads) {
      const int q = e / K;
      const int c = held[q * R + r];
      if (e - q * K >= c) o[e] = c == 0 ? N : o[q * K];
    }
  }

  if constexpr (!std::is_same<Epilogue, NoGroup>::value) {
    __syncthreads();  // the rows' fill is visible; the tile and masks free
    group_rows(epi, radii.out[0] + (static_cast<size_t>(b) * S + s0) *
                                       radii.K[0],
               qs, reinterpret_cast<int*>(dyn), group_chunk(tile, L), nq,
               radii.K[0], N, b,
               (static_cast<long long>(b) * S + s0) * radii.K[0]);
  }
}

template <int kR>
__global__ void __launch_bounds__(kThreads, 1)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ new_xyz, int N, int S, int Q,
                  int L, int tile, bool walk, const MultiRadii radii) {
  ball_query_block<kR>(xyz, new_xyz, N, S, Q, L, tile, walk, radii,
                       NoGroup{});
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_ball_group_kernel(const float* __restrict__ xyz,
                        const float* __restrict__ new_xyz, int N, int S,
                        int Q, int L, int tile, bool walk,
                        const MultiRadii radii, const GroupRows<T> epi) {
  ball_query_block<1>(xyz, new_xyz, N, S, Q, L, tile, walk, radii, epi);
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// Launches ball_query_kernel<kR> (or, with a GroupRows epilogue, the fused
// kernel, one radius) on `stream` at geometry (Q, L, tile, walk);
// cudaErrorInvalidValue for a geometry or radii it cannot run.
template <int kR, typename Epilogue = NoGroup>
int launch_ball_query(const float* xyz, const float* new_xyz,
                      const MultiRadii& radii, int B, int N, int S, int Q,
                      int L, int tile, int walk, void* stream,
                      const Epilogue& epi = Epilogue()) {
  constexpr bool kGroup = !std::is_same<Epilogue, NoGroup>::value;
  if (B == 0 || S == 0) return 0;
  if (radii.R < 1 || radii.R > kR || Q < 1 || Q > kThreads || !pow2(L) ||
      L > 32 || tile < 1 || tile > kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int r = 0; r < radii.R; ++r)
    if (radii.K[r] < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = [] {
    if constexpr (kGroup)
      return fused_ball_group_kernel<typename Epilogue::Out>;
    else
      return ball_query_kernel<kR>;
  }();
  // above 48 KB of dynamic shared memory only once allowed, per device
  static int allowed[kMaxDevices];
  int device = 0;
  cudaGetDevice(&device);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (allowed[device] == 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int most = kSmemPerBlock - static_cast<int>(attr.sharedSizeBytes);
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = most;
  }
  const size_t bytes = smem_bytes(tile, Q, L, radii.R);
  if (bytes > static_cast<size_t>(allowed[device]))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + Q - 1) / Q, B);
  const auto s = static_cast<cudaStream_t>(stream);
  if constexpr (kGroup)
    kernel<<<grid, kThreads, bytes, s>>>(xyz, new_xyz, N, S, Q, L, tile,
                                         walk != 0, radii, epi);
  else
    kernel<<<grid, kThreads, bytes, s>>>(xyz, new_xyz, N, S, Q, L, tile,
                                         walk != 0, radii);
  return tumseg::last_error();
}

}  // namespace
