// Neighbourhood grouping: idx [B, S, K] i32, src [B, N, C] f32 (xyz first),
// centers [B, S, 3] f32 -> out [B, S, K, C] with
//   out[b,s,k,c] = src[b, idx[b,s,k], c] - (c < 3 ? centers[b,s,c] : 0),
// f32, or in the fast mode bf16: bf16(f32(bf16(src)) - centre)
// (common.cuh's grouped_value). Any B, N, S, K and C >= 3 with B*S*K and
// B*N below 2^31 - 1024; out must be 16-byte aligned (torch.empty is).
//
// Replaces tumseg/ops/pallas/group.py:_group_fwd_kernel, which gathers with a
// one-hot contraction on the MXU (split into three bf16 passes to stay exact,
// or one pass and a bf16 store in its fast mode, exact=False), and the
// centroid gather tumseg/ops/__init__.py:gather_rows that reuses it with K=1
// and zero centers, always exact. An index outside [0, N) (the empty-ball
// sentinel N) matches no one-hot column there and reads a zero row here.
//
// What bounds it: bytes. The output is written once, B*S*K*C elements (sa2
// of the B=32 forward: 17.6M, 70 MB in f32), against one 4-byte index a row
// (b, s, k) and source rows that stay in the 50 MB L2 (a stage's src is at
// most 8.8 MB), so the floor is the store stream: 0.056 ms over sa1-sa4 and
// the centroid gathers at 3.35 TB/s. What keeps a kernel from that floor
// is per-element work: a division by C and a reload of the row's index
// and centre for every element make it bound by instructions.
// Design: a block takes R consecutive rows, whose R*C outputs are one
// contiguous span, with R*C about 4096 (R <= 1024, fewer where the grid
// would not give each SM two blocks). Its threads first stage each row's
// source row (b*N + n, or -1 for an index outside [0, N)) and centre in
// shared memory, one division a row. Then each thread writes 16 bytes at a
// time (4 f32 or 8 bf16 elements, 16-byte aligned): the position of a
// vector's first element splits into (row, c) by a 32-bit multiply-high with
// a constant for C that the wrapper computes (ops/kernels.py:group_geometry),
// the rest by stepping c. A span's ragged head and tail, where its ends are
// not on a 16-byte boundary, take scalar stores. Source rows are read by
// consecutive lanes at consecutive (row, c), so each gathered row is read
// whole.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 1024;  // ops/kernels.py:GROUP_MAX_ROWS

// 16 bytes of output: 4 f32 or 8 bf16 elements.
template <typename T>
struct Vector;
template <>
struct Vector<float> {
  static constexpr int kSize = 4;
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vector<__nv_bfloat16> {
  static constexpr int kSize = 8;
  static __device__ __forceinline__ unsigned pack(__nv_bfloat16 lo,
                                                  __nv_bfloat16 hi) {
    return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
           (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const __nv_bfloat16 (&v)[8]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]),
                   pack(v[6], v[7]));
  }
};

// The rows of one block.
struct Rows {
  int src[kMaxRows];  // b*N + n, or -1: the row reads zeros
  float centre[kMaxRows][3];
};

// t / C for 0 <= t < the block's span: the multiply-high is exact there
// when magic != 0 (the wrapper leaves it 0 where it would not be).
__device__ __forceinline__ int div_c(int t, int C, unsigned magic) {
  return magic ? static_cast<int>(__umulhi(static_cast<unsigned>(t), magic))
               : t / C;
}

template <typename T>
__device__ __forceinline__ T element(const Rows& rows,
                                     const float* __restrict__ src, int row,
                                     int c, int C) {
  const int r = rows.src[row];
  const float v = r >= 0 ? src[static_cast<size_t>(r) * C + c] : 0.0f;
  return tumseg::grouped_value<T>(v, c < 3 ? rows.centre[row][c] : 0.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_kernel(const int* __restrict__ idx, const float* __restrict__ src,
             const float* __restrict__ centers, T* __restrict__ out, int N,
             int S, int K, int C, int total_rows, int rows_per_block,
             unsigned magic) {
  __shared__ Rows rows;
  const int r0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, total_rows - r0);
  for (int i = threadIdx.x; i < nrows; i += kThreads) {
    const unsigned r = r0 + i;
    const unsigned bs = r / static_cast<unsigned>(K);  // b*S + s
    const int b = static_cast<int>(bs / static_cast<unsigned>(S));
    const int n = idx[r];
    rows.src[i] = (n >= 0 && n < N) ? b * N + n : -1;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      rows.centre[i][c] = centers[3 * static_cast<size_t>(bs) + c];
    }
  }
  __syncthreads();

  constexpr int V = Vector<T>::kSize;
  const long long base = static_cast<long long>(r0) * C;
  T* span = out + base;
  const int len = nrows * C;
  const int head = min(static_cast<int>((V - base % V) % V), len);
  const int nvec = (len - head) / V;
  for (int j = threadIdx.x; j < nvec; j += kThreads) {
    const int t = head + j * V;
    int row = div_c(t, C, magic);
    int c = t - row * C;
    T v[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      v[e] = element<T>(rows, src, row, c, C);
      if (++c == C) {
        c = 0;
        ++row;
      }
    }
    Vector<T>::store(span + t, v);
  }
  const int tail = head + nvec * V;
  const int ragged = head + (len - tail);
  for (int j = threadIdx.x; j < ragged; j += kThreads) {
    const int t = j < head ? j : tail + (j - head);
    const int row = div_c(t, C, magic);
    span[t] = element<T>(rows, src, row, t - row * C, C);
  }
}

template <typename T>
int launch(const int* idx, const float* src, const float* centers, void* out,
           int N, int S, int K, int C, int total_rows, int rows_per_block,
           unsigned magic, cudaStream_t stream) {
  const int blocks = (total_rows + rows_per_block - 1) / rows_per_block;
  group_kernel<T><<<blocks, kThreads, 0, stream>>>(
      idx, src, centers, static_cast<T*>(out), N, S, K, C, total_rows,
      rows_per_block, magic);
  return tumseg::last_error();
}

}  // namespace

// out is f32, or bf16 when fast != 0. rows_per_block and c_magic come from
// ops/kernels.py:group_geometry(B*S*K, C).
TUMSEG_API int tumseg_group(const int* idx, const float* src,
                            const float* centers, void* out, int B, int N,
                            int S, int K, int C, int rows_per_block,
                            int c_magic, int fast, void* stream) {
  const long long rows = static_cast<long long>(B) * S * K;
  if (rows == 0) return 0;
  if (rows > INT_MAX - kMaxRows || static_cast<long long>(B) * N > INT_MAX ||
      C < 3 || rows_per_block < 1 || rows_per_block > kMaxRows ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned magic = static_cast<unsigned>(c_magic);
  const int total = static_cast<int>(rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch<__nv_bfloat16>(idx, src, centers, out, N, S, K, C,
                                      total, rows_per_block, magic, s)
              : launch<float>(idx, src, centers, out, N, S, K, C, total,
                              rows_per_block, magic, s);
}
