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
// subtracted in f32, and the difference stored rounded to bf16. group.cu and
// the fused ball query + group (ball_query.cuh's grouping epilogue) both
// compute it here and store it through write_grouped_span below.
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

// 16 bytes of a grouped output: 4 f32 or 8 bf16 elements, packed for one
// store.
template <typename T>
struct GroupedVector;
template <>
struct GroupedVector<float> {
  static constexpr int kSize = 4;
  static __device__ __forceinline__ float4 pack(const float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct GroupedVector<__nv_bfloat16> {
  static constexpr int kSize = 8;
  static __device__ __forceinline__ unsigned pack(__nv_bfloat16 lo,
                                                  __nv_bfloat16 hi) {
    return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
           (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
  }
  static __device__ __forceinline__ uint4 pack(const __nv_bfloat16 (&v)[8]) {
    return make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]),
                      pack(v[6], v[7]));
  }
};

// t / C for 0 <= t < a span's length: the multiply-high is exact there
// when magic != 0 (the caller leaves it 0 where it would not be; see
// ops/kernels.py:group_geometry).
__device__ __forceinline__ int div_c(int t, int C, unsigned magic) {
  return magic ? static_cast<int>(__umulhi(static_cast<unsigned>(t), magic))
               : t / C;
}

// Writes the span [0, len) of a grouped output [rows, C] that starts at
// element `base` of an output 16-byte aligned (span = out + base): element
// t is (row, c) = divmod(t, C) (div_c with `magic`) and holds
// value(row, c), a T. Lanes 0..lanes-1 (`lane` this thread's) write 16
// bytes at a time (4 f32 or 8 bf16 elements, 16-byte aligned, each
// vector's first (row, c) by one division and the rest by stepping c); the
// span's ragged head and tail, where its ends are not on a 16-byte
// boundary, take scalar stores. kStream marks the vectors evict-first in
// L2 (st.global.cs), so that an output larger than the L2 does not evict
// the sources its gathers read.
template <bool kStream = false, typename T, typename Value>
__device__ __forceinline__ void write_grouped_span(T* __restrict__ span,
                                                   long long base, int len,
                                                   int C, unsigned magic,
                                                   int lane, int lanes,
                                                   Value value) {
  constexpr int V = GroupedVector<T>::kSize;
  const int head = min(static_cast<int>((V - base % V) % V), len);
  const int nvec = (len - head) / V;
  for (int j = lane; j < nvec; j += lanes) {
    const int t = head + j * V;
    int row = div_c(t, C, magic);
    int c = t - row * C;
    T v[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      v[e] = value(row, c);
      if (++c == C) {
        c = 0;
        ++row;
      }
    }
    using Packed = decltype(GroupedVector<T>::pack(v));
    Packed* to = reinterpret_cast<Packed*>(span + t);
    if constexpr (kStream)
      __stcs(to, GroupedVector<T>::pack(v));
    else
      *to = GroupedVector<T>::pack(v);
  }
  const int tail = head + nvec * V;
  const int ragged = head + (len - tail);
  for (int j = lane; j < ragged; j += lanes) {
    const int t = j < head ? j : tail + (j - head);
    const int row = div_c(t, C, magic);
    span[t] = value(row, t - row * C);
  }
}

}  // namespace tumseg
