// Neighbourhood grouping: idx [B, S, K] i32, src [B, N, C] f32 (xyz first),
// centers [B, S, 3] f32 -> out [B, S, K, C] with
//   out[b,s,k,c] = src[b, idx[b,s,k], c] - (c < 3 ? centers[b,s,c] : 0),
// f32, or in the fast mode bf16: bf16(f32(bf16(src)) - centre)
// (common.cuh's store_grouped).
//
// Replaces tumseg/ops/pallas/group.py:_group_fwd_kernel, which gathers with a
// one-hot contraction on the MXU (split into three bf16 passes to stay exact,
// or one pass and a bf16 store in its fast mode, exact=False), and the
// centroid gather tumseg/ops/__init__.py:gather_rows that reuses it with K=1
// and zero centers, always exact. An index outside [0, N) (the empty-ball
// sentinel N) matches no one-hot column there and reads a zero row here.
//
// What bounds it: bytes. Each output element is one 4-byte store (2 in the
// fast mode) and one gathered 4-byte load (sa2: 17.6M elements at B=32),
// with no arithmetic but the centre subtraction, which is exact in f32 as it
// is on the TPU.
// Design: one thread per output element, c fastest, so a warp stores
// consecutive addresses and reads whole source rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_kernel(const int* __restrict__ idx, const float* __restrict__ src,
             const float* __restrict__ centers, T* __restrict__ out, int N,
             int S, int K, int C, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const int c = static_cast<int>(t % C);
    const long long row = t / C;   // (b*S + s)*K + k
    const long long bs = row / K;  // b*S + s
    const long long b = bs / S;
    const int n = idx[row];
    const float v = (n >= 0 && n < N) ? src[(b * N + n) * C + c] : 0.0f;
    tumseg::store_grouped(out + t, v, c < 3 ? centers[bs * 3 + c] : 0.0f);
  }
}

template <typename T>
int launch(const int* idx, const float* src, const float* centers, void* out,
           int N, int S, int K, int C, long long total, cudaStream_t stream) {
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  group_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      idx, src, centers, static_cast<T*>(out), N, S, K, C, total);
  return tumseg::last_error();
}

}  // namespace

// out is f32, or bf16 when fast != 0.
TUMSEG_API int tumseg_group(const int* idx, const float* src,
                            const float* centers, void* out, int B, int N,
                            int S, int K, int C, int fast, void* stream) {
  const long long total = static_cast<long long>(B) * S * K * C;
  if (total == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch<__nv_bfloat16>(idx, src, centers, out, N, S, K, C,
                                      total, s)
              : launch<float>(idx, src, centers, out, N, S, K, C, total, s);
}
