// Backward of neighbourhood grouping with respect to the source rows:
// idx [B, S, K] i32 in [0, N], grad [B, S, K, C] f32 -> dsrc [B, N, C] f32,
//   dsrc[b, n, c] = sum over (s, k) with idx[b, s, k] == n of grad[b, s, k, c].
// The fast mode (the backward of group.cu's bf16 output) takes a bf16 or an
// f32 cotangent and rounds each element to bf16 before the f32 add, as the
// fast _group_bwd_kernel's single bf16 pass does.
// The caller zeroes dsrc. The empty-ball sentinel idx == N (and any index
// outside [0, N)) adds nothing, as it matches no one-hot column on the TPU.
// The centres get no gradient, as in tumseg/ops/pallas/group.py:155-158.
//
// Replaces tumseg/ops/pallas/group.py:_group_bwd_kernel, which contracts the
// transposed cotangent with an [R, N] one-hot on the MXU and accumulates the
// R tiles of its sequential grid into one [C, N] block (exact=True through a
// 3-way bf16 split, exact=False in one bf16 pass).
//
// What bounds it: bytes, plus atomic contention. Each cotangent element is
// one coalesced 4-byte load and one atomicAdd (sa2 at B=16: 16*256*32*67 =
// 8.8M of each into a 16*1024*67 = 1.1M-element dsrc). A row that many
// balls hold (a point inside many overlapping balls, or the first hit that
// pads a short ball up to K) takes many adds to the same addresses, and
// those serialise in L2.
// Design: one thread per cotangent element, c fastest, so a warp reads
// consecutive addresses and its adds for one source row land on consecutive
// addresses of dsrc. f32 atomics commit in an order that changes from run to
// run, so the low bits of dsrc do too; a deterministic variant (a counting
// sort of the inverse index, then one ordered sum per row) is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename G>
__global__ void __launch_bounds__(kThreads)
group_backward_kernel(const int* __restrict__ idx, const G* __restrict__ grad,
                      float* __restrict__ dsrc, int N, int R, int C,
                      long long total, bool fast) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const int c = static_cast<int>(t % C);
    const long long row = t / C;  // b*R + (s*K + k)
    const long long b = row / R;
    const int n = idx[row];
    if (n >= 0 && n < N) {
      float g = tumseg::to_float(grad[t]);
      if (fast) g = tumseg::bf16_round(g);
      atomicAdd(&dsrc[(b * N + n) * C + c], g);
    }
  }
}

}  // namespace

// grad is bf16 when grad_bf16 != 0 (fast mode only), else f32.
TUMSEG_API int tumseg_group_backward(const int* idx, const void* grad,
                                     float* dsrc, int B, int N, int S, int K,
                                     int C, int grad_bf16, int fast,
                                     void* stream) {
  const long long total = static_cast<long long>(B) * S * K * C;
  if (total == 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  const unsigned grid = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grad_bf16) {
    group_backward_kernel<<<grid, kThreads, 0, s>>>(
        idx, static_cast<const __nv_bfloat16*>(grad), dsrc, N, S * K, C,
        total, fast != 0);
  } else {
    group_backward_kernel<<<grid, kThreads, 0, s>>>(
        idx, static_cast<const float*>(grad), dsrc, N, S * K, C, total,
        fast != 0);
  }
  return tumseg::last_error();
}
