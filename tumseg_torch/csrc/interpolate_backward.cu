// Backward of the inverse-distance interpolation with respect to points2:
// idx [B, N, 3] i32 in [0, S), w [B, N, 3] f32, grad [B, N, D] f32 ->
// dp2 [B, S, D] f32 = W^T g, i.e.
//   dp2[b, s, d] = sum over (n, k) with idx[b, n, k] == s of
//                  w[b, n, k] * grad[b, n, d].
// The fast mode rounds w and grad to bf16 before the f32 product, as the
// single bf16 pass of interpolate.py:136-148 does. The caller zeroes dp2.
// The weights and indices are constants of the coordinates and get no
// gradient, as in tumseg/ops/pallas/interpolate.py:127-131.
//
// Replaces tumseg/ops/pallas/interpolate.py:_interp_bwd_kernel, which builds
// the [N_t, S] weight matrix of each query tile in VMEM and accumulates
// W^T g on the MXU over the tiles of its sequential grid.
//
// What bounds it: bytes, plus atomic contention. Each cotangent element is
// one coalesced 4-byte load and three atomicAdds (fp1 at B=16: 8.4M loads
// and 25M adds into a 16*1024*128 = 2.1M-element dp2). Each source is among
// the three nearest of about 3*N/S queries (12 at fp1 to fp4), so about
// that many adds meet at each address of dp2 and serialise in L2.
// Design: one thread per cotangent element, d fastest, so a warp reads
// consecutive grad addresses, the three (index, weight) pairs of its query
// are one broadcast load, and its adds for one source row land on
// consecutive addresses. f32 atomics commit in an order that changes from
// run to run, so the low bits of dp2 do too; a deterministic variant (a
// counting sort of the inverse index) is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
interpolate_backward_kernel(const int* __restrict__ idx,
                            const float* __restrict__ w,
                            const float* __restrict__ grad,
                            float* __restrict__ dp2, int N, int S, int D,
                            long long total, bool fast) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const int d = static_cast<int>(t % D);
    const long long q = t / D;  // b*N + n
    const long long b = q / N;
    const float g = fast ? tumseg::bf16_round(grad[t]) : grad[t];
    float* out = dp2 + b * S * D + d;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int s = idx[3 * q + k];
      if (s >= 0 && s < S) {
        float wk = w[3 * q + k];
        if (fast) wk = tumseg::bf16_round(wk);
        atomicAdd(out + static_cast<long long>(s) * D, wk * g);
      }
    }
  }
}

}  // namespace

TUMSEG_API int tumseg_interpolate_backward(const int* idx, const float* w,
                                           const float* grad, float* dp2,
                                           int B, int N, int S, int D,
                                           int fast, void* stream) {
  const long long total = static_cast<long long>(B) * N * D;
  if (total == 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  interpolate_backward_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      idx, w, grad, dp2, N, S, D, total, fast != 0);
  return tumseg::last_error();
}
