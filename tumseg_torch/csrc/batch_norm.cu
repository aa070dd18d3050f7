// BatchNorm + ReLU, the epilogue of every Dense layer of the models
// (tumseg_torch/nn/layers.py:BatchNorm), over a contiguous [M, C] f32
// activation x (C channels on the last axis, M rows), bitwise the eager ops
// of ops/core.py:batch_norm and of autograd's backward of them:
//
//   tumseg_bn_apply           y = relu?((x - mean) * inv + bias), stored
//                             f32 or bf16 (eval and training forward)
//   tumseg_bn_backward_terms  gz = (z <= 0 ? 0 : g) with the ReLU (else g),
//                             gz * (x - mean) and gz * inv, each [M, C] f32
//   tumseg_bn_backward_dx     dx = ((gz * inv + p) + p) + q, p = ks * x,
//                             q = kmu (training)
//
// with inv = rsqrt(var + eps) * weight, z = (x - mean) * inv + bias
// recomputed from the saved x (no y, no mask kept), g the cotangent (f32,
// or bf16 where y was stored bf16), and ks, kmu [C] the gradients of
// E[x^2] and E[x] over M, which the [C] ops of ops/autograd.py:
// BatchNormReLU compute from the three terms' sums.
//
// Replaces no Pallas kernel: tumseg leaves BatchNorm and ReLU to XLA, which
// fuses them into the GEMMs' neighbours (tumseg/nn/layers.py:82-116). In the
// port they were eager PyTorch ops: in eval three broadcast passes (- mean,
// * inv, + bias) and a ReLU, each a full read and write of [M, C] f32 (32
// bytes an element); a training step about 170 bytes an element in some 25
// passes, forward and autograd's backward.
//
// What bounds it: bytes. The apply reads x and writes y: 8 bytes an element
// (6 with a bf16 y), 0.80 ms for the SSG forward's 336.6M elements at B=32
// at 3.35 TB/s. A training step's sums stay PyTorch's reductions, over x,
// x * x and the three terms (their order is PyTorch's: a sum in any other
// order, even an exact one, moves a seeded run's Adam trajectory by as much
// as bf16 compute does, which the benchmark's training check refuses), so a
// step moves 68 bytes an element: x * x (8), two means (8), the apply (8),
// the terms (20), their three sums (12), dx (12).
// Design: a block of 256 threads walks rows of x, each thread one 16-byte
// column vector (4 channels; 1 where C % 4 != 0 or a pointer is not
// 16-byte aligned) of rows r0, r0 + R, ... (R = 256 / (C / 4) rows a block
// steps; blockIdx.y takes the column tiles where C / 4 > 256), so a warp
// reads whole rows, with 4 rows' loads in flight a thread; each thread keeps
// its channels' constants in registers for the whole walk. Every operation
// is the eager one, in its order, rounded alone (the _rn intrinsics; the
// library is also built with -fmad=false): the ReLU is torch's clamp_min
// (NaN passes), its backward threshold_backward's (g passes unless y <= 0),
// and dx sums autograd's four contributions to x's gradient in the order
// its engine adds them (x - mean's, then x * x's two, then mean's); a bf16
// y rounds to nearest even, as .to(torch.bfloat16) does.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // ops/kernels.py:BN_THREADS
constexpr int kUnroll = 4;     // rows a thread loads before it stores

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// V consecutive elements at p (16-byte aligned f32, or 8-byte aligned bf16
// when V == 4) as f32.
template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&v)[V]) {
  if constexpr (V == 4 && std::is_same<T, float>::value) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (V == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __bfloat162float(__ushort_as_bfloat16(t.x & 0xffffu));
    v[1] = __bfloat162float(__ushort_as_bfloat16(t.x >> 16));
    v[2] = __bfloat162float(__ushort_as_bfloat16(t.y & 0xffffu));
    v[3] = __bfloat162float(__ushort_as_bfloat16(t.y >> 16));
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = load1(p + e);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = v[e];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* __restrict__ p,
                                          const float (&v)[V]) {
  if constexpr (V == 4) {
    using Pack = tumseg::GroupedVector<__nv_bfloat16>;
    *reinterpret_cast<uint2*>(p) =
        make_uint2(Pack::pack(__float2bfloat16_rn(v[0]),
                              __float2bfloat16_rn(v[1])),
                   Pack::pack(__float2bfloat16_rn(v[2]),
                              __float2bfloat16_rn(v[3])));
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = __float2bfloat16_rn(v[e]);
  }
}

template <int V>
__device__ __forceinline__ void load_consts(const float* __restrict__ a,
                                            int c0, float (&v)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = __ldg(a + c0 + e);
}

// A thread's place: column vector j of the [M, C / V] vector view (its
// channels j*V .. j*V + V - 1), first row r0 of its block's rows, R rows a
// block steps; active is false for the threads past the last column tile
// or past R rows.
struct Place {
  int j, r0, R;
  bool active;
};

__device__ __forceinline__ Place place(int Cv) {
  const int tile = min(Cv, kThreads);
  Place p;
  p.R = kThreads / tile;
  p.r0 = threadIdx.x / tile;
  p.j = blockIdx.y * tile + (threadIdx.x - p.r0 * tile);
  p.active = p.r0 < p.R && p.j < Cv;
  return p;
}

// z = (x - mean) * inv + bias in the eager order, each operation rounded.
__device__ __forceinline__ float normalise(float x, float mean, float inv,
                                           float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), inv), bias);
}

// torch's relu (clamp_min(0)): NaN passes.
__device__ __forceinline__ float relu(float z) {
  return isnan(z) ? z : fmaxf(z, 0.0f);
}

// -------------------------------------------------------------- bn_apply

template <typename Out, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ inv,
                const float* __restrict__ bias, Out* __restrict__ y, int M,
                int C) {
  const Place p = place(C / V);
  if (!p.active) return;
  const int c0 = p.j * V;
  float m[V], s[V], b[V];
  load_consts(mean, c0, m);
  load_consts(inv, c0, s);
  load_consts(bias, c0, b);
  const long long step = static_cast<long long>(gridDim.x) * p.R;
  for (long long row = static_cast<long long>(blockIdx.x) * p.R + p.r0;
       row < M; row += kUnroll * step) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = row + u * step;
      if (r < M) load_vec<V>(x + r * C + c0, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = row + u * step;
      if (r >= M) break;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float z = normalise(v[u][e], m[e], s[e], b[e]);
        v[u][e] = kRelu ? relu(z) : z;
      }
      store_vec<V>(y + r * C + c0, v[u]);
    }
  }
}

// ------------------------------------------------------ bn_backward_terms

template <typename G, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bn_backward_terms_kernel(const G* __restrict__ g, const float* __restrict__ x,
                         const float* __restrict__ mean,
                         const float* __restrict__ inv,
                         const float* __restrict__ bias,
                         float* __restrict__ gz, float* __restrict__ gzd,
                         float* __restrict__ gzi, int M, int C) {
  const Place p = place(C / V);
  if (!p.active) return;
  const int c0 = p.j * V;
  float m[V], s[V], b[V];
  load_consts(mean, c0, m);
  load_consts(inv, c0, s);
  load_consts(bias, c0, b);
  const long long step = static_cast<long long>(gridDim.x) * p.R;
  for (long long row = static_cast<long long>(blockIdx.x) * p.R + p.r0;
       row < M; row += kUnroll * step) {
    float gv[kUnroll][V], xv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = row + u * step;
      if (r < M) {
        load_vec<V>(g + r * C + c0, gv[u]);
        load_vec<V>(x + r * C + c0, xv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = row + u * step;
      if (r >= M) break;
      float d[V], gd[V], gi[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        d[e] = __fsub_rn(xv[u][e], m[e]);
        if (kRelu && __fadd_rn(__fmul_rn(d[e], s[e]), b[e]) <= 0.0f)
          gv[u][e] = 0.0f;
        gd[e] = __fmul_rn(gv[u][e], d[e]);
        gi[e] = __fmul_rn(gv[u][e], s[e]);
      }
      const long long at = r * C + c0;
      store_vec<V>(gz + at, gv[u]);
      store_vec<V>(gzd + at, gd);
      store_vec<V>(gzi + at, gi);
    }
  }
}

// --------------------------------------------------------- bn_backward_dx

template <int V>
__global__ void __launch_bounds__(kThreads)
bn_backward_dx_kernel(const float* __restrict__ gzi,
                      const float* __restrict__ x,
                      const float* __restrict__ ks,
                      const float* __restrict__ kmu, float* __restrict__ dx,
                      int M, int C) {
  const Place p = place(C / V);
  if (!p.active) return;
  const int c0 = p.j * V;
  float a[V], q[V];
  load_consts(ks, c0, a);
  load_consts(kmu, c0, q);
  const long long step = static_cast<long long>(gridDim.x) * p.R;
  for (long long row = static_cast<long long>(blockIdx.x) * p.R + p.r0;
       row < M; row += kUnroll * step) {
    float gv[kUnroll][V], xv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = row + u * step;
      if (r < M) {
        load_vec<V>(gzi + r * C + c0, gv[u]);
        load_vec<V>(x + r * C + c0, xv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = row + u * step;
      if (r >= M) break;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float px = __fmul_rn(a[e], xv[u][e]);
        gv[u][e] =
            __fadd_rn(__fadd_rn(__fadd_rn(gv[u][e], px), px), q[e]);
      }
      store_vec<V>(dx + r * C + c0, gv[u]);
    }
  }
}

// ------------------------------------------------------------- launchers

bool bad_shape(int M, int C, int vec, int blocks) {
  return M < 0 || C < 1 || blocks < 1 || (vec && C % 4 != 0);
}

dim3 bn_grid(int blocks, int C, int V) {
  const int Cv = C / V;
  const int tile = Cv < kThreads ? Cv : kThreads;
  return dim3(blocks, (Cv + tile - 1) / tile);
}

template <typename Out, int V>
int launch_apply(const float* x, const float* mean, const float* inv,
                 const float* bias, void* y, int M, int C, int relu,
                 int blocks, cudaStream_t s) {
  Out* out = static_cast<Out*>(y);
  const dim3 grid = bn_grid(blocks, C, V);
  if (relu)
    bn_apply_kernel<Out, V, true>
        <<<grid, kThreads, 0, s>>>(x, mean, inv, bias, out, M, C);
  else
    bn_apply_kernel<Out, V, false>
        <<<grid, kThreads, 0, s>>>(x, mean, inv, bias, out, M, C);
  return tumseg::last_error();
}

template <typename G, int V>
int launch_terms(const void* g, const float* x, const float* mean,
                 const float* inv, const float* bias, float* gz, float* gzd,
                 float* gzi, int M, int C, int relu, int blocks,
                 cudaStream_t s) {
  const G* gt = static_cast<const G*>(g);
  const dim3 grid = bn_grid(blocks, C, V);
  if (relu)
    bn_backward_terms_kernel<G, V, true><<<grid, kThreads, 0, s>>>(
        gt, x, mean, inv, bias, gz, gzd, gzi, M, C);
  else
    bn_backward_terms_kernel<G, V, false><<<grid, kThreads, 0, s>>>(
        gt, x, mean, inv, bias, gz, gzd, gzi, M, C);
  return tumseg::last_error();
}

}  // namespace

// y [M, C]: f32, or bf16 when out_bf16 != 0. vec != 0 takes 16-byte column
// vectors (C % 4 == 0 and x and y 16-byte aligned), else single channels;
// blocks (the grid's x) from ops/kernels.py:bn_blocks.
TUMSEG_API int tumseg_bn_apply(const float* x, const float* mean,
                               const float* inv, const float* bias, void* y,
                               int M, int C, int relu, int out_bf16, int vec,
                               int blocks, void* stream) {
  if (bad_shape(M, C, vec, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return vec ? launch_apply<__nv_bfloat16, 4>(x, mean, inv, bias, y, M, C,
                                                relu, blocks, s)
               : launch_apply<__nv_bfloat16, 1>(x, mean, inv, bias, y, M, C,
                                                relu, blocks, s);
  return vec ? launch_apply<float, 4>(x, mean, inv, bias, y, M, C, relu,
                                      blocks, s)
             : launch_apply<float, 1>(x, mean, inv, bias, y, M, C, relu,
                                      blocks, s);
}

// g [M, C] f32, or bf16 when g_bf16 != 0; x [M, C] and mean, inv, bias [C]
// f32 -> gz, gzd = gz * (x - mean), gzi = gz * inv, each [M, C] f32.
TUMSEG_API int tumseg_bn_backward_terms(const void* g, const float* x,
                                        const float* mean, const float* inv,
                                        const float* bias, float* gz,
                                        float* gzd, float* gzi, int M, int C,
                                        int relu, int g_bf16, int vec,
                                        int blocks, void* stream) {
  if (bad_shape(M, C, vec, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_bf16)
    return vec ? launch_terms<__nv_bfloat16, 4>(g, x, mean, inv, bias, gz,
                                                gzd, gzi, M, C, relu, blocks,
                                                s)
               : launch_terms<__nv_bfloat16, 1>(g, x, mean, inv, bias, gz,
                                                gzd, gzi, M, C, relu, blocks,
                                                s);
  return vec ? launch_terms<float, 4>(g, x, mean, inv, bias, gz, gzd, gzi, M,
                                      C, relu, blocks, s)
             : launch_terms<float, 1>(g, x, mean, inv, bias, gz, gzd, gzi, M,
                                      C, relu, blocks, s);
}

// dx [M, C] f32 from gzi [M, C] (tumseg_bn_backward_terms'), x [M, C] and
// ks, kmu [C] f32.
TUMSEG_API int tumseg_bn_backward_dx(const float* gzi, const float* x,
                                     const float* ks, const float* kmu,
                                     float* dx, int M, int C, int vec,
                                     int blocks, void* stream) {
  if (bad_shape(M, C, vec, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = bn_grid(blocks, C, vec ? 4 : 1);
  if (vec)
    bn_backward_dx_kernel<4>
        <<<grid, kThreads, 0, s>>>(gzi, x, ks, kmu, dx, M, C);
  else
    bn_backward_dx_kernel<1>
        <<<grid, kThreads, 0, s>>>(gzi, x, ks, kmu, dx, M, C);
  return tumseg::last_error();
}
