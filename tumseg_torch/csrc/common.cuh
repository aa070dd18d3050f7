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
#pragma once

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

}  // namespace tumseg
