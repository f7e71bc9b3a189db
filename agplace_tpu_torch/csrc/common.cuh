// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel in this directory is built by agplace_tpu_torch/ops/_build.py
// with `nvcc -gencode arch=compute_90a,code=sm_90a` into one shared library
// with a plain C interface (loaded with ctypes).  Each C entry point launches
// on the stream it is given and returns cudaGetLastError(); the Python
// wrapper raises when that is not cudaSuccess.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace agp {

using bf16 = __nv_bfloat16;

// Round an fp32 value to the nearest bf16 (ties to even) and widen it back:
// the JAX rounding points (bf16 elementwise ops) are emulated with this.
__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.0f / (1.0f + expf(-v));
}

}  // namespace agp
