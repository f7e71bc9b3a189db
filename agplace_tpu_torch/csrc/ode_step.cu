// K1: fused fixed-step Euler chain of the FCODE block.
//
// Replaces the TPU kernel agplace_tpu/ops/pallas/ode_step.py:fused_euler_ode
// (_ode_kernel, forward only; the custom-VJP backward is a later port).
// Computes n_steps Euler steps x <- x + dt * act(x W + b) for x [B, D] fp32,
// W [D, D] fp32 ([in, out] layout), b [D].
//
// What bounds it on the H100: latency, not bytes or FLOPs.  At the slice
// shape (B=32, D=256, 10 steps) the whole chain is 42 MFLOP, and an unfused
// chain is 30 dependent launches.  W in fp32 is 256 KB, more than the
// 227 KB of shared memory a block may hold, so the TPU design (W resident
// in VMEM) does not carry over.
//
// Design: rows of x are independent, so each block owns a tile of ROWS
// rows and runs all n_steps inside one launch, with its states in shared
// memory (double-buffered: step t reads one buffer, writes the other, and
// a __syncthreads() separates steps).  W streams from global memory, where
// it stays L2-resident across steps and blocks.  Each step is a chain of
// dependent L2 loads, so the dot products are split four ways over k: a
// thread owns one output column and a quarter of the k range (coalesced W
// reads across columns), partial sums meet in shared memory and are added
// in a fixed order.  fp32 FMA throughout; the activation is a template
// parameter.
#include "common.cuh"

namespace {

constexpr int kRows = 4;
constexpr int kCols = 256;               // output columns per pass
constexpr int kSplit = 4;                // k split of each dot product
constexpr int kThreads = kCols * kSplit;

template <int ACT>
__device__ __forceinline__ float act_fn(float v) {
  if (ACT == 0) return fmaxf(v, 0.0f);          // relu
  if (ACT == 1) return tanhf(v);                // tanh
  if (ACT == 2) return agp::sigmoidf_(v);       // sigmoid
  return v;                                     // id
}

template <int ACT>
__global__ void __launch_bounds__(kThreads)
ode_euler_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ out,
                 int batch, int dim, int n_steps, float dt) {
  extern __shared__ float sh[];  // [2][kRows][dim] states
  __shared__ float part[kSplit][kRows][kCols];
  float* cur = sh;
  float* nxt = sh + kRows * dim;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, batch - r0);
  const int col = threadIdx.x % kCols, q = threadIdx.x / kCols;
  for (int i = threadIdx.x; i < kRows * dim; i += blockDim.x) {
    const int r = i / dim;
    cur[i] = r < rows ? x[(size_t)(r0 + r) * dim + (i - r * dim)] : 0.0f;
  }
  __syncthreads();
  for (int step = 0; step < n_steps; ++step) {
    for (int j0 = 0; j0 < dim; j0 += kCols) {
      const int j = j0 + col;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      if (j < dim) {
        for (int k = q; k < dim; k += kSplit) {
          const float wk = w[(size_t)k * dim + j];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r] = fmaf(cur[r * dim + k], wk, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[q][r][col] = acc[r];
      __syncthreads();
      if (q == 0 && j < dim) {
        const float bj = b[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float s = part[0][r][col];
#pragma unroll
          for (int t = 1; t < kSplit; ++t) s += part[t][r][col];
          const float f = act_fn<ACT>(s + bj);
          // x + dt*f with two roundings, as the reference (no FMA)
          nxt[r * dim + j] = __fadd_rn(cur[r * dim + j], __fmul_rn(dt, f));
        }
      }
      __syncthreads();
    }
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int i = threadIdx.x; i < rows * dim; i += blockDim.x) {
    const int r = i / dim;
    out[(size_t)(r0 + r) * dim + (i - r * dim)] = cur[i];
  }
}

template <int ACT>
cudaError_t launch(const float* x, const float* w, const float* b, float* out,
                   int batch, int dim, int n_steps, float dt,
                   cudaStream_t stream) {
  const size_t smem = 2 * kRows * (size_t)dim * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(ode_euler_kernel<ACT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const int grid = (batch + kRows - 1) / kRows;
  ode_euler_kernel<ACT><<<grid, kThreads, smem, stream>>>(x, w, b, out, batch,
                                                         dim, n_steps, dt);
  return cudaGetLastError();
}

}  // namespace

extern "C" int agp_ode_euler(const float* x, const float* w, const float* b,
                             float* out, int batch, int dim, int n_steps,
                             float dt, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case 0: return launch<0>(x, w, b, out, batch, dim, n_steps, dt, s);
    case 1: return launch<1>(x, w, b, out, batch, dim, n_steps, dt, s);
    case 2: return launch<2>(x, w, b, out, batch, dim, n_steps, dt, s);
    default: return launch<3>(x, w, b, out, batch, dim, n_steps, dt, s);
  }
}
