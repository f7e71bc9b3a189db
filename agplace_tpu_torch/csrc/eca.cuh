// The ECA attention phase shared by the K3 (bev_block_sm.cu, bf16
// attention) and K6 (bev_block.cu, fp32 attention) block kernels.
//
// One block per batch item.  count = max(sum(mask), 1); pooled[c] =
// sum_z pool[z*C + c] / count; att[c] = sigmoid(sum_t w[t] pooled[c+t-half])
// (zero padded), all in fp32; written z-tiled as [B, Z*C] in the output
// type (K3 rounds it to bf16, K6 keeps fp32, as their Pallas kernels do).
#pragma once

#include "common.cuh"

namespace agp {

constexpr int kEcaThreads = 256;

__device__ __forceinline__ void store_att(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_att(float* p, float v) { *p = v; }

template <typename T>
__global__ void __launch_bounds__(kEcaThreads)
eca_kernel(const float* __restrict__ pool, const uint8_t* __restrict__ mask,
           const float* __restrict__ w, T* __restrict__ att, int xyz, int z,
           int c, int k) {
  extern __shared__ float pooled[];  // [c]
  __shared__ int wsum[kEcaThreads / 32];
  const int b = blockIdx.x;
  int cnt = 0;
  for (int i = threadIdx.x; i < xyz; i += blockDim.x)
    cnt += mask[(size_t)b * xyz + i];
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = cnt;
  __syncthreads();
  int total = 0;
  for (int i = 0; i < kEcaThreads / 32; ++i) total += wsum[i];
  const float n = fmaxf((float)total, 1.0f);
  const int zc = z * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float s = 0.0f;
    for (int zz = 0; zz < z; ++zz) s += pool[(size_t)b * zc + zz * c + ch];
    pooled[ch] = s / n;
  }
  __syncthreads();
  const int half = (k - 1) / 2;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float a = 0.0f;
    for (int t = 0; t < k; ++t) {
      const int src = ch + t - half;
      if (src >= 0 && src < c) a += w[t] * pooled[src];
    }
    const float v = sigmoidf_(a);
    for (int zz = 0; zz < z; ++zz)
      store_att(att + (size_t)b * zc + zz * c + ch, v);
  }
}

template <typename T>
cudaError_t launch_eca(const float* pool, const uint8_t* mask,
                       const float* w_eca, int k, T* att, int B, int xyz,
                       int z, int c, cudaStream_t stream) {
  eca_kernel<T><<<B, kEcaThreads, c * sizeof(float), stream>>>(
      pool, mask, w_eca, att, xyz, z, c, k);
  return cudaGetLastError();
}

}  // namespace agp
