// K6: the batch-major eval ECA block (identity residual), in four phases.
//
// Replaces the TPU kernel agplace_tpu/ops/pallas/bev_block.py:
// fused_eca_block (_block_kernel), the r3 batch-major form of K3 that no
// model path calls.  Like K3 (bev_block_sm.cu), CUDA blocks cannot carry
// the per-item ECA pool from the second conv to the attention multiply, so
// the block runs as phases, with fp32 epilogues:
//   1. h   = bf16(relu(conv3x3(x)*s1 + b1) * mask)
//   2. g   = bf16(conv3x3(h)*s2 + b2); pool += g * mask
//   3. att = sigmoid(conv1d_k(sum_z pool / count)), fp32 (eca.cuh)
//   4. out = bf16(relu(g*att + x) * mask), fp32, one round (combine_kernel)
// Phases 1 and 2 are instances 2 and 3 of K3's TMA + wgmma conv kernel
// (conv3x3_sm90.cu, launched through agp_conv3x3) where Z*C is a multiple
// of 128; at the narrower widths its tiles do not divide (Z*C = 32, 64, 96,
// ...) they are the wmma implicit GEMM below (conv_igemm, EPI 3 and 4).
// These are the rounding points of bev_block.py:78-124, which differ from
// K3's: the affines run in fp32 on the fp32 accumulator, the attention is
// never rounded, and the residual combine rounds once.
//
// What bounds it on the H100: as K3, the two 3x3 convs are tensor-core
// work and the rest is bytes; h and g cross HBM once each between phases.
#include "conv_igemm.cuh"
#include "eca.cuh"

namespace {

using agp::bf16;

// Phase 4: out = bf16(relu(g*att + x) * mask), the multiply and the add
// each rounded to fp32 (no fma), as the plain PyTorch version computes it.
__global__ void combine_kernel(const bf16* __restrict__ g,
                               const bf16* __restrict__ x,
                               const float* __restrict__ att,
                               const uint8_t* __restrict__ mask,
                               bf16* __restrict__ out, long long chunks,
                               int hw, int zc, int z) {
  const int cpr = zc / 8;  // 8-channel chunks per pixel
  const int cz = zc / z;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < chunks; i += (long long)gridDim.x * blockDim.x) {
    const long long m = i / cpr;
    const int n = (int)(i - m * cpr) * 8;
    const int b = (int)(m / hw);
    const float mk = (float)mask[m * z + n / cz];
    const uint4 gv = *reinterpret_cast<const uint4*>(g + m * zc + n);
    const uint4 xv = *reinterpret_cast<const uint4*>(x + m * zc + n);
    const float4* ap =
        reinterpret_cast<const float4*>(att + (long long)b * zc + n);
    const float4 a0 = ap[0], a1 = ap[1];
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const bf16* ge = reinterpret_cast<const bf16*>(&gv);
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
    uint4 o;
    bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v =
          __fadd_rn(__fmul_rn(agp::bf2f(ge[j]), a[j]), agp::bf2f(xe[j]));
      oe[j] = __float2bfloat16_rn(fmaxf(v, 0.0f) * mk);
    }
    *reinterpret_cast<uint4*>(out + m * zc + n) = o;
  }
}

}  // namespace

extern "C" int agp_block_bm_conv1(const bf16* x, const uint8_t* mask,
                                  const bf16* w1, const float* s1,
                                  const float* b1, bf16* h, int B, int X,
                                  int Y, int zc, int z, void* stream) {
  agp::ConvParams p =
      agp::same_conv_params(x, w1, h, B, X, Y, zc, zc, 3, z, s1, b1, mask);
  return agp::launch_conv<agp::EPI_F32_RELU_MASK>(
      p, static_cast<cudaStream_t>(stream));
}

extern "C" int agp_block_bm_conv2_pool(const bf16* h, const uint8_t* mask,
                                       const bf16* w2, const float* s2,
                                       const float* b2, bf16* g, float* pool,
                                       int B, int X, int Y, int zc, int z,
                                       void* stream) {
  agp::ConvParams p =
      agp::same_conv_params(h, w2, g, B, X, Y, zc, zc, 3, z, s2, b2, mask);
  p.pool = pool;
  return agp::launch_conv<agp::EPI_F32_POOL>(
      p, static_cast<cudaStream_t>(stream));
}

extern "C" int agp_block_bm_eca(const float* pool, const uint8_t* mask,
                                const float* w_eca, int k, float* att, int B,
                                int xyz, int z, int c, void* stream) {
  return agp::launch_eca(pool, mask, w_eca, k, att, B, xyz, z, c,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int agp_block_bm_combine(const bf16* g, const bf16* x,
                                    const float* att, const uint8_t* mask,
                                    bf16* out, int B, int X, int Y, int zc,
                                    int z, void* stream) {
  const long long chunks = (long long)B * X * Y * (zc / 8);
  const int threads = 256;
  const long long want = (chunks + threads - 1) / threads;
  const int grid = (int)(want < 132 * 16 ? want : 132 * 16);
  combine_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, x, att, mask, out, chunks, X * Y, zc, z);
  return cudaGetLastError();
}
