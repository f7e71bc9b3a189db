// K3: the eval-mode BEV ECA basic block, in four phases.
//
// Replaces the TPU kernel agplace_tpu/ops/pallas/bev_block_sm.py:
// fused_eca_block_sm (_block_kernel).  The TPU kernel runs a whole block per
// batch tile in one grid step, carrying the per-item ECA pool between the
// second conv and the attention multiply inside VMEM.  CUDA blocks run in
// no order and cannot carry that sum, so the block is written as phases,
// each a hand-written kernel:
//   1. h   = relu(bn1(conv3x3(x))) * mask                (conv3x3_sm90.cu)
//   2. g   = bn2(conv3x3(h)); pool[b, zc] += sum g*mask  (conv3x3_sm90.cu)
//      -- at the widths the sm90 tiles do not divide (Zcin not a multiple
//      of 64, Zcout not of 128, C not of 8; ops/bev_block_sm.py:
//      conv3x3_instance) both phases are the z-banded wgmma GEMM
//      (zband_sm90.cu) with the same bf16 epilogues
//   3. att = sigmoid(conv1d_k(sum_z pool / count))       (eca.cuh)
//   4. out = relu(g*att + r) * mask with r = x (combine_id_kernel) or
//      r = bn_d(conv1x1(x)) computed in the GEMM epilogue (conv_igemm, EPI 2)
// Dtype flow and rounding points are those of bev_block_sm.py:77-136: convs
// accumulate in fp32 and round to bf16, BN affines, relu, mask, the
// attention multiply and the residual add run in bf16, the pool and the
// 1-D channel conv in fp32.
//
// What bounds it on the H100: at the slice shapes the two 3x3 convs are
// tensor-core work (block0 at b32: 2 x 38.7 GFLOP over a 33.6 MB map; their
// kernel and its design are in conv3x3_sm90.cu), the rest is bytes.
// Between phases h and g go through HBM (the TPU kernel kept them in VMEM);
// each is one bf16 map, written once and read once.  The masked pool is
// folded into phase 2's epilogue, so g is never re-read for it.  This file
// holds phases 3 and 4.
#include "conv_igemm.cuh"
#include "eca.cuh"

namespace {

using agp::bf16;

// Phase 4, identity residual: out = relu(bf16(bf16(g*att) + x)) * mask.
__global__ void combine_id_kernel(const bf16* __restrict__ g,
                                  const bf16* __restrict__ x,
                                  const bf16* __restrict__ att,
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
    const uint4 av = *reinterpret_cast<const uint4*>(att + (long long)b * zc + n);
    const bf16* ge = reinterpret_cast<const bf16*>(&gv);
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
    const bf16* ae = reinterpret_cast<const bf16*>(&av);
    uint4 o;
    bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = agp::rbf(agp::rbf(agp::bf2f(ge[j]) * agp::bf2f(ae[j])) +
                               agp::bf2f(xe[j]));
      oe[j] = __float2bfloat16_rn(fmaxf(v, 0.0f) * mk);
    }
    *reinterpret_cast<uint4*>(out + m * zc + n) = o;
  }
}

}  // namespace

extern "C" int agp_block_eca(const float* pool, const uint8_t* mask,
                             const float* w_eca, int k, bf16* att, int B,
                             int xyz, int z, int c, void* stream) {
  return agp::launch_eca(pool, mask, w_eca, k, att, B, xyz, z, c,
                         static_cast<cudaStream_t>(stream));
}

// gather: conv_igemm's gather for Zcin (GATHER_SLAB32 at Zcin % 32 == 0,
// every preset's; GATHER_C8 at the other multiples of 8: the wrapper pads
// every z-slab to a multiple of 8 channels)
extern "C" int agp_block_combine_ds(const bf16* x, const uint8_t* mask,
                                    const bf16* wd, const float* sd,
                                    const float* bd, const bf16* g,
                                    const bf16* att, bf16* out, int B, int X,
                                    int Y, int zci, int zco, int z,
                                    int gather, void* stream) {
  agp::ConvParams p =
      agp::same_conv_params(x, wd, out, B, X, Y, zci, zco, 1, z, sd, bd, mask);
  p.g = g;
  p.att = att;
  return agp::launch_conv_gather<agp::EPI_AFFINE_COMBINE>(
      p, gather, static_cast<cudaStream_t>(stream));
}

extern "C" int agp_block_combine_id(const bf16* g, const bf16* x,
                                    const bf16* att, const uint8_t* mask,
                                    bf16* out, int B, int X, int Y, int zc,
                                    int z, void* stream) {
  const long long chunks = (long long)B * X * Y * (zc / 8);
  const int threads = 256;
  const long long want = (chunks + threads - 1) / threads;
  const int grid = (int)(want < 132 * 16 ? want : 132 * 16);
  combine_id_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, x, att, mask, out, chunks, X * Y, zc, z);
  return cudaGetLastError();
}
