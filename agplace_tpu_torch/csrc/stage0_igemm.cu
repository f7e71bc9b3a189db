// The narrow instances of the BEV stage-0 kernels K2 and K4: the widths
// their TMA + wgmma tiles do not divide, chosen by shape in the wrappers
// (ops/bev_down.py: down0_instance, ops/bev_head.py: head_instance).
//
// Replace, at those widths, the TPU kernels agplace_tpu/ops/pallas/
// bev_down.py:fused_conv0_down0 and agplace_tpu/ops/pallas/bev_head.py:
// fused_head, which keep their operands whole in VMEM at any width (their
// only asserts are even X / Y and the conv0 kernel size).  The sm90
// instances (bev_down.cu, bev_head.cu) tile Z*C1 in 64-channel K slabs
// under the 128-byte swizzle, Zo*C2 in 128-channel N tiles, stage the down
// BN's affine for Zo*C2 <= 512 and fold 4 x z <= 64 mask bits per row;
// K4's im2col box takes Z*C0 in (4, 8, 16).  Here every one of those is a
// runtime width of conv_igemm.cuh's wmma implicit GEMM (128 x 64 tiles,
// 32-deep K slices, a 3-stage ring):
//   * K2 (agp_bev_down_igemm): the down0 GEMM over conv0's bare output g
//     [B, X, Y, Z*C1] as a k=2 s=2 conv, its A chunks through registers
//     with BN0's bf16 affine, relu and the z-slab's mask (GATHER_C8_BN),
//     the epilogue K2's (EPI 0: bf16 affine, relu, the output mask): the
//     rounding points of bev_down.py:84-105, as the sm90 instance;
//   * K4 (agp_bev_head_igemm): conv0 over feats [B, X, Y, Z*C0] (any Z*C0:
//     C0 = 1 gives z channels) with the fp32 BN0 epilogue (EPI 3: fp32
//     affine, relu, mask, ONE round), its activation h [B, X, Y, Z*C1]
//     written to memory, then down0 over h with the fp32 epilogue and the
//     output mask: bev_head.py:146-163's rounding.  Unlike the sm90
//     instance, h goes through HBM (one bf16 write and read).
// What bounds them on the H100: at the widths the flags reach (W1-W3 of
// chip_smoke.py's [widths]) the down0 product is tensor-core work over the
// folds' dense blocks; wmma reaches a fraction of wgmma's rate, which is
// the price of taking any multiple of 8 channels.
#include "conv_igemm.cuh"

namespace {

using agp::bf16;
using agp::ConvParams;

// A k x k 'same' conv or the k=2 s=2 down conv over [B, X, Y, cin], its
// epilogue's affine and output mask [B, Ho, Wo, out_z]
ConvParams stage0_params(const bf16* x, const bf16* w, bf16* out, int B,
                         int X, int Y, int cin, int cout, int k, int stride,
                         const float* scale, const float* bias,
                         const uint8_t* out_mask, int out_z) {
  ConvParams p = {};
  p.x = x;
  p.w = w;
  p.out = out;
  p.B = B;
  p.H = X;
  p.W = Y;
  p.Cin = cin;
  p.Ho = X / stride;
  p.Wo = Y / stride;
  p.Cout = cout;
  p.KH = k;
  p.KW = k;
  p.stride = stride;
  p.pad = stride == 1 ? k / 2 : 0;
  p.scale = scale;
  p.bias = bias;
  p.out_mask = out_mask;
  p.out_z = out_z;
  p.out_cz = cout / out_z;
  return p;
}

bool widths_ok(int zc, int z) {
  return z >= 1 && zc % z == 0 && (zc / z) % 8 == 0;
}

}  // namespace

// K2's narrow instance: out = relu(bf16 affine(bf16(sum over the 2x2
// window of relu(bf16 affine(g)) * mask . wd))) * mask_out.
extern "C" int agp_bev_down_igemm(const bf16* g, const uint8_t* mask,
                                  const float* s0, const float* b0,
                                  const bf16* wd, const float* sd,
                                  const float* bd, const uint8_t* mask_out,
                                  bf16* out, int B, int X, int Y, int zc1,
                                  int zc2, int z, int zo, void* stream) {
  if (X % 2 || Y % 2 || !widths_ok(zc1, z) || !widths_ok(zc2, zo))
    return cudaErrorInvalidValue;
  ConvParams p = stage0_params(g, wd, out, B, X, Y, zc1, zc2, 2, 2, sd, bd,
                               mask_out, zo);
  p.in_scale = s0;
  p.in_bias = b0;
  p.in_mask = mask;
  p.in_z = z;
  p.in_cz = zc1 / z;
  return agp::launch_conv<agp::EPI_BF16_RELU_MASK, agp::GATHER_C8_BN>(
      p, static_cast<cudaStream_t>(stream));
}

// K4's narrow instance: h = bf16(relu(conv0(feats)*s0 + b0) * mask), then
// out = bf16(relu(down0(h)*sd + bd) * mask_out), each affine in fp32.
// gather0 / gather_d: conv_igemm's gathers for Z*C0 and Z*C1.
extern "C" int agp_bev_head_igemm(const bf16* feats, const uint8_t* mask,
                                  const bf16* w0, const float* s0,
                                  const float* b0, bf16* h, const bf16* wd,
                                  const float* sd, const float* bd,
                                  const uint8_t* mask_out, bf16* out, int B,
                                  int X, int Y, int k0, int zc0, int zc1,
                                  int zc2, int z, int zo, int gather0,
                                  int gather_d, void* stream) {
  if (X % 2 || Y % 2 || k0 % 2 == 0 || zc0 < 1 || !widths_ok(zc1, z) ||
      !widths_ok(zc2, zo) || gather_d == agp::GATHER_ANY)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ConvParams p0 = stage0_params(feats, w0, h, B, X, Y, zc0, zc1, k0,
                                      1, s0, b0, mask, z);
  cudaError_t err =
      agp::launch_conv_gather<agp::EPI_F32_RELU_MASK>(p0, gather0, s);
  if (err != cudaSuccess) return err;
  const ConvParams pd = stage0_params(h, wd, out, B, X, Y, zc1, zc2, 2, 2,
                                      sd, bd, mask_out, zo);
  return agp::launch_conv_gather<agp::EPI_F32_RELU_MASK>(pd, gather_d, s);
}
