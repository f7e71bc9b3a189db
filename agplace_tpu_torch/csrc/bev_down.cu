// K2: fused stage-0 epilogue + masked down0 of the BEV FPN.
//
// Replaces the TPU kernel agplace_tpu/ops/pallas/bev_down.py:
// fused_conv0_down0 (_down_kernel).  conv0 itself runs outside the kernel
// as one full-resolution cuDNN conv, as XLA ran it outside the Pallas call;
// the TPU kernel's four-parity split was a TPU layout trick (bitcast
// transposes against XLA's conv layout) and is not carried over.  This
// kernel reads conv0's bare output g [B, X, Y, Z*C1] once and, per 2x2
// window (down0 is k=2, s=2, so windows never overlap):
//   prologue  h = relu(bf16(bf16(g*s0) + b0)) * zmask     (BN0, relu, mask)
//   GEMM      acc = sum_taps h . wd   (K = 4*Z*C1, fp32 accumulation)
//   epilogue  out = relu(bf16(bf16(bf16(acc)*sd) + bd)) * mask_out
// mask_out (the ME max-pool of the occupancy over 2x2x2 with the z pairing
// of me_down_align) is computed outside, as the JAX wrapper computes it.
//
// What bounds it on the H100: bytes.  At b32 the kernel reads the 268 MB
// conv0 activation once and does 2*32*64*64*1024*128 = 34 GFLOP, about
// 80 us of HBM traffic at 3.35 TB/s against 35 us of bf16 tensor-core
// work.  The design therefore fuses every elementwise pass between conv0
// and down0 into the GEMM's A-tile load, so the full-resolution activation
// is read exactly once and never re-written masked; the GEMM itself is the
// shared wmma implicit-GEMM (conv_igemm.cuh).
#include "conv_igemm.cuh"

extern "C" int agp_bev_down(const agp::bf16* g, const uint8_t* mask,
                            const float* s0, const float* b0,
                            const agp::bf16* wd, const float* sd,
                            const float* bd, const uint8_t* mask_out,
                            agp::bf16* out, int B, int X, int Y, int zc1,
                            int z, int zc2, int zo, void* stream) {
  agp::ConvParams p = {};
  p.x = g;
  p.w = wd;
  p.out = out;
  p.B = B;
  p.H = X;
  p.W = Y;
  p.Cin = zc1;
  p.Ho = X / 2;
  p.Wo = Y / 2;
  p.Cout = zc2;
  p.KH = 2;
  p.KW = 2;
  p.stride = 2;
  p.pad = 0;
  p.pro_scale = s0;
  p.pro_bias = b0;
  p.in_mask = mask;
  p.in_z = z;
  p.in_cz = zc1 / z;
  p.scale = sd;
  p.bias = bd;
  p.out_mask = mask_out;
  p.out_z = zo;
  p.out_cz = zc2 / zo;
  return agp::launch_conv<agp::PRO_AFFINE_RELU_MASK, agp::EPI_AFFINE_RELU_MASK>(
      p, static_cast<cudaStream_t>(stream));
}
