// conv0 of K4's off-preset instance: the widths its TMA + wgmma tiles do
// not take, chosen by shape in the wrapper (ops/bev_head.py:
// head_instance).
//
// Replaces, at those widths, the conv0 half of the TPU kernel
// agplace_tpu/ops/pallas/bev_head.py:fused_head, which keeps its operands
// whole in VMEM at any width.  The sm90 instance (bev_head.cu) takes Z*C0
// in (4, 8, 16) in its im2col box; here conv0 over feats [B, X, Y, Z*C0]
// (any Z*C0: C0 = 1 gives z occupancy channels) is conv_igemm.cuh's wmma
// implicit GEMM with the element gather (GATHER_ANY) and the fp32 BN0
// epilogue (EPI 3: fp32 affine, relu, mask, ONE round): bev_head.py:
// 146-153's rounding.  Its activation h [B, X, Y, Z*C1] goes through HBM
// (one bf16 write and read); the down0 half then runs on the z-banded
// wgmma GEMM (zband_sm90.cu, its fp32 instance) over h.
// What bounds it on the H100: conv0 reads z occupancy channels per cell,
// so its A gather, not the tensor cores, sets the pace.
#include "conv_igemm.cuh"

// h = bf16(relu(conv0(feats)*s0 + b0) * mask), the affine in fp32; Z*C1 a
// multiple of 8 channels per z-slab (the wrapper pads them).  gather0:
// conv_igemm's gather for Z*C0.
extern "C" int agp_bev_head_conv0(const agp::bf16* feats, const uint8_t* mask,
                                  const agp::bf16* w0, const float* s0,
                                  const float* b0, agp::bf16* h, int B, int X,
                                  int Y, int k0, int zc0, int zc1, int z,
                                  int gather0, void* stream) {
  if (X % 2 || Y % 2 || k0 % 2 == 0 || zc0 < 1 || z < 1 || zc1 % z ||
      (zc1 / z) % 8)
    return cudaErrorInvalidValue;
  agp::ConvParams p = agp::same_conv_params(feats, w0, h, B, X, Y, zc0, zc1,
                                            k0, z, s0, b0, mask);
  return agp::launch_conv_gather<agp::EPI_F32_RELU_MASK>(
      p, gather0, static_cast<cudaStream_t>(stream));
}
