// K5: the ResNet stem tail — BN eval affine, relu and maxpool 3x3/2 pad 1.
//
// Replaces the TPU kernel agplace_tpu/ops/pallas/stem_pool.py:
// fused_affine_relu_maxpool (_kernel).  The TPU kernel's batch-pair channel
// fold (to fill 128-lane registers) and its H-blocking with a one-row halo
// (to fit VMEM) are TPU layout tricks and are not carried over: here each
// thread owns one output pixel's 8 consecutive channels (one 16-byte
// store) and reads its whole 3x3 window straight from the conv output.
//
// Arithmetic (stem_pool.py:62-73): scale and bias are rounded to bf16 and
// widened; y = relu(x*s + b) in fp32 with one bf16 round; the window max
// runs on those bf16 values.  x and s are both bf16 values, so their
// product is exact in fp32 (8-bit by 8-bit significands): the multiply and
// the add below, written as two rounded fp32 operations, give the same bits
// as the TPU kernel's fma and as the plain PyTorch version's
// `x.float() * s + b`.  The pad is 1 on every side; padded taps contribute
// 0, which equals the true -inf pad because every real tap is >= 0 after
// the relu.
//
// What bounds it on the H100: bytes.  At b32 the kernel reads the
// [32,128,128,64] bf16 conv output (67 MB) and writes a quarter of it; the
// 3x3/2 windows overlap, so each input vector is read by up to four
// threads — the repeats hit L1/L2, and HBM sees the input about once.
#include "common.cuh"

namespace {

using agp::bf16;

__global__ void __launch_bounds__(256)
stem_pool_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 long long n_out, int H, int W, int C) {
  const int cpp = C / 8;  // 8-channel vectors per pixel
  const int Ho = H / 2, Wo = W / 2;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_out; i += (long long)gridDim.x * blockDim.x) {
    const int cv = (int)(i % cpp);
    long long pix = i / cpp;
    const int ow = (int)(pix % Wo);
    pix /= Wo;
    const int oh = (int)(pix % Ho);
    const long long b = pix / Ho;
    const int c0 = cv * 8;
    float s[8], bb[8], m[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] = agp::rbf(scale[c0 + j]);
      bb[j] = agp::rbf(bias[c0 + j]);
      m[j] = 0.0f;  // the zero pad (every real tap is >= 0)
    }
#pragma unroll
    for (int dh = -1; dh <= 1; ++dh) {
      const int ih = 2 * oh + dh;
      if (ih < 0 || ih >= H) continue;
#pragma unroll
      for (int dw = -1; dw <= 1; ++dw) {
        const int iw = 2 * ow + dw;
        if (iw < 0 || iw >= W) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(
            x + ((b * H + ih) * W + iw) * C + c0);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float y =
              __fadd_rn(__fmul_rn(agp::bf2f(e[j]), s[j]), bb[j]);
          m[j] = fmaxf(m[j], agp::rbf(fmaxf(y, 0.0f)));
        }
      }
    }
    uint4 o;
    bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int j = 0; j < 8; ++j) oe[j] = __float2bfloat16_rn(m[j]);
    *reinterpret_cast<uint4*>(out + i * 8) = o;
  }
}

}  // namespace

extern "C" int agp_stem_pool(const bf16* x, const float* scale,
                             const float* bias, bf16* out, int B, int H,
                             int W, int C, void* stream) {
  const long long n_out = (long long)B * (H / 2) * (W / 2) * (C / 8);
  const int threads = 256;
  const long long want = (n_out + threads - 1) / threads;
  const int grid = (int)(want < 132 * 32 ? want : 132 * 32);
  stem_pool_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, scale, bias, out, n_out, H, W, C);
  return cudaGetLastError();
}
