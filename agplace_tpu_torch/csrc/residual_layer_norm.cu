// The seam between two layers of CCT's bf16 encoder in one pass: the
// residual add of a bf16 branch into the fp32 stream, the LayerNorm of the
// sum, and the rounding of that norm to the next Dense's bf16 operand.
//
// No TPU kernel stands behind it: XLA fuses the add, the norm and the cast
// on the TPU.  PyTorch's eager mode runs them as three passes over the
// [rows, C] stream (models/cct.py: `tokens + y`, `F.layer_norm`, then
// `x.to(bf16)` in Dense.forward), each reading and writing it in HBM.  This
// kernel reads the stream (and the branch) once and writes what the next
// step reads, chosen by the wrapper (ops/residual_layer_norm.py):
//   t = x + float(r)            (r, the bf16 branch, may be absent: t = x)
//   stream:  t or LN(t), fp32   (or nothing)
//   operand: bf16(LN(t))        (or nothing)
//
// Arithmetic: the add is one fp32 add of the widened bf16, as the eager
// add; mean, variance, the normalisation and the affine are fp32, LN(t) =
// gamma * (rstd * (t - mean)) + beta with rstd = rsqrt(var + eps), as
// PyTorch's vectorized LayerNorm writes it; the operand is the
// round-to-nearest-even of that fp32 value, as `x.to(bf16)`.  Only the row
// reduction differs from PyTorch's: a two-pass mean, then the mean of the
// squared deviations, in fp32 registers (PyTorch: Welford).
//
// What bounds it on the H100: bytes (340 MB a pass at CCT-14's b128 seams,
// a few flops an element).  One warp takes one row: lane l holds columns
// 128 j + 4 l .. + 3 of each 128-column chunk j, so each load of the stream
// is one 16-byte vector a lane (512 contiguous bytes a warp), the branch's
// an 8-byte one, gamma and beta's 16-byte loads are issued beside them,
// and the row's sums are warp shuffles.  A block is 8 rows, the grid
// covers the rows once, and at most 64 registers a thread keep 32 rows in
// flight an SM (C = 512 spills a few).  Inputs are read with streaming hints (each byte once);
// outputs are new tensors.  Timed at [73,728, 384] on an H100, this grid
// (2.95 TB/s, the speed of a plain fp32 copy there: 2.99) beat a
// persistent one of 4 blocks an SM walking the rows (2.85) and two or four
// rows in flight a warp (2.75-2.84).
#include "common.cuh"

namespace {

using agp::bf16;

constexpr int kThreads = 256;  // 8 warps, a row each
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;   // resident blocks an SM: at most 64 registers
constexpr int kChunk = 128;     // columns of one 16-byte load a lane
constexpr int kMaxChunks = 4;   // C <= 512

struct LnParams {
  const float* x;      // [rows, C] the fp32 stream
  const bf16* r;       // [rows, C] the bf16 branch, or null
  const float* gamma;  // [C]
  const float* beta;
  float* out;          // [rows, C] fp32: t (keep_sum) or LN(t), or null
  bf16* operand;       // [rows, C] bf16(LN(t)), or null
  long long rows;
  float eps;
  int keep_sum;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// two fp32 values rounded to bf16 (ties to even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int NC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    residual_layer_norm_kernel(const LnParams p) {
  constexpr int C = NC * kChunk;
  const int lane = threadIdx.x & 31;
  const long long row = blockIdx.x * (long long)kWarps + (threadIdx.x >> 5);
  if (row >= p.rows) return;
  const float4* xr = reinterpret_cast<const float4*>(p.x + row * C);
  float4 xv[NC], g[NC], b[NC];
  uint2 rv[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    xv[j] = __ldcs(xr + j * 32 + lane);
    g[j] = __ldg(reinterpret_cast<const float4*>(p.gamma) + j * 32 + lane);
    b[j] = __ldg(reinterpret_cast<const float4*>(p.beta) + j * 32 + lane);
  }
  if (p.r) {
    const uint2* rr = reinterpret_cast<const uint2*>(p.r + row * C);
#pragma unroll
    for (int j = 0; j < NC; ++j) rv[j] = __ldcs(rr + j * 32 + lane);
  }
  float v[NC][4];
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    v[j][0] = xv[j].x, v[j][1] = xv[j].y, v[j][2] = xv[j].z,
    v[j][3] = xv[j].w;
    if (p.r) {
      v[j][0] = __fadd_rn(v[j][0], __uint_as_float(rv[j].x << 16));
      v[j][1] = __fadd_rn(v[j][1], __uint_as_float(rv[j].x & 0xffff0000u));
      v[j][2] = __fadd_rn(v[j][2], __uint_as_float(rv[j].y << 16));
      v[j][3] = __fadd_rn(v[j][3], __uint_as_float(rv[j].y & 0xffff0000u));
    }
    s += (v[j][0] + v[j][1]) + (v[j][2] + v[j][3]);
  }
  const float mean = warp_sum(s) / C;
  float q = 0.0f;
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float d = v[j][k] - mean;
      q = fmaf(d, d, q);
    }
  const float rstd = rsqrtf(warp_sum(q) / C + p.eps);
  float4* out = p.out ? reinterpret_cast<float4*>(p.out + row * C) : nullptr;
  uint2* op =
      p.operand ? reinterpret_cast<uint2*>(p.operand + row * C) : nullptr;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (out && p.keep_sum)
      __stcs(out + j * 32 + lane,
             make_float4(v[j][0], v[j][1], v[j][2], v[j][3]));
    const float n0 = g[j].x * (rstd * (v[j][0] - mean)) + b[j].x;
    const float n1 = g[j].y * (rstd * (v[j][1] - mean)) + b[j].y;
    const float n2 = g[j].z * (rstd * (v[j][2] - mean)) + b[j].z;
    const float n3 = g[j].w * (rstd * (v[j][3] - mean)) + b[j].w;
    if (out && !p.keep_sum)
      __stcs(out + j * 32 + lane, make_float4(n0, n1, n2, n3));
    if (op)
      __stcs(op + j * 32 + lane,
             make_uint2(pack_bf16x2(n0, n1), pack_bf16x2(n2, n3)));
  }
}

template <int NC>
int launch(const LnParams& p, int grid, cudaStream_t stream) {
  residual_layer_norm_kernel<NC><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x: fp32 [rows, c]; r: bf16 [rows, c] or null; gamma, beta: fp32 [c]; out:
// fp32 [rows, c] or null, t when keep_sum (which needs r) else LN(t);
// operand: bf16 [rows, c] or null; at least one of out and operand.  Every
// pointer 16-byte aligned, c a multiple of 128 up to 512; grid:
// ops/residual_layer_norm.py's ln_grid (a warp a row), block its BLOCK.
extern "C" int agp_residual_layer_norm(const void* x, const void* r,
                                       const float* gamma, const float* beta,
                                       void* out, void* operand,
                                       long long rows, int c, float eps,
                                       int keep_sum, int grid, int block,
                                       void* stream) {
  const int nc = c / kChunk;
  if (rows < 1 || c % kChunk || nc < 1 || nc > kMaxChunks ||
      block != kThreads || (long long)grid * kWarps < rows ||
      (!out && !operand) ||
      (keep_sum && (!r || !out)))
    return cudaErrorInvalidValue;
  const LnParams p = {static_cast<const float*>(x),
                      static_cast<const bf16*>(r),
                      gamma,
                      beta,
                      static_cast<float*>(out),
                      static_cast<bf16*>(operand),
                      rows,
                      eps,
                      keep_sum};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nc) {
    case 1: return launch<1>(p, grid, s);
    case 2: return launch<2>(p, grid, s);
    case 3: return launch<3>(p, grid, s);
    default: return launch<4>(p, grid, s);
  }
}
