// One templated implicit-GEMM convolution with a fused epilogue, shared by
// K6's conv phases at the widths the TMA + wgmma kernel's tiles do not
// divide (bev_block.cu, EPI 3-4) and K3's 1x1 residual combine
// (bev_block_sm.cu, EPI 2); P1 and P2 use its cp.async helpers.  K2's
// down0, K3's conv phases and K4's down0 off their sm90 tiles run the
// z-banded wgmma GEMM (zband_sm90.cu), K4's conv0 there the window GEMM
// (head_conv0_sm90.cu).
//
// Layouts (the port's public layouts): x [B, H, W, Cin] bf16 (NHWC, the
// z-major fold puts z*C in the channel axis), weights [KH, KW, Cin, Cout]
// bf16 (the folded HWIO kernels, read as a row-major [K, Cout] matrix with
// K = KH*KW*Cin), out [B, Ho, Wo, Cout] bf16.  Output pixel (b, ox, oy)
// reads input pixel (ox*stride + dx - pad, oy*stride + dy - pad) for tap
// (dx, dy); out-of-range taps read zero.
//
// GEMM view: M = B*Ho*Wo output pixels, N = Cout, K = KH*KW*Cin.  A block
// computes a BM x BN tile with 8 warps (4 x 2), each warp a 32 x 32 patch
// of nvcuda::wmma bf16 16x16x16 tiles with fp32 accumulation.  The A tile
// is gathered from x in chunks of 8 K-columns, by one of two gathers
// chosen at compile time (the wrapper's rule picks the instance):
//   GATHER_SLAB32  Cin % 32 == 0: a BK slice lies inside one tap, one
//                  16-byte cp.async per chunk (the first design's);
//   GATHER_C8      Cin % 8 == 0: each chunk finds its own tap, K padded to
//                  a multiple of BK with zeros (A and B both, so that no
//                  0 x garbage product reaches the sum).
// The B tile comes from the weight matrix, rows past K zero.  Tiles stream
// through a 3-stage ring in shared memory, so two K slices are in flight
// while one feeds the tensor cores.  The fp32 accumulator
// tile goes through shared memory to an epilogue that works on 8
// consecutive output channels per thread (16-byte stores: Cout % 8 == 0,
// and the output mask's z-slabs Cout / out_z a multiple of 8).
//
// Rounding points follow the JAX kernels.  The bf16 epilogue (EPI 2,
// bev_block_sm.py): the conv result is rounded to bf16, the BN eval affine
// runs in bf16 (one rounding after the multiply, one after the add), relu
// and the 0/1 mask are exact; scale and bias arrive in fp32 and are rounded
// to bf16 here, as that Pallas kernel does (`a_ref[0].astype(bf16)`).  The
// fp32 epilogues (EPI 3-4, bev_block.py): the affine runs
// in fp32 on the unrounded accumulator with fp32 scale and bias, as a
// multiply and an add each rounded to fp32 (no fma contraction, so the
// plain PyTorch `acc * s + b` gives the same bits), and the result is
// rounded to bf16 once.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace agp {

enum {
  EPI_AFFINE_COMBINE = 2,  // relu(g*att + bf16(bf16(bf16(acc)*s) + b))*mask
  EPI_F32_RELU_MASK = 3,   // bf16(relu(acc*s + b) * mask), fp32 affine
  EPI_F32_POOL = 4         // g = bf16(acc*s + b); pool += g * mask
};

enum { GATHER_SLAB32 = 0, GATHER_C8 = 1 };

struct ConvParams {
  const bf16* x;
  const bf16* w;
  bf16* out;
  int B, H, W, Cin, Ho, Wo, Cout, KH, KW, stride, pad;
  // epilogue: per-output-channel BN affine, output mask [B, Ho, Wo, out_z]
  const float* scale;
  const float* bias;
  const uint8_t* out_mask;
  int out_z, out_cz;
  float* pool;      // EPI_*_POOL: [B, Cout] fp32 masked sums (+=)
  const bf16* g;    // EPI_AFFINE_COMBINE: [M, Cout] second-conv output
  const bf16* att;  // EPI_AFFINE_COMBINE: [B, Cout] z-tiled attention
};

constexpr int kBM = 128, kBN = 64, kBK = 32, kNT = 256, kStages = 3;
constexpr int kLDA = kBK + 8, kLDB = kBN + 8, kLDC = kBN + 4;
constexpr int kStageElems = kBM * kLDA + kBK * kLDB;  // bf16 per stage
constexpr int kSmemBytes = kStages * kStageElems * 2 > kBM * kLDC * 4
                               ? kStages * kStageElems * 2
                               : kBM * kLDC * 4;  // C tile reuses the ring

// 16-byte global->shared copy, zero-filled when !pred (src is then unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int EPI, int GATHER>
__global__ void __launch_bounds__(kNT) conv_igemm_kernel(ConvParams p) {
  using namespace nvcuda;
  constexpr bool kF32 = EPI == EPI_F32_RELU_MASK || EPI == EPI_F32_POOL;
  constexpr bool kPool = EPI == EPI_F32_POOL;
  constexpr bool kReluMask = EPI == EPI_F32_RELU_MASK;
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __shared__ float red[kNT / 32][kBN];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int HWo = p.Ho * p.Wo;
  const int M = p.B * HWo;
  const int K = p.KH * p.KW * p.Cin;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  // A gather: kBM*kBK/8 = 512 chunks of 8 channels, two per thread
  int a_row[2], a_kc[2], a_b[2], a_ox[2], a_oy[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kNT;
    a_row[i] = c / (kBK / 8);
    a_kc[i] = (c % (kBK / 8)) * 8;
    const int m = m0 + a_row[i];
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    a_b[i] = mm / HWo;
    const int rem = mm - a_b[i] * HWo;
    a_ox[i] = rem / p.Wo;
    a_oy[i] = rem - a_ox[i] * p.Wo;
  }
  // B load: kBK*kBN/8 = 256 chunks, one per thread
  const int b_row = tid / (kBN / 8), b_nc = (tid % (kBN / 8)) * 8;
  const bool b_ok = n0 + b_nc < p.Cout;

  // input pixel of A chunk i at tap `tap`, or -1 (zero padding)
  auto a_pix = [&](int i, int tap) -> long long {
    const int dx = tap / p.KW, dy = tap - dx * p.KW;
    const int ix = a_ox[i] * p.stride + dx - p.pad;
    const int iy = a_oy[i] * p.stride + dy - p.pad;
    if (!a_ok[i] || ix < 0 || ix >= p.H || iy < 0 || iy >= p.W) return -1;
    return ((long long)a_b[i] * p.H + ix) * p.W + iy;
  };
  auto b_src = [&](int k0) {
    return p.w + (size_t)(k0 + b_row) * p.Cout + n0 + b_nc;
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  const int wm = warp >> 1, wn = warp & 1;

  auto mma_tile = [&](const bf16* As, const bf16* Bs) {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * kLDA + kk,
                               kLDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kLDB + wn * 32 + j * 16,
                               kLDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  };

  // K rounded up to the slice (GATHER_SLAB32: K % kBK == 0 already)
  const int KT = (K + kBK - 1) / kBK;
  // kStages-deep cp.async ring: tiles kt+1 .. kt+kStages-1 are in flight
  // while tile kt feeds the tensor cores
  auto issue = [&](int kt) {
    bf16* As = ring + (kt % kStages) * kStageElems;
    bf16* Bs = As + kBM * kLDA;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bf16* dst = As + a_row[i] * kLDA + a_kc[i];
      const int k = k0 + a_kc[i];
      if (GATHER == GATHER_SLAB32) {
        const int ci0 = k0 % p.Cin;
        const long long pix = a_pix(i, k0 / p.Cin);
        cp_async16(dst, pix >= 0 ? p.x + pix * p.Cin + ci0 + a_kc[i] : p.x,
                   pix >= 0);
      } else {
        // Cin % 8 == 0: the chunk lies in one tap (and one z-slab)
        const int tap = k / p.Cin, ci = k - tap * p.Cin;
        const long long pix = k < K ? a_pix(i, tap) : -1;
        cp_async16(dst, pix >= 0 ? p.x + pix * p.Cin + ci : p.x, pix >= 0);
      }
    }
    const bool bk = b_ok && k0 + b_row < K;
    cp_async16(Bs + b_row * kLDB + b_nc, bk ? b_src(k0) : p.w, bk);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) issue(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every warp is done with kt-1
    if (kt + kStages - 1 < KT) issue(kt + kStages - 1);
    cp_async_commit();
    const bf16* As = ring + (kt % kStages) * kStageElems;
    mma_tile(As, As + kBM * kLDA);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the C tile
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kLDC + wn * 32 + j * 16,
                              acc[i][j], kLDC, wmma::mem_row_major);
  __syncthreads();

  // ---- epilogue: thread -> 8 channels (cg) x rows rbase + 32*t
  const int cg = tid % (kBN / 8);
  const int rbase = tid / (kBN / 8);
  const int n = n0 + cg * 8;
  const bool n_ok = n < p.Cout;
  float sc[8], bi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = n_ok ? (kF32 ? p.scale[n + j] : rbf(p.scale[n + j])) : 0.0f;
    bi[j] = n_ok ? (kF32 ? p.bias[n + j] : rbf(p.bias[n + j])) : 0.0f;
  }
  const bool uniform =
      (m0 + kBM <= M) && (m0 / HWo == (m0 + kBM - 1) / HWo);
  float psum[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) psum[j] = 0.0f;
  int pb = -1;

#pragma unroll
  for (int t = 0; t < kBM / (kNT / (kBN / 8)); ++t) {
    const int row = rbase + t * (kNT / (kBN / 8));
    const int m = m0 + row;
    if (m >= M || !n_ok) continue;
    const int b = m / HWo;
    const float mk = (float)p.out_mask[(size_t)m * p.out_z + n / p.out_cz];
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float acc = Cs[row * kLDC + cg * 8 + j];
      v[j] = kF32 ? __fadd_rn(__fmul_rn(acc, sc[j]), bi[j])
                  : rbf(rbf(rbf(acc) * sc[j]) + bi[j]);
      if (EPI == EPI_F32_POOL) v[j] = rbf(v[j]);  // g is a bf16 map
    }
    uint4 o;
    bf16* oe = reinterpret_cast<bf16*>(&o);
    if (kReluMask) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        oe[j] = __float2bfloat16_rn(fmaxf(v[j], 0.0f) * mk);
    } else if (kPool) {
#pragma unroll
      for (int j = 0; j < 8; ++j) oe[j] = __float2bfloat16_rn(v[j]);
      if (!uniform && b != pb) {
        if (pb >= 0)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            atomicAdd(p.pool + (size_t)pb * p.Cout + n + j, psum[j]);
            psum[j] = 0.0f;
          }
        pb = b;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) psum[j] += v[j] * mk;
    } else {  // EPI_AFFINE_COMBINE: relu(g*att + bn(acc)) * mask
      const uint4 gv = *reinterpret_cast<const uint4*>(
          p.g + (size_t)m * p.Cout + n);
      const uint4 av = *reinterpret_cast<const uint4*>(
          p.att + (size_t)b * p.Cout + n);
      const bf16* ge = reinterpret_cast<const bf16*>(&gv);
      const bf16* ae = reinterpret_cast<const bf16*>(&av);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float o2 = rbf(rbf(bf2f(ge[j]) * bf2f(ae[j])) + v[j]);
        oe[j] = __float2bfloat16_rn(fmaxf(o2, 0.0f) * mk);
      }
    }
    *reinterpret_cast<uint4*>(p.out + (size_t)m * p.Cout + n) = o;
  }

  if (kPool) {
    if (!uniform) {
      if (pb >= 0 && n_ok)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          atomicAdd(p.pool + (size_t)pb * p.Cout + n + j, psum[j]);
    } else {
      // lanes sharing cg (lane ^ 8, lane ^ 16) hold consecutive rows of
      // the same item: reduce in-warp, then across warps in shared memory,
      // then one atomic per channel per block
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        psum[j] += __shfl_xor_sync(0xffffffffu, psum[j], 8);
        psum[j] += __shfl_xor_sync(0xffffffffu, psum[j], 16);
      }
      if (lane < 8)
#pragma unroll
        for (int j = 0; j < 8; ++j) red[warp][lane * 8 + j] = psum[j];
      __syncthreads();
      if (tid < kBN && n0 + tid < p.Cout) {
        float s = 0.0f;
#pragma unroll
        for (int w8 = 0; w8 < kNT / 32; ++w8) s += red[w8][tid];
        atomicAdd(p.pool + (size_t)(m0 / HWo) * p.Cout + n0 + tid, s);
      }
    }
  }
}

// Parameters of a stride-1 'same' k x k conv over a [B, X, Y, cin] map
// whose epilogue applies a per-channel affine and the occupancy mask
// [B, X, Y, z] (the BEV block convs of K3 and K6).
inline ConvParams same_conv_params(const bf16* x, const bf16* w, bf16* out,
                                   int B, int X, int Y, int cin, int cout,
                                   int k, int z, const float* scale,
                                   const float* bias, const uint8_t* mask) {
  ConvParams p = {};
  p.x = x;
  p.w = w;
  p.out = out;
  p.B = B;
  p.H = X;
  p.W = Y;
  p.Cin = cin;
  p.Ho = X;
  p.Wo = Y;
  p.Cout = cout;
  p.KH = k;
  p.KW = k;
  p.stride = 1;
  p.pad = k / 2;
  p.scale = scale;
  p.bias = bias;
  p.out_mask = mask;
  p.out_z = z;
  p.out_cz = cout / z;
  return p;
}

// Launch helper: grid over (M tiles, N tiles) on `stream`.
template <int EPI, int GATHER = GATHER_SLAB32>
cudaError_t launch_conv(const ConvParams& p, cudaStream_t stream) {
  const int M = p.B * p.Ho * p.Wo;
  dim3 grid((M + kBM - 1) / kBM, (p.Cout + kBN - 1) / kBN);
  conv_igemm_kernel<EPI, GATHER><<<grid, kNT, 0, stream>>>(p);
  return cudaGetLastError();
}

// The gather a Cin takes (the wrappers' rules pass it): GATHER_SLAB32 at
// Cin % 32 == 0, GATHER_C8 at the other multiples of 8.
template <int EPI>
cudaError_t launch_conv_gather(const ConvParams& p, int gather,
                               cudaStream_t stream) {
  switch (gather) {
    case GATHER_SLAB32:
      if (p.Cin % 32) return cudaErrorInvalidValue;
      return launch_conv<EPI, GATHER_SLAB32>(p, stream);
    case GATHER_C8:
      if (p.Cin % 8) return cudaErrorInvalidValue;
      return launch_conv<EPI, GATHER_C8>(p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace agp
