// K4: the fused BEV-FPN head — conv0 + BN0 + relu + mask, then down0 + BN +
// relu + mask — without the full-resolution conv0 activation ever reaching
// device memory.
//
// Replaces the TPU kernel agplace_tpu/ops/pallas/bev_head.py:fused_head
// (_head_kernel).  The TPU kernel splits the input into its four (x, y)
// parity planes and builds conv0's im2col taps from rolled, masked copies
// of them, because Mosaic has no strided access; here each thread block
// gathers its im2col rows straight from the occupancy grid instead.  What
// the design keeps is the TPU kernel's point: down0 is k=2 s=2, so an
// output cell (xo, yo) needs conv0 only at the four full-resolution cells
// (2xo + dx, 2yo + dy), one per parity p = 2*dx + dy, and each of those
// parity activations is one tap of down0.
//
// A block owns kTM = 64 output cells.  For each parity p:
//   1. gather A [64, KP] from x [B, X, Y, Z*C0] (K = k0*k0*Z*C0 = 100 at
//      KITTI, zero-padded to KP = 112, a multiple of the MMA depth), and
//      that parity's z-mask [64, Z];
//   2. conv0 as a wmma GEMM A . W0 [KP, Z*C1] with W0 resident in shared
//      memory, fp32 accumulation;
//   3. epilogue into shared memory: H = bf16(relu(acc*s0 + b0) * mask)
//      ([64, Z*C1=256]; the affine in fp32 with fp32 scale and bias, one
//      round, as bev_head.py:149-155);
//   4. down0 as a wmma GEMM H . Wd[p] [Z*C1, Zo*C2] into an fp32
//      accumulator that stays in registers across the four parities
//      (Wd[p] is fetched with cp.async while steps 1-3 run).
// Then out = bf16(relu(acc_d*sd + bd) * mask_out) (bev_head.py:161-163).
// The affines are a multiply and an add each rounded to fp32 (no fma), so
// the plain PyTorch version `acc * s + b` gives the same bits; what differs
// from it is only the fp32 summation order of the two GEMMs.  mask_out is
// the ME max-pool of the occupancy (z pairing zp = (zi + lo_z) / 2),
// computed outside as the JAX wrapper computes it.
//
// What bounds it on the H100: tensor-core work.  At b32 KITTI the kernel
// reads the 4 MB occupancy grid and writes the 34 MB output, and does
// 2*32*128*128*112*256 + 2*32*64*64*1024*128 = 30 + 34 GFLOP; the 268 MB
// full-resolution activation that K2's path writes and reads again never
// exists.  The weights (57 KB + 4 x 64 KB) come from L2 per block.
#include <mma.h>

#include "conv_igemm.cuh"

namespace {

using agp::bf16;
using namespace nvcuda;

constexpr int kTM = 64;   // output cells per block
constexpr int kHT = 256;  // 8 warps: 2 along M x 4 along N

struct HeadParams {
  const bf16* x;
  const uint8_t* mask;
  const bf16* w0;  // [kp, zc1], rows >= k0*k0*zc0 zero
  const float* s0;
  const float* b0;
  const bf16* wd;  // [4, zc1, zc2]
  const float* sd;
  const float* bd;
  const uint8_t* mask_out;  // [B, X/2, Y/2, zo]
  bf16* out;                // [B, X/2, Y/2, zc2]
  int B, X, Y, zc0, k0, kp, zc1, z, zc2, zo;
};

__host__ __device__ inline int round128(int bytes) {
  return (bytes + 127) / 128 * 128;
}

// shared-memory layout (bytes), every region 128-byte aligned
struct HeadSmem {
  int w0, wd, a, h, scr, msk, total;
  int ldw0, ldwd, lda, ldh;
  __host__ __device__ explicit HeadSmem(const HeadParams& p) {
    ldw0 = p.zc1 + 8;
    ldwd = p.zc2 + 8;
    lda = p.kp + 8;
    ldh = p.zc1 + 8;
    w0 = 0;
    wd = w0 + round128(p.kp * ldw0 * 2);
    a = wd + round128(p.zc1 * ldwd * 2);
    h = a + round128(kTM * lda * 2);
    scr = h + round128(kTM * ldh * 2);
    msk = scr + (kHT / 32) * 256 * 4;
    total = msk + round128(kTM * p.z);
  }
};

__global__ void __launch_bounds__(kHT) bev_head_kernel(HeadParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const HeadSmem L(p);
  bf16* sW0 = reinterpret_cast<bf16*>(smem + L.w0);
  bf16* sWd = reinterpret_cast<bf16*>(smem + L.wd);
  bf16* sA = reinterpret_cast<bf16*>(smem + L.a);
  bf16* sH = reinterpret_cast<bf16*>(smem + L.h);
  uint8_t* sMask = smem + L.msk;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  float* scr = reinterpret_cast<float*>(smem + L.scr) + warp * 256;
  const int Xo = p.X / 2, Yo = p.Y / 2;
  const int HWo = Xo * Yo;
  const int M = p.B * HWo;
  const int m0 = blockIdx.x * kTM;
  const int taps = p.k0 * p.k0;
  const int kk0 = taps * p.zc0;  // true conv0 depth (< kp)
  const int half = p.k0 / 2;
  const int c1 = p.zc1 / p.z, c2 = p.zc2 / p.zo;
  const int nw1 = p.zc1 / 4, nw2 = p.zc2 / 4;  // columns per warp
  const int nf1 = nw1 / 16, nf2 = nw2 / 16;    // fragments per warp

  // W0 -> shared memory once (cp.async group 0); zero A's padded depth
  {
    const int cpr = p.zc1 / 8;
    for (int c = tid; c < p.kp * cpr; c += kHT) {
      const int k = c / cpr, n = (c - k * cpr) * 8;
      agp::cp_async16(sW0 + k * L.ldw0 + n, p.w0 + (size_t)k * p.zc1 + n,
                      true);
    }
    agp::cp_async_commit();
    const int padw = p.kp - kk0;
    for (int i = tid; i < kTM * padw; i += kHT) {
      const int r = i / padw;
      sA[r * L.lda + kk0 + (i - r * padw)] = __float2bfloat16_rn(0.0f);
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_d[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc_d[i][j], 0.0f);

  for (int par = 0; par < 4; ++par) {
    const int dx = par >> 1, dy = par & 1;
    // Wd[par] -> shared memory, in flight while conv0 runs
    {
      const bf16* src = p.wd + (size_t)par * p.zc1 * p.zc2;
      const int cpr = p.zc2 / 8;
      for (int c = tid; c < p.zc1 * cpr; c += kHT) {
        const int k = c / cpr, n = (c - k * cpr) * 8;
        agp::cp_async16(sWd + k * L.ldwd + n, src + (size_t)k * p.zc2 + n,
                        true);
      }
      agp::cp_async_commit();
    }
    // im2col rows of conv0 at (2xo + dx, 2yo + dy), zero outside the grid
    for (int i = tid; i < kTM * taps; i += kHT) {
      const int r = i / taps, t = i - r * taps;
      const int m = m0 + r;
      bool ok = m < M;
      long long pix = 0;
      if (ok) {
        const int b = m / HWo, rem = m - b * HWo;
        const int xo = rem / Yo, yo = rem - xo * Yo;
        const int ta = t / p.k0, tb = t - ta * p.k0;
        const int ix = 2 * xo + dx + ta - half;
        const int iy = 2 * yo + dy + tb - half;
        ok = ix >= 0 && ix < p.X && iy >= 0 && iy < p.Y;
        pix = ((long long)b * p.X + ix) * p.Y + iy;
      }
      bf16* dst = sA + r * L.lda + t * p.zc0;
      for (int ci = 0; ci < p.zc0; ++ci)
        dst[ci] = ok ? p.x[pix * p.zc0 + ci] : __float2bfloat16_rn(0.0f);
    }
    // this parity's occupancy [kTM, z]
    for (int i = tid; i < kTM * p.z; i += kHT) {
      const int r = i / p.z, zz = i - r * p.z;
      const int m = m0 + r;
      uint8_t v = 0;
      if (m < M) {
        const int b = m / HWo, rem = m - b * HWo;
        const int xo = rem / Yo, yo = rem - xo * Yo;
        v = p.mask[(((long long)b * p.X + 2 * xo + dx) * p.Y + 2 * yo + dy) *
                       p.z + zz];
      }
      sMask[i] = v;
    }
    agp::cp_async_wait<1>();  // W0 landed (Wd[par] may still be in flight)
    __syncthreads();

    // conv0: this warp's [32, nw1] patch of A . W0
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc0[i][j], 0.0f);
    for (int kk = 0; kk < p.kp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sA + (wm * 32 + i * 16) * L.lda + kk,
                               L.lda);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nf1) break;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sW0 + kk * L.ldw0 + wn * nw1 + j * 16,
                               L.ldw0);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::mma_sync(acc0[i][j], fa[i], fb, acc0[i][j]);
      }
    }
    // epilogue: H = bf16(relu(acc*s0 + b0) * mask), one 16x16 tile at a
    // time through this warp's scratch; lane -> row lane/2, 8 columns
    const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nf1) break;
        wmma::store_matrix_sync(scr, acc0[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int r = wm * 32 + i * 16 + er;
        const int n = wn * nw1 + j * 16 + ec;
        const float mk = (float)sMask[r * p.z + n / c1];
        uint4 o;
        bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float v =
              __fadd_rn(__fmul_rn(scr[er * 16 + ec + e], p.s0[n + e]),
                        p.b0[n + e]);
          oe[e] = __float2bfloat16_rn(fmaxf(v, 0.0f) * mk);
        }
        *reinterpret_cast<uint4*>(sH + r * L.ldh + n) = o;
        __syncwarp();
      }
    agp::cp_async_wait<0>();  // Wd[par] landed
    __syncthreads();          // H complete

    // down0 tap `par`: acc_d += H . Wd[par]
    for (int kk = 0; kk < p.zc1; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sH + (wm * 32 + i * 16) * L.ldh + kk,
                               L.ldh);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j >= nf2) break;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sWd + kk * L.ldwd + wn * nw2 + j * 16,
                               L.ldwd);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::mma_sync(acc_d[i][j], fa[i], fb, acc_d[i][j]);
      }
    }
    __syncthreads();  // A, mask, H and Wd are rewritten by the next parity
  }

  // out = bf16(relu(acc_d*sd + bd) * mask_out)
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= nf2) break;
      wmma::store_matrix_sync(scr, acc_d[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 32 + i * 16 + er;
      const int n = wn * nw2 + j * 16 + ec;
      if (m < M) {
        const float mk = (float)p.mask_out[(size_t)m * p.zo + n / c2];
        uint4 o;
        bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float v = __fadd_rn(
              __fmul_rn(scr[er * 16 + ec + e], p.sd[n + e]), p.bd[n + e]);
          oe[e] = __float2bfloat16_rn(fmaxf(v, 0.0f) * mk);
        }
        *reinterpret_cast<uint4*>(p.out + (size_t)m * p.zc2 + n) = o;
      }
      __syncwarp();
    }
}

}  // namespace

// kp: conv0 depth padded to a multiple of 16 (<= 128); zc1 a multiple of
// 64 up to 256; zc2 64 or 128 (the wrapper checks).
extern "C" int agp_bev_head(const bf16* x, const uint8_t* mask,
                            const bf16* w0p, const float* s0, const float* b0,
                            const bf16* wd, const float* sd, const float* bd,
                            const uint8_t* mask_out, bf16* out, int B, int X,
                            int Y, int zc0, int k0, int kp, int zc1, int z,
                            int zc2, int zo, void* stream) {
  const HeadParams p = {x,  mask, w0p, s0, b0, wd, sd, bd, mask_out, out,
                        B,  X,    Y,   zc0, k0, kp, zc1, z, zc2, zo};
  const int smem = HeadSmem(p).total;
  cudaError_t err = cudaFuncSetAttribute(
      bev_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int M = B * (X / 2) * (Y / 2);
  bev_head_kernel<<<(M + kTM - 1) / kTM, kHT, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
