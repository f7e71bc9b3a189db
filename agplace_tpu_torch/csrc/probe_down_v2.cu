// P2: BEV stage 0 as one concat GEMM over the four conv0 parity planes.
//
// Replaces the TPU probe kernel scripts/probe_down_v2.py:fused_v2 (_kernel,
// whose pallas_call is at :143), an alternative formulation of K2
// (bev_down.cu).  conv0 runs outside the kernel as four bare stride-2 cuDNN
// convs, one per output parity, as XLA ran them outside the Pallas call.
// The kernel reads the four contiguous planes g_p [B, X/2, Y/2, Z*C1]
// (p = 2*px + py) as one operand with K = 4*Z*C1 -- the TPU kernel's
// concatenation, never materialised:
//   A load    act = relu(bf16(bf16(g*s0) + b0)) * zmask  (one wide BN0
//             affine over the 4*Z*C1 concatenated channels)
//   GEMM      acc = sum_k act . wd   (fp32 accumulation)
//   epilogue  out = relu(bf16(bf16(bf16(acc)*sd) + bd)) * mask_out
// The TPU kernel's E / PE selection dots become index arithmetic: the z-mask
// of plane p at (xo, yo) is the full-resolution mask at (2xo+px, 2yo+py);
// mask_out (the ME max-pool with the z pairing of me_down_align) is computed
// outside, as for K2.
//
// What bounds it on the H100: bytes.  At b32 the four planes are 4 x 67 MB,
// read once, and the output 34 MB: 0.090 ms at 3.35 TB/s, against 0.035 ms
// of bf16 tensor-core work.  That is K2's GEMM with A taken from four maps
// instead of one strided map, so at the widths K2's tiles take (Z*C1 a
// multiple of 64 up to 1024, Zo*C2 of 128 up to 512, z <= 16: every
// preset's stage 0) P2 runs K2's Hopper main loop (down0_sm90.cuh):
//   * a persistent grid of one block per SM walks tiles of an 8 (xo) x 16
//     (yo) patch of one item and a 128-channel N tile;
//   * the K loop is 4 planes x Z*C1/64 slabs.  Plane p is the step's tap
//     p = 2 dx + dy of K2, and its A operand is one 4-D TMA box [C 64,
//     Yo 16, Xo 8, B 1] of g_p at (c0, yo0, xo0, b), from one of four
//     tensor maps chosen by the step; TMA zero-fills the ragged edge.  B
//     is wd as a row-major [4*Z*C1, Zo*C2] matrix, two 64 x 64 boxes per
//     step read MN-major;
//   * one producer warp keeps a 4-stage ring (32 KB a stage) full; two
//     consumer warpgroups ldmatrix the A stage into wgmma's register
//     fragment, apply the BN0 affine, relu and the z-mask of the step's
//     plane in packed bf16x2 (K2's bit-exact __hmul2_rn / __hadd2_rn), and
//     issue RS wgmma m64n128k16; the epilogue is K3's store_tile.
// The launch geometry comes from the wrapper (ops/probe_down_v2.py:
// down_concat_tiling), its one source; the host side only checks the
// boxes against the compiled tiles.
//
// At the narrower widths the parent took (Z*C1 a multiple of 32, Zo*C2 of
// 8: e.g. C1 = 8 at z = 4) the first design below stays, chosen by shape
// in the wrapper: a block owns 128 output cells and 128 channels of N, the
// wide affine, relu and mask applied in registers between a 16-byte global
// load and the shared-memory store, a 2-stage cp.async ring for the
// weights, nvcuda::wmma bf16 with fp32 accumulation.
#include "conv_igemm.cuh"
#include "down0_sm90.cuh"

namespace {

__global__ void __launch_bounds__(agp::kSm90Threads, agp::kDown0MinBlocks)
    down_concat_sm90_kernel(const __grid_constant__ CUtensorMap tmap_g0,
                            const __grid_constant__ CUtensorMap tmap_g1,
                            const __grid_constant__ CUtensorMap tmap_g2,
                            const __grid_constant__ CUtensorMap tmap_g3,
                            const __grid_constant__ CUtensorMap tmap_w,
                            agp::Down0Params p) {
  // plane p = tap: the box of g_p [B, Xo, Yo, Z*C1]
  agp::down0_body(tmap_w, p,
                  [&](uint32_t sa, uint32_t bar, int tap, int c0, int yo0,
                      int xo0, int b) {
                    const CUtensorMap* m = tap == 0   ? &tmap_g0
                                           : tap == 1 ? &tmap_g1
                                           : tap == 2 ? &tmap_g2
                                                      : &tmap_g3;
                    agp::tma_load_4d(sa, m, bar, c0, yo0, xo0, b);
                  });
}


using agp::bf16;
using agp::bf2f;
using agp::rbf;

constexpr int kBM = 128, kBN = 128, kBK = 32, kNT = 256;
constexpr int kLDA = kBK + 8, kLDB = kBN + 8, kLDC = kBN + 4;
constexpr int kStageElems = kBM * kLDA + kBK * kLDB;  // bf16 per stage
constexpr int kRingBytes = 2 * kStageElems * 2;
constexpr int kTileBytes =
    kRingBytes > kBM * kLDC * 4 ? kRingBytes : kBM * kLDC * 4;

struct DownConcatParams {
  const bf16* g[4];         // parity planes [B, Xo, Yo, zc1]
  const uint8_t* mask;      // full-resolution occupancy [B, X, Y, z]
  const float* s0;          // wide BN0 affine [4*zc1]
  const float* b0;
  const bf16* wd;           // [4*zc1, zc2] (the folded [2,2,zc1,zc2])
  const float* sd;          // down BN affine [zc2]
  const float* bd;
  const uint8_t* mask_out;  // [B, Xo, Yo, zo]
  bf16* out;                // [B, Xo, Yo, zc2]
  int B, X, Y, zc1, z, zc2, zo;
};

__global__ void __launch_bounds__(kNT)
down_concat_kernel(DownConcatParams p) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);  // after the K loop
  const int K = 4 * p.zc1;
  float* aff = reinterpret_cast<float*>(smem + kTileBytes);  // [2][K]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int xo_n = p.X / 2, yo_n = p.Y / 2;
  const int M = p.B * xo_n * yo_n;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int c1 = p.zc1 / p.z;

  for (int k = tid; k < K; k += kNT) {
    aff[k] = rbf(p.s0[k]);
    aff[K + k] = rbf(p.b0[k]);
  }

  // A: kBM*kBK/8 = 512 chunks of 8 channels, two per thread
  int a_row[2], a_kc[2];
  long long a_off[2], a_mb[2];  // plane element / full-res mask offsets
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kNT;
    a_row[i] = c / (kBK / 8);
    a_kc[i] = (c % (kBK / 8)) * 8;
    const int m = m0 + a_row[i];
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    const int b = mm / (xo_n * yo_n);
    const int rem = mm - b * xo_n * yo_n;
    const int xo = rem / yo_n, yo = rem - xo * yo_n;
    a_off[i] = (long long)mm * p.zc1;
    a_mb[i] = (((long long)b * p.X + 2 * xo) * p.Y + 2 * yo) * p.z;
  }
  uint4 ra[2];
  float rmk[2];
  auto fetch_a = [&](int kt) {
    const int k0 = kt * kBK;
    const int pl = k0 / p.zc1;  // zc1 % kBK == 0: one plane per slice
    const int ci0 = k0 - pl * p.zc1;
    const bf16* g = p.g[pl];
    const long long mshift = ((long long)(pl >> 1) * p.Y + (pl & 1)) * p.z;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ra[i] = make_uint4(0, 0, 0, 0);
      rmk[i] = 0.0f;
      if (a_ok[i]) {
        const int ci = ci0 + a_kc[i];
        ra[i] = *reinterpret_cast<const uint4*>(g + a_off[i] + ci);
        rmk[i] = (float)p.mask[a_mb[i] + mshift + ci / c1];
      }
    }
  };
  auto store_a = [&](bf16* As, int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bf16* e = reinterpret_cast<bf16*>(&ra[i]);
      const int k = kt * kBK + a_kc[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float t = rbf(rbf(bf2f(e[j]) * aff[k + j]) + aff[K + k + j]);
        e[j] = __float2bfloat16_rn(fmaxf(t, 0.0f) * rmk[i]);
      }
      *reinterpret_cast<uint4*>(As + a_row[i] * kLDA + a_kc[i]) = ra[i];
    }
  };
  // B: kBK*kBN/8 = 512 chunks, two per thread, through cp.async
  auto issue_b = [&](bf16* Bs, int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kNT;
      const int row = c / (kBN / 8), nc = (c % (kBN / 8)) * 8;
      const bool ok = n0 + nc < p.zc2;
      agp::cp_async16(Bs + row * kLDB + nc,
                      ok ? p.wd + (size_t)(kt * kBK + row) * p.zc2 + n0 + nc
                         : p.wd,
                      ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps of 32 x 64

  const int KT = K / kBK;
  fetch_a(0);
  issue_b(ring + kBM * kLDA, 0);
  agp::cp_async_commit();
  __syncthreads();  // the affine is in shared memory
  for (int kt = 0; kt < KT; ++kt) {
    bf16* As = ring + (kt & 1) * kStageElems;
    const bf16* Bs = As + kBM * kLDA;
    store_a(As, kt);  // stage kt & 1 was last read in step kt - 2
    agp::cp_async_wait<0>();
    __syncthreads();  // A and B of kt are in; every warp is done with kt-1
    if (kt + 1 < KT) {
      fetch_a(kt + 1);
      issue_b(ring + ((kt + 1) & 1) * kStageElems + kBM * kLDA, kt + 1);
    }
    agp::cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * kLDA + kk,
                               kLDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kLDB + wn * 64 + j * 16,
                               kLDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  agp::cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the C tile
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kLDC + wn * 64 + j * 16,
                              acc[i][j], kLDC, wmma::mem_row_major);
  __syncthreads();

  // epilogue: thread -> 8 channels (cg) x rows rbase + 16*t
  const int cg = tid % (kBN / 8);
  const int rbase = tid / (kBN / 8);
  const int n = n0 + cg * 8;
  if (n >= p.zc2) return;
  const int c2 = p.zc2 / p.zo;
  float sc[8], bi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = rbf(p.sd[n + j]);
    bi[j] = rbf(p.bd[n + j]);
  }
#pragma unroll
  for (int t = 0; t < kBM / (kNT / (kBN / 8)); ++t) {
    const int row = rbase + t * (kNT / (kBN / 8));
    const int m = m0 + row;
    if (m >= M) break;
    const float mk = (float)p.mask_out[(size_t)m * p.zo + n / c2];
    uint4 o;
    bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = rbf(rbf(rbf(Cs[row * kLDC + cg * 8 + j]) * sc[j]) + bi[j]);
      oe[j] = __float2bfloat16_rn(fmaxf(v, 0.0f) * mk);
    }
    *reinterpret_cast<uint4*>(p.out + (size_t)m * p.zc2 + n) = o;
  }
}

}  // namespace

extern "C" int agp_down_concat(const bf16* g0, const bf16* g1, const bf16* g2,
                               const bf16* g3, const uint8_t* mask,
                               const float* s0, const float* b0,
                               const bf16* wd, const float* sd,
                               const float* bd, const uint8_t* mask_out,
                               bf16* out, int B, int X, int Y, int zc1, int z,
                               int zc2, int zo, void* stream) {
  DownConcatParams p = {{g0, g1, g2, g3}, mask, s0, b0, wd, sd, bd, mask_out,
                        out, B, X, Y, zc1, z, zc2, zo};
  const int smem = kTileBytes + 2 * 4 * zc1 * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      down_concat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int M = B * (X / 2) * (Y / 2);
  dim3 grid((M + kBM - 1) / kBM, (zc2 + kBN - 1) / kBN);
  down_concat_kernel<<<grid, kNT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// The Hopper route.  The geometry arguments are the fields of the wrapper's
// DownConcatTiling in order: the planes' dims (Z*C1, Yo, Xo, B) and box, wd
// dims (Zo*C2, 4*Z*C1) and box, innermost first, then the patch grid, the
// N tiles, the K steps, the number of tiles and the number of blocks.
extern "C" int agp_down_concat_sm90(
    const bf16* g0, const bf16* g1, const bf16* g2, const bf16* g3,
    const uint8_t* mask, const float* s0, const float* b0, const bf16* wd,
    const float* sd, const float* bd, const uint8_t* mask_out, bf16* out,
    int z, int zo, int gd0, int gd1, int gd2, int gd3, int gb0, int gb1,
    int gb2, int gb3, int wd0, int wd1, int wb0, int wb1, int npx, int npy,
    int nn, int steps, int tiles, int grid, void* stream) {
  using namespace agp;
  // the boxes and widths must be the tiles the kernel is compiled for
  if (gb0 != kSlab || gb1 != kPatchY || gb2 != kPatchX || gb3 != 1 ||
      !down0_widths_ok(gd0, z, zo, wd0, wd1, wb0, wb1, nn, steps, grid))
    return cudaErrorInvalidValue;
  const cuuint64_t gd[4] = {(cuuint64_t)gd0, (cuuint64_t)gd1,
                            (cuuint64_t)gd2, (cuuint64_t)gd3};
  const cuuint32_t gb[4] = {(cuuint32_t)gb0, (cuuint32_t)gb1,
                            (cuuint32_t)gb2, (cuuint32_t)gb3};
  const cuuint64_t wdims[2] = {(cuuint64_t)wd0, (cuuint64_t)wd1};
  const cuuint32_t wbox[2] = {(cuuint32_t)wb0, (cuuint32_t)wb1};
  CUtensorMap tg[4], tw;
  const bf16* planes[4] = {g0, g1, g2, g3};
  for (int i = 0; i < 4; ++i)
    if (!encode_bf16(&tg[i], planes[i], 4, gd, gb))
      return cudaErrorInvalidValue;
  if (!encode_bf16(&tw, wd, 2, wdims, wbox)) return cudaErrorInvalidValue;
  const Down0Params p = {mask, s0, b0, sd, bd, mask_out, out, 2 * gd2,
                         2 * gd1, gd0, wd0, z, zo, npx, npy, nn, steps,
                         tiles};
  return launch_sm90(down_concat_sm90_kernel, grid, kDown0SmemBytes,
                     static_cast<cudaStream_t>(stream), kSm90Threads, tg[0],
                     tg[1], tg[2], tg[3], tw, p);
}
