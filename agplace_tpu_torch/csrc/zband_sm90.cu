// The z-banded implicit GEMM for Hopper: the BEV convs of K2, K3 and K4 at
// every width the preset sm90 tiles do not take.
//
// Replaces, at those widths, the convs of the TPU kernels agplace_tpu/ops/
// pallas/bev_down.py:fused_conv0_down0 (the down0 GEMM with its BN0
// prologue), agplace_tpu/ops/pallas/bev_block_sm.py:fused_eca_block_sm
// (the two 3x3 conv phases) and agplace_tpu/ops/pallas/bev_head.py:
// fused_head (its down0 half), which keep their operands whole in VMEM at
// any width.  It computes the same function as those kernels: the conv of
// the z-folded map x [B, X, Y, Zi*Ci] with the folded weight [k, k, Zi*Ci,
// Zo*Co], and the same epilogue with the same rounding points.  The wrapper
// pads every z-slab to a multiple of 8 channels (ops/widths.py: pad_slabs).
//
// What bounds it on the H100.  The folded weight is block-banded: output
// slab zo of the 3x3x3 stride-1 fold reads the input slabs zo-1..zo+1
// (sparse/bev_grid.py: fold_w2_stride1), the k2s2 down's reads 2 zo + t -
// lo, t in (0, 1), lo from me_down_align (fold_w2_k2s2); every other block
// of the fold is zero.  A dense GEMM over the fold multiplies those zeros
// (15/16 of K2's products at z = 32).  Over the live blocks alone the work
// is a conv per slab of taps * Ci deep and Co wide: bytes-bound for the
// k2s2 down (g is read once), near the balance point for the 3x3 phases.
// So the K loop visits only the live blocks, and z and Z*C are no longer
// tile sizes:
//   * a tile is an 8 (x) x 16 (y) patch of output cells of one item (128
//     GEMM rows) times 64 output channels of ONE output slab zo: Co is
//     padded to 8 and split into Co / 64 N tiles (the last one ragged:
//     only its live columns are stored); tiles run N tile fastest, then
//     zo, so neighbouring tiles read the same input slabs from L2;
//   * its K loop runs over the live input slabs of zo, clipped to [0, Zi),
//     then the spatial taps, then 64-channel slices of the slab.  A step's
//     A operand is one 5-D TMA box of x whose innermost dim is the slab's
//     Ci channels: (Ci, Zi, Y, X, B) for the 'same' 3x3 conv, at (c0, zi,
//     y0 + dy - 1, x0 + dx - 1, b), so the halo and the ragged edge read
//     zeros; (Ci, 2 Zi, Yo, 2, B Xo) for the k2s2 down, at (c0, dy Zi + zi,
//     yo0, dx, b Xo + xo0), x[b, 2 xo + dx, 2 yo + dy] being that view's
//     [b Xo + xo, dx, yo, dy Zi + zi] (rows past the item are read and
//     never stored).  Channels past Ci read zeros, so a slice never crosses
//     into the next slab.  B is the live block's [64 ci, 64 co] box of the
//     weight viewed as (Co, Zo, Ci, Zi, taps) at (n0, zo, c0, zi, tap):
//     rows past Ci and columns past Co read zeros.  Both boxes land
//     128-byte swizzled, as K3's sm90 kernel reads them: A K-major, B
//     MN-major; only the 16-deep K steps that hold live channels are
//     issued;
//   * one producer warp keeps a ring of kStages = 4 stages (24 KB each)
//     full with TMA loads on full / empty mbarriers (sm90.cuh's ring); two
//     consumer warpgroups of 64 rows issue wgmma m64n64k16, A from shared
//     memory (SS), or for K2 from registers (RS): the A tile is ldmatrix'ed
//     into the register fragment and takes BN0's bf16 affine, relu and the
//     row's occupancy of (tap, zi) first, in packed bf16x2 arithmetic, the
//     rounding points of bev_down.py:89-94 (down0_sm90.cuh's prologue);
//   * a persistent grid of two blocks per SM (97 KB of shared memory each)
//     walks the tiles; the ring's step counters run on across a block's
//     tiles, whose K loops differ in length at the ends of the z range;
//   * the epilogue works from the accumulator registers: K3's bf16 forms
//     (phase 1: relu and mask; phase 2: g and its fp32 masked pool, one
//     atomic per channel per tile), K2's bf16 form, K4's fp32 form, each
//     with the output slab's mask (one byte per row).
// This is the first, simple design: tuning (N tiles of 128 for the wide
// slabs, A reused across a slab's N tiles) is for later work.
#include "sm90.cuh"

namespace {

using namespace agp;

enum { FOLD_S1 = 0, FOLD_K2S2 = 1 };  // the 3x3 'same' conv, the k2s2 down

constexpr int kBN = 64;  // output channels of a tile
constexpr int kStages = 4;
constexpr int kMinBlocks = 2;  // per SM
constexpr int kABytes = kSlabBytes;  // the x box: 128 cells x 64 channels
constexpr int kBBytes = kBoxBytes;   // the weight box: 64 x 64
constexpr int kStageBytes = kABytes + kBBytes;  // 24 KB
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + alignment

struct ZbandParams {
  const uint8_t* mask_in;  // K2's prologue: occupancy [B, X, Y, Zi]
  const float* s_in;       // K2's prologue: BN0's affine [Zi*Ci]
  const float* b_in;
  const float* scale;      // the epilogue's affine [Zo*Co]
  const float* bias;
  const uint8_t* mask;     // output occupancy [B, Xo, Yo, Zo]
  bf16* out;               // [B, Xo, Yo, Zo*Co]
  float* pool;             // the pool form: [B, Zo*Co] fp32 sums (+=)
  int X, Y, Xo, Yo, zi, ci, zo, co;  // Ci, Co: per slab, multiples of 8
  int npx, npy, ntn, nks, taps, zk, zs, zlo, tiles;
};

// D[64 x 64] += A[64 x 16] (bf16 registers, the m16n8k16 A fragment of
// each warp's 16 rows) * B[16 x 64] (MN-major, shared)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// A tile of the schedule: item b, patch origin (x0, y0) in output cells,
// output slab zo, first output channel n0 of the slab, first live input
// slab, K steps (live slabs x taps x 64-channel slices).  The wrapper's
// zband_tile replays it.
struct Tile {
  int b, x0, y0, zo, n0, zi0, steps;
};

__device__ __forceinline__ Tile tile_at(const ZbandParams& p, int t) {
  Tile o;
  o.n0 = (t % p.ntn) * kBN;
  t /= p.ntn;
  o.zo = t % p.zo;
  t /= p.zo;
  o.y0 = (t % p.npy) * kPatchY;
  t /= p.npy;
  o.x0 = (t % p.npx) * kPatchX;
  o.b = t / p.npx;
  const int first = p.zs * o.zo - p.zlo;  // the fold's slab of t = 0
  o.zi0 = max(first, 0);
  const int last = min(first + p.zk - 1, p.zi - 1);
  o.steps = max(last - o.zi0 + 1, 0) * p.taps * p.nks;
  return o;
}

template <int FOLD, bool PRO, int EPI>
__global__ void __launch_bounds__(kSm90Threads, kMinBlocks)
    zband_sm90_kernel(const __grid_constant__ CUtensorMap tmap_x,
                      const __grid_constant__ CUtensorMap tmap_w,
                      ZbandParams p) {
  constexpr bool kPool = EPI == STORE_BF16_POOL;
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ float red[kConsumers / 32][kBN];
  const uint32_t ring = (smem_u32(smem) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  if (tid == 0) {
    ring_init<kStages>(full, empty);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: one thread keeps the ring full across the tiles
    if (tid == kConsumers) {
      int k0 = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const Tile t = tile_at(p, tile);
        ring_produce<kStages>(
            full, empty, k0, t.steps, kStageBytes,
            [&](int i, int s, uint32_t bar) {
              // step i: (live slab, tap, slice), the slice fastest
              const int ks = i % p.nks, r = i / p.nks;
              const int tap = r % p.taps, zi = t.zi0 + r / p.taps;
              const int c0 = ks * kSlab;
              const uint32_t sa = ring + s * kStageBytes, sb = sa + kABytes;
              if (FOLD == FOLD_S1) {
                const int dx = tap / 3, dy = tap - 3 * dx;
                tma_load_5d(sa, &tmap_x, bar, c0, zi, t.y0 + dy - 1,
                            t.x0 + dx - 1, t.b);
              } else {
                tma_load_5d(sa, &tmap_x, bar, c0, (tap & 1) * p.zi + zi,
                            t.y0, tap >> 1, t.b * p.Xo + t.x0);
              }
              tma_load_5d(sb, &tmap_w, bar, t.n0, t.zo, c0, zi, tap);
            });
        k0 += t.steps;
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns GEMM rows [64 wg, 64 wg + 64); warp
  // `warp` holds rows 16 warp + lane/4 (+8) of the accumulator, patch cells
  // (warp, lane/4 (+8))
  const int wg = tid / 128, warp = tid / 32, lane = tid & 31, q = lane & 3;
  // ldmatrix (the RS prologue): lane l gives row l % 8 (+8 for lanes 8-15,
  // 24-31) of the warp's 16 rows, 16-byte chunk l / 16 of the K step
  const int lrow = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.0f, 0.0f);
  const int zco = p.zo * p.co;
  int k0 = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const Tile t = tile_at(p, tile);
    // the prologue's occupancy: bit (slab * taps + tap) of mb[h] is the
    // input cell of tap (dx, dy) under row h's output cell, in live slab
    // zi0 + slab
    uint32_t mb[2] = {0u, 0u};
    if (PRO) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int xo = t.x0 + warp, yo = t.y0 + lane / 4 + 8 * h;
        if (xo < p.Xo && yo < p.Yo) {
          const int nlive = t.steps / (p.taps * p.nks);
          for (int tap = 0; tap < p.taps; ++tap) {
            const int dx = tap >> 1, dy = tap & 1;
            const uint8_t* mp =
                p.mask_in + (((size_t)t.b * p.X + 2 * xo + dx) * p.Y +
                             2 * yo + dy) * p.zi + t.zi0;
            for (int sl = 0; sl < nlive; ++sl)
              mb[h] |= (uint32_t)(mp[sl] != 0) << (sl * p.taps + tap);
          }
        }
      }
    }
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    uint32_t a[16] = {};  // the RS prologue's A fragments, 4 per K step
    auto mma = [&](int i, int s) {
      const int ks = i % p.nks;
      // the 16-deep K steps holding live channels of the slice
      const int nk = min(kSlab, p.ci - ks * kSlab + 15) / 16;
      const uint32_t sa = ring + s * kStageBytes, sb = sa + kABytes;
      if (PRO) {
        const int r = i / p.nks;
        const int tap = r % p.taps, sl = r / p.taps, zi = t.zi0 + sl;
        const uint32_t bit = sl * p.taps + tap;
        const uint32_t mt[2] = {(mb[0] >> bit) & 1u, (mb[1] >> bit) & 1u};
#pragma unroll
        for (int kk = 0; kk < kSlab / 16; ++kk) {
          if (kk >= nk) break;
          uint32_t v[4];
          ldmatrix_x4(v, sa + sw128_offset(lrow, 2 * kk + (lane >> 4)));
          // register r: row lane/4 + 8 (r & 1), channels ch, ch + 1 of
          // the slab, ch = 64 ks + 16 kk + 2q (+8 for r >= 2)
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const int ch = ks * kSlab + 16 * kk + 2 * q + 8 * (rr >> 1);
            const bool on = mt[rr & 1] && ch < p.ci;
            const int c = on ? zi * p.ci + ch : 0;
            const float2 sc = *reinterpret_cast<const float2*>(p.s_in + c);
            const float2 bi = *reinterpret_cast<const float2*>(p.b_in + c);
            __nv_bfloat162 x2 =
                __hmul2_rn(*reinterpret_cast<const __nv_bfloat162*>(&v[rr]),
                           __floats2bfloat162_rn(sc.x, sc.y));
            x2 = __hmax2(__hadd2_rn(x2, __floats2bfloat162_rn(bi.x, bi.y)),
                         zero2);
            a[4 * kk + rr] = on ? *reinterpret_cast<uint32_t*>(&x2) : 0u;
          }
        }
        // every fragment in registers before the MMAs (down0_sm90.cuh)
        fence_regs(a);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSlab / 16; ++kk)
          if (kk < nk) wgmma_m64n64k16_rs(acc, &a[4 * kk], b_desc(sb, kk));
      } else {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSlab / 16; ++kk)
          if (kk < nk)
            wgmma_m64n64k16_ss(acc, a_desc(sa, wg, kk), b_desc(sb, kk), 1);
      }
    };
    if (PRO)
      ring_consume<kStages, 0>(full, empty, k0, t.steps, lane, mma, [&] {
        fence_regs(acc);
        fence_regs(a);
      });
    else
      ring_consume<kStages, 1>(full, empty, k0, t.steps, lane, mma,
                               [&] { fence_regs(acc); });
    k0 += t.steps;

    // ---- epilogue: rows (warp, lane/4 (+8)) of the patch, the tile's
    // live columns (a multiple of 8) of slab zo
    const int live = min(kBN, p.co - t.n0);
    const int nbase = t.zo * p.co + t.n0;
    size_t m[2];
    bool ok[2];
    float mk[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int xo = t.x0 + warp, yo = t.y0 + lane / 4 + 8 * h;
      ok[h] = xo < p.Xo && yo < p.Yo;
      m[h] = ((size_t)t.b * p.Xo + (ok[h] ? xo : 0)) * p.Yo +
             (ok[h] ? yo : 0);
      mk[h] = ok[h] ? (float)p.mask[m[h] * p.zo + t.zo] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      if (8 * j >= live) break;  // warp-uniform
      const int nl = 8 * j + 2 * q;
      const int n = nbase + nl;
      float s0 = p.scale[n], s1 = p.scale[n + 1];
      float c0 = p.bias[n], c1 = p.bias[n + 1];
      if (EPI != STORE_F32_RELU_MASK) {
        s0 = rbf(s0), s1 = rbf(s1), c0 = rbf(c0), c1 = rbf(c1);
      }
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok[h]) continue;
        const float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
        float v0, v1;
        if (EPI == STORE_F32_RELU_MASK) {
          v0 = __fadd_rn(__fmul_rn(a0, s0), c0);
          v1 = __fadd_rn(__fmul_rn(a1, s1), c1);
        } else {
          v0 = rbf(rbf(rbf(a0) * s0) + c0);
          v1 = rbf(rbf(rbf(a1) * s1) + c1);
        }
        __nv_bfloat162 r;
        if (kPool) {
          r.x = __float2bfloat16_rn(v0);
          r.y = __float2bfloat16_rn(v1);
          ps0 += v0 * mk[h];
          ps1 += v1 * mk[h];
        } else {
          r.x = __float2bfloat16_rn(fmaxf(v0, 0.0f) * mk[h]);
          r.y = __float2bfloat16_rn(fmaxf(v1, 0.0f) * mk[h]);
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + m[h] * zco + n) = r;
      }
      if (kPool) {
        // lanes with the same lane % 4 hold the same channels: reduce over
        // the warp's 16 cells, then over the 8 warps in shared memory
#pragma unroll
        for (int sh = 4; sh < 32; sh <<= 1) {
          ps0 += __shfl_xor_sync(0xffffffffu, ps0, sh);
          ps1 += __shfl_xor_sync(0xffffffffu, ps1, sh);
        }
        if (lane < 4) {
          red[warp][nl] = ps0;
          red[warp][nl + 1] = ps1;
        }
      }
    }
    if (kPool) {
      named_sync(1, kConsumers);
      if (tid < live) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kConsumers / 32; ++w) sum += red[w][tid];
        atomicAdd(p.pool + (size_t)t.b * zco + nbase + tid, sum);
      }
      named_sync(1, kConsumers);  // red is free for the next tile
    }
  }
}

template <int FOLD, bool PRO, int EPI>
int launch(const CUtensorMap& tx, const CUtensorMap& tw, const ZbandParams& p,
           int grid, cudaStream_t stream) {
  return launch_sm90(zband_sm90_kernel<FOLD, PRO, EPI>, grid, kSmemBytes,
                     stream, kSm90Threads, tx, tw, p);
}

}  // namespace

// One launch of instance `inst`: 0 K2's down0 (k2s2, BN0 prologue, bf16
// epilogue), 1 / 2 K3's conv phases (3x3, bf16 relu-mask / pool
// epilogues), 3 K4's down0 half (k2s2, fp32 epilogue).  The geometry
// arguments are the fields of the wrapper's ZbandTiling in order (ops/
// zband.py: zband_tiling, its one source): x's and w's 5-D views, dims and
// boxes innermost first, then the widths and the schedule.  mask_in, s_in
// and b_in are read by instance 0 only, pool by instance 2 only.
extern "C" int agp_zband(const bf16* x, const bf16* w, const uint8_t* mask_in,
                         const float* s_in, const float* b_in,
                         const float* scale, const float* bias,
                         const uint8_t* mask, bf16* out, float* pool,
                         int inst, int xd0, int xd1, int xd2, int xd3,
                         int xd4, int xb0, int xb1, int xb2, int xb3,
                         int xb4, int wd0, int wd1, int wd2, int wd3,
                         int wd4, int wb0, int wb1, int wb2, int wb3,
                         int wb4, int X, int Y, int Xo, int Yo, int zi,
                         int ci, int zo, int co, int npx, int npy, int ntn,
                         int nks, int taps, int zk, int zs, int zlo,
                         int tiles, int grid, void* stream) {
  const bool s1 = inst == 1 || inst == 2;
  // the boxes must be the tiles the kernel is compiled for, the views the
  // widths', every slab a multiple of 8 channels
  const bool boxes =
      xb0 == kSlab && xb1 == 1 && (s1 ? xb2 == kPatchY && xb3 == kPatchX &&
                                            xb4 == 1
                                      : xb2 == kPatchY && xb3 == 1 &&
                                            xb4 == kPatchX) &&
      wb0 == kBN && wb1 == 1 && wb2 == kSlab && wb3 == 1 && wb4 == 1;
  const bool views =
      xd0 == ci && wd0 == co && wd1 == zo && wd2 == ci && wd3 == zi &&
      wd4 == taps && (s1 ? xd1 == zi && xd2 == Y && xd3 == X && Xo == X &&
                               Yo == Y && taps == 9 && zk == 3 && zs == 1 &&
                               zlo == 1
                         : xd1 == 2 * zi && xd2 == Yo && xd3 == 2 &&
                               xd4 % Xo == 0 && 2 * Xo == X &&
                               2 * Yo == Y && taps == 4 && zk == 2 &&
                               zs == 2);
  if (inst < 0 || inst > 3 || !boxes || !views || ci % 8 || co % 8 ||
      ci < 8 || co < 8 || nks != (ci + kSlab - 1) / kSlab ||
      ntn != (co + kBN - 1) / kBN || tiles < 1 || grid < 1)
    return cudaErrorInvalidValue;
  const cuuint64_t xdims[5] = {(cuuint64_t)xd0, (cuuint64_t)xd1,
                               (cuuint64_t)xd2, (cuuint64_t)xd3,
                               (cuuint64_t)xd4};
  const cuuint32_t xbox[5] = {(cuuint32_t)xb0, (cuuint32_t)xb1,
                              (cuuint32_t)xb2, (cuuint32_t)xb3,
                              (cuuint32_t)xb4};
  const cuuint64_t wdims[5] = {(cuuint64_t)wd0, (cuuint64_t)wd1,
                               (cuuint64_t)wd2, (cuuint64_t)wd3,
                               (cuuint64_t)wd4};
  const cuuint32_t wbox[5] = {(cuuint32_t)wb0, (cuuint32_t)wb1,
                              (cuuint32_t)wb2, (cuuint32_t)wb3,
                              (cuuint32_t)wb4};
  CUtensorMap tx, tw;
  if (!encode_bf16(&tx, x, 5, xdims, xbox) ||
      !encode_bf16(&tw, w, 5, wdims, wbox))
    return cudaErrorInvalidValue;
  const ZbandParams p = {mask_in, s_in, b_in, scale, bias, mask, out, pool,
                         X, Y, Xo, Yo, zi, ci, zo, co, npx, npy, ntn, nks,
                         taps, zk, zs, zlo, tiles};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (inst) {
    case 0:
      return launch<FOLD_K2S2, true, STORE_BF16_RELU_MASK>(tx, tw, p, grid,
                                                           s);
    case 1:
      return launch<FOLD_S1, false, STORE_BF16_RELU_MASK>(tx, tw, p, grid, s);
    case 2:
      return launch<FOLD_S1, false, STORE_BF16_POOL>(tx, tw, p, grid, s);
    default:
      return launch<FOLD_K2S2, false, STORE_F32_RELU_MASK>(tx, tw, p, grid,
                                                           s);
  }
}
