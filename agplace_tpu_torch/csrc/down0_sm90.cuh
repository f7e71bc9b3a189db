// The down0 GEMM of the BEV stage 0 on the Hopper main loop, shared by K2
// (bev_down.cu: A from one strided view of conv0's output) and P2
// (probe_down_v2.cu: A from the four contiguous conv0 parity planes).
// The two kernels differ only in where a K step's A box comes from; the
// consumer below -- the BN0 prologue on the ldmatrix'ed register operand,
// the RS wgmma and the epilogue -- is one body, and each kernel passes the
// A load as a functor.  Design and rounding points: bev_down.cu.
#pragma once

#include "sm90.cuh"

namespace agp {

// the ring's depth and blocks per SM (bev_down.cu says why)
constexpr int kDown0Stages = 4;
constexpr int kDown0MinBlocks = 1;
constexpr int kDown0StageBytes = kSlabBytes + 2 * kBoxBytes;  // 32 KB
constexpr int kDown0SmemBytes = kDown0Stages * kDown0StageBytes + 1024;
// BN0's and the down BN's affines are staged in shared memory; a row's mask
// bits of one tap are 16 (z <= 16)
constexpr int kDown0MaxZC1 = 1024, kDown0MaxZC2 = 512, kDown0MaxZ = 16;

struct Down0Params {
  const uint8_t* mask;      // [B, X, Y, z]
  const float* s0;          // BN0 eval affine [zc1]
  const float* b0;
  const float* sd;          // down BN eval affine [zc2]
  const float* bd;
  const uint8_t* mask_out;  // [B, X/2, Y/2, zo]
  bf16* out;                // [B, X/2, Y/2, zc2]
  int X, Y, zc1, zc2, z, zo;
  int npx, npy, nn, steps, tiles;
};

// The kernel body.  K step k is (tap, 64-channel slab), tap = 2 dx + dy;
// `load_a(sa, bar, tap, c0, yo0, xo0, b)` issues the step's A box: the
// 128 x 64 tile g[b, 2 (xo0 + i) + dx, 2 (yo0 + j) + dy, c0 + c] (i < 8,
// j < 16, c < 64), 128-byte swizzled, into shared address `sa` against
// barrier `bar`.
template <class LoadA>
__device__ __forceinline__ void down0_body(const CUtensorMap& tmap_w,
                                           const Down0Params& p,
                                           LoadA&& load_a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kDown0Stages], empty[kDown0Stages];
  // BN0's scale and bias as bf16 pairs, the z-slab of each 8-channel group
  __shared__ __nv_bfloat162 s_s0[kDown0MaxZC1 / 2], s_b0[kDown0MaxZC1 / 2];
  __shared__ uint8_t s_zg[kDown0MaxZC1 / 8];
  __shared__ float s_sd[kDown0MaxZC2], s_bd[kDown0MaxZC2];
  const uint32_t ring = (smem_u32(smem) + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int c1 = p.zc1 / p.z;
  for (int i = tid; i < p.zc1 / 2; i += kSm90Threads) {
    s_s0[i] = __floats2bfloat162_rn(p.s0[2 * i], p.s0[2 * i + 1]);
    s_b0[i] = __floats2bfloat162_rn(p.b0[2 * i], p.b0[2 * i + 1]);
    if (i % 4 == 0) s_zg[i / 4] = (uint8_t)(2 * i / c1);
  }
  for (int i = tid; i < p.zc2; i += kSm90Threads) {
    s_sd[i] = rbf(p.sd[i]);
    s_bd[i] = rbf(p.bd[i]);
  }
  if (tid == 0) {
    ring_init<kDown0Stages>(full, empty);
    mbar_init_fence();
  }
  __syncthreads();

  const int Xo = p.X / 2, Yo = p.Y / 2;
  // tile -> (item b, patch (xp, yp), N tile); down0_coords and
  // down_concat_coords replay this on the CPU
  auto patch = [&](int tile, int& b, int& xo0, int& yo0, int& n0) {
    n0 = (tile % p.nn) * kTileN;
    tile /= p.nn;
    yo0 = (tile % p.npy) * kPatchY;
    tile /= p.npy;
    xo0 = (tile % p.npx) * kPatchX;
    b = tile / p.npx;
  };

  if (tid >= kConsumers) {
    // ---- producer warp: one thread keeps the ring full across the tiles
    if (tid == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
        int b, xo0, yo0, n0;
        patch(tile, b, xo0, yo0, n0);
        ring_produce<kDown0Stages>(
            full, empty, it * p.steps, p.steps, kDown0StageBytes,
            [&](int k, int s, uint32_t bar) {
          const int k0 = k * kSlab;
          const int tap = k0 / p.zc1, c0 = k0 - tap * p.zc1;
          const uint32_t sa = ring + s * kDown0StageBytes,
                         sb = sa + kSlabBytes;
          load_a(sa, bar, tap, c0, yo0, xo0, b);
          tma_load_2d(sb, &tmap_w, bar, n0, k0);
          tma_load_2d(sb + kBoxBytes, &tmap_w, bar, n0 + 64, k0);
        });
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns GEMM rows [64 wg, 64 wg + 64); warp
  // `warp` holds rows 16 warp + lane/4 (+8) of the A fragment, i.e. patch
  // cells (warp, lane/4 (+8))
  const int warp = tid / 32, lane = tid & 31, q = lane & 3;
  // ldmatrix: lane l gives row l % 8 (+8 for lanes 8-15, 24-31) of the
  // warp's 16 rows, 16-byte chunk l / 16 of the K step
  const int lrow = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const TileOut o = {p.out, p.mask_out, Xo, Yo, p.zc2, p.zo};
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.0f, 0.0f);
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
    int b, xo0, yo0, n0;
    patch(tile, b, xo0, yo0, n0);
    // the occupancy of this thread's two rows' 2x2 windows, read once per
    // tile: bit 16 tap + z of mb[h] is cell (2 xo + dx, 2 yo + dy), z-slab
    // z, tap = 2 dx + dy
    uint64_t mb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int xo = xo0 + warp, yo = yo0 + lane / 4 + 8 * h;
      mb[h] = 0;
      if (xo < Xo && yo < Yo) {
        const uint8_t* mp =
            p.mask + (((size_t)b * p.X + 2 * xo) * p.Y + 2 * yo) * p.z;
#pragma unroll
        for (int tap = 0; tap < 4; ++tap)
          for (int zz = 0; zz < p.z; ++zz)
            mb[h] |= (uint64_t)(mp[((tap >> 1) * p.Y + (tap & 1)) * p.z +
                                   zz] != 0) << (16 * tap + zz);
      }
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    uint32_t a[16];  // the step's A fragments, 4 per 16-column K step
    ring_consume<kDown0Stages, 0>(
        full, empty, it * p.steps, p.steps, lane,
        [&](int k, int s) {
          const int k0 = k * kSlab;
          const int tap = k0 / p.zc1, c0 = k0 - tap * p.zc1;
          const uint32_t sa = ring + s * kDown0StageBytes;
          // the step's tap of the two rows' mask bits
          const uint32_t mt[2] = {(uint32_t)(mb[0] >> (16 * tap)),
                                  (uint32_t)(mb[1] >> (16 * tap))};
#pragma unroll
          for (int kk = 0; kk < kSlab / 16; ++kk) {
            uint32_t v[4];
            ldmatrix_x4(v, sa + sw128_offset(lrow, 2 * kk + (lane >> 4)));
            // register r: row lane/4 + 8 (r & 1), channels c0 + 16 kk + 2q
            // (+8 for r >= 2) and one more.  BN0 in packed bf16: a bf16
            // product or sum rounded once gives the bits of the fp32
            // operation rounded to bf16 (bev_down.py:89-94's rounding); the
            // _rn forms keep the multiply and the add from contracting
            // into one fma
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int ch = c0 + 16 * kk + 2 * q + 8 * (r >> 1);
              const uint32_t live =
                  0u - ((mt[r & 1] >> s_zg[ch >> 3]) & 1u);
              __nv_bfloat162 t = __hmul2_rn(
                  *reinterpret_cast<const __nv_bfloat162*>(&v[r]),
                  s_s0[ch >> 1]);
              t = __hmax2(__hadd2_rn(t, s_b0[ch >> 1]), zero2);
              a[4 * kk + r] = *reinterpret_cast<uint32_t*>(&t) & live;
            }
          }
          // all 16 fragments in registers before the MMAs: computed later,
          // they would reuse one set of registers and ptxas would then
          // serialize the wgmmas
          fence_regs(a);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kSlab / 16; ++kk)
            wgmma_m64n128k16_rs(acc, &a[4 * kk], b_desc(sa + kSlabBytes, kk));
        },
        [&] {
          fence_regs(acc);
          fence_regs(a);
        });
    store_tile<STORE_BF16_RELU_MASK>(acc, o, b, xo0, yo0, n0, s_sd + n0,
                                     s_bd + n0, warp, lane, nullptr, nullptr);
  }
}

// The host side's check of the geometry both kernels share: the wd box and
// the widths must be the tiles the body is compiled for (wd dims (Zo*C2,
// 4*Z*C1)).
inline bool down0_widths_ok(int zc1, int z, int zo, int wd0, int wd1,
                            int wb0, int wb1, int nn, int steps, int grid) {
  return wb0 == 64 && wb1 == kSlab && wd0 % kTileN == 0 &&
         wd0 <= kDown0MaxZC2 && nn == wd0 / kTileN && wd1 == 4 * zc1 &&
         zc1 % kSlab == 0 && zc1 <= kDown0MaxZC1 && steps == wd1 / kSlab &&
         z >= 1 && z <= kDown0MaxZ && zc1 % (8 * z) == 0 && zo >= 1 &&
         wd0 % (2 * zo) == 0 && grid >= 1;
}

}  // namespace agp
