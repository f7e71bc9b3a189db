// conv0 of K4 off its sm90 tiles: a TMA + wgmma implicit GEMM whose K loop
// reads only the fold's live input channels.
//
// Replaces, at the widths K4's sm90 kernel (bev_head.cu) does not take, the
// conv0 half of the TPU kernel agplace_tpu/ops/pallas/bev_head.py:
// fused_head, which keeps its operands whole in VMEM at any width.  It
// computes the same function with the same rounding (bev_head.py:145-155):
// h = bf16(relu(conv0(feats) * s0 + b0) * mask), the conv accumulated in
// fp32 from bf16 operands, the affine in fp32, ONE round.  feats [B, X, Y,
// Z*C0] (the wrapper pads the channels to a multiple of 8 with zeros), w0
// the model's fold_w2_stride1 of a k0 x k0 x k0 kernel with every output
// slab padded to C1_8 channels (ops/bev_head.py: pad_head; a padded
// channel of h is 0), h [B, X, Y, Z*C1_8].  The down0 half then runs on
// zband_sm90.cu's fp32 instance over h.
//
// What bounds it on the H100.  The fold is block-banded: output slab zo
// reads input slabs zo - k0/2 .. zo + k0/2 (sparse/bev_grid.py:
// fold_w2_stride1); every other block is zero.  In the z-major fold those
// live channels are one contiguous window of feats' channels.  So a tile of
// 16 (x) x 8 (y) output cells x 128 output channels of the flattened Z*C1_8
// axis (the channels of one to ~17 output slabs) reads only the window of
// its slabs: [max(za - k0/2, 0) C0, min(zb + k0/2 + 1, Z) C0), za / zb its
// first / last slab, from a0, the window's start rounded down to 8
// channels (a TMA box starts 16-byte aligned).  Every channel in the
// window the tile's slabs do not read meets the fold's zero rows of B.  At
// the occupancy maps' C0 = 1 the window is a few channels, where the dense
// fold is Z*C0 deep (40 at z = 40): the work left is the taps' 16-deep
// MMA steps, and the h write.
//   * A: the halo'd input patch, 15 + k0 x 8 + k0 cells (one spare cell a
//     row), loaded ONCE per tile as one 4-D TMA box per 8-channel block of
//     the window, no swizzle: shared memory holds [block][x][y][8 ch], so
//     8 consecutive y cells of a block are one 128-byte wgmma core matrix.
//     Each tap's A operand is a no-swizzle K-major descriptor started at
//     the tap's (dx, dy) cell: SBO = one halo row (the next 8 GEMM rows are
//     the next x row), LBO = the next 8-channel block.  Where the window is
//     at most 8 channels wide at every tile (the occupancy maps), LBO is
//     one cell: a 16-deep MMA step reads taps (dx, dy) and (dx, dy + 1) of
//     the same 8 channels, and the K loop halves (k0 ceil(k0/2) steps, not
//     k0^2).  Past 64 channels the window is split into slices of 8
//     blocks, each with its own halo;
//   * B: per tap (or pair of taps), two 128-byte-swizzled 64 x rows boxes
//     of w0 viewed as (Z*C1_8, Z*C0, k0 dy, k0 dx), rows a0 .., read
//     MN-major; rows past Z*C0 and the tap dy = k0 of the last pair read
//     TMA's zeros.  A ring stage holds a row of k0 taps (ceil(k0/2)
//     pairs) where it fits 24 KB, else one tap: a stage of one tap's 4 KB
//     left the ring's four stages short of TMA's latency;
//   * one producer warp fills a ring of kStages = 3 weight stages and the two
//     halo buffers (one per slice in flight, full / empty mbarriers); two
//     consumer warpgroups of 64 rows issue SS wgmma m64n128k16 (sm90.cuh's
//     ring), one accumulator across a tile's slices;
//   * a persistent grid of two blocks per SM walks the tiles, N tile
//     fastest (neighbouring tiles share the halo in L2);
//   * the epilogue (store_h) stages the tile's h in shared memory and
//     stores it with TMA, clipped to the map and to Z*C1_8.
// The launch geometry comes from the wrapper (ops/bev_head.py:
// conv0_tiling, its one source; conv0_tile / conv0_window replay it); the
// host side checks it against the compiled constants and the window rule.
#include <algorithm>

#include "sm90.cuh"

namespace {

using namespace agp;

constexpr int kPX = 16, kPY = 8;  // the output patch: 16 (x) x 8 (y)
constexpr int kBN = 128;          // output channels of a tile
constexpr int kStages = 3;
constexpr int kOutBytes = kTileM * kBN * 2;  // h's staging: 32 KB
constexpr int kMaxSlabs = kBN / 8 + 1;  // slabs a tile's channels span
constexpr int kMinBlocks = 2;  // per SM
constexpr int kMaxSliceBlocks = 8;  // 8-channel blocks of a halo slice
constexpr int kMaxStageBytes = 24 * 1024;  // a ring stage's weight boxes

struct Conv0Params {
  const uint8_t* mask;  // [B, X, Y, Z]
  const float* s0;      // BN0's affine [Z*C1_8] fp32 (zeros on the pads)
  const float* b0;
  bf16* h;              // [B, X, Y, Z*C1_8]
  int X, Y, z, k0, c0, c18, npx, npy, ntn, sb, nsl, pair, tg, steps, tiles;
  int xh, yh;          // the halo's cells: 15 + k0 x 8 + k0
  int hstride;         // bytes of one 8-channel block of the halo
  int stage_bytes;     // one weight stage: two boxes a tap
};

// the no-swizzle shared-memory matrix descriptor (K-major): start address,
// the K-direction (leading) and M-direction (stride) core-matrix offsets,
// all in 16-byte units
// wait until this thread's bulk stores have read their shared memory /
// have completed
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t nosw_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// a tile of the schedule: item b, patch origin (x0, y0), first output
// channel n0 of Z*C1_8, the window's start a0 (ops/bev_head.py:
// conv0_tile)
struct Tile {
  int b, x0, y0, n0, a0;
};

// tap j of a slice: (dx, dy), with a pair the first of dy, dy + 1
__device__ __forceinline__ void tap_of(const Conv0Params& p, int j, int& dx,
                                       int& dy) {
  const int per = p.pair ? (p.k0 + 1) / 2 : p.k0;
  dx = j / per;
  dy = p.pair ? 2 * (j - dx * per) : j - dx * per;
}

__device__ __forceinline__ Tile tile_at(const Conv0Params& p, int t) {
  Tile o;
  o.n0 = (t % p.ntn) * kBN;
  t /= p.ntn;
  o.y0 = (t % p.npy) * kPY;
  t /= p.npy;
  o.x0 = (t % p.npx) * kPX;
  o.b = t / p.npx;
  const int za = o.n0 / p.c18;
  o.a0 = max(za - p.k0 / 2, 0) * p.c0 / 8 * 8;
  return o;
}

// TMA store of a box from shared memory into the tensor, counted in this
// thread's bulk group
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The epilogue: h = bf16(relu(acc * s0 + b0) * mask), the affine in fp32
// (a multiply and an add, no fma), one round.  Accumulator layout of
// m64nNk16 on the 16 x 8 patch: warp w holds patch cells (x 2 w + hh, y
// lane / 4), channels 8 j + 2 (lane % 4) (+1) in acc[4 j + 2 hh + c].
// Each thread writes its pairs into the tile's staging buffer, two
// 128-byte-swizzled halves [128 cells][64 channels] (the swizzle spreads
// a warp's 8 cells over the banks), and one thread stores the halves with
// TMA: the box clips the patch's cells past the map and the channels past
// Z*C1_8 (the ragged N tile).  (Register stores of the pairs, sm90.cuh's
// store_tile, left h's 32-byte sectors half written by each store and
// took 3-4x the MMAs' time; reading the affine and the mask from global
// memory and dividing by C1_8 for each pair took 3x the MMAs' time.)  The
// staging buffer is reused once the previous tile's stores have read it.
// The tile's epilogue inputs, staged once per tile in shared memory: the
// affine of its 128 channels (zeros past Z*C1_8), each channel's slab
// counted from the tile's first, and the occupancy of each of its cells in
// each of those slabs.
struct EpiStage {
  float sc[kBN], bi[kBN];
  uint8_t slab[kBN];
  uint8_t mask[kTileM * kMaxSlabs];
};

__device__ __forceinline__ void store_h(const float (&acc)[64],
                                        const Conv0Params& p, const Tile& t,
                                        const CUtensorMap* tmap_h,
                                        uint32_t out, EpiStage& st, int tid) {
  const int warp = tid / 32, lane = tid & 31, q = lane & 3;
  const int cout = p.z * p.c18, za = t.n0 / p.c18;
  const int ns = (min(t.n0 + kBN, cout) - 1) / p.c18 - za + 1;
  if (tid == 0) bulk_wait_read();
  // every thread is past the previous epilogue, whose stores have read
  // the staging buffer
  named_sync(2, kConsumers);
  if (tid < kBN) {
    const int n = t.n0 + tid;
    const bool live = n < cout;
    st.sc[tid] = live ? p.s0[n] : 0.0f;
    st.bi[tid] = live ? p.b0[n] : 0.0f;
    st.slab[tid] = live ? n / p.c18 - za : 0;
  }
  for (int i = tid; i < kTileM * ns; i += kConsumers) {
    const int cell = i / ns, sl = i - cell * ns;
    const int x = t.x0 + cell / kPY, y = t.y0 + cell % kPY;
    st.mask[cell * kMaxSlabs + sl] =
        x < p.X && y < p.Y
            ? p.mask[(((size_t)t.b * p.X + x) * p.Y + y) * p.z + za + sl]
            : 0;
  }
  named_sync(2, kConsumers);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = (2 * warp + hh) * kPY + lane / 4;  // the box's cell
    const uint8_t* mrow = st.mask + row * kMaxSlabs;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int nl = 8 * j + 2 * q;  // a pair in one slab: C1_8 is 8k
      const float2 sc = *reinterpret_cast<const float2*>(st.sc + nl);
      const float2 bi = *reinterpret_cast<const float2*>(st.bi + nl);
      const float mk = (float)mrow[st.slab[nl]];
      const float r0 =
          fmaxf(__fadd_rn(__fmul_rn(acc[4 * j + 2 * hh], sc.x), bi.x), 0.0f) *
          mk;
      const float r1 =
          fmaxf(__fadd_rn(__fmul_rn(acc[4 * j + 2 * hh + 1], sc.y), bi.y),
                0.0f) *
          mk;
      const uint32_t at = out + (j / 8) * (kTileM * 128) + row * 128 +
                          (((j % 8) ^ (row & 7)) << 4) + 4 * q;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                   "r"(pack_bf16x2(r0, r1))
                   : "memory");
    }
  }
  fence_proxy_async();  // the writes, before the async proxy reads them
  named_sync(2, kConsumers);
  if (tid == 0) {
    for (int hf = 0; hf < 2; ++hf)
      if (t.n0 + 64 * hf < cout)
        tma_store_4d(tmap_h, out + hf * (kTileM * 128), t.n0 + 64 * hf, t.y0,
                     t.x0, t.b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

__global__ void __launch_bounds__(kSm90Threads, kMinBlocks)
    head_conv0_sm90_kernel(const __grid_constant__ CUtensorMap tmap_x,
                           const __grid_constant__ CUtensorMap tmap_w,
                           const __grid_constant__ CUtensorMap tmap_h,
                           Conv0Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ __align__(8) uint64_t hfull[2], hempty[2];
  __shared__ __align__(16) EpiStage epi;
  const uint32_t ring = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t out = ring + kStages * p.stage_bytes;  // h's staging
  const uint32_t halo0 = out + kOutBytes;
  const int halo_bytes = p.sb * p.hstride;
  const int tid = threadIdx.x;
  if (tid == 0) {
    ring_init<kStages>(full, empty);
    for (int i = 0; i < 2; ++i) {
      mbar_init(smem_u32(&hfull[i]), 1);
      mbar_init(smem_u32(&hempty[i]), kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int hk = p.k0 / 2;
  const int box_bytes = p.stage_bytes / (2 * p.tg);

  if (tid >= kConsumers) {
    // ---- producer warp: one thread keeps the ring and the halos full
    if (tid == kConsumers) {
      int k = 0, u = 0;  // ring steps, halo slices
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const Tile t = tile_at(p, tile);
        for (int sl = 0; sl < p.nsl; ++sl, ++u) {
          const int hs = u & 1;
          if (u >= 2) mbar_wait(smem_u32(&hempty[hs]), ((u >> 1) + 1) & 1);
          const uint32_t hbar = smem_u32(&hfull[hs]);
          mbar_expect_tx(hbar, p.sb * p.xh * p.yh * 16);
          const uint32_t hb = halo0 + hs * halo_bytes;
          const int c0 = t.a0 + 8 * p.sb * sl;
          for (int c = 0; c < p.sb; ++c)
            tma_load_4d(hb + c * p.hstride, &tmap_x, hbar, c0 + 8 * c,
                        t.y0 - hk, t.x0 - hk, t.b);
          ring_produce<kStages>(
              full, empty, k, p.steps, p.stage_bytes,
              [&](int i, int s, uint32_t bar) {
                // tg taps (or pairs of taps) a step, two boxes each
                for (int g = 0; g < p.tg; ++g) {
                  const uint32_t sw = ring + s * p.stage_bytes +
                                      g * 2 * box_bytes;
                  int dx, dy;
                  tap_of(p, i * p.tg + g, dx, dy);
                  for (int half = 0; half < 2; ++half)
                    tma_load_4d(sw + half * box_bytes, &tmap_w, bar,
                                t.n0 + 64 * half, c0, dy, dx);
                }
              });
          k += p.steps;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns GEMM rows [64 wg, 64 wg + 64), the
  // patch's x rows 8 wg .. 8 wg + 7 (8 y cells each)
  const int wg = tid / 128, lane = tid & 31;
  const uint32_t sbo = p.yh * 16;
  const uint32_t lbo = p.pair ? 16 : p.hstride;
  const int kk_n = p.pair ? 1 : p.sb / 2;
  int k = 0, u = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const Tile t = tile_at(p, tile);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    for (int sl = 0; sl < p.nsl; ++sl, ++u) {
      const int hs = u & 1;
      mbar_wait(smem_u32(&hfull[hs]), (u >> 1) & 1);
      const uint32_t hb = halo0 + hs * halo_bytes;
      auto mma = [&](int i, int s) {
        wgmma_fence();
        for (int g = 0; g < p.tg; ++g) {
          const uint32_t sw = ring + s * p.stage_bytes + g * 2 * box_bytes;
          int dx, dy;
          tap_of(p, i * p.tg + g, dx, dy);
          // GEMM row 8 m + r of the warpgroup: halo cell (8 wg + m + dx,
          // r + dy)
          const uint32_t a0 = hb + ((8 * wg + dx) * p.yh + dy) * 16;
          for (int kk = 0; kk < kk_n; ++kk)
            wgmma_m64n128k16_ss(acc,
                                nosw_desc(a0 + 2 * kk * p.hstride, lbo, sbo),
                                b_desc(sw, kk, box_bytes), 1);
        }
      };
      ring_consume<kStages, 1>(full, empty, k, p.steps, lane, mma,
                               [&] { fence_regs(acc); });
      k += p.steps;
      // every MMA that read this halo has retired (ring_consume waits for
      // all of them)
      if (lane == 0) mbar_arrive(smem_u32(&hempty[hs]));
    }
    store_h(acc, p, t, &tmap_h, out, epi, tid);
  }
  if (tid == 0) bulk_wait();  // every store done before the block leaves
}

// the widest window of an N tile's live input channels, in 8-channel
// blocks from its start (ops/bev_head.py: conv0_window)
int window_blocks(int k0, int c0, int c18, int z, int ntn) {
  int nb = 0;
  for (int n = 0; n < ntn; ++n) {
    const int za = n * kBN / c18;
    const int zb = (std::min((n + 1) * kBN, z * c18) - 1) / c18;
    const int a0 = std::max(za - k0 / 2, 0) * c0 / 8 * 8;
    const int hi = std::min(zb + k0 / 2 + 1, z) * c0;
    nb = std::max(nb, (hi - a0 + 7) / 8);
  }
  return nb;
}

}  // namespace

// One launch.  The geometry arguments are the fields of the wrapper's
// Conv0Tiling in order (ops/bev_head.py: conv0_tiling): feats' 4-D view
// (Z*C0_8, Y, X, B) and its halo box, w0's view (Z*C1_8, Z*C0, k0, k0) and
// its box, then the widths and the schedule.
extern "C" int agp_head_conv0(const bf16* feats, const uint8_t* mask,
                              const bf16* w0, const float* s0,
                              const float* b0, bf16* h, int xd0, int xd1,
                              int xd2, int xd3, int xb0, int xb1, int xb2,
                              int xb3, int wd0, int wd1, int wd2, int wd3,
                              int wb0, int wb1, int wb2, int wb3, int z,
                              int k0, int c0, int c18, int npx, int npy,
                              int ntn, int nb, int sb, int nsl, int pair,
                              int tg, int steps, int tiles, int grid,
                              void* stream) {
  const int X = xd2, Y = xd1, zc0 = z * c0;
  const int xh = kPX + k0 - 1, yh = kPY + k0;
  const int npair = (k0 + 1) / 2;
  const int taps = pair ? k0 * npair : k0 * k0;
  const int stage_bytes = tg * 2 * wb0 * wb1 * wb2 * 2;
  const bool sched =
      (pair ? (nb == 1 && sb == 1 && nsl == 1 && wb1 == 8 && wb2 == 2)
            : (nb > 1 && sb % 2 == 0 && sb <= kMaxSliceBlocks &&
               nsl == (nb + sb - 1) / sb &&
               (sb == kMaxSliceBlocks || nsl == 1) && wb1 == 8 * sb &&
               wb2 == 1)) &&
      tg >= 1 && steps * tg == taps && stage_bytes <= kMaxStageBytes;
  const bool views = xd0 == (zc0 + 7) / 8 * 8 && wd0 == z * c18 &&
                     wd1 == zc0 && wd2 == k0 && wd3 == k0 && xb0 == 8 &&
                     xb1 == yh && xb2 == xh && xb3 == 1 && wb0 == 64 &&
                     wb3 == 1;
  if (X % 2 || Y % 2 || k0 % 2 == 0 || k0 > 5 || c0 < 1 || z < 1 ||
      c18 % 8 || c18 < 8 || !views || !sched ||
      npx != (X + kPX - 1) / kPX || npy != (Y + kPY - 1) / kPY ||
      ntn != (z * c18 + kBN - 1) / kBN ||
      nb != window_blocks(k0, c0, c18, z, ntn) ||
      tiles != xd3 * npx * npy * ntn || grid < 1)
    return cudaErrorInvalidValue;
  const cuuint64_t xdims[4] = {(cuuint64_t)xd0, (cuuint64_t)xd1,
                               (cuuint64_t)xd2, (cuuint64_t)xd3};
  const cuuint32_t xbox[4] = {(cuuint32_t)xb0, (cuuint32_t)xb1,
                              (cuuint32_t)xb2, (cuuint32_t)xb3};
  const cuuint64_t wdims[4] = {(cuuint64_t)wd0, (cuuint64_t)wd1,
                               (cuuint64_t)wd2, (cuuint64_t)wd3};
  const cuuint32_t wbox[4] = {(cuuint32_t)wb0, (cuuint32_t)wb1,
                              (cuuint32_t)wb2, (cuuint32_t)wb3};
  // h [B, X, Y, Z*C1_8] in boxes of 64 channels x the 16 x 8 patch
  const cuuint64_t hdims[4] = {(cuuint64_t)wd0, (cuuint64_t)Y, (cuuint64_t)X,
                               (cuuint64_t)xd3};
  const cuuint32_t hbox[4] = {64, kPY, kPX, 1};
  CUtensorMap tx, tw, th;
  if (!encode_bf16(&tx, feats, 4, xdims, xbox, false) ||
      !encode_bf16(&tw, w0, 4, wdims, wbox) ||
      !encode_bf16(&th, h, 4, hdims, hbox))
    return cudaErrorInvalidValue;
  Conv0Params p;
  p.mask = mask;
  p.s0 = s0;
  p.b0 = b0;
  p.h = h;
  p.X = X, p.Y = Y, p.z = z, p.k0 = k0, p.c0 = c0, p.c18 = c18;
  p.npx = npx, p.npy = npy, p.ntn = ntn, p.sb = sb, p.nsl = nsl;
  p.pair = pair, p.tg = tg, p.steps = steps, p.tiles = tiles;
  p.xh = xh, p.yh = yh;
  p.hstride = (xh * yh * 16 + 127) / 128 * 128;
  p.stage_bytes = stage_bytes;
  const int smem =
      1024 + kStages * p.stage_bytes + kOutBytes + 2 * sb * p.hstride;
  return launch_sm90(head_conv0_sm90_kernel, grid, smem,
                     static_cast<cudaStream_t>(stream), kSm90Threads, tx, tw,
                     th, p);
}
