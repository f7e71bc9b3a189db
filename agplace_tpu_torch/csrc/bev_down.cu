// K2: fused stage-0 epilogue + masked down0 of the BEV FPN, as a TMA +
// wgmma GEMM with the BN0 prologue applied to the A operand in registers.
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
// with the rounding points of bev_down.py:84-105.  mask_out (the ME max-pool
// of the occupancy over 2x2x2 with the z pairing of me_down_align) is
// computed outside, as the JAX wrapper computes it.
//
// What bounds it on the H100: bytes.  At b32 the kernel reads the 268 MB
// conv0 activation once and writes 34 MB: 0.090 ms at 3.35 TB/s, against
// 0.035 ms of bf16 tensor-core work for the dense folded product.  So the
// design reads g exactly once, at full rate, and does the elementwise work
// on the way from shared memory to the tensor cores (sm90.cuh's ring):
//   * a block owns an 8 (xo) x 16 (yo) patch of output cells of one item
//     (128 GEMM rows) and a 128-channel N tile: all of Zo*C2 at KITTI-360
//     (Zo*C2 = 128), so g is read once there.  Wider maps (Zo*C2 = 256 at
//     z = 8, 512 at z = 16) take Zo*C2 / 128 N tiles, adjacent in the tile
//     order, so that a patch's second read of g comes from L2;
//   * the K loop is 4 taps x Z*C1/64 slabs.  A step's A operand is one 5-D
//     TMA box of the view [B, Xo, 2, Yo, 2*Z*C1] of g (innermost first
//     (2*Z*C1, Yo, 2, Xo, B)): g[b, 2xo+dx, 2yo+dy, c] is view[b, xo, dx,
//     yo, dy*Z*C1 + c], so the box (64, 16, 1, 8, 1) at (dy*Z*C1 + c0, yo0,
//     dx, xo0, b) is the 128 x 64 tile of tap (dx, dy) in the same
//     128-byte-swizzled K-major layout as K3's x box; TMA zero-fills the
//     ragged edge.  B is wd as a row-major [4*Z*C1, Z*C2] matrix (row
//     (2 dx + dy) * Z*C1 + c: fold_w2_k2s2's tap order), two 64 x 64 boxes
//     of the N tile's columns per step, read MN-major;
//   * one producer warp keeps a ring of kStages = 4 stages (32 KB each)
//     full; the two consumer warpgroups ldmatrix their 64 rows of the A
//     stage into wgmma's register fragment, apply BN0's affine (scale and
//     bias staged once per block as bf16 pairs), relu and the z-mask (one
//     bit per row, tap and z <= 16, read once per tile) in packed bf16x2
//     arithmetic, whose single roundings give the bits of the TPU kernel's
//     fp32-then-bf16 steps (a bf16 product is exact in fp32; a sum of two
//     bf16 is either exact in fp32 or too lopsided for the second rounding
//     to matter), and issue wgmma.mma_async m64n128k16 with A from
//     registers.  Registers that a wgmma reads must not be written while
//     any wgmma is in flight (ptxas serializes every wgmma of the kernel
//     otherwise), so each step's MMAs retire (wait_group 0) before the
//     next step's prologue, and the stage is released then; the two
//     consumer warpgroups interleave one's prologue with the other's MMAs.
//     One block per SM with 4 stages (129 KB): two blocks per SM at 3
//     stages capped the registers at 96 and spilled, and measured slower
//     (PERF.md, scripts/ablate_torch_stage0.py);
//   * the epilogue is K3's EPI 0 (store_tile) at the output resolution;
//   * a persistent grid of one block per SM: a block walks tiles
//     blockIdx.x, + gridDim.x, ..., its ring running on across them, so
//     the producer fills the next tile's first stages during the epilogue
//     (faster than one tile per block, PERF.md).
// The launch geometry (tensor-map dims and boxes, patch grid, K steps, tile
// count, grid) comes from the wrapper (ops/bev_down.py: down0_tiling), its
// one source; the host side here only checks the boxes against the tiles
// this kernel is compiled for.
#include "sm90.cuh"

// Ablation switches, the shipped values unless set with -D: the ring's
// depth, blocks per SM, and parts of the work taken out (bit 1: the g box,
// 2: the BN0 prologue, 4: the MMAs; results are then wrong on purpose)
#ifndef AGP_DOWN0_STAGES
#define AGP_DOWN0_STAGES 4
#endif
#ifndef AGP_DOWN0_MIN_BLOCKS
#define AGP_DOWN0_MIN_BLOCKS 1
#endif
#ifndef AGP_DOWN0_SKIP
#define AGP_DOWN0_SKIP 0
#endif

namespace {

using namespace agp;

constexpr int kStages = AGP_DOWN0_STAGES;
constexpr int kSkip = AGP_DOWN0_SKIP;
constexpr int kStageBytes = kSlabBytes + 2 * kBoxBytes;  // 32 KB
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + 1 KB alignment
// BN0's and the down BN's affines are staged in shared memory; a row's mask
// bits of one tap are 16 (z <= 16)
constexpr int kMaxZC1 = 1024, kMaxZC2 = 512, kMaxZ = 16;

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

__global__ void __launch_bounds__(kSm90Threads, AGP_DOWN0_MIN_BLOCKS)
    down0_sm90_kernel(const __grid_constant__ CUtensorMap tmap_g,
                      const __grid_constant__ CUtensorMap tmap_w,
                      Down0Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // BN0's scale and bias as bf16 pairs, the z-slab of each 8-channel group
  __shared__ __nv_bfloat162 s_s0[kMaxZC1 / 2], s_b0[kMaxZC1 / 2];
  __shared__ uint8_t s_zg[kMaxZC1 / 8];
  __shared__ float s_sd[kMaxZC2], s_bd[kMaxZC2];
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
    ring_init<kStages>(full, empty);
    mbar_init_fence();
  }
  __syncthreads();

  const int Xo = p.X / 2, Yo = p.Y / 2;
  // tile -> (item b, patch (xp, yp), N tile); down0_coords replays this on
  // the CPU
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
        ring_produce<kStages>(full, empty, it * p.steps, p.steps,
                              kStageBytes - (kSkip & 1 ? kSlabBytes : 0),
                              [&](int k, int s, uint32_t bar) {
          // K step k is (tap, 64-channel slab), tap = 2 dx + dy
          const int k0 = k * kSlab;
          const int tap = k0 / p.zc1, c0 = k0 - tap * p.zc1;
          const int dx = tap >> 1, dy = tap & 1;
          const uint32_t sa = ring + s * kStageBytes, sb = sa + kSlabBytes;
          if (!(kSkip & 1))
            tma_load_5d(sa, &tmap_g, bar, dy * p.zc1 + c0, yo0, dx, xo0, b);
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
    ring_consume<kStages, 0>(
        full, empty, it * p.steps, p.steps, lane,
        [&](int k, int s) {
          const int k0 = k * kSlab;
          const int tap = k0 / p.zc1, c0 = k0 - tap * p.zc1;
          const uint32_t sa = ring + s * kStageBytes;
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
              a[4 * kk + r] = kSkip & 2 ? v[r]
                                        : *reinterpret_cast<uint32_t*>(&t) & live;
            }
          }
          // all 16 fragments in registers before the MMAs: computed later,
          // they would reuse one set of registers and ptxas would then
          // serialize the wgmmas
          fence_regs(a);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kSlab / 16; ++kk)
            if (!(kSkip & 4))
              wgmma_m64n128k16_rs(acc, &a[4 * kk],
                                  b_desc(sa + kSlabBytes, kk));
        },
        [&] {
          fence_regs(acc);
          fence_regs(a);
        });
    store_tile<STORE_BF16_RELU_MASK>(acc, o, b, xo0, yo0, n0, s_sd + n0,
                                     s_bd + n0, warp, lane, nullptr, nullptr);
  }
}

}  // namespace

// The geometry arguments are the fields of the wrapper's Down0Tiling in
// order: g's 5-D view dims (2*Z*C1, Yo, 2, Xo, B) and box, wd dims (Zo*C2,
// 4*Z*C1) and box, innermost first, then the patch grid, the N tiles, the
// K steps, the number of tiles and the number of blocks.
extern "C" int agp_bev_down(const bf16* g, const uint8_t* mask,
                            const float* s0, const float* b0, const bf16* wd,
                            const float* sd, const float* bd,
                            const uint8_t* mask_out, bf16* out, int z, int zo,
                            int gd0, int gd1, int gd2, int gd3, int gd4,
                            int gb0, int gb1, int gb2, int gb3, int gb4,
                            int wd0, int wd1, int wb0, int wb1, int npx,
                            int npy, int nn, int steps, int tiles, int grid,
                            void* stream) {
  const int zc1 = gd0 / 2;
  // the boxes and widths must be the tiles the kernel is compiled for
  if (gb0 != kSlab || gb1 != kPatchY || gb2 != 1 || gb3 != kPatchX ||
      gb4 != 1 || gd2 != 2 || wb0 != 64 || wb1 != kSlab ||
      wd0 % kTileN != 0 || wd0 > kMaxZC2 || nn != wd0 / kTileN ||
      wd1 != 4 * zc1 || zc1 % kSlab != 0 || zc1 > kMaxZC1 ||
      steps != wd1 / kSlab || z < 1 || z > kMaxZ || zc1 % (8 * z) != 0 ||
      zo < 1 || wd0 % (2 * zo) != 0 || grid < 1)
    return cudaErrorInvalidValue;
  const cuuint64_t gd[5] = {(cuuint64_t)gd0, (cuuint64_t)gd1,
                            (cuuint64_t)gd2, (cuuint64_t)gd3,
                            (cuuint64_t)gd4};
  const cuuint32_t gb[5] = {(cuuint32_t)gb0, (cuuint32_t)gb1,
                            (cuuint32_t)gb2, (cuuint32_t)gb3,
                            (cuuint32_t)gb4};
  const cuuint64_t wdims[2] = {(cuuint64_t)wd0, (cuuint64_t)wd1};
  const cuuint32_t wbox[2] = {(cuuint32_t)wb0, (cuuint32_t)wb1};
  CUtensorMap tg, tw;
  if (!encode_bf16(&tg, g, 5, gd, gb) || !encode_bf16(&tw, wd, 2, wdims, wbox))
    return cudaErrorInvalidValue;
  const Down0Params p = {mask, s0, b0, sd, bd, mask_out, out, 2 * gd3,
                         2 * gd1, zc1, wd0, z, zo, npx, npy, nn, steps,
                         tiles};
  return launch_sm90(down0_sm90_kernel, grid, kSmemBytes,
                     static_cast<cudaStream_t>(stream), kSm90Threads, tg, tw,
                     p);
}
