// K4: the fused BEV-FPN head — conv0 + BN0 + relu + mask, then down0 + BN +
// relu + mask — in one TMA + wgmma kernel, the full-resolution conv0
// activation never leaving the chip.
//
// Replaces the TPU kernel agplace_tpu/ops/pallas/bev_head.py:fused_head
// (_head_kernel).  The TPU kernel splits the input into its four (x, y)
// parity planes and builds conv0's im2col taps from rolled, masked copies
// of them, because Mosaic has no strided access.  What the design keeps is
// the TPU kernel's point: down0 is k=2 s=2, so an output cell (xo, yo)
// needs conv0 only at the four full-resolution cells (2xo + dx, 2yo + dy),
// one per parity p = 2 dx + dy, and each parity's activation is one tap of
// down0.  Rounding as bev_head.py:146-163: conv0 accumulated in fp32, the
// BN0 affine in fp32 (a multiply and an add, no fma), relu, mask, ONE bf16
// round; down0 accumulated in fp32, its affine in fp32, relu, the output
// mask, one round.  mask_out is computed outside, as the JAX wrapper does.
//
// What bounds it on the H100: tensor-core work.  At b32 KITTI it reads the
// 4 MB occupancy grid and writes 34 MB, and does 34 + 34 GFLOP with the
// im2col padding and the folds' zero blocks (40.7 GFLOP of 3-D conv
// products): 0.04-0.07 ms at the bf16 peak, against 0.011 ms of bytes.  So
// the design keeps the tensor cores on wgmma and everything between the two
// GEMMs on the chip (sm90.cuh's ring and epilogue):
//   * a persistent block (one per SM) walks tiles (output patch of 8 (xo) x
//     16 (yo) cells of one item: 128 GEMM rows, two consumer warpgroups of
//     64; a 128-channel N tile of down0's Zo*C2 outputs, all of them at
//     KITTI; a patch's N tiles are adjacent in the tile order, and each
//     computes the patch's conv0 again: at Zo*C2 = 256 / 512 conv0's MMAs
//     and im2col run 2 / 4 times per patch);
//   * per tile one TMA box brings the input halo, (16 + 2h) x 36
//     full-resolution cells x Z*C0 channels (h = k0/2): at Z*C0 = 4 (a cell
//     is 8 bytes, below TMA's 16-byte inner box) through the view [B, X,
//     Y*4, 1], the box starting 2 cells before the patch along y so that
//     its inner coordinate stays 16-byte aligned; at Z*C0 = 8 / 16 through
//     the view [B, X, Y, Z*C0] with the channels as the inner box dimension
//     (36 * Z*C0 elements would pass TMA's 256-element box limit), the same
//     2-cell lead.  Either way a halo row is 36 * Z*C0 elements in shared
//     memory, and the view's zero fill outside the map is conv0's padding;
//   * each warpgroup builds conv0's im2col operand of a parity for its 64
//     rows in shared memory from the halo, one lane per tap, Z*C0 / 4
//     8-byte copies (K = k0*k0*Z*C0 padded to kp, a multiple of 64, with
//     zeros; the 128-byte-swizzled K-major layout of K3's x box);
//   * per chunk of 64 conv0 channels (Z*C1 / 64 of them per parity):
//       - conv0 as SS wgmma m64n64k16 against W0's 64 columns,
//       - the BN0 epilogue in registers (fp32 affine, relu, z-mask, one
//         round), whose m64n64 accumulator layout is the m16n8k16 A
//         fragment of the next MMA (as FlashAttention-3 feeds P to P.V),
//       - down0 as RS wgmma m64n128k16 of that fragment against the
//         chunk's 64 rows x the N tile's 128 columns of Wd[p], streamed
//         through a 4-stage TMA ring, into an fp32 accumulator that stays
//         in registers across the four parities;
//     registers a wgmma reads may be written only while none of the
//     warpgroup's wgmmas is in flight (else ptxas serializes every wgmma
//     of the kernel), so each chunk waits for its MMAs before the
//     epilogue; the two warpgroups overlap one's epilogue with the other's
//     MMAs;
//   * the output epilogue (store_tile, fp32 form).
// Two instances of this one source, chosen by shape (agp_bev_head below;
// head_tiling in ops/bev_head.py):
//   * resident (Z*C0 = 4, Z*C1 <= 256, Zo*C2 = 128: KITTI-360's stage 0,
//     one N tile of compile-time width; a runtime width cost its b32 time
//     3-4 %): W0 (the im2col weight [kp, Z*C1], up to 64 KB) is loaded
//     once per block by TMA and stays in shared memory; im2col
//     double-buffered (the next parity's is built while the current one's
//     MMAs run); D(j) and the next chunk's conv0 C(j + 1) issued as one
//     group; two halo buffers;
//   * streamed (every other shape): W0 is 256 KB at the z = 8 presets'
//     widths (kp 256 x Z*C1 512) and 896 KB at z = 16 (448 x 1024), so it
//     streams through the ring as (64 columns x 128 rows) boxes, ceil(kp /
//     128) per chunk, before the chunk's Wd step; each conv0 box's MMAs are
//     one group, the previous box released once they retire; the im2col
//     (kp = 448: 112 KB) and the halo are single-buffered (the next tile's
//     halo is loaded once parity 3's im2col is built).
// The launch geometry comes from the wrapper (ops/bev_head.py:
// head_tiling), its one source; the host side here only checks it against
// the tiles this kernel is compiled for.
#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace agp;

constexpr int kStages = 4;            // ring: 16 KB per stage
constexpr int kStageBytes = 2 * kBoxBytes;
constexpr int kMaxZC2 = 512;          // the down BN's affine, staged
// the halo starts 2 cells before the patch along y for every k0 (at Z*C0 =
// 4 its inner TMA coordinate, 8 bf16 = 16 bytes per 2 cells, stays 16-byte
// aligned); along x it starts h = k0/2 rows before
constexpr int kHaloLead = 2;
constexpr int kHaloCells = 2 * kPatchY + 2 * kHaloLead;  // 36
constexpr int kHaloRowsMax = 2 * kPatchX + 4;            // 20 (k0 = 5)
// Shared memory, resident instance (1 KB of alignment slack included):
// W0 64 KB + im2col 2 buffers x 2 slabs 64 KB + ring 64 KB + 2 halos of
// 5.6 KB = 209,152 bytes; BN0's affine (256 channels) 2 KB, the down BN's
// 1 KB and the barriers static: 212 KB of the 227 KB a block may hold.
constexpr int kResZC1 = 256;
constexpr int kResHaloBytes = kHaloCells * 4 * kHaloRowsMax * 2;  // 5,760
constexpr int kResW0Off = 0;
constexpr int kResAOff = kResW0Off + 128 * kResZC1 * 2;
constexpr int kResRingOff = kResAOff + 4 * kSlabBytes;
constexpr int kResHaloOff = kResRingOff + kStages * kStageBytes;
constexpr int kResSmem = kResHaloOff + 2 * kResHaloBytes + 1024;
// Streamed instance: ring 64 KB + one halo of up to 22.5 KB (Z*C0 = 16) in
// 23 KB + im2col kp / 64 slabs of 16 KB (7 at kp = 448: 112 KB) = 204,800
// bytes at most; BN0's affine (1024 channels) 8 KB, the down BN's 4 KB and
// the barriers static: 217 KB.
constexpr int kStrZC1 = 1024;
constexpr int kStrMaxKP = 448;
constexpr int kStrRingOff = 0;
constexpr int kStrHaloOff = kStrRingOff + kStages * kStageBytes;
constexpr int kStrAOff = kStrHaloOff + 23 * 1024;
constexpr int kStrSmem = kStrAOff + kStrMaxKP / kSlab * kSlabBytes + 1024;
static_assert(kHaloCells * 16 * kHaloRowsMax * 2 <= kStrAOff - kStrHaloOff,
              "halo buffer");

struct HeadParams {
  const uint8_t* mask;      // [B, X, Y, z]
  const float* s0;          // BN0 eval affine [zc1]
  const float* b0;
  const float* sd;          // down BN eval affine [zc2]
  const float* bd;
  const uint8_t* mask_out;  // [B, X/2, Y/2, zo]
  bf16* out;                // [B, X/2, Y/2, zc2]
  int X, Y, k0, zc0, zc1, zc2, z, zo, kp;
  int pitch, halo_bytes;    // halo row (elements), halo box bytes
  int npx, npy, nn, steps, tiles;
};

// KP: conv0's padded im2col depth (64 or 128) of the resident instance,
// fixed at compile time so that its conv0 MMAs unroll; 0 for the streamed
// instance (p.kp)
template <int KP, bool kStream>
__global__ void __launch_bounds__(kSm90Threads, 1)
    head_sm90_kernel(const __grid_constant__ CUtensorMap tmap_x,
                     const __grid_constant__ CUtensorMap tmap_w0,
                     const __grid_constant__ CUtensorMap tmap_wd,
                     HeadParams p) {
  constexpr int kMaxZC1 = kStream ? kStrZC1 : kResZC1;
  constexpr int kMaxZC2T = kStream ? kMaxZC2 : kTileN;
  constexpr int kHaloBufs = kStream ? 1 : 2;
  constexpr int kHaloBytes = kStream ? kStrAOff - kStrHaloOff : kResHaloBytes;
  // a row's occupancy bits: kZBits per parity (z <= 4 resident, <= 16)
  using MaskBits = std::conditional_t<kStream, uint64_t, uint32_t>;
  constexpr int kZBits = kStream ? 16 : 8;
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ __align__(8) uint64_t halo_full[kHaloBufs],
      halo_empty[kHaloBufs], w0_full;
  __shared__ float2 s_sb0[kMaxZC1 / 2][2];  // BN0 (scale, bias) pairs
  __shared__ uint8_t s_zg[kMaxZC1 / 8];     // z-slab of 8-channel group
  __shared__ float s_sd[kMaxZC2T], s_bd[kMaxZC2T];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  unsigned char* gbase = smem + (base - smem_u32(smem));
  const int a_off = kStream ? kStrAOff : kResAOff;
  const int halo_off = kStream ? kStrHaloOff : kResHaloOff;
  const uint32_t w0s = base + kResW0Off, as = base + a_off;
  const uint32_t ring = base + (kStream ? kStrRingOff : kResRingOff);
  const uint32_t halo = base + halo_off;

  const int tid = threadIdx.x;
  const int kp = kStream ? p.kp : KP;
  const int nks = kp / kSlab;            // im2col slabs
  const int nw0 = (kp + 127) / 128;      // streamed W0 boxes per chunk
  const int nch = p.zc1 / 64;
  for (int i = tid; i < p.zc1 / 2; i += kSm90Threads) {
    s_sb0[i][0] = make_float2(p.s0[2 * i], p.s0[2 * i + 1]);
    s_sb0[i][1] = make_float2(p.b0[2 * i], p.b0[2 * i + 1]);
    if (i % 4 == 0) s_zg[i / 4] = (uint8_t)(2 * i / (p.zc1 / p.z));
  }
  for (int i = tid; i < p.zc2; i += kSm90Threads) {
    s_sd[i] = p.sd[i];
    s_bd[i] = p.bd[i];
  }
  if (tid == 0) {
    ring_init<kStages>(full, empty);
    for (int i = 0; i < kHaloBufs; ++i) {
      mbar_init(smem_u32(&halo_full[i]), 1);
      mbar_init(smem_u32(&halo_empty[i]), kConsumers);
    }
    mbar_init(smem_u32(&w0_full), 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int h = p.k0 / 2;
  const int nn = kStream ? p.nn : 1;
  // tile -> (item b, patch (xp, yp), N tile); head_coords replays this on
  // the CPU
  auto patch = [&](int tile, int& b, int& xo0, int& yo0, int& n0) {
    n0 = (tile % nn) * kTileN;
    tile /= nn;
    yo0 = (tile % p.npy) * kPatchY;
    tile /= p.npy;
    xo0 = (tile % p.npx) * kPatchX;
    b = tile / p.npx;
  };

  if (tid >= kConsumers) {
    // ---- producer warp: one thread loads W0 once (resident), then per
    // tile its halo and its ring steps
    if (tid == kConsumers) {
      if constexpr (!kStream) {
        const uint32_t wbar = smem_u32(&w0_full);
        mbar_expect_tx(wbar, KP * p.zc1 * 2);
        for (int c = 0; c < nch; ++c)
          for (int ks = 0; ks < nks; ++ks)
            tma_load_2d(w0s + (c * nks + ks) * kBoxBytes, &tmap_w0, wbar,
                        c * 64, ks * kSlab);
      }
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
        int b, xo0, yo0, n0;
        patch(tile, b, xo0, yo0, n0);
        const int hb = it % kHaloBufs;
        if (it >= kHaloBufs)
          mbar_wait(smem_u32(&halo_empty[hb]), ((it / kHaloBufs) + 1) & 1);
        const uint32_t hbar = smem_u32(&halo_full[hb]);
        mbar_expect_tx(hbar, p.halo_bytes);
        if (p.zc0 == 4)  // view [B, X, Y*4, 1]
          tma_load_4d(halo + hb * kHaloBytes, &tmap_x, hbar,
                      (2 * yo0 - kHaloLead) * 4, 2 * xo0 - h, b, 0);
        else  // view [B, X, Y, Z*C0]
          tma_load_4d(halo + hb * kHaloBytes, &tmap_x, hbar, 0,
                      2 * yo0 - kHaloLead, 2 * xo0 - h, b);
        ring_produce<kStages>(full, empty, it * p.steps, p.steps,
                              kStageBytes,
                              [&](int i, int s, uint32_t bar) {
          const uint32_t sb = ring + s * kStageBytes;
          int wrow = i * 64;  // resident: step i is rows [64 i, 64 i + 64)
          if constexpr (kStream) {
            // chunk j = (parity, 64 conv0 channels c), parity-major: nw0
            // W0 boxes (its 64 columns, 128 rows each), then Wd's rows
            // [par * Z*C1 + 64 c, + 64) of the N tile
            const int j = i / (nw0 + 1), r = i - j * (nw0 + 1);
            const int par = j / nch, c = j - par * nch;
            if (r < nw0) {
              tma_load_2d(sb, &tmap_w0, bar, c * 64, r * 128);
              return;
            }
            wrow = par * p.zc1 + c * 64;
          }
          tma_load_2d(sb, &tmap_wd, bar, n0, wrow);
          tma_load_2d(sb + kBoxBytes, &tmap_wd, bar, n0 + 64, wrow);
        });
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns GEMM rows [64 wg, 64 wg + 64)
  const int wg = tid / 128, warp = tid / 32, lane = tid & 31, q = lane & 3;
  const int wt = tid & 127;  // thread within the warpgroup
  // im2col: lane t of a warp copies tap t = a*k0 + bb (lanes >= k0*k0
  // idle) of each of the warp's 16 rows, Z*C0 channels = Z*C0 / 4 8-byte
  // words; its offsets are fixed
  const int taps = p.k0 * p.k0;
  const bool tap_lane = lane < taps;
  const int ta = lane / p.k0, tb = lane - ta * p.k0;
  const int zc0 = kStream ? p.zc0 : 4;  // compile-time when resident
  const int pitch = kStream ? p.pitch : kHaloCells * 4;
  const int src_lane = ta * pitch + (tb + kHaloLead - h) * zc0;
  const int words = zc0 / 4;
  const int col_byte = 2 * lane * zc0;  // the tap's first column, bytes
  // zero this warpgroup's rows of the im2col buffers once: the padded
  // depth [k0*k0*Z*C0, kp) is never written again
  const int a_slabs = kStream ? nks : 4;
  for (int i = wt; i < a_slabs * 64 * 8; i += 128) {
    const int slab = i / (64 * 8), rem = i - slab * 64 * 8;
    *reinterpret_cast<uint4*>(gbase + a_off + slab * kSlabBytes +
                              (wg * 64 + rem / 8) * 128 + (rem % 8) * 16) =
        make_uint4(0, 0, 0, 0);
  }
  if constexpr (!kStream) mbar_wait(smem_u32(&w0_full), 0);
  const TileOut o = {p.out, p.mask_out, p.X / 2, p.Y / 2,
                     kStream ? p.zc2 : kTileN, p.zo};
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
    int b, xo0, yo0, n0;
    patch(tile, b, xo0, yo0, n0);
    const int hb = it % kHaloBufs;
    const unsigned char* hsrc = gbase + halo_off + hb * kHaloBytes;
    // the occupancy of this thread's two rows' 2x2 windows: bit kZBits par
    // + z of mb[hh] is cell (2 xo + dx, 2 yo + dy), z-slab z, par = 2 dx +
    // dy
    MaskBits mb[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int xo = xo0 + warp, yo = yo0 + lane / 4 + 8 * hh;
      mb[hh] = 0;
      if (xo < p.X / 2 && yo < p.Y / 2) {
        const uint8_t* mp =
            p.mask + (((size_t)b * p.X + 2 * xo) * p.Y + 2 * yo) * p.z;
#pragma unroll
        for (int par = 0; par < 4; ++par)
          for (int zz = 0; zz < p.z; ++zz)
            mb[hh] |= (MaskBits)(mp[((par >> 1) * p.Y + (par & 1)) * p.z +
                                    zz] != 0) << (kZBits * par + zz);
      }
    }
    mbar_wait(smem_u32(&halo_full[hb]), (it / kHaloBufs) & 1);
    // im2col of parity `par` into buffer `buf`, this warpgroup's rows: row
    // R = cell (xi, yi) takes tap (a, bb) from halo cell (2 xi + dx + a,
    // 2 yi + dy + bb + 2 - h) into columns Z*C0 t .. Z*C0 (t + 1) - 1, t =
    // a*k0 + bb (head_im2col replays it)
    auto im2col = [&](int par, int buf) {
      const int dx = par >> 1, dy = par & 1;
      unsigned char* dst = gbase + a_off + buf * 2 * kSlabBytes;
      const unsigned char* src =
          hsrc + (src_lane + dx * pitch + dy * zc0) * 2;
      named_sync(2 + wg, 128);  // the buffer's last MMAs are done
      if (tap_lane) {
#pragma unroll 4
        for (int i = 0; i < 16; ++i) {
          const int R = warp * 16 + i;  // patch cell (R / 16, R % 16)
          const int xi = R / kPatchY, yi = R % kPatchY;
          const unsigned char* s =
              src + (2 * xi * pitch + 2 * yi * zc0) * 2;
          for (int wd = 0; wd < words; ++wd) {
            const int cb = col_byte + 8 * wd;
            *reinterpret_cast<uint2*>(dst + (cb >> 7) * kSlabBytes +
                                      sw128_offset(R, (cb >> 4) & 7) +
                                      (cb & 15)) =
                *reinterpret_cast<const uint2*>(s + 8 * wd);
          }
        }
      }
      if (par == 3) mbar_arrive(smem_u32(&halo_empty[hb]));
      fence_proxy_async();
      named_sync(2 + wg, 128);
    };
    // BN0 epilogue of chunk (par, c): acc0[4 jj + 2 hh + e] is row lane/4
    // + 8 hh, channel 64 c + 8 jj + 2 q + e; as bf16 pairs these are
    // register 2 (jj & 1) + hh of down0's A fragment for K step jj / 2.
    // The mask selects (exact: relu(v) * 1 or + 0)
    auto bn0 = [&](const float(&acc0)[32], uint32_t(&af)[16], int par,
                   int c) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int n = c * 64 + 8 * jj + 2 * q;
        const int zs = kZBits * par + s_zg[n >> 3];
        const float2 sc = s_sb0[n >> 1][0], bi = s_sb0[n >> 1][1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const bool live = (mb[hh] >> zs) & 1u;
          const float v0 =
              __fadd_rn(__fmul_rn(acc0[4 * jj + 2 * hh], sc.x), bi.x);
          const float v1 =
              __fadd_rn(__fmul_rn(acc0[4 * jj + 2 * hh + 1], sc.y), bi.y);
          af[4 * (jj >> 1) + 2 * (jj & 1) + hh] =
              live ? pack_bf16x2(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f)) : 0u;
        }
      }
    };
    float acc_d[64];  // down0's accumulator: D(0) overwrites it
    float acc0[32];   // conv0's, one chunk's
    uint32_t af[16];  // down0's A fragments, one chunk's
    const int k_base = it * p.steps;  // ring step of the tile's first step
    if constexpr (kStream) {
      // ---- streamed W0: per chunk j = (par, c), ring steps k .. k + nw0
      // are its W0 boxes and k + nw0 its Wd rows
      int k = k_base;
      auto release = [&](int step) {
        if (lane == 0) mbar_arrive(smem_u32(&empty[step % kStages]));
      };
      for (int par = 0; par < 4; ++par) {
        im2col(par, 0);
        for (int c = 0; c < nch; ++c) {
          for (int r = 0; r < nw0; ++r, ++k) {
            const int s = k % kStages;
            mbar_wait(smem_u32(&full[s]), (k / kStages) & 1);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
              const int kg = 8 * r + kk;  // K step of 16 im2col columns
              if (kg < kp / 16)
                wgmma_m64n64k16_ss(acc0,
                                   a_desc(as + (kg / 4) * kSlabBytes, wg,
                                          kg % 4),
                                   b_desc(ring + s * kStageBytes, kk),
                                   kg > 0);
            }
            wgmma_commit();
            if (r > 0) {  // the previous box's MMAs have retired
              wgmma_wait<1>();
              release(k - 1);
            }
          }
          wgmma_wait<0>();
          fence_regs(acc0);
          release(k - 1);
          bn0(acc0, af, par, c);
          // down0 of the chunk: tap `par`, K rows [64 c, 64 c + 64) of
          // Wd[par], the N tile's 128 columns
          const int s = k % kStages;
          mbar_wait(smem_u32(&full[s]), (k / kStages) & 1);
          fence_regs(af);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n128k16_rs(acc_d, &af[4 * kk],
                                b_desc(ring + s * kStageBytes, kk),
                                par > 0 || c > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc_d);
          fence_regs(af);
          release(k);
          ++k;
        }
      }
    } else {
      // ---- resident W0: ring step j is chunk j's Wd rows
      // conv0 of chunk j: A (parity j / nch's im2col) . W0's 64 columns of
      // chunk j % nch, into acc0
      auto conv0 = [&](int j, float(&acc)[32]) {
        const uint32_t a_buf = as + ((j / nch) & 1) * 2 * kSlabBytes;
        const uint32_t w_box = w0s + (j % nch) * nks * kBoxBytes;
#pragma unroll
        for (int kk = 0; kk < KP / 16; ++kk)
          wgmma_m64n64k16_ss(acc,
                             a_desc(a_buf + (kk / 4) * kSlabBytes, wg,
                                    kk % 4),
                             b_desc(w_box + (kk / 4) * kBoxBytes, kk % 4),
                             kk > 0);
      };
      // Chunk j: wait until C(j) and D(j - 1) retire; the BN0 epilogue
      // turns acc0 into af; then D(j) and C(j + 1) go to the tensor cores
      // as one group.  A parity's first chunk builds the next parity's
      // im2col (the other buffer) while C(j) and D(j - 1) run.  `next`
      // (compile-time): whether a C(j + 1) exists
      auto chunk = [&](int j, auto next) {
        const int par = j / nch, c = j - par * nch;
        if (c == 0 && par < 3) im2col(par + 1, (par + 1) & 1);
        wgmma_wait<0>();
        fence_regs(acc0);
        fence_regs(acc_d);
        fence_regs(af);
        if (j > 0 && lane == 0)
          mbar_arrive(smem_u32(&empty[(k_base + j - 1) % kStages]));
        bn0(acc0, af, par, c);
        // down0 D(j): tap `par`, K rows [64 c, 64 c + 64) of Wd[par], from
        // ring step k_base + j
        const int k = k_base + j, s = k % kStages;
        mbar_wait(smem_u32(&full[s]), (k / kStages) & 1);
        fence_regs(af);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16_rs(acc_d, &af[4 * kk],
                              b_desc(ring + s * kStageBytes, kk),
                              j > 0 || kk > 0);
        if constexpr (decltype(next)::value) conv0(j + 1, acc0);
        wgmma_commit();
      };
      const int chunks = 4 * nch;  // (parity, 64 conv0 channels)
      im2col(0, 0);
      wgmma_fence();
      conv0(0, acc0);
      wgmma_commit();
      for (int j = 0; j + 1 < chunks; ++j) chunk(j, std::true_type{});
      chunk(chunks - 1, std::false_type{});
      wgmma_wait<0>();
      fence_regs(acc_d);
      fence_regs(af);
      if (lane == 0)
        mbar_arrive(smem_u32(&empty[(k_base + chunks - 1) % kStages]));
    }
    store_tile<STORE_F32_RELU_MASK>(acc_d, o, b, xo0, yo0, n0, s_sd + n0,
                                    s_bd + n0, warp, lane, nullptr, nullptr);
  }
}

}  // namespace

// The geometry arguments are the fields of the wrapper's HeadTiling in
// order: x's 4-D view dims and the halo box ((Y*4, X, B, 1) and (144, 16 +
// 2h, 1, 1) at Z*C0 = 4, else (Z*C0, Y, X, B) and (Z*C0, 36, 16 + 2h, 1)),
// w0 dims (Z*C1, rows) and box, wd dims (Zo*C2, 4*Z*C1) and box, innermost
// first, then the patch grid, the N tiles, the ring steps per tile, the
// number of tiles and of blocks.  The instance follows from the shape:
// resident for Z*C0 = 4, Z*C1 <= 256 and Zo*C2 = 128, streamed otherwise.
extern "C" int agp_bev_head(const bf16* x, const uint8_t* mask,
                            const bf16* w0p, const float* s0, const float* b0,
                            const bf16* wd, const float* sd, const float* bd,
                            const uint8_t* mask_out, bf16* out, int z, int zo,
                            int k0, int zc0, int xd0, int xd1, int xd2,
                            int xd3, int xb0, int xb1, int xb2, int xb3,
                            int w0d0, int w0d1, int w0b0, int w0b1, int wdd0,
                            int wdd1, int wdb0, int wdb1, int npx, int npy,
                            int nn, int steps, int tiles, int grid,
                            void* stream) {
  const int zc1 = w0d0, zc2 = wdd0, h = k0 / 2;
  const int kp = (k0 * k0 * zc0 + kSlab - 1) / kSlab * kSlab;
  const bool resident = zc0 == 4 && zc1 <= kResZC1 && zc2 == kTileN;
  const int nw0 = (kp + 127) / 128;
  const bool cells = zc0 == 4;  // the [B, X, Y*4, 1] view
  const int X = cells ? xd1 : xd2, Y = cells ? xd0 / 4 : xd1;
  // the boxes and widths must be the tiles the kernel is compiled for
  if ((k0 != 3 && k0 != 5) || (zc0 != 4 && zc0 != 8 && zc0 != 16) ||
      zc1 % 64 != 0 || zc1 > kStrZC1 || z < 1 || z > 16 ||
      zc1 % (8 * z) != 0 || zc2 % kTileN != 0 || zc2 > kMaxZC2 ||
      nn != zc2 / kTileN || zo < 1 || zc2 % (2 * zo) != 0 || X % 2 != 0 ||
      Y % 2 != 0 || kp > kStrMaxKP ||
      (cells ? (xd3 != 1 || xb0 != kHaloCells * 4 || xb1 != 16 + 2 * h ||
                xb2 != 1 || xb3 != 1)
             : (xd0 != zc0 || xb0 != zc0 || xb1 != kHaloCells ||
                xb2 != 16 + 2 * h || xb3 != 1)) ||
      w0d1 != (resident ? kp : nw0 * 128) || w0b0 != 64 ||
      w0b1 != (resident ? kSlab : 128) || wdd1 != 4 * zc1 || wdb0 != 64 ||
      wdb1 != 64 ||
      steps != (resident ? 4 * zc1 / 64 : 4 * (zc1 / 64) * (nw0 + 1)) ||
      grid < 1)
    return cudaErrorInvalidValue;
  const cuuint64_t xd[4] = {(cuuint64_t)xd0, (cuuint64_t)xd1,
                            (cuuint64_t)xd2, (cuuint64_t)xd3};
  const cuuint32_t xb[4] = {(cuuint32_t)xb0, (cuuint32_t)xb1,
                            (cuuint32_t)xb2, (cuuint32_t)xb3};
  const cuuint64_t w0d[2] = {(cuuint64_t)w0d0, (cuuint64_t)w0d1};
  const cuuint32_t w0b[2] = {(cuuint32_t)w0b0, (cuuint32_t)w0b1};
  const cuuint64_t wdd[2] = {(cuuint64_t)wdd0, (cuuint64_t)wdd1};
  const cuuint32_t wdb[2] = {(cuuint32_t)wdb0, (cuuint32_t)wdb1};
  CUtensorMap tx, tw0, twd;
  if (!encode_bf16(&tx, x, 4, xd, xb, false) ||
      !encode_bf16(&tw0, w0p, 2, w0d, w0b) ||
      !encode_bf16(&twd, wd, 2, wdd, wdb))
    return cudaErrorInvalidValue;
  const HeadParams p = {mask, s0, b0, sd, bd, mask_out, out,
                        X, Y, k0, zc0, zc1, zc2, z, zo, kp,
                        kHaloCells * zc0, xb0 * xb1 * xb2 * 2,
                        npx, npy, nn, steps, tiles};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!resident)
    return launch_sm90(head_sm90_kernel<0, true>, grid, kStrSmem, st,
                       kSm90Threads, tx, tw0, twd, p);
  return kp == 64 ? launch_sm90(head_sm90_kernel<64, false>, grid, kResSmem,
                                st, kSm90Threads, tx, tw0, twd, p)
                  : launch_sm90(head_sm90_kernel<128, false>, grid, kResSmem,
                                st, kSm90Threads, tx, tw0, twd, p);
}
