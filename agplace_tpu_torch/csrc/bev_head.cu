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
//   * a persistent block (one per SM, 204 KB of shared memory) walks output
//     patches of 8 (xo) x 16 (yo) cells of one item (128 GEMM rows, two
//     consumer warpgroups of 64) with all 128 output channels; W0 (the
//     im2col weight [kp, Z*C1], up to 64 KB) is loaded once per block by
//     TMA and stays resident;
//   * per patch one 3-D TMA box brings the input halo, (16 + 2h) x 36
//     full-resolution cells x Z*C0 = 4 channels (h = k0/2; 5.8 KB at k0 =
//     5), through the view [B, X, Y*4] (a cell's 4 channels are 8 bytes,
//     below TMA's 16-byte inner box; the box starts 2 cells before the
//     patch along y, so its inner coordinate stays 16-byte aligned); the
//     view's zero fill outside the map is conv0's zero padding.  The
//     producer warp loads the next patch's halo into the second of two
//     buffers while the consumers work;
//   * each warpgroup builds conv0's im2col operand of a parity for its 64
//     rows in shared memory from the halo, one lane per tap, 8-byte copies
//     (K = k0*k0*4 padded to kp = 64 or 128 with zeros, the 128-byte-
//     swizzled K-major layout of K3's x box), into one of two buffers: the
//     next parity's is built while the current one's MMAs run;
//   * per chunk of 64 conv0 channels (16 per patch at KITTI):
//       - conv0 as SS wgmma m64n64k16 against W0,
//       - the BN0 epilogue in registers (fp32 affine, relu, z-mask, one
//         round), whose m64n64 accumulator layout is the m16n8k16 A
//         fragment of the next MMA (as FlashAttention-3 feeds P to P.V),
//       - down0 as RS wgmma m64n128k16 of that fragment against the
//         chunk's 64 rows of Wd[p], streamed through a 4-stage TMA ring,
//         into an fp32 accumulator that stays in registers across the four
//         parities;
//     D(j) and the next chunk's conv0 C(j + 1) are issued as one group.
//     Registers a wgmma reads may be written only while none of the
//     warpgroup's wgmmas is in flight (else ptxas serializes every wgmma
//     of the kernel), so each chunk waits for its group before the
//     epilogue; the two warpgroups overlap one's epilogue with the other's
//     MMAs;
//   * the output epilogue (store_tile, fp32 form).
// The launch geometry comes from the wrapper (ops/bev_head.py:
// head_tiling), its one source; the host side here only checks it against
// the tiles this kernel is compiled for.
#include "sm90.cuh"

// Ablation switch, 0 unless set with -D: parts of the work taken out (bit
// 1: the im2col copies, 2: conv0's MMAs, 4: down0's MMAs, 8: the BN0
// epilogue's arithmetic, 16: the Wd loads; results are then wrong on
// purpose)
#ifndef AGP_HEAD_SKIP
#define AGP_HEAD_SKIP 0
#endif

namespace {

using namespace agp;

constexpr int kSkip = AGP_HEAD_SKIP;
constexpr int kStages = 4;            // Wd ring: one 64 x 128 slab per stage
constexpr int kStageBytes = 2 * kBoxBytes;  // 16 KB
constexpr int kMaxZC1 = 256;
// the halo starts 2 cells before the patch along y for every k0, so that
// its inner TMA coordinate (8 bf16 = 16 bytes per 2 cells) stays 16-byte
// aligned; along x it starts h = k0/2 rows before
constexpr int kHaloLead = 2;
constexpr int kHaloRow = (2 * kPatchY + 2 * kHaloLead) * 4;  // 144 bf16
constexpr int kHaloMax = kHaloRow * 20 * 2;  // bytes of one halo buffer
constexpr int kW0Off = 0;               // W0 boxes, up to 64 KB
constexpr int kAOff = kW0Off + 128 * kMaxZC1 * 2;  // im2col: 2 x 2 slabs
constexpr int kRingOff = kAOff + 4 * kSlabBytes;
constexpr int kHaloOff = kRingOff + kStages * kStageBytes;
constexpr int kSmemBytes = kHaloOff + 2 * kHaloMax + 1024;  // + alignment

struct HeadParams {
  const uint8_t* mask;      // [B, X, Y, z]
  const float* s0;          // BN0 eval affine [zc1]
  const float* b0;
  const float* sd;          // down BN eval affine [128]
  const float* bd;
  const uint8_t* mask_out;  // [B, X/2, Y/2, zo]
  bf16* out;                // [B, X/2, Y/2, 128]
  int X, Y, k0, zc1, z, zo;
  int pitch, halo_bytes;    // halo row (elements), halo box bytes
  int npx, npy, steps, tiles;
};

// KP: conv0's padded im2col depth (64 or 128), fixed at compile time so
// that the conv0 MMAs unroll
template <int KP>
__global__ void __launch_bounds__(kSm90Threads, 1)
    head_sm90_kernel(const __grid_constant__ CUtensorMap tmap_x,
                     const __grid_constant__ CUtensorMap tmap_w0,
                     const __grid_constant__ CUtensorMap tmap_wd,
                     HeadParams p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ __align__(8) uint64_t halo_full[2], halo_empty[2], w0_full;
  __shared__ float2 s_sb0[kMaxZC1 / 2][2];  // BN0 (scale, bias) pairs
  __shared__ uint8_t s_zg[kMaxZC1 / 8];     // z-slab of 8-channel group
  __shared__ float s_sd[kTileN], s_bd[kTileN];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  unsigned char* gbase = smem + (base - smem_u32(smem));
  const uint32_t w0s = base + kW0Off, as = base + kAOff;
  const uint32_t ring = base + kRingOff, halo = base + kHaloOff;

  const int tid = threadIdx.x;
  constexpr int nks = KP / kSlab;
  const int nch = p.zc1 / 64;
  for (int i = tid; i < p.zc1 / 2; i += kSm90Threads) {
    s_sb0[i][0] = make_float2(p.s0[2 * i], p.s0[2 * i + 1]);
    s_sb0[i][1] = make_float2(p.b0[2 * i], p.b0[2 * i + 1]);
    if (i % 4 == 0) s_zg[i / 4] = (uint8_t)(2 * i / (p.zc1 / p.z));
  }
  if (tid < kTileN) {
    s_sd[tid] = p.sd[tid];
    s_bd[tid] = p.bd[tid];
  }
  if (tid == 0) {
    ring_init<kStages>(full, empty);
    for (int i = 0; i < 2; ++i) {
      mbar_init(smem_u32(&halo_full[i]), 1);
      mbar_init(smem_u32(&halo_empty[i]), kConsumers);
    }
    mbar_init(smem_u32(&w0_full), 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int h = p.k0 / 2;
  // tile -> (item b, patch (xp, yp)); head_coords replays this on the CPU
  auto patch = [&](int tile, int& b, int& xo0, int& yo0) {
    yo0 = (tile % p.npy) * kPatchY;
    tile /= p.npy;
    xo0 = (tile % p.npx) * kPatchX;
    b = tile / p.npx;
  };

  if (tid >= kConsumers) {
    // ---- producer warp: one thread loads W0 once, then per tile its halo
    // and Wd[0..3]
    if (tid == kConsumers) {
      const uint32_t wbar = smem_u32(&w0_full);
      mbar_expect_tx(wbar, KP * p.zc1 * 2);
      for (int c = 0; c < nch; ++c)
        for (int ks = 0; ks < nks; ++ks)
          tma_load_2d(w0s + (c * nks + ks) * kBoxBytes, &tmap_w0, wbar,
                      c * 64, ks * kSlab);
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
        int b, xo0, yo0;
        patch(tile, b, xo0, yo0);
        const int hb = it & 1;
        if (it >= 2)
          mbar_wait(smem_u32(&halo_empty[hb]), ((it / 2) + 1) & 1);
        const uint32_t hbar = smem_u32(&halo_full[hb]);
        mbar_expect_tx(hbar, p.halo_bytes);
        tma_load_3d(halo + hb * kHaloMax, &tmap_x, hbar,
                    (2 * yo0 - kHaloLead) * 4, 2 * xo0 - h, b);
        // step i: rows [64 i, 64 i + 64) of wd [4*zc1, 128], i.e. parity
        // i / nch, conv0 channels 64 (i % nch) + [0, 64)
        ring_produce<kStages>(full, empty, it * p.steps, p.steps,
                              kSkip & 16 ? 0 : kStageBytes,
                              [&](int i, int s, uint32_t bar) {
          const uint32_t sb = ring + s * kStageBytes;
          if (kSkip & 16) return;
          tma_load_2d(sb, &tmap_wd, bar, 0, i * 64);
          tma_load_2d(sb + kBoxBytes, &tmap_wd, bar, 64, i * 64);
        });
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns GEMM rows [64 wg, 64 wg + 64)
  const int wg = tid / 128, warp = tid / 32, lane = tid & 31, q = lane & 3;
  const int wt = tid & 127;  // thread within the warpgroup
  // im2col: lane t of a warp copies tap t = a*k0 + bb (lanes >= k0*k0
  // idle) of each of the warp's 16 rows; its offsets are fixed
  const int taps = p.k0 * p.k0;
  const bool tap_lane = lane < taps;
  const int ta = lane / p.k0, tb = lane - ta * p.k0;
  const int src_lane = ta * p.pitch + (tb + kHaloLead - h) * 4;  // elements
  const int dst_slab = (lane / 16) * kSlabBytes, dst_chunk = (lane % 16) / 2;
  const int dst_half = (lane & 1) * 8;
  // zero this warpgroup's rows of both im2col buffers once: the padded
  // depth [4 taps, KP) is never written again
  for (int i = wt; i < 2 * 2 * 64 * 8; i += 128) {
    const int slab = i / (64 * 8), rem = i - slab * 64 * 8;
    *reinterpret_cast<uint4*>(gbase + kAOff + slab * kSlabBytes +
                              (wg * 64 + rem / 8) * 128 + (rem % 8) * 16) =
        make_uint4(0, 0, 0, 0);
  }
  mbar_wait(smem_u32(&w0_full), 0);
  const TileOut o = {p.out, p.mask_out, p.X / 2, p.Y / 2, kTileN, p.zo};
  const int chunks = 4 * nch;  // (parity, 64 conv0 channels), parity-major
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
    int b, xo0, yo0;
    patch(tile, b, xo0, yo0);
    const int hb = it & 1;
    const unsigned char* hsrc = gbase + kHaloOff + hb * kHaloMax;
    // the occupancy of this thread's two rows' 2x2 windows: bit 8 par + z
    // of mb[hh] is cell (2 xo + dx, 2 yo + dy), z-slab z, par = 2 dx + dy
    uint32_t mb[2];
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
            mb[hh] |= (uint32_t)(mp[((par >> 1) * p.Y + (par & 1)) * p.z +
                                   zz] != 0) << (8 * par + zz);
      }
    }
    mbar_wait(smem_u32(&halo_full[hb]), (it / 2) & 1);
    // im2col of parity `par` into buffer par % 2, this warpgroup's rows:
    // row R = cell (xi, yi) takes tap (a, bb) from halo cell (2 xi + dx + a,
    // 2 yi + dy + bb + 2 - h) into columns 4 t .. 4 t + 3, t = a*k0 + bb
    // (head_im2col replays it)
    auto im2col = [&](int par) {
      const int dx = par >> 1, dy = par & 1;
      unsigned char* dst = gbase + kAOff + (par & 1) * 2 * kSlabBytes;
      const unsigned char* src =
          hsrc + (src_lane + dx * p.pitch + dy * 4) * 2;
      named_sync(2 + wg, 128);  // the buffer's last MMAs are done
      if (tap_lane && !(kSkip & 1)) {
#pragma unroll 4
        for (int i = 0; i < 16; ++i) {
          const int R = warp * 16 + i;  // patch cell (R / 16, R % 16)
          const int xi = R / kPatchY, yi = R % kPatchY;
          const uint2 v = *reinterpret_cast<const uint2*>(
              src + (2 * xi * p.pitch + 2 * yi * 4) * 2);
          *reinterpret_cast<uint2*>(dst + dst_slab +
                                    sw128_offset(R, dst_chunk) + dst_half) =
              v;
        }
      }
      if (par == 3) mbar_arrive(smem_u32(&halo_empty[hb]));
      fence_proxy_async();
      named_sync(2 + wg, 128);
    };
    // conv0 of chunk j: A (parity j / nch's im2col) . W0's 64 columns of
    // chunk j % nch, into acc0
    auto conv0 = [&](int j, float(&acc0)[32]) {
      const uint32_t a_buf = as + ((j / nch) & 1) * 2 * kSlabBytes;
      const uint32_t w_box = w0s + (j % nch) * nks * kBoxBytes;
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk)
        if (!(kSkip & 2))
          wgmma_m64n64k16_ss(acc0,
                           a_desc(a_buf + (kk / 4) * kSlabBytes, wg, kk % 4),
                           b_desc(w_box + (kk / 4) * kBoxBytes, kk % 4),
                           kk > 0);
    };
    float acc_d[64];  // down0's accumulator: D(0) overwrites it
    float acc0[32];   // conv0's, one chunk's
    uint32_t af[16];  // down0's A fragments, one chunk's
    const int k_base = it * p.steps;  // ring step of chunk 0
    // Chunk j: wait until C(j) and D(j - 1) retire; the BN0 epilogue turns
    // acc0 into af; then D(j) and C(j + 1) go to the tensor cores as one
    // group.  Registers that a wgmma reads are written only while no wgmma
    // of this warpgroup is in flight (ptxas serializes every wgmma of the
    // kernel otherwise), so a warpgroup's epilogue does not overlap its own
    // MMAs: the two consumer warpgroups interleave, one's epilogue with the
    // other's MMAs.  A parity's first chunk builds the next parity's
    // im2col (the other buffer) while C(j) and D(j - 1) run.  `next`
    // (compile-time): whether a C(j + 1) exists
    auto chunk = [&](int j, auto next) {
      const int par = j / nch, c = j - par * nch;
      if (c == 0 && par < 3) im2col(par + 1);
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(acc_d);
      fence_regs(af);
      if (j > 0 && lane == 0)
        mbar_arrive(smem_u32(&empty[(k_base + j - 1) % kStages]));
      // BN0 epilogue: acc0[4 jj + 2 hh + e] is row lane/4 + 8 hh, channel
      // 64 c + 8 jj + 2 q + e; as bf16 pairs these are register 2 (jj & 1)
      // + hh of down0's A fragment for K step jj / 2.  The mask selects
      // (exact: relu(v) * 1 or + 0)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int n = c * 64 + 8 * jj + 2 * q;
        const int zs = 8 * par + s_zg[n >> 3];
        const float2 sc = s_sb0[n >> 1][0], bi = s_sb0[n >> 1][1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const bool live = (mb[hh] >> zs) & 1u;
          const float v0 =
              __fadd_rn(__fmul_rn(acc0[4 * jj + 2 * hh], sc.x), bi.x);
          const float v1 =
              __fadd_rn(__fmul_rn(acc0[4 * jj + 2 * hh + 1], sc.y), bi.y);
          af[4 * (jj >> 1) + 2 * (jj & 1) + hh] =
              kSkip & 8
                  ? pack_bf16x2(acc0[4 * jj + 2 * hh],
                                acc0[4 * jj + 2 * hh + 1])
                  : live ? pack_bf16x2(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f))
                         : 0u;
        }
      }
      // down0 D(j): tap `par`, K rows [64 c, 64 c + 64) of Wd[par], from
      // ring step k_base + j
      const int k = k_base + j, s = k % kStages;
      mbar_wait(smem_u32(&full[s]), (k / kStages) & 1);
      fence_regs(af);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (!(kSkip & 4))
          wgmma_m64n128k16_rs(acc_d, &af[4 * kk],
                              b_desc(ring + s * kStageBytes, kk),
                              j > 0 || kk > 0);
      if constexpr (decltype(next)::value) conv0(j + 1, acc0);
      wgmma_commit();
    };
    im2col(0);
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
    store_tile<STORE_F32_RELU_MASK>(acc_d, o, b, xo0, yo0, 0, s_sd, s_bd,
                                    warp, lane, nullptr, nullptr);
  }
}

}  // namespace

// The geometry arguments are the fields of the wrapper's HeadTiling in
// order: x's 3-D view dims (Y*4, X, B) and the halo box, w0 dims (Z*C1, kp)
// and box, wd dims (128, 4*Z*C1) and box, innermost first, then the patch
// grid, the ring steps per tile, the number of tiles and of blocks.
extern "C" int agp_bev_head(const bf16* x, const uint8_t* mask,
                            const bf16* w0p, const float* s0, const float* b0,
                            const bf16* wd, const float* sd, const float* bd,
                            const uint8_t* mask_out, bf16* out, int z, int zo,
                            int k0, int xd0, int xd1, int xd2, int xb0,
                            int xb1, int xb2, int w0d0, int w0d1, int w0b0,
                            int w0b1, int wdd0, int wdd1, int wdb0, int wdb1,
                            int npx, int npy, int steps, int tiles, int grid,
                            void* stream) {
  const int zc1 = w0d0, kp = w0d1, h = k0 / 2;
  // the boxes and widths must be the tiles the kernel is compiled for
  if ((k0 != 3 && k0 != 5) || (kp != 64 && kp != 128) ||
      4 * k0 * k0 > kp || zc1 % 64 != 0 || zc1 > kMaxZC1 || z < 1 ||
      z > 4 || zc1 % (8 * z) != 0 || xd0 % 8 != 0 || xb0 != kHaloRow ||
      xb1 != 16 + 2 * h || xb2 != 1 ||
      w0b0 != 64 || w0b1 != kSlab || wdd0 != kTileN || wdd1 != 4 * zc1 ||
      wdb0 != 64 || wdb1 != 64 || steps != 4 * zc1 / 64 || grid < 1)
    return cudaErrorInvalidValue;
  const cuuint64_t xd[3] = {(cuuint64_t)xd0, (cuuint64_t)xd1,
                            (cuuint64_t)xd2};
  const cuuint32_t xb[3] = {(cuuint32_t)xb0, (cuuint32_t)xb1,
                            (cuuint32_t)xb2};
  const cuuint64_t w0d[2] = {(cuuint64_t)w0d0, (cuuint64_t)w0d1};
  const cuuint32_t w0b[2] = {(cuuint32_t)w0b0, (cuuint32_t)w0b1};
  const cuuint64_t wdd[2] = {(cuuint64_t)wdd0, (cuuint64_t)wdd1};
  const cuuint32_t wdb[2] = {(cuuint32_t)wdb0, (cuuint32_t)wdb1};
  CUtensorMap tx, tw0, twd;
  if (!encode_bf16(&tx, x, 3, xd, xb, false) ||
      !encode_bf16(&tw0, w0p, 2, w0d, w0b) ||
      !encode_bf16(&twd, wd, 2, wdd, wdb))
    return cudaErrorInvalidValue;
  const HeadParams p = {mask, s0, b0, sd, bd, mask_out, out,
                        xd1, xd0 / 4, k0, zc1, z, zo,
                        xb0, xb0 * xb1 * 2, npx, npy, steps, tiles};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kp == 64 ? launch_sm90(head_sm90_kernel<64>, grid, kSmemBytes, st,
                                kSm90Threads, tx, tw0, twd, p)
                  : launch_sm90(head_sm90_kernel<128>, grid, kSmemBytes, st,
                                kSm90Threads, tx, tw0, twd, p);
}
