// P1: the two 3x3 conv phases of the eval ECA block as concat GEMMs over a
// halo'd input patch, on TMA + wgmma.
//
// Replaces the TPU probe kernel scripts/probe_block_sm_v2.py:fused_v2
// (_block_kernel, whose pallas_call is at :178), an alternative formulation
// of K3 (bev_block_sm.cu).  The TPU kernel writes its batch tile into a
// halo-padded VMEM scratch (pad_ref) and forms each group of `chunk` taps
// as a concatenation of shifted windows of it: one MXU dot per group over
// chunk*Zcin channels, the groups summed in fp32 and rounded to bf16 once
// (probe_block_sm_v2.py:62-80).
//   phase 1 (EPI 0): h = relu(bf16(bf16(bf16(acc)*s1) + b1)) * mask
//   phase 2 (EPI 1): g = bf16(bf16(bf16(acc)*s2) + b2); pool[b, c] += the
//                    masked sum of g (one atomic per channel per tile)
// The ECA phase and the combine are K3's (eca.cuh, bev_block_sm.cu).
//
// What bounds it on the H100: tensor-core work (block0 at b32: 2 x 38.7
// GFLOP over a 33.5 MB map).  K3's conv phases (conv3x3_sm90.cu) bring x
// into shared memory once per tap, nine times per slab.  Here each input
// element reaches shared memory once per (patch, 64-channel slab):
//   * a tile is an output patch of one item -- kPX x kPY = 128 cells, the
//     GEMM's M -- and 128 output channels; a persistent grid of two blocks
//     per SM walks the tiles (N tiles of a patch adjacent, so a patch's
//     second read of x comes from L2), one block's epilogue overlapping
//     the other's MMAs;
//   * per slab, ONE 4-D TMA box [C 64, Y kHY, X kPX+2, B 1] of x [B, X, Y,
//     Zcin] at (c0, y0-1, x0-1, b) brings the halo'd patch, 128-byte
//     swizzled (a halo cell is one 128-byte row).  TMA zero-fills cells
//     outside the map (negative coordinates included: the conv's padding)
//     and channels past Zcin, so ragged patches and Zcin = 32, 96, ... cost
//     no address arithmetic.  One halo buffer: a block waits for the next
//     slab's halo while the other block on its SM runs its MMAs, and the
//     room goes to weight stages (a second buffer measured no faster,
//     PERF.md section 6, PR 9);
//   * a weight stage holds `chunk` taps -- the TPU kernel's concatenated
//     group -- of KC input channels for the tile's 128 output channels: two
//     3-D TMA boxes (64 columns, KC rows, chunk taps) of w viewed as [9,
//     Zcin, Zcout].  Two blocks per SM leave a block about 100 KB, so KC
//     is 64 at chunk 1, 32 at chunk 3 and 16 at chunk 9 (16 / 24 / 36 KB a
//     stage, 5 / 3 / 2 stages; the TPU's group of 9 x 64 x 128 bf16 would
//     be 144 KB), and a slab takes 9 / chunk x 64 / KC stages.  Rows past
//     Zcin and columns past Zcout are zero-filled;
//   * the A operand of tap (dx, dy) is the halo's rows (px+dx)*kHY +
//     py+dy.  wgmma reads them from shared memory (SS) through a
//     descriptor that starts dy rows into the halo with a stride of kHY*128
//     bytes between 8-row core groups: a 16 x 8 patch, so a core group is
//     one x row of the patch, and kHY = 10.  The 128-byte swizzle is a
//     function of the shared-memory address: the descriptor's base-offset
//     field stays 0 at any start row (set to (start >> 7) & 7 it gave
//     wrong results at every dy != 0).  At chunk 3, the default, this
//     design measured faster than each variant timed: the rows
//     ldmatrix'ed into wgmma's register fragment (an 8 x 16 patch, K3's),
//     halo rows of 16 cells, two halo buffers, two weight stages, and one
//     block per SM with larger stages (PERF.md section 6, PR 9);
//   * one producer warp keeps both rings full; two consumer warpgroups
//     (64 rows each) issue wgmma m64n128k16 into one fp32 accumulator
//     over all nine taps and every slab, rounded to bf16 once in the
//     epilogue (store_tile, K3's forms; channels past Zcout skipped).
// The launch geometry (tensor-map dims and boxes, patch grid, N tiles, K
// steps, tiles, grid) comes from the wrapper (ops/probe_block_sm_v2.py:
// concat_conv_tiling), its one source; the host side here only checks the
// boxes against the tiles this kernel is compiled for.
#include "sm90.cuh"

namespace {

using namespace agp;

constexpr int kPX = 16, kPY = 8;        // output patch
constexpr int kHX = kPX + 2, kHY = 10;  // halo box
constexpr int kHaloTx = kHX * kHY * 128;  // bytes of one halo box
constexpr int kHaloBytes = (kHaloTx + 1023) / 1024 * 1024;
constexpr int kMinBlocks = 2;  // per SM
// the rings' share of a block's shared memory: two blocks per SM leave a
// block about 110 KB besides its static scratch
constexpr int kRingBudget = 104 * 1024;

// Input channels and the number of weight stages at each chunk: KC shrinks
// with the taps a stage holds, so that two blocks per SM (one block's
// epilogue overlapping the other's MMAs) keep two stages or more
template <int CHUNK>
constexpr int kKC = CHUNK == 1 ? 64 : CHUNK == 3 ? 32 : 16;
template <int CHUNK>
constexpr int kWBytes = CHUNK * kKC<CHUNK> * kTileN * 2;  // a weight stage
constexpr int kHalos = 1;
// as many weight stages as the budget holds besides the halo (two at
// least: a consumer releases a stage one step after reading it)
template <int CHUNK>
constexpr int kWStages =
    (kRingBudget - kHalos * kHaloBytes) / kWBytes<CHUNK> > 2
        ? (kRingBudget - kHalos * kHaloBytes) / kWBytes<CHUNK>
        : 2;
template <int CHUNK>
constexpr int kSmemBytes =
    kHalos * kHaloBytes + kWStages<CHUNK> * kWBytes<CHUNK> + 1024;

struct P1Params {
  const uint8_t* mask;  // [B, X, Y, z]
  const float* scale;   // BN eval affine [cout], fp32
  const float* bias;
  bf16* out;            // [B, X, Y, cout]
  float* pool;          // EPI 1: [B, cout] fp32 masked sums (+=)
  int X, Y, cin, cout, z;
  int npx, npy, ntn, nslab, steps, tiles;
};

// shared-memory descriptor of tap (dx, dy)'s A rows for warpgroup wg:
// patch rows 8 wg .. 8 wg + 7 start (8 wg + dx) * kHY + dy halo rows in,
// one 8-row core group per patch row at a stride of kHY rows
__device__ __forceinline__ uint64_t halo_desc(uint32_t halo, int wg, int dx,
                                              int dy, int kg) {
  const uint32_t a = halo + ((8 * wg + dx) * kHY + dy) * 128 + kg * 32;
  return sw128_desc(a, 16, kHY * 128);
}

template <int CHUNK, int EPI>
__global__ void __launch_bounds__(kSm90Threads, kMinBlocks)
    p1_sm90_kernel(const __grid_constant__ CUtensorMap tmap_x,
                   const __grid_constant__ CUtensorMap tmap_w, P1Params p) {
  constexpr int KC = kKC<CHUNK>, S = kWStages<CHUNK>, WB = kWBytes<CHUNK>;
  constexpr int NH = kHalos;          // halo buffers
  constexpr int H = kSlab / KC;       // stages of a tap group per slab
  constexpr int GH = 9 / CHUNK * H;   // stages per slab
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(8) uint64_t wfull[S], wempty[S], hfull[NH], hempty[NH];
  __shared__ float red[kConsumers / 32][kTileN];
  __shared__ float s_sc[kTileN], s_bi[kTileN];
  const uint32_t halo = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t wring = halo + NH * kHaloBytes;

  const int tid = threadIdx.x;
  if (tid == 0) {
    ring_init<S>(wfull, wempty);
    ring_init<NH>(hfull, hempty);
    mbar_init_fence();
  }
  __syncthreads();

  // tile -> (item b, patch (xp, yp), N tile), N tiles fastest;
  // concat_conv_coords replays this on the CPU
  auto patch = [&](int tile, int& b, int& x0, int& y0, int& n0) {
    n0 = (tile % p.ntn) * kTileN;
    tile /= p.ntn;
    y0 = (tile % p.npy) * kPY;
    tile /= p.npy;
    x0 = (tile % p.npx) * kPX;
    b = tile / p.npx;
  };
  // Step i of a tile: slab i / GH, tap group (i / H) % (9 / CHUNK),
  // channel half i % H.  Step counters (k: weight stages, hk: halos) run
  // on across a block's tiles.

  if (tid >= kConsumers) {
    // ---- producer warp: one thread keeps both rings full
    if (tid == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
        int b, x0, y0, n0;
        patch(tile, b, x0, y0, n0);
        for (int i = 0; i < p.steps; ++i) {
          const int s = i / GH, j = (i / H) % (9 / CHUNK), hh = i % H;
          const int c0 = s * kSlab;
          if (i % GH == 0) {  // the slab's halo, once
            const int hk = it * p.nslab + s, hs = hk % NH;
            if (hk >= NH)
              mbar_wait(smem_u32(&hempty[hs]), ((hk / NH) + 1) & 1);
            const uint32_t bar = smem_u32(&hfull[hs]);
            mbar_expect_tx(bar, kHaloTx);
            tma_load_4d(halo + hs * kHaloBytes, &tmap_x, bar, c0, y0 - 1,
                        x0 - 1, b);
          }
          const int k = it * p.steps + i, ws = k % S;
          if (k >= S) mbar_wait(smem_u32(&wempty[ws]), ((k / S) + 1) & 1);
          const uint32_t bar = smem_u32(&wfull[ws]), sw = wring + ws * WB;
          mbar_expect_tx(bar, WB);
          tma_load_3d(sw, &tmap_w, bar, n0, c0 + hh * KC, j * CHUNK);
          tma_load_3d(sw + WB / 2, &tmap_w, bar, n0 + 64, c0 + hh * KC,
                      j * CHUNK);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns GEMM rows [64 wg, 64 wg + 64)
  const int wg = tid / 128, warp = tid / 32, lane = tid & 31;
  const TileOut o = {p.out, p.mask, p.X, p.Y, p.cout, p.z};
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
    int b, x0, y0, n0;
    patch(tile, b, x0, y0, n0);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    for (int i = 0; i < p.steps; ++i) {
      const int s = i / GH, j = (i / H) % (9 / CHUNK), hh = i % H;
      const int hk = it * p.nslab + s, hs = hk % NH;
      const int k = it * p.steps + i, ws = k % S;
      if (i % GH == 0) mbar_wait(smem_u32(&hfull[hs]), (hk / NH) & 1);
      mbar_wait(smem_u32(&wfull[ws]), (k / S) & 1);
      const uint32_t hb = halo + hs * kHaloBytes, sw = wring + ws * WB;
      wgmma_fence();
#pragma unroll
      for (int ti = 0; ti < CHUNK; ++ti) {
        const int tap = j * CHUNK + ti, dx = tap / 3, dy = tap - 3 * dx;
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk)
          wgmma_m64n128k16_ss(
              acc, halo_desc(hb, wg, dx, dy, hh * (KC / 16) + kk),
              b_desc(sw + ti * KC * 128, kk, WB / 2));
      }
      wgmma_commit();
      // one MMA group stays in flight, except at a slab's last step,
      // which drains so that its halo is released before the next
      // slab's is awaited (a single halo buffer would deadlock else)
      const bool slab_end = i % GH == GH - 1;
      if (slab_end)
        wgmma_wait<0>();
      else
        wgmma_wait<1>();
      fence_regs(acc);
      if (lane == 0) {
        if (i % GH != 0)  // step i - 1 retired, and did not end a slab
          mbar_arrive(smem_u32(&wempty[(k - 1) % S]));
        if (slab_end) {
          mbar_arrive(smem_u32(&wempty[ws]));
          mbar_arrive(smem_u32(&hempty[hs]));
        }
      }
    }
    // the tile's scale and bias, rounded to bf16 as K3's epilogue reads
    // them, in shared memory; every consumer is done with the previous
    // tile's (and with the pool form's `red`: a short K loop could let a
    // warp run a whole tile ahead) before they are rewritten
    if (it > 0) named_sync(1, kConsumers);
    if (tid < kTileN) {
      const bool n_ok = n0 + tid < p.cout;
      s_sc[tid] = n_ok ? rbf(p.scale[n0 + tid]) : 0.0f;
      s_bi[tid] = n_ok ? rbf(p.bias[n0 + tid]) : 0.0f;
    }
    named_sync(1, kConsumers);
    store_tile<EPI == 0 ? STORE_BF16_RELU_MASK : STORE_BF16_POOL, kPY,
               true>(acc, o, b, x0, y0, n0, s_sc, s_bi, warp, lane, red,
                     p.pool);
  }
}

template <int CHUNK, int EPI>
int launch(const CUtensorMap& tx, const CUtensorMap& tw, int grid,
           const P1Params& p, cudaStream_t stream) {
  return launch_sm90(p1_sm90_kernel<CHUNK, EPI>, grid, kSmemBytes<CHUNK>,
                     stream, kSm90Threads, tx, tw, p);
}

template <int CHUNK>
int launch_epi(int epi, const CUtensorMap& tx, const CUtensorMap& tw,
               int grid, const P1Params& p, cudaStream_t stream) {
  return epi == 0 ? launch<CHUNK, 0>(tx, tw, grid, p, stream)
                  : launch<CHUNK, 1>(tx, tw, grid, p, stream);
}

}  // namespace

// Dynamic shared memory of one block at `chunk` (1, 3 or 9), -1 otherwise.
extern "C" int agp_p1_smem_bytes(int chunk) {
  switch (chunk) {
    case 1: return kSmemBytes<1>;
    case 3: return kSmemBytes<3>;
    case 9: return kSmemBytes<9>;
    default: return -1;
  }
}

// One conv phase: EPI 0 (pool null) or 1.  The geometry arguments are the
// fields of the wrapper's ConcatConvTiling in order: x dims (Zcin, Y, X, B)
// and the halo box, w dims (Zcout, Zcin, 9) and box, innermost first, then
// the patch grid, the N tiles, the K steps per tile, the number of tiles
// and the number of blocks.
extern "C" int agp_p1_conv_sm90(const bf16* x, const uint8_t* mask,
                                const bf16* w, const float* scale,
                                const float* bias, bf16* out, float* pool,
                                int epi, int chunk, int z, int xd0, int xd1,
                                int xd2, int xd3, int xb0, int xb1, int xb2,
                                int xb3, int wd0, int wd1, int wd2, int wb0,
                                int wb1, int wb2, int npx, int npy, int ntn,
                                int steps, int tiles, int grid,
                                void* stream) {
  const int cin = xd0, cout = wd0;
  const int kc = chunk == 1 ? kKC<1> : chunk == 3 ? kKC<3> : kKC<9>;
  const int nslab = (cin + kSlab - 1) / kSlab;
  // the boxes and widths must be the tiles the kernel is compiled for
  if ((chunk != 1 && chunk != 3 && chunk != 9) || (epi != 0 && epi != 1) ||
      xb0 != kSlab || xb1 != kHY || xb2 != kHX || xb3 != 1 || wd1 != cin ||
      wd2 != 9 || wb0 != kTileN / 2 || wb1 != kc || wb2 != chunk ||
      cin % 32 != 0 || cout % 32 != 0 || z < 1 || cout % z != 0 ||
      (cout / z) % 2 != 0 || ntn != (cout + kTileN - 1) / kTileN ||
      steps != nslab * (9 / chunk) * (kSlab / kc) || tiles < 1 || grid < 1 ||
      (epi == 1 && pool == nullptr))
    return cudaErrorInvalidValue;
  const cuuint64_t xd[4] = {(cuuint64_t)xd0, (cuuint64_t)xd1,
                            (cuuint64_t)xd2, (cuuint64_t)xd3};
  const cuuint32_t xb[4] = {(cuuint32_t)xb0, (cuuint32_t)xb1,
                            (cuuint32_t)xb2, (cuuint32_t)xb3};
  const cuuint64_t wd[3] = {(cuuint64_t)wd0, (cuuint64_t)wd1,
                            (cuuint64_t)wd2};
  const cuuint32_t wb[3] = {(cuuint32_t)wb0, (cuuint32_t)wb1,
                            (cuuint32_t)wb2};
  CUtensorMap tx, tw;
  // x [B, X, Y, Zcin] and w [9, Zcin, Zcout], dense rows of bf16
  if (!encode_bf16(&tx, x, 4, xd, xb) || !encode_bf16(&tw, w, 3, wd, wb))
    return cudaErrorInvalidValue;
  const P1Params p = {mask, scale, bias, out, pool, xd2, xd1, cin, cout, z,
                      npx, npy, ntn, nslab, steps, tiles};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 1: return launch_epi<1>(epi, tx, tw, grid, p, s);
    case 3: return launch_epi<3>(epi, tx, tw, grid, p, s);
    default: return launch_epi<9>(epi, tx, tw, grid, p, s);
  }
}
