// The 3x3 conv phases of K3 and K6 for Hopper: TMA loads into a
// 128-byte-swizzled shared-memory ring and wgmma from shared memory,
// warp-specialised.
//
// Replaces, for the TPU kernel agplace_tpu/ops/pallas/bev_block_sm.py:
// fused_eca_block_sm (_block_kernel), the two conv3x3 + BN epilogues of the
// block (bev_block_sm.py:77-90); K3's ECA phase (eca.cuh) and its combine
// (bev_block_sm.cu) are unchanged.  The TPU kernel feeds the MXU with whole
// shifted windows of a VMEM-resident batch tile.  On the H100 the same work
// is an implicit GEMM per phase, M = B*X*Y cells, N = Zcout, K = 9*Zcin:
//   phase 1 (EPI 0): h = relu(bf16(bf16(bf16(acc)*s1) + b1)) * mask
//   phase 2 (EPI 1): g = bf16(bf16(bf16(acc)*s2) + b2); pool[b, c] += the
//                    masked sum of g (one atomic per channel per block)
// K6 (agplace_tpu/ops/pallas/bev_block.py: fused_eca_block, bev_block.cu)
// computes the same two convs with the fp32 epilogues of bev_block.py:78-
// 104: the affine in fp32 on the unrounded accumulator with unrounded
// scale and bias, a multiply and an add each rounded to fp32:
//   phase 1 (EPI 2): h = bf16(relu(acc*s1 + b1) * mask)
//   phase 2 (EPI 3): g = bf16(acc*s2 + b2); pool[b, c] += the masked sum of
//                    the rounded g
// The four instances share the main loop; only the scale / bias load and
// the epilogue form differ, chosen at compile time.
//
// What bounds it: tensor-core work.  At the main-path shapes (z = 2 after
// down0, where the folded 3x3x3 kernels are dense) a phase is 19-39 GFLOP
// over maps of 4-34 MB: 0.02-0.04 ms at the bf16 peak, against 0.006-0.02
// ms to read x and the weights and write the output once (b32).  So the design keeps the tensor
// cores fed and spends no thread on addresses:
//   * a block owns an output patch of one batch item, 8 (x) x 16 (y) cells
//     = 128 GEMM rows, and 128 output channels; its cells belong to one item,
//     so phase 2's masked pool is one atomic per channel per block;
//   * the K loop runs 9 * Zcin/64 steps, one per (tap, 64-channel slab).  A
//     step's A operand is ONE 4-D TMA box [C 64, Y 16, X 8, B 1] of the map
//     x [B, X, Y, Zcin] at (c0, y0+dy-1, x0+dx-1, b).  TMA fills cells
//     outside the map with zeros and takes negative coordinates, so the
//     conv's zero padding and the ragged edge of maps smaller than the patch
//     cost no address arithmetic.  64 bf16 are one 128-byte row, so with the
//     128-byte swizzle the box lands as the K-major 128 x 64 operand wgmma
//     reads from shared memory.  The nine taps re-read x from L2, not HBM;
//   * B is the folded weight matrix [9*Zcin, Zcout], row-major as the model
//     keeps it, loaded as two 64 x 64 TMA boxes per step with the 128-byte
//     swizzle and read by wgmma MN-major (its transpose bit);
//   * one producer warp issues the TMA loads into a ring of kStages = 3
//     stages (32 KB each) with full/empty mbarrier pairs; two consumer
//     warpgroups, 64 rows each, issue wgmma.mma_async m64n128k16 and keep
//     the fp32 accumulator in registers, one wgmma group in flight;
//   * two blocks share an SM (3 stages each, 99 KB of shared memory, at
//     most 112 registers a thread; ptxas uses 93-95 without spills, so no
//     setmaxnreg rebalancing is needed), so one block's epilogue and ring
//     fill overlap the other's main loop.  On an H100 80GB HBM3 this
//     measured 1.23-1.26x faster than one block per SM with six stages,
//     and 1.12-1.25x faster than two stages, at every shape it timed
//     (PERF.md section 6, PR 4);
//   * the epilogue works from the accumulator registers with the JAX
//     rounding points: bf16(acc), a bf16 multiply by bf16(scale), a bf16 add
//     of bf16(bias), then relu * mask or the fp32 masked pool.
// The TMA / mbarrier / wgmma primitives, the producer/consumer ring and the
// register epilogue are the shared Hopper main loop (sm90.cuh), which K2
// and K4 use too.
// The launch geometry (tensor-map dims and boxes, patch grid, K steps, grid)
// comes from the wrapper (ops/bev_block_sm.py: conv3x3_tiling), its one
// source; the host side here only checks that the boxes are the tiles this
// kernel is compiled for.  The tensor maps are encoded per call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no -lcuda),
// and passed as __grid_constant__ kernel parameters.
#include "sm90.cuh"

namespace {

using namespace agp;

constexpr int kBN = kTileN;      // 128 output channels per block
constexpr int kABytes = kSlabBytes;  // the x box: 128 cells x 64 channels
constexpr int kBBytes = 2 * kBoxBytes;  // two 64 x 64 weight boxes
constexpr int kStageBytes = kABytes + kBBytes;  // 32 KB

constexpr int kStages = 3;     // per block
constexpr int kMinBlocks = 2;  // per SM
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + 1 KB alignment
constexpr int kTxBytes = kABytes + kBBytes;

struct Conv3x3Params {
  const uint8_t* mask;  // [B, X, Y, z]
  const float* scale;   // BN eval affine [cout]
  const float* bias;
  bf16* out;            // [B, X, Y, cout]
  float* pool;          // EPI 1: [B, cout] fp32 masked sums (+=)
  int X, Y, cin, cout, z;
  int npx, npy, ntn, steps;  // patch grid, N tiles, K steps
};

// the epilogue form of each instance: K3's bf16 forms, K6's fp32 forms
template <int EPI>
constexpr int kStore = EPI == 0   ? STORE_BF16_RELU_MASK
                       : EPI == 1 ? STORE_BF16_POOL
                       : EPI == 2 ? STORE_F32_RELU_MASK
                                  : STORE_F32_POOL;

template <int EPI>
__global__ void __launch_bounds__(kSm90Threads, kMinBlocks)
    conv3x3_sm90_kernel(const __grid_constant__ CUtensorMap tmap_x,
                        const __grid_constant__ CUtensorMap tmap_w,
                        Conv3x3Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ float s_sc[kBN], s_bi[kBN];
  __shared__ float red[kConsumers / 32][kBN];
  const uint32_t ring = (smem_u32(smem) + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  // block -> (item b, patch (xp, yp), N tile nt), N tiles fastest so that
  // neighbouring blocks read the same input patch from L2
  int r = blockIdx.x;
  const int nt = r % p.ntn;
  r /= p.ntn;
  const int yp = r % p.npy;
  r /= p.npy;
  const int xp = r % p.npx;
  const int b = r / p.npx;
  const int x0 = xp * kPatchX, y0 = yp * kPatchY, n0 = nt * kBN;

  if (tid < kBN) {  // the bf16 forms round scale and bias, the fp32 don't
    const float sc = p.scale[n0 + tid], bi = p.bias[n0 + tid];
    s_sc[tid] = EPI < 2 ? rbf(sc) : sc;
    s_bi[tid] = EPI < 2 ? rbf(bi) : bi;
  }
  if (tid == 0) {
    ring_init<kStages>(full, empty);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: one thread keeps the ring full
    if (tid == kConsumers)
      ring_produce<kStages>(full, empty, 0, p.steps, kTxBytes,
                            [&](int k, int s, uint32_t bar) {
        // K step k is (tap, 64-channel slab); conv3x3_coords in the
        // wrapper replays these coordinates on the CPU
        const int k0 = k * kSlab;
        const int tap = k0 / p.cin, c0 = k0 - tap * p.cin;
        const int dx = tap / 3, dy = tap - 3 * dx;
        const uint32_t sa = ring + s * kStageBytes, sb = sa + kABytes;
        tma_load_4d(sa, &tmap_x, bar, c0, y0 + dy - 1, x0 + dx - 1, b);
        // w [9*cin, cout]: two 64 x 64 boxes of 64 output channels each
        tma_load_2d(sb, &tmap_w, bar, n0, k0);
        tma_load_2d(sb + kBoxBytes, &tmap_w, bar, n0 + 64, k0);
      });
    return;
  }

  // ---- consumers: warpgroup wg owns GEMM rows [64 wg, 64 wg + 64)
  const int wg = tid / 128, warp = tid / 32, lane = tid & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  ring_consume<kStages, 1>(
      full, empty, 0, p.steps, lane,
      [&](int, int s) {
        const uint32_t sa = ring + s * kStageBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSlab / 16; ++kk)
          wgmma_m64n128k16_ss(acc, a_desc(sa, wg, kk),
                              b_desc(sa + kABytes, kk));
      },
      [&] { fence_regs(acc); });

  const TileOut o = {p.out, p.mask, p.X, p.Y, p.cout, p.z};
  store_tile<kStore<EPI>>(acc, o, b, x0, y0, n0, s_sc, s_bi, warp, lane,
                          red, p.pool);
}

template <int EPI>
int launch(const bf16* x, const bf16* w, const cuuint64_t (&xd)[4],
           const cuuint32_t (&xb)[4], const cuuint64_t (&wd)[2],
           const cuuint32_t (&wb)[2], int grid, const Conv3x3Params& p,
           cudaStream_t stream) {
  // the boxes must be the tiles the kernel is compiled for
  if (xb[0] != kSlab || xb[1] != kPatchY || xb[2] != kPatchX || xb[3] != 1 ||
      wb[0] != kBN / 2 || wb[1] != kSlab)
    return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  // x [B, X, Y, cin] and w [9*cin, cout], dense rows of bf16
  if (!encode_bf16(&tx, x, 4, xd, xb) || !encode_bf16(&tw, w, 2, wd, wb))
    return cudaErrorInvalidValue;
  return launch_sm90(conv3x3_sm90_kernel<EPI>, grid, kSmemBytes, stream,
                     kSm90Threads, tx, tw, p);
}

}  // namespace

// One conv phase: EPI 0 or 2 (pool null), EPI 1 or 3.  The geometry
// arguments are the fields of the wrapper's Conv3x3Tiling in order: x dims
// (Zcin, Y, X, B) and box, w dims (Zcout, 9*Zcin) and box, innermost first,
// then the patch grid, the K steps and the number of blocks.
extern "C" int agp_conv3x3(const bf16* x, const uint8_t* mask, const bf16* w,
                           const float* scale, const float* bias, bf16* out,
                           float* pool, int epi, int z, int xd0, int xd1,
                           int xd2, int xd3, int xb0, int xb1, int xb2,
                           int xb3, int wd0, int wd1, int wb0, int wb1,
                           int npx, int npy, int ntn, int steps, int grid,
                           void* stream) {
  const cuuint64_t xd[4] = {(cuuint64_t)xd0, (cuuint64_t)xd1,
                            (cuuint64_t)xd2, (cuuint64_t)xd3};
  const cuuint32_t xb[4] = {(cuuint32_t)xb0, (cuuint32_t)xb1,
                            (cuuint32_t)xb2, (cuuint32_t)xb3};
  const cuuint64_t wd[2] = {(cuuint64_t)wd0, (cuuint64_t)wd1};
  const cuuint32_t wb[2] = {(cuuint32_t)wb0, (cuuint32_t)wb1};
  const Conv3x3Params p = {mask, scale, bias, out, pool, xd2, xd1, xd0, wd0,
                           z, npx, npy, ntn, steps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case 0: return launch<0>(x, w, xd, xb, wd, wb, grid, p, s);
    case 1: return launch<1>(x, w, xd, xb, wd, wb, grid, p, s);
    case 2: return launch<2>(x, w, xd, xb, wd, wb, grid, p, s);
    case 3: return launch<3>(x, w, xd, xb, wd, wb, grid, p, s);
    default: return cudaErrorInvalidValue;
  }
}
