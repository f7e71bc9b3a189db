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
//     (PERF.md section 6, PR 5);
//   * the epilogue is K3's EPI 0 (store_tile) at the output resolution;
//   * a persistent grid of one block per SM: a block walks tiles
//     blockIdx.x, + gridDim.x, ..., its ring running on across them, so
//     the producer fills the next tile's first stages during the epilogue
//     (faster than one tile per block, PERF.md).
// The kernel body (everything but the A box's source) is down0_body in
// down0_sm90.cuh, which P2 (probe_down_v2.cu) shares.
// The launch geometry (tensor-map dims and boxes, patch grid, K steps, tile
// count, grid) comes from the wrapper (ops/bev_down.py: down0_tiling), its
// one source; the host side here only checks the boxes against the tiles
// this kernel is compiled for.
#include "down0_sm90.cuh"

namespace {

using namespace agp;

__global__ void __launch_bounds__(kSm90Threads, kDown0MinBlocks)
    down0_sm90_kernel(const __grid_constant__ CUtensorMap tmap_g,
                      const __grid_constant__ CUtensorMap tmap_w,
                      Down0Params p) {
  // tap (dx, dy) of the 5-D view [B, Xo, 2, Yo, 2*Z*C1] of g
  down0_body(tmap_w, p,
             [&](uint32_t sa, uint32_t bar, int tap, int c0, int yo0, int xo0,
                 int b) {
               tma_load_5d(sa, &tmap_g, bar, (tap & 1) * p.zc1 + c0, yo0,
                           tap >> 1, xo0, b);
             });
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
      gb4 != 1 || gd2 != 2 ||
      !down0_widths_ok(zc1, z, zo, wd0, wd1, wb0, wb1, nn, steps, grid))
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
  return launch_sm90(down0_sm90_kernel, grid, kDown0SmemBytes,
                     static_cast<cudaStream_t>(stream), kSm90Threads, tg, tw,
                     p);
}
