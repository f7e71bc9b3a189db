// The Hopper main loop shared by the port's TMA + wgmma kernels: the 3x3
// conv phases of K3 and K6 (conv3x3_sm90.cu), K2's down0 GEMM (bev_down.cu)
// and K4's fused head (bev_head.cu); K5 (stem_pool.cu) uses its mbarrier
// and bulk-copy primitives.
//
// * mbarrier, TMA (cp.async.bulk.tensor, 2-D to 5-D boxes; cp.async.bulk,
//   1-D) and wgmma
//   primitives in raw PTX (sm_90a): the shared-memory matrix descriptor of
//   the 128-byte swizzle, m64n128k16 with A from shared memory (SS) or from
//   registers (RS), m64n64k16 SS, ldmatrix, and the register fences that
//   keep the compiler off registers an asynchronous MMA still reads;
// * the producer/consumer ring: one producer thread fills kStages stages
//   with TMA loads (full/empty mbarrier pairs, expect_tx on full), the
//   consumer warpgroups wait on full, issue their MMAs, and release a stage
//   once the MMAs that read it have retired (ring_produce / ring_consume).
//   Step counters run on across a block's tiles, so a persistent block's
//   producer fills the next tile's first stages while the consumers are in
//   the current tile's epilogue;
// * the register epilogue of an m64n128 accumulator tile whose 128 rows are
//   an 8 (x) x 16 (y) patch of output cells (store_tile), in the four
//   rounding forms the JAX kernels use;
// * host side: cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint (no -lcuda), for dense bf16 tensors.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace agp {

constexpr int kPatchX = 8, kPatchY = 16;  // output patch of a block
constexpr int kTileM = kPatchX * kPatchY;  // 128 GEMM rows
constexpr int kTileN = 128;                // output channels of a block
constexpr int kSlab = 64;                  // K per TMA box: 128-byte rows
constexpr int kConsumers = 256;            // two warpgroups of 64 rows
constexpr int kSm90Threads = kConsumers + 32;  // and one producer warp
constexpr int kSlabBytes = kTileM * kSlab * 2;  // 16 KB: a 128 x 64 A tile
constexpr int kBoxBytes = 64 * 64 * 2;          // 8 KB: a 64 x 64 B box

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// make the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed; a
// phase that never completes (a fault in the pipeline) traps after about
// 2^26 polls instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// generic-proxy writes to shared memory (st.shared) before an async-proxy
// read of them (wgmma's shared operands)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of `threads` threads (a multiple of 32) under name `id` (1-15)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --------------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], "
      "[%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// 1-D bulk copy of `bytes` (a multiple of 16) contiguous bytes from global
// to shared memory, both 16-byte aligned, counted on barrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------------- wgmma
// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// A operand of K step `kk` (16 columns) of a 128 x 64 K-major tile at
// `tile`, rows [64 wg, 64 wg + 64): 32 bytes further along each swizzled
// 128-byte row
__device__ __forceinline__ uint64_t a_desc(uint32_t tile, int wg, int kk) {
  return sw128_desc(tile + wg * (kSlabBytes / 2) + kk * 32, 16, 1024);
}

// B operand of K step `kk` of 64 K rows x N columns read MN-major (the
// transpose bit) from 64 x 64 boxes of a row-major [K, N] matrix: 16 K rows
// are two 8-row swizzle atoms (2 KB) further; the next 64 columns (the
// leading offset) are the next box, 8 KB on (`next64` bytes for boxes of
// another size)
__device__ __forceinline__ uint64_t b_desc(uint32_t boxes, int kk,
                                           uint32_t next64 = kBoxBytes) {
  return sw128_desc(boxes + kk * 2048, next64, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64 x 128] (+)= A[64 x 16] (K-major, shared) * B[16 x 128] (MN-major,
// shared); scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                    uint64_t db,
                                                    int scale_d = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] (bf16 registers, the m16n8k16 A fragment of
// each warp's 16 rows) * B[16 x 128] (MN-major, shared); scale_d 0
// overwrites D
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t* a,
                                                    uint64_t db,
                                                    int scale_d = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] (K-major, shared) * B[16 x 64] (MN-major,
// shared); scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// keep the compiler from moving or reusing registers an asynchronous MMA
// still reads or writes (its accumulator, its register A operand)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; register i holds matrix i in the m16n8k16
// fragment layout
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// byte offset of 16-byte chunk `chunk` of row `row` in a tile of 128-byte
// rows written with the 128-byte swizzle (the tile 1024-byte aligned)
__device__ __forceinline__ uint32_t sw128_offset(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// -------------------------------------------------------------------- ring
// Stage s of the ring has a `full` barrier (one arrival, the producer's
// expect_tx, plus the TMA bytes) and an `empty` barrier (one arrival per
// consumer warp).  Step k of a block (counted on across its tiles) uses
// stage k % kStages in its (k / kStages)-th round.
template <int kStages>
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty) {
  for (int s = 0; s < kStages; ++s) {
    mbar_init(smem_u32(&full[s]), 1);
    mbar_init(smem_u32(&empty[s]), kConsumers / 32);
  }
}

// the producer thread: steps [k0, k0 + steps), `load(i, s, bar)` issuing
// step k0 + i's TMA loads into stage s against barrier `bar`, `tx` bytes
template <int kStages, class Load>
__device__ __forceinline__ void ring_produce(uint64_t* full, uint64_t* empty,
                                             int k0, int steps, int tx,
                                             Load&& load) {
  for (int i = 0; i < steps; ++i) {
    const int k = k0 + i, s = k % kStages;
    if (k >= kStages)
      mbar_wait(smem_u32(&empty[s]), ((k / kStages) + 1) & 1);
    const uint32_t bar = smem_u32(&full[s]);
    mbar_expect_tx(bar, tx);
    load(i, s, bar);
  }
}

// the consumer warpgroups: `mma(i, s)` issues step k0 + i's MMAs on stage
// s (after its own wgmma_fence); kWait MMA groups stay in flight (1: a
// step's loads overlap the previous step's MMAs; 0 when the MMAs read
// registers, which must not be written while any wgmma is in flight:
// ptxas serializes every wgmma of the kernel otherwise, C7513); `fence()`
// fences the registers the MMAs use.  A stage is released once the MMAs
// that read it have retired.
template <int kStages, int kWait, class Mma, class Fence>
__device__ __forceinline__ void ring_consume(uint64_t* full, uint64_t* empty,
                                             int k0, int steps, int lane,
                                             Mma&& mma, Fence&& fence) {
  for (int i = 0; i < steps; ++i) {
    const int k = k0 + i, s = k % kStages;
    mbar_wait(smem_u32(&full[s]), (k / kStages) & 1);
    mma(i, s);
    wgmma_commit();
    wgmma_wait<kWait>();
    fence();
    if (i >= kWait && lane == 0)
      mbar_arrive(smem_u32(&empty[(k - kWait) % kStages]));
  }
  if (kWait > 0) {
    wgmma_wait<0>();
    fence();
    if (steps > 0 && lane == 0)
      mbar_arrive(smem_u32(&empty[(k0 + steps - 1) % kStages]));
  }
}

// --------------------------------------------------------------- epilogue
enum {
  STORE_BF16_RELU_MASK = 0,  // relu(bf16(bf16(bf16(acc)*s) + b)) * mask
  STORE_BF16_POOL = 1,       // g = bf16(bf16(bf16(acc)*s) + b); pool += g*mask
  STORE_F32_RELU_MASK = 2,   // bf16(relu(acc*s + b) * mask), fp32 affine
  STORE_F32_POOL = 3         // g = bf16(acc*s + b), fp32 affine; pool += g*mask
};

// Where an output tile goes: a [B, X, Y, cout] bf16 map with its occupancy
// mask [B, X, Y, z] (channel n in z-slab n / (cout / z)).
struct TileOut {
  bf16* out;
  const uint8_t* mask;
  int X, Y, cout, z;
};

// Store the m64n128 accumulator tile of a kPY = 16 (8 x 16) or kPY = 8
// (16 x 8) patch at (b, x0, y0), channels [n0, n0 + 128).  Accumulator
// layout of m64nNk16: warp w of the warpgroup holds rows 16 w + lane/4
// (+8), columns 8 j + 2 (lane%4) (+1) in acc[4 j + 2 h + c]; row kPY q + t
// of the tile is patch cell (q, t), so consumer warp `warp` (0-7) owns
// patch row `warp` of an 8 x 16 patch, rows 2 warp and 2 warp + 1 of a
// 16 x 8 one.  s_sc / s_bi are the tile's 128 scales and biases
// (bf16-rounded for the bf16 forms).  kRaggedN: the N tile may run past
// cout (a multiple of 32), and its channels past cout are neither read
// nor written.  The two pool forms also reduce the masked sum of the
// tile's (rounded) channels into pool [B, cout] (one atomic per channel;
// named barrier 1 over the consumers, `red` [8][128] of shared scratch).
template <int EPI, int kPY = kPatchY, bool kRaggedN = false>
__device__ __forceinline__ void store_tile(const float (&acc)[64],
                                           const TileOut& o, int b, int x0,
                                           int y0, int n0, const float* s_sc,
                                           const float* s_bi, int warp,
                                           int lane, float (*red)[kTileN],
                                           float* pool) {
  static_assert(kPY == kPatchY || kPY == kPatchY / 2, "8 x 16 or 16 x 8");
  constexpr bool kPool = EPI == STORE_BF16_POOL || EPI == STORE_F32_POOL;
  const int ox = x0 + warp;
  const int cz = o.cout / o.z;
  size_t m[2];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int cx = kPY == kPatchY ? ox : x0 + 2 * warp + h;
    const int oy = y0 + lane / 4 + (kPY == kPatchY ? 8 * h : 0);
    ok[h] = cx < o.X && oy < o.Y;
    m[h] = ((size_t)b * o.X + (ok[h] ? cx : 0)) * o.Y + (ok[h] ? oy : 0);
  }
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j) {
    const int nl = 8 * j + 2 * (lane & 3);
    const int n = n0 + nl;
    // warp-uniform: cout - n0 is a multiple of 32
    if (kRaggedN && n0 + 8 * j >= o.cout) continue;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!ok[h]) continue;
      const float mk = (float)o.mask[m[h] * o.z + n / cz];
      const float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
      float v0, v1;
      if (EPI == STORE_F32_RELU_MASK) {
        v0 = __fadd_rn(__fmul_rn(a0, s_sc[nl]), s_bi[nl]);
        v1 = __fadd_rn(__fmul_rn(a1, s_sc[nl + 1]), s_bi[nl + 1]);
      } else if (EPI == STORE_F32_POOL) {  // g is a bf16 map
        v0 = rbf(__fadd_rn(__fmul_rn(a0, s_sc[nl]), s_bi[nl]));
        v1 = rbf(__fadd_rn(__fmul_rn(a1, s_sc[nl + 1]), s_bi[nl + 1]));
      } else {
        v0 = rbf(rbf(rbf(a0) * s_sc[nl]) + s_bi[nl]);
        v1 = rbf(rbf(rbf(a1) * s_sc[nl + 1]) + s_bi[nl + 1]);
      }
      __nv_bfloat162 r;
      if (kPool) {
        r.x = __float2bfloat16_rn(v0);
        r.y = __float2bfloat16_rn(v1);
        ps0 += v0 * mk;
        ps1 += v1 * mk;
      } else {
        r.x = __float2bfloat16_rn(fmaxf(v0, 0.0f) * mk);
        r.y = __float2bfloat16_rn(fmaxf(v1, 0.0f) * mk);
      }
      *reinterpret_cast<__nv_bfloat162*>(o.out + m[h] * o.cout + n) = r;
    }
    if (kPool) {
      // lanes with the same lane%4 hold the same channels: reduce over the
      // warp's 16 cells, then over the 8 warps in shared memory
#pragma unroll
      for (int s = 4; s < 32; s <<= 1) {
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, s);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, s);
      }
      if (lane < 4) {
        red[warp][nl] = ps0;
        red[warp][nl + 1] = ps1;
      }
    }
  }
  if (kPool) {
    named_sync(1, kConsumers);
    const int t = warp * 32 + lane;
    if (t < kTileN && (!kRaggedN || n0 + t < o.cout)) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kConsumers / 32; ++w) s += red[w][t];
      atomicAdd(pool + (size_t)b * o.cout + n0 + t, s);
    }
  }
}

// --------------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// tensor map of a dense bf16 tensor of `rank` dims (innermost first), box
// `box`, zero fill outside the tensor; 128-byte swizzle unless `swizzle`
// is false
inline bool encode_bf16(CUtensorMap* map, const void* base, int rank,
                        const cuuint64_t* dims, const cuuint32_t* box,
                        bool swizzle = true) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || rank < 2 || rank > 5) return false;
  cuuint64_t strides[4];
  cuuint64_t s = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = s *= dims[i];
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// opt a kernel into `bytes` of dynamic shared memory and launch it with
// `threads` threads per block
template <class Kernel, class... Args>
cudaError_t launch_sm90(Kernel kernel, int grid, int smem_bytes,
                        cudaStream_t stream, int threads, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem_bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace agp
