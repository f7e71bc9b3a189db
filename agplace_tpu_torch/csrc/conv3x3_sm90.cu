// K3's two 3x3 conv phases for Hopper: TMA loads into a 128-byte-swizzled
// shared-memory ring and wgmma from shared memory, warp-specialised.
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
//     (scripts/ablate_torch_conv3x3.py, which builds this file with the
//     AGP_CONV3X3_* switches below);
//   * the epilogue works from the accumulator registers with the JAX
//     rounding points: bf16(acc), a bf16 multiply by bf16(scale), a bf16 add
//     of bf16(bias), then relu * mask or the fp32 masked pool.
// The launch geometry (tensor-map dims and boxes, patch grid, K steps, grid)
// comes from the wrapper (ops/bev_block_sm.py: conv3x3_tiling), its one
// source; the host side here only checks that the boxes are the tiles this
// kernel is compiled for.  The tensor maps are encoded per call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no -lcuda),
// and passed as __grid_constant__ kernel parameters.
#include <cuda.h>

#include "common.cuh"

// Ablation switches, 0 / the shipped values unless set with -D: the ring's
// depth, blocks per SM, and parts of the work taken out (bit 1: the x box,
// 2: the weight boxes, 4: the MMAs; results are then wrong on purpose)
#ifndef AGP_CONV3X3_STAGES
#define AGP_CONV3X3_STAGES 3
#endif
#ifndef AGP_CONV3X3_MIN_BLOCKS
#define AGP_CONV3X3_MIN_BLOCKS 2
#endif
#ifndef AGP_CONV3X3_SKIP
#define AGP_CONV3X3_SKIP 0
#endif

namespace {

using agp::bf16;
using agp::rbf;

constexpr int kPX = 8, kPY = 16;  // output patch: x rows, y cells per row
constexpr int kBM = kPX * kPY;    // 128 GEMM rows
constexpr int kBN = 128;          // output channels per block
constexpr int kBK = 64;           // input channels per step: 128-byte rows
constexpr int kConsumers = 256;   // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kABytes = kBM * kBK * 2;
constexpr int kBBytes = kBN * kBK * 2;
constexpr int kStageBytes = kABytes + kBBytes;  // 32 KB

constexpr int kStages = AGP_CONV3X3_STAGES;  // per block
constexpr int kMinBlocks = AGP_CONV3X3_MIN_BLOCKS;  // per SM
constexpr int kSkip = AGP_CONV3X3_SKIP;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + 1 KB alignment
constexpr int kTxBytes = (kSkip & 1 ? 0 : kABytes) + (kSkip & 2 ? 0 : kBBytes);

struct Conv3x3Params {
  const uint8_t* mask;  // [B, X, Y, z]
  const float* scale;   // BN eval affine [cout]
  const float* bias;
  bf16* out;            // [B, X, Y, cout]
  float* pool;          // EPI 1: [B, cout] fp32 masked sums (+=)
  int X, Y, cin, cout, z;
  int npx, npy, ntn, steps;  // patch grid, N tiles, K steps
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// D[64 x 128] += A[64 x 16] (K-major, shared) * B[16 x 128] (MN-major,
// shared: the transpose bit)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
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
      : "l"(da), "l"(db), "r"(1));
}

// keep the compiler from moving accumulator registers across the async MMAs
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int EPI>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
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
  const int x0 = xp * kPX, y0 = yp * kPY, n0 = nt * kBN;

  if (tid < kBN) {
    s_sc[tid] = rbf(p.scale[n0 + tid]);
    s_bi[tid] = rbf(p.bias[n0 + tid]);
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: one thread keeps the ring full
    if (tid == kConsumers) {
      for (int k = 0; k < p.steps; ++k) {
        const int s = k % kStages;
        if (k >= kStages)
          mbar_wait(smem_u32(&empty[s]), ((k / kStages) + 1) & 1);
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, kTxBytes);
        // K step k is (tap, 64-channel slab); conv3x3_coords in the
        // wrapper replays these coordinates on the CPU
        const int k0 = k * kBK;
        const int tap = k0 / p.cin, c0 = k0 - tap * p.cin;
        const int dx = tap / 3, dy = tap - 3 * dx;
        const uint32_t sa = ring + s * kStageBytes, sb = sa + kABytes;
        if (!(kSkip & 1))
          tma_load_4d(sa, &tmap_x, bar, c0, y0 + dy - 1, x0 + dx - 1, b);
        // w [9*cin, cout]: two 64 x 64 boxes of 64 output channels each
        if (!(kSkip & 2)) {
          tma_load_2d(sb, &tmap_w, bar, n0, k0);
          tma_load_2d(sb + kBBytes / 2, &tmap_w, bar, n0 + 64, k0);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns GEMM rows [64 wg, 64 wg + 64)
  const int wg = tid / 128, warp = tid / 32, lane = tid & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int k = 0; k < p.steps; ++k) {
    const int s = k % kStages;
    mbar_wait(smem_u32(&full[s]), (k / kStages) & 1);
    const uint32_t sa = ring + s * kStageBytes + wg * (kABytes / 2);
    const uint32_t sb = ring + s * kStageBytes + kABytes;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A: 16 columns = 32 bytes further along each swizzled 128-byte row
      const uint64_t da = sw128_desc(sa + kk * 32, 16, 1024);
      // B, MN-major: 16 K rows = two 8-row swizzle atoms (2 KB) further;
      // the second 64-channel box (the leading offset) is 8 KB on
      const uint64_t db = sw128_desc(sb + kk * 2048, kBBytes / 2, 1024);
      if (!(kSkip & 4)) wgmma_m64n128k16(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
    // the previous step's MMAs are done: its stage may be refilled
    if (k > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(k - 1) % kStages]));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);

  // ---- epilogue.  Accumulator layout of m64nNk16: warp w of the warpgroup
  // holds rows 16 w + lane/4 (+8), columns 8 j + 2 (lane%4) (+1) in
  // acc[4 j + 2 h + c].  Row 16 q + t of the block is patch cell (q, t), so
  // each warp owns one x row of the patch.
  const int ox = x0 + warp;  // warps 0-7 <-> patch rows 0-7
  const int cz = p.cout / p.z;
  size_t m[2];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int oy = y0 + lane / 4 + 8 * h;
    ok[h] = ox < p.X && oy < p.Y;
    m[h] = ((size_t)b * p.X + (ok[h] ? ox : 0)) * p.Y + (ok[h] ? oy : 0);
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int nl = 8 * j + 2 * (lane & 3);
    const int n = n0 + nl;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!ok[h]) continue;
      const float mk = (float)p.mask[m[h] * p.z + n / cz];
      const float v0 = rbf(rbf(rbf(acc[4 * j + 2 * h]) * s_sc[nl]) + s_bi[nl]);
      const float v1 =
          rbf(rbf(rbf(acc[4 * j + 2 * h + 1]) * s_sc[nl + 1]) + s_bi[nl + 1]);
      __nv_bfloat162 o;
      if (EPI == 0) {
        o.x = __float2bfloat16_rn(fmaxf(v0, 0.0f) * mk);
        o.y = __float2bfloat16_rn(fmaxf(v1, 0.0f) * mk);
      } else {
        o.x = __float2bfloat16_rn(v0);
        o.y = __float2bfloat16_rn(v1);
        ps0 += v0 * mk;
        ps1 += v1 * mk;
      }
      *reinterpret_cast<__nv_bfloat162*>(p.out + m[h] * p.cout + n) = o;
    }
    if (EPI == 1) {
      // lanes with the same lane%4 hold the same channels: reduce over the
      // warp's 16 cells, then over the 8 warps in shared memory
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, o);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, o);
      }
      if (lane < 4) {
        red[warp][nl] = ps0;
        red[warp][nl + 1] = ps1;
      }
    }
  }
  if (EPI == 1) {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (tid < kBN) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kConsumers / 32; ++w) s += red[w][tid];
      atomicAdd(p.pool + (size_t)b * p.cout + n0 + tid, s);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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

// bf16 tensor map, 128-byte swizzle, zero fill outside the tensor
bool encode(CUtensorMap* map, const void* base, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int EPI>
int launch(const bf16* x, const bf16* w, const cuuint64_t (&xd)[4],
           const cuuint32_t (&xb)[4], const cuuint64_t (&wd)[2],
           const cuuint32_t (&wb)[2], int grid, const Conv3x3Params& p,
           cudaStream_t stream) {
  // the boxes must be the tiles the kernel is compiled for
  if (xb[0] != kBK || xb[1] != kPY || xb[2] != kPX || xb[3] != 1 ||
      wb[0] != kBN / 2 || wb[1] != kBK)
    return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  // x [B, X, Y, cin] and w [9*cin, cout], dense rows of bf16
  const cuuint64_t xs[3] = {xd[0] * 2, xd[1] * xd[0] * 2,
                            xd[2] * xd[1] * xd[0] * 2};
  if (!encode(&tx, x, 4, xd, xs, xb)) return cudaErrorInvalidValue;
  const cuuint64_t ws[1] = {wd[0] * 2};
  if (!encode(&tw, w, 2, wd, ws, wb)) return cudaErrorInvalidValue;
  auto kernel = conv3x3_sm90_kernel<EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(tx, tw, p);
  return cudaGetLastError();
}

}  // namespace

// One conv phase: EPI 0 (pool null) or EPI 1.  The geometry arguments are
// the fields of the wrapper's Conv3x3Tiling in order: x dims (Zcin, Y, X, B)
// and box, w dims (Zcout, 9*Zcin) and box, innermost first, then the patch
// grid, the K steps and the number of blocks.
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
  return epi == 0 ? launch<0>(x, w, xd, xb, wd, wb, grid, p, s)
                  : launch<1>(x, w, xd, xb, wd, wb, grid, p, s);
}
