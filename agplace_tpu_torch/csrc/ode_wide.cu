// K1's wide instance: the fused fixed-step Euler chain of the FCODE block
// above D = 2560, where W no longer fits the card's shared memory (below,
// ode_grid.cu holds it there).
//
// Replaces, at those widths, the TPU kernel agplace_tpu/ops/pallas/
// ode_step.py:fused_euler_ode, which keeps x and W whole in VMEM at any D.
// Computes n_steps Euler steps x <- x + dt * act(x W + b), x [B, D] fp32,
// W [D, D] ([in, out]), D a multiple of 128 (the wrapper pads x, W and b
// with zeros, as for ode_step.cu's instances).
//
// ode_step.cu's instances take D as a template parameter and give each
// output (row, column) of a block's tile to kSplit = 2 threads, so a block
// has D threads: 1024 at most.  Here D is a runtime width and a block of
// 1024 threads walks its outputs:
//   * a cluster of kCluster = 8 blocks owns kRows rows of x; block r of the
//     cluster computes W's columns [D/8 r, D/8 (r + 1)) of them.  kRows is
//     4, 2 or 1, the most for which the tile's two states [2][kRows][D] fit
//     a block's shared memory (up to D = 27136 at one row);
//   * a warp takes an item of 16 columns of one row, its two half-warps a
//     half of the k range each (the 16 lanes reading 16 consecutive floats
//     of two W rows per k step, W's column slice streamed from L2 every
//     step), four partial sums, then
//     one shuffle adds the halves; the 32 warps walk the block's
//     kRows * D/128 items;
//   * the new value goes to the next state buffer of every block of the
//     cluster by st.async, counted on that block's mbarrier of the buffer,
//     and a step ends when this block's next buffer holds all kRows x D
//     values: ode_step.cu's exchange.
// What bounds it on the H100: the steps are dependent, and each reads the
// whole of W (16 MB at D = 2048) from L2 per cluster: L2 bandwidth, not
// HBM, at B = 32.  The update x + dt * act(.) keeps the reference's two
// roundings (no fma).  The launch geometry comes from the wrapper
// (ops/ode_step.py: ode_tiling).
#include <cooperative_groups.h>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using agp::mbar_expect_tx;
using agp::mbar_init;
using agp::mbar_wait;
using agp::smem_u32;

constexpr int kCluster = 8;
constexpr int kThreads = 1024;
constexpr int kItemCols = 16;  // columns of a warp's item
constexpr int kDimStep = 128, kMinDim = 1024 + kDimStep;
// the dynamic shared memory a block may take, 1 KB left for the barriers
constexpr int kSmemLimit = 226 * 1024;

// the shared memory of a block: b's slice and the two states
inline int smem_bytes(int dim, int rows) {
  return (dim / kCluster + 2 * rows * dim) * (int)sizeof(float);
}

// rows per cluster at width dim: 4, 2 or 1, the most that fit (0: none)
inline int wide_rows(int dim) {
  for (int rows = 4; rows >= 1; rows /= 2)
    if (smem_bytes(dim, rows) <= kSmemLimit) return rows;
  return 0;
}

template <int ACT>
__device__ __forceinline__ float act_fn(float v) {
  if (ACT == 0) return fmaxf(v, 0.0f);     // relu
  if (ACT == 1) return tanhf(v);           // tanh
  if (ACT == 2) return agp::sigmoidf_(v);  // sigmoid
  return v;                                // id
}

__device__ __forceinline__ uint32_t map_cluster(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

template <int ACT>
__global__ void __launch_bounds__(kThreads)
    ode_wide_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ out,
                    int batch, int n_steps, float dt, int dim, int rows) {
  extern __shared__ __align__(16) float sh[];
  __shared__ __align__(8) uint64_t full[2];
  const int cols = dim / kCluster;  // a multiple of 16
  float* bs = sh;                   // [cols]
  float* state = bs + cols;         // [2][rows][dim]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int r0 = (blockIdx.x / kCluster) * rows;
  const int nrows = min(rows, batch - r0);
  const int c0 = rank * cols;
  const int tid = threadIdx.x;
  const int d4 = dim / 4;
  for (int i = tid; i < rows * d4; i += kThreads) {
    const int r = i / d4;
    reinterpret_cast<float4*>(state)[i] =
        r < nrows ? reinterpret_cast<const float4*>(x)[(size_t)(r0 + r) * d4 +
                                                       i - r * d4]
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int i = tid; i < cols; i += kThreads) bs[i] = b[c0 + i];
  if (tid == 0) {
    mbar_init(smem_u32(&full[0]), 1);
    mbar_init(smem_u32(&full[1]), 1);
    agp::mbar_init_fence();
  }
  cluster.sync();

  const int warp = tid / 32, lane = tid & 31;
  const int s = lane / kItemCols, lc = lane % kItemCols;  // k half, column
  const int seg = dim / 2;
  const int groups = cols / kItemCols, items = rows * groups;
  const int state_bytes = rows * dim * (int)sizeof(float);
  int cur = 0;
  for (int step = 0; step < n_steps; ++step) {
    const int nb = cur ^ 1;
    if (tid == 0) mbar_expect_tx(smem_u32(&full[nb]), state_bytes);
    for (int item = warp; item < items; item += kThreads / 32) {
      const int r = item / groups;
      const int jl = (item - r * groups) * kItemCols + lc, j = c0 + jl;
      const float* xr = state + cur * rows * dim + r * dim;
      const float* wsl = w + (size_t)s * seg * dim + j;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int k = 0; k < seg; k += 4) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xr + s * seg + k);
        acc[0] = fmaf(xv.x, wsl[(size_t)(k + 0) * dim], acc[0]);
        acc[1] = fmaf(xv.y, wsl[(size_t)(k + 1) * dim], acc[1]);
        acc[2] = fmaf(xv.z, wsl[(size_t)(k + 2) * dim], acc[2]);
        acc[3] = fmaf(xv.w, wsl[(size_t)(k + 3) * dim], acc[3]);
      }
      float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      sum += __shfl_xor_sync(0xffffffffu, sum, kItemCols);
      const float f = act_fn<ACT>(sum + bs[jl]);
      // x + dt*f with two roundings, as the reference (no FMA)
      const float v = __fadd_rn(xr[j], __fmul_rn(dt, f));
      // the halves share the stores to the cluster's blocks q = s, s + 2,
      // ...: each counted on block q's barrier of buffer nb
      const uint32_t dst =
          smem_u32(state + nb * rows * dim + r * dim + j);
      const uint32_t bar = smem_u32(&full[nb]);
#pragma unroll
      for (int q = s; q < kCluster; q += 2)
        st_async(map_cluster(dst, q), v, map_cluster(bar, q));
    }
    mbar_wait(smem_u32(&full[nb]), (step / 2) & 1);
    cur = nb;
  }
  for (int i = tid; i < nrows * cols; i += kThreads) {
    const int r = i / cols, jl = i - r * cols;
    out[(size_t)(r0 + r) * dim + c0 + jl] =
        state[cur * rows * dim + r * dim + c0 + jl];
  }
  // no block leaves while a peer's stores to it may be in flight
  cluster.sync();
}

template <int ACT>
cudaError_t launch(const float* x, const float* w, const float* b,
                   float* out, int batch, int n_steps, float dt, int dim,
                   int rows, int grid, cudaStream_t stream) {
  auto kernel = ode_wide_kernel<ACT>;
  const int smem = smem_bytes(dim, rows);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, w, b, out, batch, n_steps, dt,
                           dim, rows);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The geometry arguments are the fields of the wrapper's OdeTiling in order
// (the wide instance's): the width (x, W and b padded to it), 0 (W is never
// resident), rows per cluster, blocks per cluster, row tiles, blocks.
extern "C" int agp_ode_wide(const float* x, const float* w, const float* b,
                            float* out, int batch, int n_steps, float dt,
                            int act, int dim, int resident, int rows,
                            int cluster, int tiles, int grid, void* stream) {
  if (dim < kMinDim || dim % kDimStep != 0 || resident != 0 ||
      rows != wide_rows(dim) || rows == 0 || cluster != kCluster ||
      batch < 1 || tiles != (batch + rows - 1) / rows ||
      grid != tiles * kCluster || n_steps < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case 0:
      return launch<0>(x, w, b, out, batch, n_steps, dt, dim, rows, grid, s);
    case 1:
      return launch<1>(x, w, b, out, batch, n_steps, dt, dim, rows, grid, s);
    case 2:
      return launch<2>(x, w, b, out, batch, n_steps, dt, dim, rows, grid, s);
    default:
      return launch<3>(x, w, b, out, batch, n_steps, dt, dim, rows, grid, s);
  }
}
