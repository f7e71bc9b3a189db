// K1: fused fixed-step Euler chain of the FCODE block.
//
// Replaces the TPU kernel agplace_tpu/ops/pallas/ode_step.py:fused_euler_ode
// (_ode_kernel, forward only; the custom-VJP backward is a later port).
// Computes n_steps Euler steps x <- x + dt * act(x W + b) for x [B, D] fp32,
// W [D, D] fp32 ([in, out] layout), b [D], D a multiple of 128 up to 512
// (the wrapper pads any other stg2fuse_dim with zero columns of x and b
// and zero rows and columns of W, which leave the real columns' sums
// exact; 256 at every preset).  Wider D runs ode_grid.cu (up to 2560) or
// ode_wide.cu.
//
// What bounds it on the H100: latency, not bytes or FLOPs.  At the slice
// shape (B = 32, 10 steps) the chain is 42 MFLOP and 0.3 MB, under a
// microsecond of work at the card's rates, but the steps are dependent.
// The TPU design keeps W resident in VMEM; W in fp32 is 256 KB, more than
// the 227 KB of shared memory one block may hold, so here W is resident
// across the shared memory of a thread-block cluster instead:
//   * a cluster of kCluster blocks owns a tile of kRows rows of x; block r
//     of the cluster holds W's column slice [:, kCols r, kCols (r + 1))
//     (32 KB at kCluster = 8) and b's slice, loaded once per launch with
//     16-byte loads, all in flight together;
//   * each block keeps the tile's whole state [kRows, D] in two shared
//     buffers; kSplit threads share an output (row, column), each summing
//     a kDim / kSplit slice of k with four partial sums, and a butterfly of
//     shuffles adds the slices (every lane gets the same bits); the update
//     x + dt * act(.) keeps the reference's two roundings (no fma).  The k
//     slices of W lie kDim / kSplit rows apart, padded so that a warp's
//     loads hit 32 distinct banks;
//   * the new value goes into the *next* buffer of every block of the
//     cluster through distributed shared memory, as asynchronous stores
//     (st.async, the kSplit lanes of an output sharing the peers) that
//     each count their bytes on the receiving block's mbarrier of that
//     buffer, and the step ends when this block's next buffer has all its
//     bytes: no cluster-wide barrier per step (plain remote stores and one
//     cluster barrier per step measured slower: PERF.md).  With two
//     buffers no block can overwrite a state another block still reads;
//   * at the end each block writes its column slice of its rows.
// W's column slices take up to 128 KB a block at D = 512; past that a
// portable cluster of 8 blocks cannot hold W, and ode_grid.cu holds it
// across the shared memory of the whole card.
// Rows are independent, so kRows is small enough that b32 already spreads
// over several clusters.  The cluster size, kRows and kSplit were chosen by
// timing every fitting choice of clusters of 2-16 blocks, 4-16 rows and 1,
// 2 or 4 threads per output (PERF.md section 6, PR 7).
// fp32 FMA throughout; the activation is a template parameter.  The launch
// geometry comes from the wrapper (ops/ode_step.py: ode_tiling), its one
// source; the host side here only checks it against the compiled
// constants.
#include <cooperative_groups.h>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using agp::mbar_expect_tx;
using agp::mbar_init;
using agp::mbar_wait;
using agp::smem_u32;

constexpr int kCluster = 8;  // blocks per cluster
constexpr int kRows = 4;     // rows of x per cluster
constexpr int kSplit = 2;    // threads per output
constexpr int kLaneCols = 32 / kSplit;  // a warp: kLaneCols x kSplit lanes
// D steps: every instance's D is a multiple of kDimStep, up to kMaxDim
constexpr int kDimStep = 128, kMaxDim = 512;

// The geometry of the instance at width DIM
template <int DIM>
struct Ode {
  static constexpr int kDim = DIM;
  static constexpr int kCols = kDim / kCluster;  // W's columns of a block
  static constexpr int kThreads = kCols * kRows * kSplit;
  static constexpr int kSeg = kDim / kSplit;     // k rows of a lane's slice
  // W's slice in shared memory: kSplit segments of [kSeg][kCols], each
  // kPad floats after the last, so that lane (column c, slice s) reads
  // bank (c + kPad s) mod 32: distinct over a warp
  static constexpr int kPad = kSplit > 1 ? kLaneCols : 0;
  static constexpr int kSegStride = kSeg * kCols + kPad;
  static constexpr int kWFloats = kSplit * kSegStride;
  // W's slice, b's slice, the states [2][kRows][kDim]
  static constexpr int kSmemBytes =
      (kWFloats + kCols + 2 * kRows * kDim) * (int)sizeof(float);
  // whether the cluster / row tile / split fit the block's limits at this
  // width
  static constexpr bool kValid =
      kDim % kCluster == 0 && kCols % kLaneCols == 0 && 32 % kSplit == 0 &&
      kThreads <= 1024 && kSeg % 4 == 0 && kSmemBytes <= 227 * 1024;
};

template <int ACT>
__device__ __forceinline__ float act_fn(float v) {
  if (ACT == 0) return fmaxf(v, 0.0f);          // relu
  if (ACT == 1) return tanhf(v);                // tanh
  if (ACT == 2) return agp::sigmoidf_(v);       // sigmoid
  return v;                                     // id
}

// the shared::cluster address of shared::cta address `addr` in block `rank`
// of the cluster
__device__ __forceinline__ uint32_t map_cluster(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// store v at shared::cluster address `addr`, counted as 4 bytes on the
// mbarrier at shared::cluster address `bar` (of the same block)
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

template <int ACT, int DIM>
__global__ void __launch_bounds__(Ode<DIM>::kThreads)
ode_euler_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ out,
                 int batch, int n_steps, float dt) {
  using O = Ode<DIM>;
  static_assert(O::kValid, "cluster / row tile / split off the block's "
                           "limits");
  constexpr int kDim = O::kDim, kCols = O::kCols, kThreads = O::kThreads;
  constexpr int kSeg = O::kSeg, kSegStride = O::kSegStride;
  extern __shared__ __align__(16) float sh[];
  // per state buffer: one arrival (this block's expect_tx) and the bytes
  // the cluster's blocks store into it
  __shared__ __align__(8) uint64_t full[2];
  float* ws = sh;                          // kSplit x [kSeg][kCols], padded
  float* bs = ws + O::kWFloats;            // [kCols]
  float* state = bs + kCols;               // [2][kRows][kDim]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int r0 = (blockIdx.x / kCluster) * kRows;
  const int rows = min(kRows, batch - r0);
  const int c0 = rank * kCols;
  const int tid = threadIdx.x;
  // W's slice and the tile's rows as 16-byte loads, all of a thread's
  // issued before any is stored: one round trip to L2, not one per load
  constexpr int kW4 = kDim * kCols / 4;  // float4s of the slice
  constexpr int kW4PerThread = (kW4 + kThreads - 1) / kThreads;
  float4 wv[kW4PerThread];
#pragma unroll
  for (int u = 0; u < kW4PerThread; ++u) {
    const int i = tid + u * kThreads, k = i / (kCols / 4);
    if (i < kW4)
      wv[u] = reinterpret_cast<const float4*>(w + (size_t)k * kDim + c0)
          [i - k * (kCols / 4)];
  }
  constexpr int kX4 = kRows * kDim / 4;  // float4s of the state
  constexpr int kX4PerThread = (kX4 + kThreads - 1) / kThreads;
  float4 xin[kX4PerThread];
#pragma unroll
  for (int u = 0; u < kX4PerThread; ++u) {
    const int i = tid + u * kThreads, r = i / (kDim / 4);
    xin[u] = i < kX4 && r < rows
                 ? reinterpret_cast<const float4*>(x + (size_t)(r0 + r) *
                                                           kDim)[i - r * (kDim / 4)]
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int u = 0; u < kW4PerThread; ++u) {
    const int i = tid + u * kThreads, k = i / (kCols / 4);
    if (i < kW4)
      *reinterpret_cast<float4*>(ws + (k / kSeg) * kSegStride +
                                 (k % kSeg) * kCols +
                                 4 * (i - k * (kCols / 4))) = wv[u];
  }
#pragma unroll
  for (int u = 0; u < kX4PerThread; ++u)
    if (tid + u * kThreads < kX4)
      reinterpret_cast<float4*>(state)[tid + u * kThreads] = xin[u];
  if (tid < kCols) bs[tid] = b[c0 + tid];
  if (tid == 0) {
    mbar_init(smem_u32(&full[0]), 1);
    mbar_init(smem_u32(&full[1]), 1);
    agp::mbar_init_fence();
  }
  // every block of the cluster is running (its shared memory and barriers
  // may be written) and its own loads are done
  cluster.sync();

  // warp w, lane l: slice s = l / kLaneCols of output (row r, column jl)
  const int warp = tid / 32, lane = tid & 31;
  const int s = lane / kLaneCols;
  const int jl = (warp % (kCols / kLaneCols)) * kLaneCols + lane % kLaneCols;
  const int r = warp / (kCols / kLaneCols), j = c0 + jl;
  const float bj = bs[jl];
  // W[s kSeg + k][j] in the block's slice
  constexpr int kWStride = kCols;
  const float* wsl = ws + s * kSegStride + jl;
  // this output in the state of the blocks q = s, s + kSplit, ... of the
  // cluster (the slices' lanes share the stores)
  constexpr int kPeers = (kCluster + kSplit - 1) / kSplit;
  uint32_t peer_x[kPeers], peer_bar[kPeers];
#pragma unroll
  for (int p = 0; p < kPeers; ++p) {
    const int q = (s + p * kSplit) % kCluster;
    peer_x[p] = map_cluster(smem_u32(state + r * kDim + j), q);
    peer_bar[p] = map_cluster(smem_u32(&full[0]), q);
  }
  int cur = 0;
  for (int step = 0; step < n_steps; ++step) {
    const float* xr = state + cur * kRows * kDim + r * kDim;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
    for (int k = 0; k < kSeg; k += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + s * kSeg + k);
      acc[0] = fmaf(xv.x, wsl[(k + 0) * kWStride], acc[0]);
      acc[1] = fmaf(xv.y, wsl[(k + 1) * kWStride], acc[1]);
      acc[2] = fmaf(xv.z, wsl[(k + 2) * kWStride], acc[2]);
      acc[3] = fmaf(xv.w, wsl[(k + 3) * kWStride], acc[3]);
    }
    float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
    for (int o = kLaneCols; o < 32; o <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float f = act_fn<ACT>(sum + bj);
    // x + dt*f with two roundings, as the reference (no FMA)
    const float v = __fadd_rn(xr[j], __fmul_rn(dt, f));
    const int nb = cur ^ 1;
    // the next buffer of every block, each store counted on that block's
    // barrier of the buffer; then wait until this block's next buffer
    // holds all kRows x D values (its (step / 2)-th fill).  A block can
    // only write a peer's buffer nb for step + 2 once every block has
    // sent its step + 1 values, so once every block has read buffer nb
    if (tid == 0)
      mbar_expect_tx(smem_u32(&full[nb]), kRows * kDim * (int)sizeof(float));
#pragma unroll
    for (int p = 0; p < kPeers; ++p)
      if (s + p * kSplit < kCluster)
        st_async(peer_x[p] + nb * kRows * kDim * (int)sizeof(float), v,
                 peer_bar[p] + nb * (int)sizeof(uint64_t));
    mbar_wait(smem_u32(&full[nb]), (step / 2) & 1);
    cur = nb;
  }
  if (s == 0 && r < rows)
    out[(size_t)(r0 + r) * kDim + j] = state[cur * kRows * kDim + r * kDim + j];
  // no block leaves while a peer's stores to it may be in flight
  cluster.sync();
}

template <int ACT, int DIM>
cudaError_t launch(const float* x, const float* w, const float* b, float* out,
                   int batch, int n_steps, float dt, int grid,
                   cudaStream_t stream) {
  using O = Ode<DIM>;
  auto kernel = ode_euler_kernel<ACT, DIM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, O::kSmemBytes);
  if (err == cudaSuccess && kCluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(O::kThreads);
  cfg.dynamicSmemBytes = O::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, w, b, out, batch, n_steps, dt);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instance at width `dim` (a multiple of kDimStep up to kMaxDim)
template <int ACT, int DIM = kDimStep>
cudaError_t launch_dim(int dim, const float* x, const float* w,
                       const float* b, float* out, int batch, int n_steps,
                       float dt, int grid, cudaStream_t stream) {
  if constexpr (DIM > kMaxDim) {
    return cudaErrorInvalidValue;
  } else {
    if (dim != DIM)
      return launch_dim<ACT, DIM + kDimStep>(dim, x, w, b, out, batch,
                                             n_steps, dt, grid, stream);
    return launch<ACT, DIM>(x, w, b, out, batch, n_steps, dt, grid, stream);
  }
}

}  // namespace

// The geometry arguments are the fields of the wrapper's OdeTiling in order:
// the instance's width (x, W and b padded to it) and whether W is resident
// (always, here), rows per cluster, blocks per cluster, row tiles, blocks.
extern "C" int agp_ode_euler(const float* x, const float* w, const float* b,
                             float* out, int batch, int n_steps, float dt,
                             int act, int dim, int resident, int rows,
                             int cluster, int tiles, int grid,
                             void* stream) {
  if (dim < kDimStep || dim > kMaxDim || dim % kDimStep != 0 ||
      resident != 1 || rows != kRows ||
      cluster != kCluster || batch < 1 ||
      tiles != (batch + kRows - 1) / kRows || grid != tiles * kCluster ||
      n_steps < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case 0:
      return launch_dim<0>(dim, x, w, b, out, batch, n_steps, dt, grid, s);
    case 1:
      return launch_dim<1>(dim, x, w, b, out, batch, n_steps, dt, grid, s);
    case 2:
      return launch_dim<2>(dim, x, w, b, out, batch, n_steps, dt, grid, s);
    default:
      return launch_dim<3>(dim, x, w, b, out, batch, n_steps, dt, grid, s);
  }
}
