// K1's grid instance: the fused fixed-step Euler chain of the FCODE block
// at 512 < D <= 2176, with W resident across the shared memory of the
// whole grid.
//
// Replaces, at those widths, the TPU kernel agplace_tpu/ops/pallas/
// ode_step.py:fused_euler_ode, which keeps x and W whole in VMEM.
// Computes n_steps Euler steps x <- x + dt * act(x W + b), x [B, D] fp32,
// W [D, D] fp32 ([in, out]), D a multiple of 128 (the wrapper pads x, W
// and b with zeros, as for ode_step.cu's instance).  The update keeps the
// reference's two roundings (no fma).
//
// What bounds it on the H100.  W in fp32 is 16 MiB at D = 2048: more than
// a cluster's shared memory, less than the card's (132 SMs x 227 KB).
// ode_wide.cu's clusters read all of W from L2 on every step, once per
// cluster: ~1.3 GB of L2 traffic at B = 32, D = 2048.  Here W is read from
// HBM once per launch, and a step moves only the state:
//   * a persistent grid of kBlocks = 128 blocks, one per SM, all
//     co-resident: the wrapper checks first that the card holds every
//     block at once (agp_ode_grid_resident), and the launch is cooperative,
//     which CUDA refuses for a grid the card cannot hold, so no launch
//     waits on a block that never runs.  Hardware clusters of 4 would
//     hold only 30 x 4 blocks at this shared memory (the card's GPCs), so
//     the blocks form groups of kGroup = 4 in software;
//   * group g owns W's column band [band g, band (g + 1)), band = D / 32;
//     block q of it the band's k-slice [kslice q, kslice (q + 1)), kslice
//     = D / 4.  Its W tile [kslice, band] (128 KB at D = 2048) and b's
//     are loaded once, every 16-byte copy in flight at once;
//   * every step, each block computes its partial sums x[:, slice] W[slice,
//     band] for every row, in row tiles of up to 32 rows: the tile's x
//     slice (64 KB at D = 2048) is copied into shared memory with
//     cp.async (a block reads a quarter of the state: the first design,
//     a whole column slice a block, re-read all of x from L2 every step,
//     32 MB at B = 32, and was bound by it); a thread owns a 4 x 4
//     micro-tile (rows r, r + rt/4, ..; 4 consecutive columns) and a
//     1/ks share of the slice's k range, 16 fp32 FMAs per pair of 16-byte
//     shared loads; the ks shares are added in a fixed order into the
//     block's partial tile [rt, band] in global memory (L2; two buffers);
//   * a barrier of the group's 4 blocks, then block q finishes the band's
//     columns [band/4 q, band/4 (q + 1)): the 4 partial tiles added in a
//     fixed order, the bias, the activation and the update, and the new
//     state written;
//   * the state lives in two global buffers (out and a scratch buffer,
//     alternating so that the last step writes out); a step's values reach
//     the next step through L2: one grid-wide barrier per step.  Both
//     barriers are arrival counters (bar.sync, a release add by one
//     thread, an acquire poll, bar.sync); every read of another block's
//     writes bypasses L1 (cp.async.cg, ld.global.cg).
// Capacity: W's tile and the x slice of 32 rows fit a block's 227 KB up to
// D = 2176.  The launch geometry comes from the wrapper (ops/ode_step.py:
// ode_tiling), its one source; the host side checks it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;      // k-slices of a column band
constexpr int kBlocks = 128;   // 32 groups
constexpr int kMaxRowGroups = 8;  // a row tile: up to 4 x 8 rows
constexpr int kXPad = 4;          // floats after each x row in shared memory
constexpr int kSmemLimit = 227 * 1024;

struct GridParams {
  const float* x;
  const float* w;
  const float* b;
  float* out;
  float* scratch;   // the other state buffer [B, D]
  float* part;      // the partial tiles [2][kBlocks][rt * band]
  unsigned* count;  // arrivals: the grid's, then each group's; zero at launch
  int batch, n_steps;
  float dt;
  int dim, band, kslice, rg;
};

// micro-tiles of a row tile and threads per micro-tile (the k split)
__host__ __device__ inline int micro_tiles(int band, int rg) {
  return band / 4 * rg;
}
__host__ __device__ inline int k_split(int band, int rg) {
  return kThreads / micro_tiles(band, rg);
}

// W's tile, b's finishing columns, the x slice (then the k split's
// shares)
inline int smem_bytes(int band, int kslice, int rg) {
  const int xs = 4 * rg * (kslice + kXPad);
  const int red = k_split(band, rg) * micro_tiles(band, rg) * 16;
  return (kslice * band + (band / kGroup + 3) / 4 * 4 +
          (xs > red ? xs : red)) *
         (int)sizeof(float);
}

// 16-byte global->shared copy (L2 only: the state another block wrote),
// zero-filled when !in (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int ACT>
__device__ __forceinline__ float act_fn(float v) {
  if (ACT == 0) return fmaxf(v, 0.0f);     // relu
  if (ACT == 1) return tanhf(v);           // tanh
  if (ACT == 2) return agp::sigmoidf_(v);  // sigmoid
  return v;                                // id
}

// every block of a set (the grid, or a group) has arrived at `count`:
// `target` arrivals in all.  The blocks' writes before it are visible to
// their reads after it.  A wait that never ends (a block that never ran)
// traps after about 2^26 polls.
__device__ __forceinline__ void arrive_wait(unsigned* count,
                                           unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count)
                 : "memory");
    unsigned v = 0;
    for (uint32_t polls = 0;; ++polls) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(count)
                   : "memory");
      if (v >= target) break;
      if (polls == (1u << 26)) __trap();
    }
  }
  __syncthreads();
}

template <int ACT>
__global__ void __launch_bounds__(kThreads, 1)
    ode_grid_kernel(GridParams p) {
  extern __shared__ __align__(16) float sh[];
  const int dim = p.dim, band = p.band, ksl = p.kslice, tid = threadIdx.x;
  const int grp = blockIdx.x / kGroup, q = blockIdx.x % kGroup;
  const int fc = band / kGroup;  // the columns this block finishes
  const int c0 = grp * band;     // the band's first column
  const int k0 = q * ksl;        // the slice's first row
  const int rg = p.rg, rt = 4 * rg, xstride = ksl + kXPad;
  float* ws = sh;                        // [ksl][band]
  float* bs = ws + ksl * band;           // [fc], padded to 4 floats
  float* xs = bs + (fc + 3) / 4 * 4;     // [rt][xstride], then the shares
  // W's tile and b's finishing columns, once per launch: every 16-byte
  // copy issued before any is waited for
  const int bq = band / 4;
  for (int i = tid; i < ksl * bq; i += kThreads) {
    const int k = i / bq, c = i - k * bq;
    cp_async16(ws + 4 * i, p.w + (size_t)(k0 + k) * dim + c0 + 4 * c, true);
  }
  cp_async_all();
  for (int i = tid; i < fc; i += kThreads) bs[i] = p.b[c0 + q * fc + i];
  if (p.n_steps == 0) {
    for (int i = tid; i < p.batch * fc; i += kThreads) {
      const int r = i / fc;
      const size_t at = (size_t)r * dim + c0 + q * fc + i - r * fc;
      p.out[at] = p.x[at];
    }
    return;
  }
  __syncthreads();

  const int mtn = micro_tiles(band, rg), ks = k_split(band, rg);
  const int mt = tid % mtn, s = tid / mtn;
  const bool on = s < ks;
  const int gi = mt / bq, cgi = mt - gi * bq;  // row group, column group
  const int xq = ksl / 4;                     // float4s of an x row
  const int tile = rt * band;                 // floats of a partial tile
  unsigned* group_count = p.count + 1 + grp;
  int pass = 0;  // row tiles done: the group's barriers so far
  for (int step = 0; step < p.n_steps; ++step) {
    // step s reads the state step s - 1 wrote and writes the other buffer;
    // the last step writes out
    const float* src = step == 0 ? p.x
                       : (p.n_steps - step) % 2 == 0 ? p.out
                                                     : p.scratch;
    float* dst = (p.n_steps - 1 - step) % 2 == 0 ? p.out : p.scratch;
    for (int r0 = 0; r0 < p.batch; r0 += rt) {
      // the row tile's x slice (rows past the batch: zeros)
      for (int i = tid; i < rt * xq; i += kThreads) {
        const int r = i / xq, c = i - r * xq;
        const bool in = r0 + r < p.batch;
        cp_async16(xs + r * xstride + 4 * c,
                   src + (size_t)(in ? r0 + r : 0) * dim + k0 + 4 * c, in);
      }
      cp_async_all();
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
      if (on) {
        const float* xb = xs + gi * xstride;
        const float* wb = ws + 4 * cgi;
        for (int k4 = s; k4 < xq; k4 += ks) {
          float4 xv[4], wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            xv[i] = *reinterpret_cast<const float4*>(xb + i * rg * xstride +
                                                     4 * k4);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wv[kk] = *reinterpret_cast<const float4*>(
                wb + (4 * k4 + kk) * band);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float xk[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              acc[i][0] = fmaf(xk[kk], wv[kk].x, acc[i][0]);
              acc[i][1] = fmaf(xk[kk], wv[kk].y, acc[i][1]);
              acc[i][2] = fmaf(xk[kk], wv[kk].z, acc[i][2]);
              acc[i][3] = fmaf(xk[kk], wv[kk].w, acc[i][3]);
            }
          }
        }
      }
      __syncthreads();  // every read of the x slice is done
      // the k split's shares, added in a fixed order into the partial tile
      float* red = xs;
      if (on) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            red[(s * mtn + mt) * 16 + 4 * i + c] = acc[i][c];
      }
      __syncthreads();
      // this row tile's partial tiles: buffer pass % 2 (a block writes
      // buffer b again only after the group's next barrier, which every
      // peer reaches after reading it)
      float* mine =
          p.part + ((size_t)(pass % 2) * kBlocks + blockIdx.x) * tile;
      for (int o = tid; o < tile; o += kThreads) {
        // row r is micro-tile row r / rg of row group r % rg
        const int r = o / band, j = o - r * band;
        const int m = (r % rg) * bq + j / 4, e = 4 * (r / rg) + j % 4;
        float sum = 0.0f;
        for (int t = 0; t < ks; ++t) sum += red[(t * mtn + m) * 16 + e];
        mine[o] = sum;
      }
      // every block of the group has written its partial tile
      arrive_wait(group_count, (unsigned)(++pass) * kGroup);
      const float* peers =
          p.part + ((size_t)((pass - 1) % 2) * kBlocks + grp * kGroup) * tile;
      for (int o = tid; o < rt * fc; o += kThreads) {
        const int r = o / fc, j = o - r * fc;
        if (r0 + r >= p.batch) continue;
        const float* pp = peers + r * band + q * fc + j;
        float sum = 0.0f;
#pragma unroll
        for (int t = 0; t < kGroup; ++t) sum += __ldcg(pp + (size_t)t * tile);
        const float f = act_fn<ACT>(sum + bs[j]);
        const size_t at = (size_t)(r0 + r) * dim + c0 + q * fc + j;
        // x + dt*f with two roundings, as the reference (no FMA)
        dst[at] = __fadd_rn(__ldcg(src + at), __fmul_rn(p.dt, f));
      }
      __syncthreads();  // the shares' space is the next row tile's x slice
    }
    if (step + 1 < p.n_steps)
      arrive_wait(p.count, (unsigned)(step + 1) * gridDim.x);
  }
}

// opt the kernel into its shared memory at these widths
template <int ACT>
cudaError_t opt_in(int band, int kslice, int rg) {
  return cudaFuncSetAttribute(ode_grid_kernel<ACT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes(band, kslice, rg));
}

// the blocks of the grid the card holds at once (its SMs times the blocks
// an SM holds at this shared memory), or -(the CUDA error)
int max_blocks(int band, int kslice, int rg) {
  const int smem = smem_bytes(band, kslice, rg);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = opt_in<0>(band, kslice, rg);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ode_grid_kernel<0>, kThreads, smem);
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}

template <int ACT>
cudaError_t launch(const GridParams& p, cudaStream_t stream) {
  cudaError_t err = opt_in<ACT>(p.band, p.kslice, p.rg);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(
      p.count, 0, (1 + kBlocks / kGroup) * sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kBlocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(p.band, p.kslice, p.rg);
  cfg.stream = stream;
  // CUDA refuses a cooperative grid the card cannot hold at once
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ode_grid_kernel<ACT>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The geometry arguments are the fields of the wrapper's OdeGridTiling in
// order: the width (x, W and b padded to it), W's columns per group, W's
// rows per block, the blocks, row groups of a row tile (rt = 4 rg rows).
// scratch: fp32, [B, dim] (the other state), [2][blocks][4 rg * band]
// (the partial tiles), then 1 + blocks / 4 4-byte counters.
extern "C" int agp_ode_grid(const float* x, const float* w, const float* b,
                            float* out, float* scratch, int batch,
                            int n_steps, float dt, int act, int dim,
                            int band, int kslice, int grid, int rg,
                            void* stream) {
  const int row_groups = (batch + 3) / 4;
  if (dim % 128 != 0 || dim < 128 || grid != kBlocks ||
      band * (kBlocks / kGroup) != dim || kslice * kGroup != dim ||
      batch < 1 ||
      rg != (row_groups < kMaxRowGroups ? row_groups : kMaxRowGroups) ||
      n_steps < 0 || micro_tiles(band, rg) > kThreads ||
      smem_bytes(band, kslice, rg) > kSmemLimit)
    return cudaErrorInvalidValue;
  GridParams p;
  p.x = x, p.w = w, p.b = b, p.out = out, p.scratch = scratch;
  p.part = scratch + (size_t)batch * dim;
  p.count = reinterpret_cast<unsigned*>(p.part +
                                        (size_t)2 * kBlocks * 4 * rg * band);
  p.batch = batch, p.n_steps = n_steps, p.dt = dt;
  p.dim = dim, p.band = band, p.kslice = kslice, p.rg = rg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case 0:
      return launch<0>(p, s);
    case 1:
      return launch<1>(p, s);
    case 2:
      return launch<2>(p, s);
    default:
      return launch<3>(p, s);
  }
}

// The blocks of the grid the card holds at once at these widths (the
// fields of OdeGridTiling but the width and the blocks), or minus the CUDA
// error: the wrapper raises unless it is at least the grid.  Returns a
// count, not an error code.
extern "C" int agp_ode_grid_resident(int band, int kslice, int rg) {
  return max_blocks(band, kslice, rg);
}
