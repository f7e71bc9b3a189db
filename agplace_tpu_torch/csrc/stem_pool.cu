// K5: the ResNet stem tail — BN eval affine, relu and maxpool 3x3/2 pad 1.
//
// Replaces the TPU kernel agplace_tpu/ops/pallas/stem_pool.py:
// fused_affine_relu_maxpool (_kernel).  The TPU kernel's batch-pair channel
// fold (to fill 128-lane registers) and its H-blocking with a one-row halo
// (to fit VMEM) are TPU layout tricks and are not carried over.
//
// Arithmetic (stem_pool.py:62-73): scale and bias are rounded to bf16 and
// widened; y = relu(x*s + b) in fp32 with one bf16 round; the window max
// runs on those bf16 values.  x and s are both bf16 values, so their
// product is exact in fp32 (8-bit by 8-bit significands): the multiply and
// the add below, written as two rounded fp32 operations, give the same bits
// as the TPU kernel's fma and as the plain PyTorch version's
// `x.float() * s + b`.  The pad is 1 on every side; padded taps contribute
// 0, which equals the true -inf pad because every real tap is >= 0 after
// the relu.
//
// What bounds it on the H100: bytes.  At b32 it reads the [32,128,128,64]
// bf16 conv output (67 MB) and writes a quarter of it, 0.025 ms at 3.35
// TB/s.  The design moves each input byte from device memory once and does
// the arithmetic once per input element:
//   * a work unit is a band of `band` output rows of one item (and one
//     column tile and channel tile of them, for rows too wide for a ring
//     slot); a persistent grid of two blocks per SM walks the units;
//   * one producer thread streams the band's input rows 2 r0 - 1 ... 2 (r0 +
//     band) - 1 into a ring of kStages row slots in shared memory, each row
//     (of one item, contiguous in x) with one 1-D bulk copy
//     (cp.async.bulk, counted on the slot's full mbarrier; one copy per
//     column when the channels are tiled).  A band reads 2 band + 1 rows:
//     only its top halo row is read twice;
//   * 256 consumer threads own fixed (output column, 8-channel vector)
//     positions of the unit, two each, so each keeps its channels' scale
//     and bias in registers and divides nothing per element.  Per landed
//     row a thread applies the affine + relu + bf16 round once to its two
//     input columns 2 ow and 2 ow + 1, and takes the left tap 2 ow - 1 from
//     its neighbour's odd column through a small exchange buffer (one
//     named barrier per row); the row's horizontal 3/2 max then goes into
//     the vertical max in registers: output row r is the max of the rows
//     2 r - 1, 2 r and 2 r + 1, each odd row serving two output rows;
//   * an output row leaves as coalesced 16-byte stores, one per position.
// Column tiles of a split row carry a one-column left halo, whose affine is
// computed by the position of the tile's first column (once per tile).
//
// The launch geometry (channel tile, column tile, band, units, slot size,
// grid) comes from the wrapper (ops/stem_pool.py: stem_pool_tiling), its
// one source; the host side checks it against the shape and the kernel's
// compiled limits.  The ring's depth and blocks per SM were chosen by
// timing: 4 slots at 2 blocks per SM were the fastest at b32 and 3 % behind
// 2 slots at b128 (PERF.md section 6, PR 8).
#include "sm90.cuh"

namespace {

using namespace agp;

constexpr int kThreads = kConsumers;      // 256 consumer threads (8 warps)
constexpr int kPos = 2;                   // positions per thread and row
constexpr int kRowPos = kThreads * kPos;  // positions of a unit's row
constexpr int kMaxVec = 256;              // 8-channel vectors of a tile
// the largest slot: (2 tw + 1) columns of ct vectors, tw * ct <= kRowPos
constexpr int kMaxSlot = (2 * kRowPos + kMaxVec) * 16;
constexpr int kStages = 4;                // ring slots of one input row
constexpr int kMinBlocks = 2;             // per SM

struct StemParams {
  const bf16* x;       // [B, H, W, C]
  const float* scale;  // [C]
  const float* bias;   // [C]
  bf16* out;           // [B, H/2, W/2, C]
  int B, H, W, C;
  // stem_pool_tiling: 8-channel vectors per channel tile and tiles, output
  // columns per column tile and tiles, output rows per band and bands,
  // units, bytes per ring slot
  int ct, nct, tw, ntw, band, nband, units, slot;
};

// One unit: item b, output rows [r0, r0 + rows), output columns [ow0, ow0 +
// tw), channel vectors [cv0, cv0 + ct); its input rows [i0, i1] and input
// columns [c_lo, c_hi], input column c in slot column c - (2 ow0 - halo)
// (halo: the slot's column 0 holds the left halo, when the rows are split)
struct Unit {
  int b, r0, rows, ow0, tw, cv0, ct, i0, i1, c_lo, c_hi, halo;
};

__device__ __forceinline__ Unit unit_of(const StemParams& p, int u) {
  Unit n;
  const int ctile = u % p.nct;
  u /= p.nct;
  const int wtile = u % p.ntw;
  u /= p.ntw;
  const int band = u % p.nband;
  n.b = u / p.nband;
  const int ho = p.H / 2, wo = p.W / 2, cpp = p.C / 8;
  n.r0 = band * p.band;
  n.rows = min(p.band, ho - n.r0);
  n.ow0 = wtile * p.tw;
  n.tw = min(p.tw, wo - n.ow0);
  n.cv0 = ctile * p.ct;
  n.ct = min(p.ct, cpp - n.cv0);
  n.i0 = n.r0 > 0 ? 2 * n.r0 - 1 : 0;
  n.i1 = 2 * (n.r0 + n.rows) - 1;
  n.halo = p.ntw > 1;
  n.c_lo = n.ow0 > 0 ? 2 * n.ow0 - 1 : 0;
  n.c_hi = 2 * (n.ow0 + n.tw) - 1;
  return n;
}

// relu and round two fp32 values to a bf16x2 word (lo in the low half)
__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint4 max8(uint4 a, uint4 b) {
  return make_uint4(max_bf16x2(a.x, b.x), max_bf16x2(a.y, b.y),
                    max_bf16x2(a.z, b.z), max_bf16x2(a.w, b.w));
}

// bf16(relu(x*s + b)) of 8 channels, the multiply and the add each rounded
__device__ __forceinline__ uint4 affine8(uint4 v, const float (&s)[8],
                                         const float (&b)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float lo = __uint_as_float(w[j] << 16);
    const float hi = __uint_as_float(w[j] & 0xffff0000u);
    o[j] = relu_bf16x2(__fadd_rn(__fmul_rn(lo, s[2 * j]), b[2 * j]),
                       __fadd_rn(__fmul_rn(hi, s[2 * j + 1]), b[2 * j + 1]));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__global__ void __launch_bounds__(kThreads + 32, kMinBlocks)
    stem_pool_kernel(const StemParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ uint4 odd[2][kRowPos];  // the odd columns' values, per row
  const int tid = threadIdx.x;
  if (tid == 0) {
    ring_init<kStages>(full, empty);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kThreads) {
    // ---- producer: one thread streams every unit's input rows
    if (tid != kThreads) return;
    int step = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const Unit n = unit_of(p, u);
      const int ncols = n.c_hi - n.c_lo + 1;
      const int col0 = n.c_lo - (2 * n.ow0 - n.halo);  // slot column
      for (int i = n.i0; i <= n.i1; ++i, ++step) {
        const int s = step % kStages;
        if (step >= kStages)
          mbar_wait(smem_u32(&empty[s]), ((step / kStages) + 1) & 1);
        const uint32_t bar = smem_u32(&full[s]);
        const uint32_t dst = smem_u32(smem) + s * p.slot;
        const bf16* src =
            p.x + (((size_t)n.b * p.H + i) * p.W + n.c_lo) * p.C + n.cv0 * 8;
        mbar_expect_tx(bar, ncols * n.ct * 16);
        if (p.nct == 1) {  // whole pixels: the row tile is contiguous
          bulk_load(dst + col0 * p.ct * 16, src, ncols * n.ct * 16, bar);
        } else {
          for (int c = 0; c < ncols; ++c)
            bulk_load(dst + (col0 + c) * p.ct * 16, src + (size_t)c * p.C,
                      n.ct * 16, bar);
        }
      }
    }
    return;
  }

  // ---- consumers: position q = tid + kThreads k of a unit is output
  // column ow0 + q / ct, channel vector cv0 + q % ct
  const int lane = tid & 31;
  const int ho = p.H / 2, wo = p.W / 2;
  int step = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit n = unit_of(p, u);
    bool live[kPos];
    int col[kPos], vec[kPos];
    float sc[kPos][8], bi[kPos][8];
    uint4 carry[kPos], cur[kPos];
#pragma unroll
    for (int k = 0; k < kPos; ++k) {
      const int q = tid + kThreads * k;
      live[k] = q < n.tw * n.ct;
      col[k] = live[k] ? q / n.ct : 0;
      vec[k] = live[k] ? q - col[k] * n.ct : 0;
      const int c0 = (n.cv0 + vec[k]) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[k][j] = rbf(p.scale[c0 + j]);
        bi[k][j] = rbf(p.bias[c0 + j]);
      }
      carry[k] = cur[k] = make_uint4(0, 0, 0, 0);  // the zero pad
    }
    for (int i = n.i0; i <= n.i1; ++i, ++step) {
      const int s = step % kStages, buf = step & 1;
      mbar_wait(smem_u32(&full[s]), (step / kStages) & 1);
      const unsigned char* slot = smem + s * p.slot;
      uint4 m[kPos], left[kPos];
#pragma unroll
      for (int k = 0; k < kPos; ++k) {
        if (!live[k]) continue;
        const int j = n.halo + 2 * col[k];  // slot column of input 2 ow
        const uint4 ye = affine8(
            *reinterpret_cast<const uint4*>(slot + (j * p.ct + vec[k]) * 16),
            sc[k], bi[k]);
        const uint4 yo = affine8(*reinterpret_cast<const uint4*>(
                                     slot + ((j + 1) * p.ct + vec[k]) * 16),
                                 sc[k], bi[k]);
        m[k] = max8(ye, yo);
        odd[buf][tid + kThreads * k] = yo;
        left[k] = make_uint4(0, 0, 0, 0);  // the pad left of column 0
        if (col[k] == 0 && n.ow0 > 0)      // the split row's halo column
          left[k] = affine8(
              *reinterpret_cast<const uint4*>(slot + vec[k] * 16), sc[k],
              bi[k]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));  // slot read
      named_sync(1, kThreads);  // every odd column of the row is out
#pragma unroll
      for (int k = 0; k < kPos; ++k) {
        if (!live[k]) continue;
        const int q = tid + kThreads * k;
        if (col[k] > 0) left[k] = odd[buf][q - n.ct];
        const uint4 h = max8(m[k], left[k]);  // the row's 3/2 max
        if (i & 1) {
          if (i > 2 * n.r0) {  // output row (i - 1) / 2 is complete
            const int r = (i - 1) / 2;
            *reinterpret_cast<uint4*>(
                p.out + (((size_t)n.b * ho + r) * wo + n.ow0 + col[k]) * p.C +
                (n.cv0 + vec[k]) * 8) = max8(cur[k], h);
          }
          carry[k] = h;  // row 2 r + 1 is row 2 (r + 1) - 1 of the next
        } else {
          cur[k] = max8(carry[k], h);
        }
      }
    }
  }
}

}  // namespace

// The geometry arguments are the fields of the wrapper's StemPoolTiling in
// order (ct, nct, tw, ntw, band, nband, units, slot, grid).
extern "C" int agp_stem_pool(const bf16* x, const float* scale,
                             const float* bias, bf16* out, int B, int H,
                             int W, int C, int ct, int nct, int tw, int ntw,
                             int band, int nband, int units, int slot,
                             int grid, void* stream) {
  const int cpp = C / 8, ho = H / 2, wo = W / 2;
  // the tiling must cover the map and fit the compiled kernel
  if (B < 1 || H % 2 || W % 2 || C % 8 || H < 2 || W < 2 || ct < 1 ||
      ct > kMaxVec || nct != (cpp + ct - 1) / ct ||
      ct != (cpp + nct - 1) / nct || tw < 1 ||
      tw * ct > kRowPos || ntw != (wo + tw - 1) / tw || band < 1 ||
      nband != (ho + band - 1) / band ||
      units != B * nband * ntw * nct ||
      slot != (2 * tw + (ntw > 1)) * ct * 16 || slot > kMaxSlot ||
      grid < 1 || grid > units)
    return cudaErrorInvalidValue;
  const StemParams p = {x,  scale, bias, out,  B,     H,     W,    C,
                        ct, nct,   tw,   ntw,  band,  nband, units, slot};
  return launch_sm90(stem_pool_kernel, grid, kStages * slot,
                     static_cast<cudaStream_t>(stream), kThreads + 32, p);
}
