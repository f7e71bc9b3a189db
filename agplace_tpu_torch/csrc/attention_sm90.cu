// The attention core of CCT's bf16 encoder, y = softmax(q k^T d^-1/2) v for
// every batch row and head, in one pass that keeps the scores on chip.
//
// It replaces no TPU kernel: the JAX package's attention
// (agplace_tpu/models/cct.py:102-106) is plain einsum / softmax left to
// XLA, which the port ran as the same explicit chain.  On the H100 that
// chain writes each layer's [B, h, N, N] bf16 scores to HBM, scales them
// and writes them again, softmaxes them and writes them again, then reads
// them into AV, with permute copies of q, k and v around the einsums: 25x
// the core's bound at CCT-14's 576 tokens.
//
// What bounds it on the H100: both.  At b128, 6 heads of 64 and N = 576 a
// layer is 65.2 GFLOP of products (0.066 ms at 989 TFLOP/s) against q, k,
// v read and the output written once, 226 MB (0.068 ms at 3.35 TB/s); and
// at d = 64 the softmax's 255 M exponentials take the SFUs (16 a clock an
// SM) as long as the products take the tensor cores.  So the design keeps
// tensor cores, SFUs and the ALUs busy at once and reads HBM once:
//   * q, k and v come straight from the qkv Dense's output [B, N, 3, H, 64]
//     by TMA: one 5-D tensor map (64, H, 3, N, B), innermost first, whose
//     box (64, 1, 1, 64, 1) is 64 rows of one head, each row 128 bytes,
//     the 128-byte swizzle wgmma reads.  N is a dimension of its own, so
//     TMA zero-fills rows past N and never reads the next image's rows;
//   * a work item is 192 query rows of one (batch row, head), three
//     consumer warpgroups of 64 rows each; the items of one head are
//     adjacent, so their K and V come from HBM about once and from L2 for
//     the other two.  A persistent grid of one block per SM walks the
//     items; one producer warp keeps a ring of kStages KV blocks of 64
//     keys full (K and V on barriers of their own, so S starts before V
//     lands) and double-buffers each warpgroup's Q tile, the ring running
//     on across items so the next item's loads overlap this one's tail;
//   * per KV block a warpgroup computes S = Q K^T with SS wgmma m64n64k16
//     (four k16 steps over d, K read K-major), the online softmax in
//     registers, and O += P V with RS wgmma m64n64k16 (P's bf16 registers
//     as A: the accumulator's layout is the A fragment's; V read MN-major
//     through the descriptor's transpose bit).  The steps are pipelined:
//     step j issues S_j and AV of step j - 1 together, and its softmax
//     runs as soon as S_j retires, while AV still does.  A register a
//     wgmma in flight reads or writes is never written meanwhile (step j's
//     P stays in fp32 in S_j's accumulator until AV of j - 1 retires): a
//     wgmma register written in flight makes ptxas serialise every wgmma
//     of the kernel.  The three warpgroups interleave freely: one's
//     softmax runs on the ALUs and SFUs while another's products run on
//     the tensor cores.  Forcing them to take turns at the tensor cores
//     (named barriers, as FlashAttention-3 pairs two warpgroups) measured
//     slower, and without the pipelining 16 % slower (PERF.md);
//   * the output [B, N, H, 64] (the [B, N, 384] proj reads) is written once
//     from registers, rows past N not at all.
// Rounding points, those of the eager bf16 chain where it has them: each
// score is its fp32 sum over d rounded once to bf16 (the bf16 einsum's
// output); times 1/8, exact; the softmax in fp32, online (a running max and
// sum per row), exp2 with log2(e) folded into the scale, keys >= N at -inf
// before the max; the unnormalised probabilities rounded to bf16 as AV's
// operand; AV summed in fp32 and scaled by the row sum's reciprocal, each
// rounded to fp32 (__frcp_rn, __fmul_rn: within an ulp of fp32 division);
// the output rounded to bf16.  ex2.approx.ftz is the SFU instruction exp2f
// compiles to, without exp2f's rescaling of results below 2^-126, which a
// row sum of at least 1 cannot see.
//
// The launch geometry (work items, KV steps, grid) comes from the wrapper
// (ops/attention.py: attention_tiling), its one source; the host side here
// checks it against N.
#include "sm90.cuh"

namespace {

using namespace agp;

constexpr int kD = 64;                       // head size: one swizzle row
constexpr int kWGs = 3;                      // consumer warpgroups
constexpr int kQRows = 64 * kWGs;            // query rows a work item
constexpr int kKV = 64;                      // keys a KV block
constexpr int kStages = 6;                   // KV blocks in flight
constexpr int kConsumerThreads = 128 * kWGs;
constexpr int kThreads = kConsumerThreads + 32;  // and one producer warp
constexpr int kTile = 64 * kD * 2;               // 8 KB: 64 rows of a head
constexpr int kQBytes = 2 * kWGs * kTile;        // Q, double-buffered
constexpr int kSmemBytes = kQBytes + kStages * 2 * kTile + 1024;
// d^-1/2 log2(e): exp(x / 8) = exp2(x * kScaleLog2)
constexpr float kScaleLog2 = 0.125f * 1.4426950408889634f;

struct AttnParams {
  bf16* out;  // [B, N, H, 64]
  int N, H, q_tiles, kv_steps, items;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D[64 x 64] (+)= A[64 x 16] (K-major, shared) * B[16 x 64] (K-major,
// shared: the rows of K); scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_m64n64k16_ss_kk(float (&d)[32],
                                                      uint64_t da,
                                                      uint64_t db,
                                                      int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] (bf16 registers, the m16n8k16 A fragment of
// each warp's 16 rows) * B[16 x 64] (MN-major, shared: 16 rows of V);
// scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t* a,
                                                   uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// item -> (batch row b, head h, query tile qt), the query tiles of a head
// adjacent; attention_tiling replays this on the CPU
__device__ __forceinline__ void item_coords(const AttnParams& p, int item,
                                            int& b, int& h, int& qt) {
  qt = item % p.q_tiles;
  const int bh = item / p.q_tiles;
  h = bh % p.H;
  b = bh / p.H;
}

__global__ void __launch_bounds__(kThreads, 1)
    attention_kernel(const __grid_constant__ CUtensorMap tmap,
                     const AttnParams p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(8) uint64_t qfull[2][kWGs], qempty[2][kWGs];
  __shared__ __align__(8) uint64_t kfull[kStages], vfull[kStages],
      empty[kStages];
  // Q buffers [2][kWGs] of 8 KB, then the ring: stage s holds K at
  // ring + 16 KB s and V 8 KB further
  const uint32_t qbase = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t ring = qbase + kQBytes;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i)
      for (int w = 0; w < kWGs; ++w) {
        mbar_init(smem_u32(&qfull[i][w]), 1);
        mbar_init(smem_u32(&qempty[i][w]), 4);  // the warpgroup's warps
      }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&kfull[s]), 1);
      mbar_init(smem_u32(&vfull[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumerThreads / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // ---- producer warp: one thread issues every load.  Q use u of buffer
    // i (items i, i + 2, ...) waits for the warpgroup's release of use
    // u - 1; KV step k (counted on across items) uses stage k % kStages
    // in round k / kStages and waits for the release of the round before
    if (tid == kConsumerThreads) {
      int k = 0, it = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++it) {
        int b, h, qt;
        item_coords(p, item, b, h, qt);
        const int qb = it & 1;
        for (int w = 0; w < kWGs; ++w) {
          if (it >= 2)
            mbar_wait(smem_u32(&qempty[qb][w]), ((it >> 1) + 1) & 1);
          const uint32_t bar = smem_u32(&qfull[qb][w]);
          mbar_expect_tx(bar, kTile);
          tma_load_5d(qbase + (qb * kWGs + w) * kTile, &tmap, bar, 0, h, 0,
                      qt * kQRows + 64 * w, b);
        }
        for (int j = 0; j < p.kv_steps; ++j, ++k) {
          const int s = k % kStages;
          if (k >= kStages)
            mbar_wait(smem_u32(&empty[s]), ((k / kStages) + 1) & 1);
          const uint32_t dst = ring + s * 2 * kTile;
          const uint32_t kb = smem_u32(&kfull[s]), vb = smem_u32(&vfull[s]);
          mbar_expect_tx(kb, kTile);
          tma_load_5d(dst, &tmap, kb, 0, h, 1, j * kKV, b);
          mbar_expect_tx(vb, kTile);
          tma_load_5d(dst + kTile, &tmap, vb, 0, h, 2, j * kKV, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of an
  // item.  Accumulator layout of m64nNk16: warp w holds rows 16 w + lane/4
  // (+8 for h = 1), columns 8 j + 2 (lane % 4) (+1) in acc[4 j + 2 h + c]
  const int wg = tid / 128, warp = (tid / 32) & 3, lane = tid & 31;
  const int t4 = lane & 3, g = lane >> 2;
  const float kNegInf = __int_as_float(0xff800000u);
  float sc[32], o[32];
  uint32_t pp[16];  // P of the step before, AV's A operand
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
  // per row h2: the running max of the bf16 scores (unscaled), that max
  // times kScaleLog2, and this thread's share of the running sum
  float m[2] = {kNegInf, kNegInf}, mc[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  // the k16 steps' descriptors of S = Q K^T with K at stage s_s (K-major
  // A and B: 32 bytes further along each swizzled 128-byte row a step) and
  // of O += P V with V at stage s_v (V's 64 keys are K rows, 16 of them two
  // 8-row swizzle atoms, 2 KB, further a step)
  uint64_t dq[4], dk[4], dv[4];
  auto descs = [&](uint32_t qtile, int s_s, int s_v) {
    const uint32_t kt = ring + s_s * 2 * kTile;
    const uint32_t vt = ring + s_v * 2 * kTile + kTile;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      dq[kk] = sw128_desc(qtile + kk * 32, 16, 1024);
      dk[kk] = sw128_desc(kt + kk * 32, 16, 1024);
      dv[kk] = b_desc(vt, kk);
    }
  };
  auto issue_s = [&] {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_m64n64k16_ss_kk(sc, dq[kk], dk[kk], kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&] {
#pragma unroll
    for (int kk = 0; kk < kKV / 16; ++kk)
      wgmma_m64n64k16_rs(o, &pp[4 * kk], dv[kk], 1);
    wgmma_commit();
  };
  // the online softmax of block j's scores in sc, in place: the bf16
  // scores, keys >= N at -inf, the rows' new maxima over the quad of lanes
  // that shares them, then P = exp2(x log2(e) / 8 - max) in fp32, summed
  // into l after the earlier sum is scaled by `alpha`, the factor O
  // scales by too
  auto softmax = [&](int j, float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const __nv_bfloat162 r = __floats2bfloat162_rn(sc[2 * i],
                                                     sc[2 * i + 1]);
      sc[2 * i] = __low2float(r);
      sc[2 * i + 1] = __high2float(r);
    }
    const int key0 = j * kKV;
    if (key0 + kKV > p.N) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (key0 + 8 * jj + 2 * t4 + c >= p.N)
            sc[4 * jj + c] = sc[4 * jj + 2 + c] = kNegInf;
    }
    float mn[2] = {m[0], m[1]};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        mn[h2] = fmaxf(mn[h2], fmaxf(sc[4 * jj + 2 * h2],
                                     sc[4 * jj + 2 * h2 + 1]));
    float mcn[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      mn[h2] = fmaxf(mn[h2], __shfl_xor_sync(0xffffffffu, mn[h2], 1));
      mn[h2] = fmaxf(mn[h2], __shfl_xor_sync(0xffffffffu, mn[h2], 2));
      mcn[h2] = mn[h2] * kScaleLog2;
      alpha[h2] = ex2(mc[h2] - mcn[h2]);  // 0 at the first block
      m[h2] = mn[h2];
      mc[h2] = mcn[h2];
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& v = sc[4 * jj + 2 * h2 + c];
          v = ex2(fmaf(v, kScaleLog2, -mcn[h2]));
          rs[h2] += v;
        }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) l[h2] = l[h2] * alpha[h2] + rs[h2];
  };
  // P rounded to bf16 as AV's A fragment: register 2 jj + h2 holds row
  // h2's columns 8 jj + 2 t4 (+1), so k16 step kk is registers [4 kk,
  // 4 kk + 4): the accumulator's pairs in order
  auto pack_p = [&] {
#pragma unroll
    for (int i = 0; i < 16; ++i) pp[i] = pack_bf16x2(sc[2 * i], sc[2 * i + 1]);
  };

  // Per item, the steps are pipelined: step j issues S_j and then AV of
  // step j - 1, computes step j's softmax as soon as S_j has retired (AV
  // of j - 1 still running), then waits for AV, releases the stage of
  // j - 1, rescales O and rounds step j's P into AV's operand.  A
  // product's registers are untouched while it is in flight: S_j's
  // accumulator until its wait, AV's O and P until the next (step j's P
  // stays in fp32 in S_j's accumulator until then).
  int k = 0, it = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++it) {
    int b, h, qt;
    item_coords(p, item, b, h, qt);
    const int qb = it & 1;
    const uint32_t qtile = qbase + (qb * kWGs + wg) * kTile;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      m[h2] = mc[h2] = kNegInf;
      l[h2] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    mbar_wait(smem_u32(&qfull[qb][wg]), (it >> 1) & 1);
    int s = k % kStages, par = (k / kStages) & 1;
    mbar_wait(smem_u32(&kfull[s]), par);
    descs(qtile, s, s);
    wgmma_fence();
    issue_s();
    wgmma_wait<0>();
    fence_regs(sc);
    if (p.kv_steps == 1 && lane == 0)
      mbar_arrive(smem_u32(&qempty[qb][wg]));  // Q read for the last time
    {
      float alpha[2];
      softmax(0, alpha);  // O is 0: nothing to rescale
      pack_p();
    }
    for (int j = 1; j < p.kv_steps; ++j) {
      const int sp = s, parp = par;  // step j - 1's stage
      ++k;
      s = k % kStages;
      par = (k / kStages) & 1;
      mbar_wait(smem_u32(&kfull[s]), par);
      mbar_wait(smem_u32(&vfull[sp]), parp);
      descs(qtile, s, sp);
      fence_regs(pp);
      fence_regs(o);
      wgmma_fence();
      issue_s();
      issue_pv();
      wgmma_wait<1>();
      fence_regs(sc);
      if (j == p.kv_steps - 1 && lane == 0)
        mbar_arrive(smem_u32(&qempty[qb][wg]));
      float alpha[2];
      softmax(j, alpha);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pp);
      if (lane == 0) mbar_arrive(smem_u32(&empty[sp]));  // K and V read
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          o[4 * jj + 2 * h2] *= alpha[h2];
          o[4 * jj + 2 * h2 + 1] *= alpha[h2];
        }
      pack_p();
    }
    // AV of the last step
    mbar_wait(smem_u32(&vfull[s]), par);
    descs(qtile, s, s);
    fence_regs(pp);
    fence_regs(o);
    wgmma_fence();
    issue_pv();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pp);
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
    ++k;
    // the row sums over the quad, then O times 1 / l rounded to bf16; rows
    // >= N are not stored
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
      l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
    }
    const int row0 = qt * kQRows + 64 * wg + 16 * warp + g;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = row0 + 8 * h2;
      if (row >= p.N) continue;
      bf16* dst = p.out + (((size_t)b * p.N + row) * p.H + h) * kD + 2 * t4;
      const float r = __frcp_rn(l[h2]);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<uint32_t*>(dst + 8 * jj) =
            pack_bf16x2(__fmul_rn(o[4 * jj + 2 * h2], r),
                        __fmul_rn(o[4 * jj + 2 * h2 + 1], r));
    }
  }
}

}  // namespace

// qkv [B, N, 3, H, 64] bf16, dense and 16-byte aligned; out [B, N, H, 64]
// bf16.  The geometry arguments are the fields of the wrapper's
// AttentionTiling in order: query tiles a head, KV steps, work items,
// blocks.
extern "C" int agp_attention(const bf16* qkv, bf16* out, int B, int N, int H,
                             int q_tiles, int kv_steps, int items, int grid,
                             void* stream) {
  if (B < 1 || N < 1 || H < 1 || q_tiles != (N + kQRows - 1) / kQRows ||
      kv_steps != (N + kKV - 1) / kKV || items != B * H * q_tiles ||
      grid < 1 || grid > items)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[5] = {(cuuint64_t)kD, (cuuint64_t)H, 3,
                              (cuuint64_t)N, (cuuint64_t)B};
  const cuuint32_t box[5] = {kD, 1, 1, 64, 1};
  CUtensorMap tm;
  if (!encode_bf16(&tm, qkv, 5, dims, box)) return cudaErrorInvalidValue;
  const AttnParams p = {out, N, H, q_tiles, kv_steps, items};
  return launch_sm90(attention_kernel, grid, kSmemBytes,
                     static_cast<cudaStream_t>(stream), kThreads, tm, p);
}
