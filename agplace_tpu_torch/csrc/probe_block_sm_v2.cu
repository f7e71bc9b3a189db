// P1: the two 3x3 conv phases of the eval ECA block as im2col-concat GEMMs
// over a halo'd input patch held in shared memory.
//
// Replaces the TPU probe kernel scripts/probe_block_sm_v2.py:fused_v2
// (_block_kernel, whose pallas_call is at :178), an alternative formulation
// of K3 (bev_block_sm.cu).  The TPU kernel writes its batch tile into a
// halo-padded VMEM scratch (pad_ref) and forms each group of `chunk` taps
// as a concatenation of shifted windows of it: one MXU dot per group over
// chunk*Zcin channels, the groups summed in fp32 and rounded to bf16 once.
// The card's form of that:
//   * a block owns an output patch of one batch item, kPX = 8 rows (x) of
//     kPY = 16 cells (y) = 128 GEMM rows, and kBN = 64 output channels;
//   * for each K slab of kBKC = 32 input channels it stages the halo'd patch
//     (10 x 18 cells, zero outside the map) in shared memory once, and forms
//     every tap from shifted views of that tile: with the patch 16 wide a
//     16-row wmma fragment is one output row, and tap (dx, dy) is the
//     pointer offset (dx*18 + dy)*kLDA.  kLDA = 48 is a multiple of 16
//     elements, so every such pointer stays 32-byte aligned, and is padded
//     past the slab's 32 channels against bank conflicts;
//   * CHUNK (1, 3 or 9, a template parameter) is the number of taps whose
//     weights [CHUNK*kBKC, kBN] one shared-memory stage holds: the TPU
//     kernel's groups.  A slab takes 9/CHUNK stages; the halo tile is
//     loaded with its first.  Every tap accumulates into the same fp32
//     registers and the sum is rounded to bf16 once, in the epilogue.
// The K slab is cut over channels, not taps: the TPU's concatenated tile at
// chunk 9 and Zcin 512 (9*512 bf16 per row) would not fit a block.  Stages
// are double-buffered with cp.async: step t+1's weights (and at a slab
// boundary its halo tile) load while step t feeds the tensor cores.  Each
// input element is read once per slab and N tile, where the wmma implicit
// GEMM of conv_igemm.cuh (not used here) gathers it once per tap, nine
// times.
//
//   phase 1 (EPI 0): h = relu(bf16(bf16(bf16(acc)*s1) + b1)) * mask
//   phase 2 (EPI 1): g = bf16(bf16(bf16(acc)*s2) + b2); pool[b, c] += the
//                    masked sum of g (a block's cells belong to one item:
//                    one atomic per channel per block)
// The ECA phase and the combine are K3's (eca.cuh, agp_block_eca and
// agp_block_combine_* in bev_block_sm.cu): their math is identical.
//
// What bounds it on the H100: tensor-core work (block0 at b32: 2 x 38.7
// GFLOP over a 33.5 MB map); the halo tile cuts the bytes each block moves
// per MMA.  The shared memory per block grows with CHUNK (43,776 / 62,208 /
// 117,504 bytes at 1 / 3 / 9): at 9 it allows one block per SM, below it
// the registers (about 100 a thread) allow two.
#include "conv_igemm.cuh"

namespace {

using agp::bf16;
using agp::rbf;

constexpr int kPX = 8, kPY = 16;                 // output patch (x, y)
constexpr int kHX = kPX + 2, kHY = kPY + 2;      // halo'd patch
constexpr int kBM = kPX * kPY, kBN = 64, kBKC = 32, kNT = 256;
constexpr int kLDA = kBKC + 16, kLDB = kBN + 8, kLDC = kBN + 4;
constexpr int kHaloElems = kHX * kHY * kLDA;     // bf16 per halo buffer

template <int CHUNK>
constexpr int smem_bytes() {
  constexpr int ring = (2 * kHaloElems + 2 * CHUNK * kBKC * kLDB) * 2;
  return ring > kBM * kLDC * 4 ? ring : kBM * kLDC * 4;  // C reuses it
}

struct HaloConvParams {
  const bf16* x;         // input map [B, X, Y, cin]
  const bf16* w;         // [3, 3, cin, cout] = row-major [9*cin, cout]
  bf16* out;             // [B, X, Y, cout]
  const float* scale;    // BN eval affine [cout]
  const float* bias;
  const uint8_t* mask;   // [B, X, Y, z]
  float* pool;           // EPI 1: [B, cout] fp32 masked sums (+=)
  int B, X, Y, cin, cout, z;
};

template <int CHUNK, int EPI>
__global__ void __launch_bounds__(kNT) halo_conv3x3_kernel(HaloConvParams p) {
  using namespace nvcuda;
  constexpr int G = 9 / CHUNK;  // stages per slab
  constexpr int kWElems = CHUNK * kBKC * kLDB;  // bf16 per weight stage
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[kNT / 32][kBN];
  bf16* halo = reinterpret_cast<bf16*>(smem);  // [2][kHX*kHY][kLDA]
  bf16* wbuf = halo + 2 * kHaloElems;          // [2][CHUNK*kBKC][kLDB]
  float* Cs = reinterpret_cast<float*>(smem);  // after the K loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nxp = (p.X + kPX - 1) / kPX, nyp = (p.Y + kPY - 1) / kPY;
  const int yp = blockIdx.x % nyp;
  const int xp = (blockIdx.x / nyp) % nxp;
  const int b = blockIdx.x / (nyp * nxp);
  const int x0 = xp * kPX, y0 = yp * kPY, n0 = blockIdx.y * kBN;
  const int T = (p.cin / kBKC) * G;

  // stage t: the weights of taps [j*CHUNK, (j+1)*CHUNK) of slab s, and at
  // j == 0 the slab's halo tile
  auto issue = [&](int t) {
    const int s = t / G, j = t - s * G;
    const int ci0 = s * kBKC;
    if (j == 0) {
      bf16* hb = halo + (s & 1) * kHaloElems;
      for (int c = tid; c < kHX * kHY * (kBKC / 8); c += kNT) {
        const int cell = c / (kBKC / 8), kc = (c % (kBKC / 8)) * 8;
        const int hx = cell / kHY, hy = cell - hx * kHY;
        const int ix = x0 - 1 + hx, iy = y0 - 1 + hy;
        const bool ok = ix >= 0 && ix < p.X && iy >= 0 && iy < p.Y;
        agp::cp_async16(
            hb + cell * kLDA + kc,
            ok ? p.x + (((size_t)b * p.X + ix) * p.Y + iy) * p.cin + ci0 + kc
               : p.x,
            ok);
      }
    }
    bf16* wb = wbuf + (t & 1) * kWElems;
    for (int c = tid; c < CHUNK * kBKC * (kBN / 8); c += kNT) {
      const int r = c / (kBN / 8), nc = (c % (kBN / 8)) * 8;
      const int ti = r / kBKC;
      const int k = (j * CHUNK + ti) * p.cin + ci0 + (r - ti * kBKC);
      const bool ok = n0 + nc < p.cout;
      agp::cp_async16(wb + r * kLDB + nc,
                      ok ? p.w + (size_t)k * p.cout + n0 + nc : p.w, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  // 4 x 2 warps of 32 x 32: warp row wm owns patch rows 2*wm, 2*wm + 1
  const int wm = warp >> 1, wn = warp & 1;

  issue(0);
  agp::cp_async_commit();
  for (int t = 0; t < T; ++t) {
    agp::cp_async_wait<0>();
    __syncthreads();  // stage t landed; every warp is done with stage t-1
    if (t + 1 < T) issue(t + 1);
    agp::cp_async_commit();
    const int s = t / G, j = t - s * G;
    const bf16* hb = halo + (s & 1) * kHaloElems;
    const bf16* wb = wbuf + (t & 1) * kWElems;
#pragma unroll
    for (int ti = 0; ti < CHUNK; ++ti) {
      const int tap = j * CHUNK + ti;
      const int dx = tap / 3, dy = tap - 3 * dx;
#pragma unroll
      for (int kk = 0; kk < kBKC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              fa[i], hb + ((wm * 2 + i + dx) * kHY + dy) * kLDA + kk, kLDA);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          wmma::load_matrix_sync(
              fb[jj], wb + (ti * kBKC + kk) * kLDB + wn * 32 + jj * 16, kLDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            wmma::mma_sync(acc[i][jj], fa[i], fb[jj], acc[i][jj]);
      }
    }
  }
  agp::cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the C tile
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      wmma::store_matrix_sync(
          Cs + (wm * 32 + i * 16) * kLDC + wn * 32 + jj * 16, acc[i][jj],
          kLDC, wmma::mem_row_major);
  __syncthreads();

  // epilogue: thread -> 8 channels (cg) x rows rbase + 32*t; row r is the
  // patch cell (r / kPY, r % kPY)
  const int cg = tid % (kBN / 8);
  const int rbase = tid / (kBN / 8);
  const int n = n0 + cg * 8;
  const bool n_ok = n < p.cout;
  const int cz = p.cout / p.z;
  float sc[8], bi[8], psum[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = n_ok ? rbf(p.scale[n + j]) : 0.0f;
    bi[j] = n_ok ? rbf(p.bias[n + j]) : 0.0f;
    psum[j] = 0.0f;
  }
#pragma unroll
  for (int t = 0; t < kBM / (kNT / (kBN / 8)); ++t) {
    const int row = rbase + t * (kNT / (kBN / 8));
    const int ox = x0 + row / kPY, oy = y0 + row % kPY;
    if (!n_ok || ox >= p.X || oy >= p.Y) continue;
    const size_t m = ((size_t)b * p.X + ox) * p.Y + oy;
    const float mk = (float)p.mask[m * p.z + n / cz];
    uint4 o;
    bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v =
          rbf(rbf(rbf(Cs[row * kLDC + cg * 8 + j]) * sc[j]) + bi[j]);
      if (EPI == 0) {
        oe[j] = __float2bfloat16_rn(fmaxf(v, 0.0f) * mk);
      } else {
        oe[j] = __float2bfloat16_rn(v);
        psum[j] += v * mk;
      }
    }
    *reinterpret_cast<uint4*>(p.out + m * p.cout + n) = o;
  }

  if (EPI == 1) {
    // lanes sharing cg (lane ^ 8, lane ^ 16) hold other rows of the same
    // item: reduce in-warp, then across warps, then one atomic per channel
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      psum[j] += __shfl_xor_sync(0xffffffffu, psum[j], 8);
      psum[j] += __shfl_xor_sync(0xffffffffu, psum[j], 16);
    }
    if (lane < kBN / 8)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[warp][lane * 8 + j] = psum[j];
    __syncthreads();
    if (tid < kBN && n0 + tid < p.cout) {
      float s = 0.0f;
#pragma unroll
      for (int w8 = 0; w8 < kNT / 32; ++w8) s += red[w8][tid];
      atomicAdd(p.pool + (size_t)b * p.cout + n0 + tid, s);
    }
  }
}

template <int CHUNK, int EPI>
cudaError_t launch(const HaloConvParams& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<CHUNK>();
  cudaError_t err = cudaFuncSetAttribute(
      halo_conv3x3_kernel<CHUNK, EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int patches =
      p.B * ((p.X + kPX - 1) / kPX) * ((p.Y + kPY - 1) / kPY);
  dim3 grid(patches, (p.cout + kBN - 1) / kBN);
  halo_conv3x3_kernel<CHUNK, EPI><<<grid, kNT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_chunk(int chunk, const HaloConvParams& p,
                         cudaStream_t stream) {
  switch (chunk) {
    case 1: return launch<1, EPI>(p, stream);
    case 3: return launch<3, EPI>(p, stream);
    case 9: return launch<9, EPI>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int agp_p1_smem_bytes(int chunk) {
  switch (chunk) {
    case 1: return smem_bytes<1>();
    case 3: return smem_bytes<3>();
    case 9: return smem_bytes<9>();
    default: return -1;
  }
}

extern "C" int agp_p1_conv1(const bf16* x, const uint8_t* mask,
                            const bf16* w1, const float* s1, const float* b1,
                            bf16* h, int B, int X, int Y, int zci, int zco,
                            int z, int chunk, void* stream) {
  const HaloConvParams p = {x, w1, h, s1, b1, mask, nullptr,
                            B, X, Y, zci, zco, z};
  return launch_chunk<0>(chunk, p, static_cast<cudaStream_t>(stream));
}

extern "C" int agp_p1_conv2_pool(const bf16* h, const uint8_t* mask,
                                 const bf16* w2, const float* s2,
                                 const float* b2, bf16* g, float* pool, int B,
                                 int X, int Y, int zco, int z, int chunk,
                                 void* stream) {
  const HaloConvParams p = {h, w2, g, s2, b2, mask, pool,
                            B, X, Y, zco, zco, z};
  return launch_chunk<1>(chunk, p, static_cast<cudaStream_t>(stream));
}
