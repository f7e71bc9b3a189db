// The eval-mode epilogue of a ResNet conv: BatchNorm's affine, an optional
// residual and ReLU, in one pass over the conv's NHWC output.
//
// No TPU kernel stands behind it: XLA fuses this chain into the conv on the
// TPU.  PyTorch's eager mode runs it as separate passes over the whole map
// (models/norm.py: `x * s.to(dt) + b.to(dt)`, then `torch.relu`, then `out +
// idn` and a second relu), each reading and writing the map.  This kernel
// reads each input map once and writes the output once.  Three instances of
// one kernel, chosen by the wrapper (ops/bn_act.py) from its operands:
//   kRes 0: y = relu(bn(x))                    a block's bn1, the stem tail
//   kRes 1: y = relu(bn(x) + r)                a block's identity residual
//   kRes 2: y = relu(bn(x) + bn_d(r))          a block's downsample: the
//           downsample conv's output r is read once, its BN never stored
// in bf16 or fp32 (T, the activation dtype).
//
// Arithmetic: bit-equal to the eager chain.  bn(v) = round(round(v *
// round(s)) + round(b)), each product and sum an fp32 operation rounded
// once to T (bf16 round-to-nearest-even, as PyTorch's bf16 elementwise
// kernels compute in fp32 and convert; fp32: no round); __fmul_rn and
// __fadd_rn keep the compiler from contracting a multiply and an add into an
// FMA, which would skip a rounding.  The residual sum rounds once, as `out +
// idn` does.  relu is torch.relu's clamp_min: NaN passes through, otherwise
// fmaxf(v, 0).
//
// What bounds it on the H100: bytes (2 or 3 maps moved per element, a few
// flops).  Each thread owns one 16-byte channel group (8 bf16 or 4 fp32
// channels) for the whole pass: the persistent grid's stride, grid x block
// vectors, is a multiple of the vectors per pixel (the wrapper's
// bn_act_grid), so a thread's vectors all share their channels and their
// rounded scale and bias stay in registers.  Loads and stores are 16-byte
// vectors with streaming hints (ld.global.cs / st.global.cs: each byte is
// touched once), kUnroll vectors in flight per thread.  The output may
// alias x (the wrapper writes over the conv's fresh output): each element
// is read and then written by the same thread.
#include "common.cuh"

namespace {

using agp::bf16;
using agp::rbf;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename T>
struct EpiParams {
  const T* x;          // [n_vec * V], V = 16 / sizeof(T)
  const T* r;          // the residual (kRes 1, 2), or null
  T* y;                // may equal x
  const float* scale;  // [C]
  const float* bias;
  const float* scale_d;  // kRes 2: the residual's affine
  const float* bias_d;
  long long n_vec;  // 16-byte vectors of the map
  int cv;           // vectors per pixel: C / V
};

// A value rounded to the activation dtype T and widened back to fp32
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<bf16>(float v) {
  return rbf(v);
}
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}

// The V elements of a 16-byte vector, widened to fp32, and back
template <typename T>
__device__ __forceinline__ void unpack(const uint4& q, float* f);
template <>
__device__ __forceinline__ void unpack<bf16>(const uint4& q, float* f) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void unpack<float>(const uint4& q, float* f) {
  f[0] = __uint_as_float(q.x);
  f[1] = __uint_as_float(q.y);
  f[2] = __uint_as_float(q.z);
  f[3] = __uint_as_float(q.w);
}

// pack values that T represents exactly (already rounded): no rounding here
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f);
template <>
__device__ __forceinline__ uint4 pack<bf16>(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = (__float_as_uint(f[2 * j]) >> 16) |
           (__float_as_uint(f[2 * j + 1]) & 0xffff0000u);
  return make_uint4(w[0], w[1], w[2], w[3]);
}
template <>
__device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// round(round(v * s) + b), s and b already rounded to T
template <typename T>
__device__ __forceinline__ float affine(float v, float s, float b) {
  return round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(v, s)), b));
}

template <typename T, int kRes>
__global__ void __launch_bounds__(kThreads)
    bn_act_kernel(const EpiParams<T> p) {
  constexpr int V = 16 / sizeof(T);
  const long long t = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  // stride % cv == 0: every vector of this thread has channel group t % cv
  const int c0 = (int)(t % p.cv) * V;
  float s[V], b[V], sd[V], bd[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s[j] = round_to<T>(p.scale[c0 + j]);
    b[j] = round_to<T>(p.bias[c0 + j]);
    if (kRes == 2) {
      sd[j] = round_to<T>(p.scale_d[c0 + j]);
      bd[j] = round_to<T>(p.bias_d[c0 + j]);
    }
  }
  const uint4* x = reinterpret_cast<const uint4*>(p.x);
  const uint4* r = reinterpret_cast<const uint4*>(p.r);
  uint4* y = reinterpret_cast<uint4*>(p.y);
  for (long long i0 = t; i0 < p.n_vec; i0 += kUnroll * stride) {
    uint4 xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = i0 + k * stride;
      if (i < p.n_vec) {
        xv[k] = __ldcs(x + i);
        if (kRes) rv[k] = __ldcs(r + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = i0 + k * stride;
      if (i >= p.n_vec) break;
      float f[V], g[V];
      unpack<T>(xv[k], f);
      if (kRes) unpack<T>(rv[k], g);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float v = affine<T>(f[j], s[j], b[j]);
        if (kRes == 1) v = round_to<T>(__fadd_rn(v, g[j]));
        if (kRes == 2)
          v = round_to<T>(__fadd_rn(v, affine<T>(g[j], sd[j], bd[j])));
        if (!isnan(v)) v = fmaxf(v, 0.0f);
        f[j] = v;
      }
      __stcs(y + i, pack<T>(f));
    }
  }
}

template <typename T>
int launch(const EpiParams<T>& p, int res, int grid, cudaStream_t stream) {
  if (res == 0)
    bn_act_kernel<T, 0><<<grid, kThreads, 0, stream>>>(p);
  else if (res == 1)
    bn_act_kernel<T, 1><<<grid, kThreads, 0, stream>>>(p);
  else
    bn_act_kernel<T, 2><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x, r, y: 16-byte aligned NHWC maps of n_vec vectors (r null for res 0);
// fp32: 1 for fp32 maps, 0 for bf16; res: the instance (0, 1, 2); cv: the
// vectors per pixel; grid: ops/bn_act.py's bn_act_grid, block its BLOCK;
// the stride grid x block must be a multiple of cv.
extern "C" int agp_bn_act(const void* x, const void* r, void* y,
                          const float* scale, const float* bias,
                          const float* scale_d, const float* bias_d,
                          long long n_vec, int cv, int fp32, int res,
                          int grid, int block, void* stream) {
  if (n_vec < 1 || cv < 1 || n_vec % cv || res < 0 || res > 2 ||
      block != kThreads || grid < 1 || ((long long)grid * block) % cv ||
      (res > 0) != (r != nullptr) ||
      (res == 2) != (scale_d != nullptr && bias_d != nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32) {
    const EpiParams<float> p = {
        static_cast<const float*>(x), static_cast<const float*>(r),
        static_cast<float*>(y), scale, bias, scale_d, bias_d, n_vec, cv};
    return launch(p, res, grid, s);
  }
  const EpiParams<bf16> p = {
      static_cast<const bf16*>(x), static_cast<const bf16*>(r),
      static_cast<bf16*>(y), scale, bias, scale_d, bias_d, n_vec, cv};
  return launch(p, res, grid, s);
}
