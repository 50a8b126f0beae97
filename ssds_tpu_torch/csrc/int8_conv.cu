// int8 post-training quantisation for serving on Hopper (sm_90a): the two
// kernels of ssds_tpu_torch/quant.py::QuantConv2d.
//
// Replaces ssds_tpu/quant.py:64 quantize_act and :70 int8_conv, the JAX
// package's s8 x s8 -> s32 convolution with its float epilogue (:80 dequant),
// which XLA compiles; there is no pallas_call for them. PyTorch has no CUDA
// int8 convolution (F.conv2d refuses int8 tensors there), so the port needs
// these. Same contract as the plain versions in ssds_tpu_torch/ops/quant.py:
//
// - ssds_quantize_act: NCHW float32 or bf16 -> NHWC int8 with the channels
//   zero-padded to a multiple of 4,
//     q = clamp(rint(x / act_scale), -127, 127),
//   an IEEE division (__fdiv_rn, not a multiply by the reciprocal) and
//   round-half-to-even, as jnp.round does.
// - ssds_int8_conv: an implicit-GEMM convolution of that NHWC input with
//   [Cout, KH, KW, Cin_pad] int8 weights (any kernel size, stride, padding
//   and dilation; groups 1), int32 accumulators from __dp4a, and as its
//   epilogue the float32 dequant
//     y = float(acc) * (act_scale * w_scale[n])  (+ bias[n])
//   cast to the output type, then ReLU when asked; written NCHW in float32 or
//   bf16, or the raw int32 accumulators (for checks).
//
// The accumulators are exact integers, so the kernel is bit-identical to its
// plain version whatever the order of its sums; the epilogue is the plain
// version's float32 operations in its order (the library is compiled with
// -fmad=false, so no multiply-add is contracted into an FMA).
//
// What bounds it on the card. A VGG16 conv at 300 px and batch 32 is tens of
// G multiply-adds over a few hundred MB: operations, at the tensor cores'
// dense int8 peak (1,979 TOP/s). This first kernel does not reach the tensor
// cores: it is a simple tiled GEMM on the integer pipe (__dp4a, four int8
// products a lane an instruction), a 64 x 64 output tile a 256-thread block,
// a 4 x 4 register tile a thread, K in steps of 16 words (64 int8 values)
// staged through shared memory, loads coalesced along K (NHWC channels,
// contiguous). A wgmma s8 kernel fed by TMA is later work (ROADMAP.md).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQaTile = 32;   // quantize_act: 32 pixels x 32 channels a block
constexpr int kQaRows = 8;    // block (32, 8)
constexpr int kBm = 64;       // int8_conv: output pixels a block
constexpr int kBn = 64;       // output channels a block
constexpr int kBk = 16;       // 4-byte words of K a step
constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ signed char quantize1(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<signed char>(static_cast<int>(q));
}

// grid (tiles of 32 pixels along W, times B * H; tiles of 32 channels of
// Cin_pad), block (32, 8): a [32 channels][32 pixels] tile is read along W
// (coalesced NCHW rows) into shared memory, then each thread writes one
// 4-byte word: 4 channels of one pixel, 8 threads a pixel's 32 channels.
template <typename T>
__global__ void __launch_bounds__(kQaTile * kQaRows)
    quantize_act_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        int8_t* __restrict__ out, int C, int H, int W, int Cp) {
  __shared__ float tile[kQaTile][kQaTile + 1];
  const int wtiles = (W + kQaTile - 1) / kQaTile;
  const int bh = blockIdx.x / wtiles;  // b * H + h
  const int w0 = (blockIdx.x % wtiles) * kQaTile;
  const int c0 = blockIdx.y * kQaTile;
  const int b = bh / H, h = bh % H;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float s = *scale;
  for (int c = ty; c < kQaTile; c += kQaRows) {
    const int cc = c0 + c, ww = w0 + tx;
    float v = 0.f;  // padding channels quantise 0 to 0
    if (cc < C && ww < W) v = to_float(x[((static_cast<size_t>(b) * C + cc) * H + h) * W + ww]);
    tile[c][tx] = v;
  }
  __syncthreads();
  const int t = ty * kQaTile + tx;
  const int p = t >> 3, word = t & 7;
  const int ww = w0 + p, cc = c0 + 4 * word;
  if (ww < W && cc < Cp) {
    char4 q;
    q.x = quantize1(tile[4 * word][p], s);
    q.y = quantize1(tile[4 * word + 1][p], s);
    q.z = quantize1(tile[4 * word + 2][p], s);
    q.w = quantize1(tile[4 * word + 3][p], s);
    *reinterpret_cast<char4*>(out + (static_cast<size_t>(bh) * W + ww) * Cp + cc) = q;
  }
}

}  // namespace

// Shapes and options of one convolution (ops/cuda/int8_conv.py::ConvArgs).
struct ConvArgs {
  int b, h, w, cp;        // input NHWC int8, cp % 4 == 0
  int cout, kh, kw;       // weights [cout, kh, kw, cp]
  int ho, wo;             // output spatial size
  int sh, sw, ph, pw, dh, dw;
  int relu;               // 1: ReLU after the cast
  int out_kind;           // 0 float32, 1 bf16, 2 raw int32 accumulators
};

namespace {

// grid (ceil(M / 64), ceil(Cout / 64)) with M = B * Ho * Wo; block 256.
// Thread (tx, ty) = (tid % 16, tid / 16) accumulates pixels m0 + tx + 16 i
// and channels n0 + ty + 16 j (i, j < 4): a warp's 16 pixels are
// consecutive, so the NCHW stores are 64-byte runs. For the loads, thread
// tid takes word kk = tid % 16 of the step for pixels / channels
// r = tid / 16 + 16 i, so 16 neighbouring threads read 64 contiguous bytes.
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const int* __restrict__ x, const int* __restrict__ w,
                     const float* __restrict__ act_scale, const float* __restrict__ w_scale,
                     const float* __restrict__ bias, void* __restrict__ out, ConvArgs a) {
  __shared__ int as[kBk][kBm + 1];
  __shared__ int bs[kBk][kBn + 1];
  const int tid = threadIdx.x;
  const int m_total = a.b * a.ho * a.wo;
  const int m0 = blockIdx.x * kBm, n0 = blockIdx.y * kBn;
  const int cw = a.cp >> 2;            // words a pixel
  const int k4 = a.kh * a.kw * cw;     // words of K: (kh, kw, channel word)
  const int kk = tid & (kBk - 1), r0 = tid >> 4;

  int pb[4], pih[4], piw[4];
  bool pv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + r0 + 16 * i;
    pv[i] = m < m_total;
    const int mm = pv[i] ? m : 0;
    const int ow = mm % a.wo, t = mm / a.wo;
    const int oh = t % a.ho;
    pb[i] = t / a.ho;
    pih[i] = oh * a.sh - a.ph;
    piw[i] = ow * a.sw - a.pw;
  }

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  const int tx = tid & 15, ty = tid >> 4;

  for (int k0 = 0; k0 < k4; k0 += kBk) {
    const int k = k0 + kk;
    const bool kv = k < k4;
    int c4 = 0, ky = 0, kx = 0;
    if (kv) {
      c4 = k % cw;
      const int t = k / cw;
      kx = t % a.kw;
      ky = t / a.kw;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ih = pih[i] + ky * a.dh, iw = piw[i] + kx * a.dw;
      int v = 0;
      if (kv && pv[i] && ih >= 0 && ih < a.h && iw >= 0 && iw < a.w)
        v = __ldg(x + ((static_cast<size_t>(pb[i]) * a.h + ih) * a.w + iw) * cw + c4);
      as[kk][r0 + 16 * i] = v;
      const int n = n0 + r0 + 16 * i;
      bs[kk][r0 + 16 * i] = (kv && n < a.cout) ? __ldg(w + static_cast<size_t>(n) * k4 + k) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = as[j][tx + 16 * i];
        bv[i] = bs[j][ty + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = __dp4a(av[i], bv[q], acc[i][q]);
    }
    __syncthreads();
  }

  const float sa = *act_scale;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = n0 + ty + 16 * q;
    if (n >= a.cout) continue;
    const float s = __fmul_rn(sa, w_scale[n]);
    const float bn = bias != nullptr ? bias[n] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + tx + 16 * i;
      if (m >= m_total) continue;
      const int ow = m % a.wo, t = m / a.wo;
      const int oh = t % a.ho, b = t / a.ho;
      const size_t o = ((static_cast<size_t>(b) * a.cout + n) * a.ho + oh) * a.wo + ow;
      if (a.out_kind == 2) {
        static_cast<int*>(out)[o] = acc[i][q];
        continue;
      }
      float y = __fmul_rn(__int2float_rn(acc[i][q]), s);
      if (bias != nullptr) y = __fadd_rn(y, bn);
      if (a.out_kind == 0) {
        if (a.relu && y < 0.f) y = 0.f;
        static_cast<float*>(out)[o] = y;
      } else {
        __nv_bfloat16 yb = __float2bfloat16_rn(y);
        if (a.relu && __bfloat162float(yb) < 0.f) yb = __float2bfloat16_rn(0.f);
        static_cast<__nv_bfloat16*>(out)[o] = yb;
      }
    }
  }
}

}  // namespace

extern "C" int ssds_quantize_act(const void* x, int x_is_bf16, const float* scale, int8_t* out,
                                 int b, int c, int h, int w, int cp, void* stream) {
  if (b < 0 || c < 0 || h < 0 || w < 0 || cp % 4 || cp < c) return (int)cudaErrorInvalidValue;
  if ((long long)b * h == 0 || w == 0 || cp == 0) return 0;
  const long long blocks = (long long)b * h * ((w + kQaTile - 1) / kQaTile);
  const int ctiles = (cp + kQaTile - 1) / kQaTile;
  if (blocks > 0x7fffffffLL || ctiles > kMaxGridY) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, ctiles), block(kQaTile, kQaRows);
  auto s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    quantize_act_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), scale, out, c, h, w, cp);
  else
    quantize_act_kernel<float><<<grid, block, 0, s>>>(static_cast<const float*>(x), scale, out, c,
                                                      h, w, cp);
  return (int)cudaGetLastError();
}

extern "C" int ssds_int8_conv(const void* x, const void* w, const float* act_scale,
                              const float* w_scale, const float* bias, void* out, ConvArgs a,
                              void* stream) {
  if (a.cp <= 0 || a.cp % 4 || a.kh <= 0 || a.kw <= 0 || a.sh <= 0 || a.sw <= 0 || a.dh <= 0 ||
      a.dw <= 0 || a.out_kind < 0 || a.out_kind > 2)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)a.b * a.ho * a.wo;
  if (m == 0 || a.cout == 0) return 0;
  const long long gx = (m + kBm - 1) / kBm, gy = (a.cout + kBn - 1) / kBn;
  if (m > 0x7fffffffLL || gy > kMaxGridY ||
      (long long)a.b * a.h * a.w * a.cp > 0x7fffffffLL * 4LL)
    return (int)cudaErrorInvalidValue;
  int8_conv_kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<const int*>(w), act_scale, w_scale, bias, out, a);
  return (int)cudaGetLastError();
}
