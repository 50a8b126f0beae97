// int8 post-training quantisation for serving on Hopper (sm_90a): the two
// kernels of ssds_tpu_torch/quant.py::QuantConv2d.
//
// Replaces ssds_tpu/quant.py:64 quantize_act and :70 int8_conv, the JAX
// package's s8 x s8 -> s32 convolution, with its float epilogue (:80
// dequant), which XLA compiles; there is no pallas_call for them. PyTorch has
// no CUDA int8 convolution (F.conv2d refuses int8 tensors there). Same
// contract as the plain versions in ssds_tpu_torch/ops/quant.py:
//
// - ssds_quantize_act: NCHW float32 or bf16 -> NHWC int8 with the channels
//   zero-padded to a multiple of 4,
//     q = clamp(rint(x / act_scale), -127, 127),
//   an IEEE division (__fdiv_rn, not a multiply by the reciprocal) and
//   round-half-to-even, as jnp.round does.
// - ssds_int8_conv: an implicit-GEMM convolution of that NHWC input with
//   [Cout, KH, KW, Cin_pad] int8 weights (any kernel size, stride, padding
//   and dilation; groups 1), int32 accumulators from wgmma, and as its
//   epilogue the float32 dequant
//     y = float(acc) * (act_scale * w_scale[n])  (+ bias[n])
//   cast to the output type, then ReLU when asked; written NCHW in float32 or
//   bf16, or the raw int32 accumulators (for checks).
//
// The accumulators are exact: |acc| <= 127^2 * K <= 16,129 * 9,216 < 2^31 at
// every shape served, so the s32 sums are exact in any order and no
// .satfinite is needed; the epilogue is the plain version's float32
// operations in its order (the library is compiled with -fmad=false, so no
// multiply-add is contracted into an FMA). Both kernels are bit-identical to
// their plain versions.
//
// What bounds them at SSD300-VGG16's 35 int8 convs (plus 4 MobileNetV2 /
// DarkNet-53 shapes) at batch 32: the convs are 2.07 TOP, 1.045 ms at the
// dense int8 peak (1,979 TOP/s), so operations; quantize_act moves 2.76 GB,
// 0.825 ms at 3.35 TB/s, so bytes.
//
// int8_conv's design. M = output pixels (b, oh, ow) flattened, so every
// conv fills the card however narrow its map; N = Cout; K = (ky, kx, c).
// A block computes a 128-pixel x N tile (N = 16, 32, 64, 96 or 128, the
// least that holds Cout) with two warpgroups of wgmma m64nNk32 .s32.s8.s8,
// both operands read from shared memory by descriptor in the 128-byte
// swizzled K-major layout. K advances 128 bytes a stage through a ring of 3
// stages filled by cp.async (16-, 8- or 4-byte copies, the widest that
// divides Cp), zero-filled for padding, rows past M, channels past Cout and
// the K tail; no TMA box can express the implicit GEMM's A rows (a tile of
// flattened pixels crosses image rows, strides and dilations). Every thread
// loads and both warpgroups compute, two blocks an SM (three for N <= 64):
// the next stage's copies land while the current stage's wgmmas run. The
// epilogue stages the tile in the ring and stores NCHW along pixels.
//
// Measured (tools/int8_bench.py, NVIDIA H100 80GB HBM3, 700 W, batch 32, the
// 39 shapes summed): int8_conv 5.945 ms, 17.6 % of its bound, against the
// first __dp4a kernel's 34.550 ms, cuDNN's bf16 conv of the same shapes
// 10.593 ms and torch._int_mm (cuBLASLt's s8 GEMM of the im2col'd operands,
// the GEMM alone) 6.116 ms; quantize_act 1.381 ms, 59.7 % of its bound,
// against 3.859 ms. The deep convs (K >= 2,304) reach 28-34 % of their
// bound: at a 128 x 128 tile a stage's 32 KB of operands feed 2 M
// multiply-adds, so the tensor cores' peak would need ~15 TB/s from L2, and
// the loads, not the wgmmas, set the pace (a run with the wgmmas left out
// took as long). Tried and measured slower: 64-byte unswizzled stages (10.6
// ms), deeper rings (no gain), a producer warpgroup feeding two consumer
// warpgroups through mbarriers in a persistent grid (8.3 ms; 7.4 with two
// producer warpgroups: one warpgroup cannot issue the copies fast enough).
//
// quantize_act's design: a tile of the flattened pixel p = h * W + w (4,096
// values, ct channels x 4096 / ct pixels), so that the 19- to 1-pixel maps
// fill every block; loads of four, two or one pixel a lane as alignment
// allows, stores of 16, 8 or 4 channels of one pixel a thread.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 64;

// quantize_act: a block quantises a tile of kQaTile values, kQaCt channels x
// kQaTile / kQaCt flattened pixels, 16 loads a thread
constexpr int kQaThreads = 256;
constexpr int kQaTile = 4096;

// int8_conv (wgmma route): a block computes kBm output pixels x BN output
// channels with two warpgroups of 64 pixels each; K advances kBk bytes (one
// 128-byte swizzled row a pixel) a stage through a ring of kStages stages,
// loaded kAhead stages ahead
constexpr int kBm = 128;
constexpr int kBk = 128;
constexpr int kStages = 3;
constexpr int kAhead = kStages - 2;
constexpr int kThreads = 256;
constexpr int kStg = kBm + 4;  // staging row (one output channel) in 4-byte words
constexpr int kMaxGridY = 65535;

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four consecutive values from a 16-byte (float) or 8-byte (bf16) aligned address.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

// Two consecutive values from an 8-byte (float) or 4-byte (bf16) aligned address.
__device__ __forceinline__ void load2(const float* p, float& v0, float& v1) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  v0 = v.x;
  v1 = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& v0, float& v1) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  v0 = __low2float(v);
  v1 = __high2float(v);
}

__device__ __forceinline__ signed char quantize1(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<signed char>(static_cast<int>(q));
}

template <int G>
struct Bytes;
template <>
struct Bytes<4> { using T = uint32_t; };
template <>
struct Bytes<8> { using T = uint2; };
template <>
struct Bytes<16> { using T = uint4; };

// grid (pixel tiles, channel tiles, B), block 256. The tile is `ct` channels
// (a power of 2, 4 to 64) x P = 4096 / ct pixels of one image, P along the
// flattened pixel p = h * W + w, which is contiguous in NCHW for a channel
// and the row index in NHWC. Loads: a warp's 32 lanes on consecutive pixels
// of one channel (coalesced whatever the map width), four pixels a lane
// where H * W % 4 == 0 and two where it is even, so that every load is
// aligned, else one; into a [ct][P + 1] float tile. Stores: G int8 channels of one
// pixel a thread (G = 16, 8 or 4, dividing Cp), lanes in
// channel-group-then-pixel order so that a warp writes whole runs of an
// NHWC row.
template <typename T, int G>
__global__ void __launch_bounds__(kQaThreads)
    quantize_act_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        int8_t* __restrict__ out, int C, int HW, int Cp, int ct_log2) {
  __shared__ float tile[kQaTile + 64];
  const int p_log2 = 12 - ct_log2;  // P = 4096 / ct
  const int P = 1 << p_log2, ct = 1 << ct_log2;
  const int p0 = blockIdx.x * P, c0 = blockIdx.y * ct, b = blockIdx.z;
  const int t = threadIdx.x;
  const T* xb = x + static_cast<size_t>(b) * C * HW;
  if ((HW & 3) == 0) {
#pragma unroll
    for (int i = 0; i < kQaTile / kQaThreads / 4; ++i) {
      const int e = t + i * kQaThreads;
      const int c = e >> (p_log2 - 2), p = 4 * (e & (P / 4 - 1));
      const int cc = c0 + c, pp = p0 + p;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (cc < C && pp < HW) load4(xb + static_cast<size_t>(cc) * HW + pp, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) tile[c * (P + 1) + p + j] = v[j];
    }
  } else if ((HW & 1) == 0) {
#pragma unroll
    for (int i = 0; i < kQaTile / kQaThreads / 2; ++i) {
      const int e = t + i * kQaThreads;
      const int c = e >> (p_log2 - 1), p = 2 * (e & (P / 2 - 1));
      const int cc = c0 + c, pp = p0 + p;
      float v0 = 0.f, v1 = 0.f;
      if (cc < C && pp < HW) load2(xb + static_cast<size_t>(cc) * HW + pp, v0, v1);
      tile[c * (P + 1) + p] = v0;
      tile[c * (P + 1) + p + 1] = v1;
    }
  } else {
#pragma unroll
  for (int i = 0; i < kQaTile / kQaThreads; ++i) {
    const int e = t + i * kQaThreads;
    const int c = e >> p_log2, p = e & (P - 1);
    const int cc = c0 + c, pp = p0 + p;
    float v = 0.f;  // padding channels quantise 0 to 0
    if (cc < C && pp < HW) v = to_float(xb[static_cast<size_t>(cc) * HW + pp]);
    tile[c * (P + 1) + p] = v;
  }
  }
  __syncthreads();
  const float s = *scale;
  const int gp = ct / G;  // store groups a pixel of the tile
  using V = typename Bytes<G>::T;
#pragma unroll
  for (int i = 0; i < kQaTile / G / kQaThreads; ++i) {
    const int u = t + i * kQaThreads;
    const int p = u / gp, g = u - p * gp;
    const int pp = p0 + p, cc = c0 + g * G;
    if (pp >= HW || cc >= Cp) continue;
    union {
      V v;
      signed char q[G];
    } pack;
#pragma unroll
    for (int j = 0; j < G; ++j) pack.q[j] = quantize1(tile[(g * G + j) * (P + 1) + p], s);
    *reinterpret_cast<V*>(out + (static_cast<size_t>(b) * HW + pp) * Cp + cc) = pack.v;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of V bytes with zero fill: `bytes` is V or 0 (nothing read).
template <int V>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes) {
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(V),
                 "r"(bytes)
                 : "memory");
}

// A K-major operand in shared memory: 128 bytes of K a row, 8-row atoms of
// 1,024 bytes (1,024-byte aligned), the 16-byte chunk j of row r at chunk
// j ^ (r % 8) of its row: the 128-byte swizzle that the wgmma descriptor's
// layout type 1 undoes, and that spreads each warp's 16-byte copies over all
// banks.
__device__ __forceinline__ uint32_t swizzled(int r, int byte) {
  return (r >> 3) * 1024 + (r & 7) * 128 + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15));
}

// wgmma shared-memory descriptor of such an operand: start address, LBO
// (unused with a swizzle, 16 bytes) and SBO (the next 8-row atom, 1,024
// bytes) in 16-byte units, layout type 1 (128-byte swizzle). The k-th 32-byte
// step of K starts 32 * k bytes into the atom.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

#define R8(i)                                                                                  \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])

// d = A (64 x 32 int8, descriptor a) * B (32 x N int8, descriptor b) +
// (accumulate ? d : 0) in int32, both operands K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a, uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;"
      "\n}\n"
      : R8(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;"
      "\n}\n"
      : R8(0), R8(8)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;"
      "\n}\n"
      : R8(0), R8(8), R8(16), R8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<96>(int (&d)[48], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p;"
      "\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;"
      "\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}
#undef R8

// Keeps the compiler from moving accumulator reads or writes across wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

}  // namespace

// Shapes, options and plan of one convolution (ops/cuda/int8_conv.py::ConvArgs).
struct ConvArgs {
  int b, h, w, cp;        // input NHWC int8, cp % 4 == 0
  int cout, kh, kw;       // weights [cout, kh, kw, cp]
  int ho, wo;             // output spatial size
  int sh, sw, ph, pw, dh, dw;
  int relu;               // 1: ReLU after the cast
  int out_kind;           // 0 float32, 1 bf16, 2 raw int32 accumulators
  int bn;                 // output channels a tile: the wgmma N
  int vec;                // bytes a cp.async: 16, 8 or 4, dividing cp
};

namespace {

// The implicit GEMM on the tensor cores: M = output pixels (b, oh, ow)
// flattened, N = output channels, K = (ky, kx, c) over cp; tile (m, n) =
// (blockIdx.x / n_tiles, blockIdx.x % n_tiles). Shared memory holds each
// stage's A (kBm rows) and B (BN rows) of kBk bytes in the swizzled layout
// above. Every thread loads (cp.async, zero fill past the image, past M and
// past Cout; past K, A zero and B left) and both warpgroups compute: the
// wgmmas of stage q
// run while the copies of stage q + kAhead land; a stage is overwritten only
// once both warpgroups' wgmmas that read it have completed (wait_group 1
// before the next stage's barrier). After the K loop the ring becomes the
// staging tile [BN][kStg] of 32-bit values, stored NCHW along pixels. Two
// blocks an SM, three for N tiles of 64 or fewer channels (their ring, 72 KB,
// and the row table fill the SM's 228 KB three times).
template <int BN, int V>
__global__ void __launch_bounds__(kThreads, BN <= 64 ? 3 : 2)
    int8_conv_wgmma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                           const float* __restrict__ act_scale, const float* __restrict__ w_scale,
                           const float* __restrict__ bias, void* __restrict__ out, ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kCpr = kBk / V;                 // copies a row a stage
  constexpr int kRows = kBm * kCpr / kThreads;  // A rows a thread loads
  constexpr int kStride = kThreads / kCpr;      // between a thread's rows
  constexpr int kStageBytes = (kBm + BN) * kBk;
  const int t = threadIdx.x;
  const int n_tiles = (a.cout + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * kBm, n0 = (blockIdx.x % n_tiles) * BN;
  const int m_total = a.b * a.ho * a.wo;
  const int k_total = a.kh * a.kw * a.cp;
  const int nk = (k_total + kBk - 1) / kBk;
  const uint32_t ring = (smem_u32(smem) + 1023) & ~1023u;  // the swizzle's 1,024-byte atoms

  // The tile's rows, once: the input row of output pixel (b, oh, ow) at tap
  // (ky, kx) is (b * H + ih0 + ky * dh) * W + iw0 + kx * dw with ih0 = oh * sh
  // - ph and iw0 = ow * sw - pw; a row past M gets an ih0 that is never
  // inside the image. In shared memory, not registers: a thread loads
  // kRows (up to 16) rows a stage.
  __shared__ int4 rows[kBm];
  if (t < kBm) {
    const int m = m0 + t;
    const int mm = m < m_total ? m : 0;
    const int ow = mm % a.wo, q = mm / a.wo;
    const int oh = q % a.ho;
    rows[t] = make_int4((q / a.ho) * a.h, m < m_total ? oh * a.sh - a.ph : -(1 << 28),
                        ow * a.sw - a.pw, 0);
  }
  __syncthreads();
  const int jb = (t % kCpr) * V;  // this thread's byte offset in each row of a stage
  // (ky, kx, c) of this thread's K position, advanced a stage at a time
  int c = jb, kx = 0, ky = 0, kpos = jb;
  auto normalise = [&]() {
    while (c >= a.cp) {
      c -= a.cp;
      if (++kx == a.kw) {
        kx = 0;
        ++ky;
      }
    }
  };
  normalise();

  // A chunk wholly past K (the last stage's tail) is zero-filled in A and
  // left out of B, whatever it held there: an int8 product with a zero is
  // zero.
  auto load_stage = [&](int slot) {
    const uint32_t sa = ring + slot * kStageBytes;
    const uint32_t sb = sa + kBm * kBk;
    const bool kv = ky < a.kh;
    const int dy = ky * a.dh, dx = kx * a.dw;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = t / kCpr + i * kStride;
      const int4 ri = rows[r];
      const int ih = ri.y + dy, iw = ri.z + dx;
      const bool ok = kv && ih >= 0 && ih < a.h && iw >= 0 && iw < a.w;
      const int8_t* src = ok ? x + (static_cast<size_t>(ri.x + ih) * a.w + iw) * a.cp + c : x;
      cp_async<V>(sa + swizzled(r, jb), src, ok ? V : 0);
    }
    if (kv)
#pragma unroll
    for (int e = t; e < BN * kCpr; e += kThreads) {
      const int r = e / kCpr, n = n0 + r;
      const bool ok = n < a.cout;
      const int8_t* src = ok ? w + static_cast<size_t>(n) * k_total + kpos : w;
      cp_async<V>(sb + swizzled(r, jb), src, ok ? V : 0);
    }
    c += kBk;
    kpos += kBk;
    normalise();
  };

  const int wg = t >> 7;
  int d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0;

#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < nk) load_stage(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int q = 0; q < nk; ++q) {
    // stage q has landed (kAhead - 1 younger groups may still be in flight)
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
    // cp.async writes through the generic proxy, wgmma reads through the async one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (q + kAhead < nk) load_stage((q + kAhead) % kStages);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const uint32_t sa = ring + (q % kStages) * kStageBytes + wg * 8 * 1024;
    const uint32_t sb = ring + (q % kStages) * kStageBytes + kBm * kBk;
    fence_regs(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < kBk / 32; ++s)
      wgmma_s8<BN>(d, smem_desc(sa + s * 32), smem_desc(sb + s * 32), q > 0 || s > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_regs(d);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs(d);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // the ring is free: it becomes the staging tile

  // Epilogue. Register d[4j + 2h + e] holds pixel 64 * wg + 16 * warp + 8h +
  // lane / 4 and channel 8j + 2 * (lane % 4) + e of the tile.
  uint32_t* stg = reinterpret_cast<uint32_t*>(smem + (ring - smem_u32(smem)));
  const float sa = *act_scale;
  const int lane = t & 31, warp = (t >> 5) & 3;
  const int row = 64 * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * (lane & 3) + e, n = n0 + col;
      float s = 0.f, bn = 0.f;
      if (a.out_kind != 2 && n < a.cout) {
        s = __fmul_rn(sa, w_scale[n]);  // the two scales first, as the plain version
        if (bias != nullptr) bn = bias[n];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int acc = d[4 * j + 2 * h + e];
        uint32_t v = static_cast<uint32_t>(acc);
        if (a.out_kind != 2) {
          float y = __fmul_rn(__int2float_rn(acc), s);
          if (bias != nullptr) y = __fadd_rn(y, bn);
          v = __float_as_uint(y);
        }
        stg[col * kStg + row + 8 * h] = v;
      }
    }
  __syncthreads();
  const int howo = a.ho * a.wo;
  const int r = t % kBm, m = m0 + r;
  if (m >= m_total) return;
  const int b = m / howo, p = m - b * howo;
  for (int col = t / kBm; col < BN; col += kThreads / kBm) {
    const int n = n0 + col;
    if (n >= a.cout) break;
    const size_t o = (static_cast<size_t>(b) * a.cout + n) * howo + p;
    const uint32_t v = stg[col * kStg + r];
    if (a.out_kind == 2) {
      static_cast<int*>(out)[o] = static_cast<int>(v);
    } else if (a.out_kind == 0) {  // the ReLU after the float32 result
      float y = __uint_as_float(v);
      if (a.relu && y < 0.f) y = 0.f;
      static_cast<float*>(out)[o] = y;
    } else {  // the cast to bf16, then the ReLU
      __nv_bfloat16 yb = __float2bfloat16_rn(__uint_as_float(v));
      if (a.relu && __bfloat162float(yb) < 0.f) yb = __float2bfloat16_rn(0.f);
      static_cast<__nv_bfloat16*>(out)[o] = yb;
    }
  }
}

int device_index() {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kMaxDevices) return -1;
  return device;
}

template <int BN, int V>
int launch_wgmma(const void* x, const void* w, const float* act_scale, const float* w_scale,
                 const float* bias, void* out, const ConvArgs& a, long long tiles,
                 cudaStream_t stream) {
  constexpr int kRing = kStages * (kBm + BN) * kBk, kStaging = BN * kStg * 4;
  constexpr int kSmem = (kRing > kStaging ? kRing : kStaging) + 1024;  // + the alignment
  static bool ready[kMaxDevices] = {};  // the shared-memory attribute, set once a device
  const int device = device_index();
  if (device < 0) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_conv_wgmma_kernel<BN, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    ready[device] = true;
  }
  int8_conv_wgmma_kernel<BN, V><<<(unsigned)tiles, kThreads, kSmem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), act_scale, w_scale, bias, out,
      a);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_bn(const void* x, const void* w, const float* act_scale, const float* w_scale,
              const float* bias, void* out, const ConvArgs& a, long long tiles,
              cudaStream_t stream) {
  switch (a.vec) {
    case 16: return launch_wgmma<BN, 16>(x, w, act_scale, w_scale, bias, out, a, tiles, stream);
    case 8: return launch_wgmma<BN, 8>(x, w, act_scale, w_scale, bias, out, a, tiles, stream);
    case 4: return launch_wgmma<BN, 4>(x, w, act_scale, w_scale, bias, out, a, tiles, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x NCHW float32 (x_is_bf16 0) or bf16 [b, c, h, w], out NHWC int8 [b, h, w,
// cp]; the plan (ops/cuda/int8_conv.py::quantize_plan): ct channels a tile, a
// power of 2 from 4 to 64, and g bytes a store, 16, 8 or 4, with g <= ct and
// cp % g == 0. Launches on `stream`; returns a cudaError_t (0: launched).
extern "C" int ssds_quantize_act(const void* x, int x_is_bf16, const float* scale, int8_t* out,
                                 int b, int c, int h, int w, int cp, int ct, int g, void* stream) {
  int ct_log2 = 0;
  while ((1 << ct_log2) < ct) ++ct_log2;
  if (b < 0 || c < 0 || h < 0 || w < 0 || cp % 4 || cp < c || ct != (1 << ct_log2) || ct < 4 ||
      ct > 64 || (g != 4 && g != 8 && g != 16) || g > ct || cp % g ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const long long hw = (long long)h * w;
  if (b == 0 || hw == 0 || cp == 0) return 0;
  const long long ptiles = (hw + (kQaTile >> ct_log2) - 1) / (kQaTile >> ct_log2);
  const long long ctiles = (cp + ct - 1) / ct;
  if (hw > 0x7fffffffLL || ptiles > 0x7fffffffLL || ctiles > kMaxGridY || b > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ptiles, (unsigned)ctiles, (unsigned)b);
  auto s = static_cast<cudaStream_t>(stream);
#define QA_LAUNCH(T, G)                                                                         \
  quantize_act_kernel<T, G><<<grid, kQaThreads, 0, s>>>(static_cast<const T*>(x), scale, out, c, \
                                                        (int)hw, cp, ct_log2)
  if (x_is_bf16) {
    if (g == 16) QA_LAUNCH(__nv_bfloat16, 16);
    else if (g == 8) QA_LAUNCH(__nv_bfloat16, 8);
    else QA_LAUNCH(__nv_bfloat16, 4);
  } else {
    if (g == 16) QA_LAUNCH(float, 16);
    else if (g == 8) QA_LAUNCH(float, 8);
    else QA_LAUNCH(float, 4);
  }
#undef QA_LAUNCH
  return (int)cudaGetLastError();
}

// x NHWC int8 [b, h, w, cp], w [cout, kh, kw, cp] int8, both 16-byte
// aligned; out NCHW [b, cout, ho, wo] of out_kind; bn and vec are the plan of
// ops/cuda/int8_conv.py::conv_plan. Launches on `stream`; returns a
// cudaError_t (0: launched).
extern "C" int ssds_int8_conv(const void* x, const void* w, const float* act_scale,
                              const float* w_scale, const float* bias, void* out, ConvArgs a,
                              void* stream) {
  if (a.cp <= 0 || a.cp % 4 || a.kh <= 0 || a.kw <= 0 || a.sh <= 0 || a.sw <= 0 || a.dh <= 0 ||
      a.dw <= 0 || a.out_kind < 0 || a.out_kind > 2 || (a.vec != 4 && a.vec != 8 && a.vec != 16) ||
      a.cp % a.vec || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)a.b * a.ho * a.wo;
  if (m == 0 || a.cout == 0) return 0;
  if (m > 0x7fffffffLL || (long long)a.b * a.h * a.w * a.cp > 0x7fffffffLL * 4LL ||
      (long long)a.kh * a.kw * a.cp > 0x7fffffffLL / 2)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const long long tiles = (m + kBm - 1) / kBm * ((a.cout + a.bn - 1) / a.bn);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  switch (a.bn) {
    case 16: return launch_bn<16>(x, w, act_scale, w_scale, bias, out, a, tiles, s);
    case 32: return launch_bn<32>(x, w, act_scale, w_scale, bias, out, a, tiles, s);
    case 64: return launch_bn<64>(x, w, act_scale, w_scale, bias, out, a, tiles, s);
    case 96: return launch_bn<96>(x, w, act_scale, w_scale, bias, out, a, tiles, s);
    case 128: return launch_bn<128>(x, w, act_scale, w_scale, bias, out, a, tiles, s);
  }
  return (int)cudaErrorInvalidValue;
}
