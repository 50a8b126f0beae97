// Shifted bf16 row/column sums for Hopper (sm_90a).
//
// Replaces the 17 non-dot kernels of the conv prototype's probe ladder:
// tools/pallas_conv_bisect.py k_copy, k_pad, k_cat, k_reshape;
// tools/pallas_conv_bisect2.py k_pad_w, k_pad_h, k_cat_lane, k_cat_lane_same,
// k_add_shifted, k_w_shift_slice, k_roll_w; tools/pallas_conv_bisect3.py
// g_pad_nodma, g_dma_add, g_dma_pad, g_dma_pad_read, g_dma_cat; and
// tools/pallas_elem_halo_probe.py kern (ssds_tpu_torch/ops/stencil.py::PROBES
// gives each its terms). Each computes
//   out[b, r, w, :] = sum over terms t, in order, of x[b, r + dr_t, w + dw_t, :]
// with a column outside [0, W) read as +0.0 (zero, the probes' jnp.pad) or
// wrapped (wrap, pltpu.roll); in `valid` mode the wrapper has checked that
// none is. Bit-identical to ssds_tpu_torch/ops/stencil.py::row_stencil_torch:
// the first term is copied, and each later one is added in float32 and
// rounded to bf16 (__float2bfloat16_rn) at once, as PyTorch and JAX round
// a bf16 add one operation at a time.
//
// What bounds it: bytes. An output element costs a 2-byte store, a 2-byte
// load per term (a 3-row sum reads each input row three times, the later
// two mostly from L2) and at most two adds. One thread per 8 channels of one
// pixel, so loads and stores are 16 bytes, neighbouring threads on
// neighbouring addresses; a grid-stride loop over the output.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTerms = 8;
constexpr int kThreads = 256;
constexpr long long kMaxVecs = 1LL << 30;  // 32-bit indices with room for the grid stride
enum WMode { kValid = 0, kZero = 1, kWrap = 2 };  // ops/stencil.py WMODES

struct Terms {
  int n;
  int dr[kMaxTerms];
  int dw[kMaxTerms];
};

union Vec8 {
  uint4 raw;
  __nv_bfloat16 e[8];
};

__global__ void __launch_bounds__(kThreads)
row_stencil_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, int h, int w, int cvec,
                   int out_rows, int out_cols, const Terms t, int wmode, int total) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int v = i % cvec;
    int p = i / cvec;
    const int ow = p % out_cols;
    p /= out_cols;
    const int r = p % out_rows;
    const size_t b = p / out_rows;
    float acc[8];
    for (int k = 0; k < t.n; ++k) {
      int col = ow + t.dw[k];
      bool inside = true;
      if (wmode == kWrap) {
        col = ((col % w) + w) % w;
      } else {
        inside = col >= 0 && col < w;
      }
      Vec8 in;
      in.raw = inside ? x[((b * h + r + t.dr[k]) * w + col) * cvec + v] : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float f = __bfloat162float(in.e[j]);
        acc[j] = k == 0 ? f : __bfloat162float(__float2bfloat16_rn(acc[j] + f));
      }
    }
    Vec8 res;
#pragma unroll
    for (int j = 0; j < 8; ++j) res.e[j] = __float2bfloat16_rn(acc[j]);  // exact: already bf16
    out[i] = res.raw;
  }
}

}  // namespace

// x [b, h, w, c] bf16, out [b, out_rows, out_cols, c] bf16, both contiguous
// and 16-byte aligned on the current device, c % 8 == 0; n_terms <= 8 offsets
// (dr[k], dw[k]) in host memory, rows r + dr[k] inside [0, h) for every
// r < out_rows (the wrapper checks); wmode 0 valid, 1 zero, 2 wrap; at most
// 2^30 vectors of 8 outputs.
// Launches on `stream`; returns a cudaError_t (0: launched).
extern "C" int ssds_row_stencil(const void* x, void* out, int b, int h, int w, int c,
                                int out_rows, int out_cols, int n_terms, const int* dr,
                                const int* dw, int wmode, void* stream) {
  if (n_terms < 1 || n_terms > kMaxTerms || c <= 0 || c % 8 || wmode < kValid || wmode > kWrap)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)b * out_rows * out_cols * (c / 8);
  if (total <= 0) return 0;
  if (total > kMaxVecs) return (int)cudaErrorInvalidValue;
  Terms t;
  t.n = n_terms;
  for (int k = 0; k < kMaxTerms; ++k) {
    t.dr[k] = k < n_terms ? dr[k] : 0;
    t.dw[k] = k < n_terms ? dw[k] : 0;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < sms * 16LL ? want : sms * 16LL);
  row_stencil_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), h, w, c / 8, out_rows, out_cols, t,
      wmode, (int)total);
  return (int)cudaGetLastError();
}
