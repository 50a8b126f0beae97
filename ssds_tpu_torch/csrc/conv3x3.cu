// 3x3 and 3x1 convolution over NHWC bf16 rows for Hopper (sm_90a).
//
// Replaces the TPU kernels tools/pallas_conv_bench.py::_conv_rows_kernel
// (pallas_conv: 3x3 SAME, stride 1, no bias) and the dot probes
// tools/pallas_conv_bisect.py::k_dot / k_dot3d (a 3x1 valid conv over an
// H-padded input). One core computes
//   out[b, r, x, n] = sum_{dy < 3, dx < KW, ci} in(b, r + dy - pad_h, x + dx - pad_w, ci) * w[dy, dx, ci, n]
// where in() is zero outside the image (the TPU kernel's padded H rows and
// its VMEM W pad at :60), with float32 accumulation and one rounding to bf16.
// Same contract as ssds_tpu_torch/ops/conv.py (conv3x3_rows_torch,
// vconv3_torch), up to the order of the float32 sums.
//
// Design. An implicit GEMM, M = output pixels, N = Cout, K = 3 * KW * Cin, on
// the tensor cores through nvcuda::wmma bf16 16x16x16 fragments with float32
// accumulators (the TPU kernel's dy-stacked K = 3 * Cin dots). The TPU tile,
// TH = 30 rows x the full 300-pixel width in VMEM, is 1.24 MB with its halo and
// does not fit a block's 227 KB, so the tile is cut in H and W: a block owns
// `tile_rows` output rows x 32 * `col_groups` columns x 64 output channels,
// one warp per 32-column row segment (two A fragments x four B fragments,
// eight accumulators). The block stages its 64-channel slice of the weights
// (3 * KW * Cin rows) in shared memory once, then walks tiles (a persistent
// grid of one wave): the next tile's halo (tile_rows + 2 rows x the columns
// plus KW - 1, all Cin) is copied by cp.async into the second of two buffers
// while the tensor cores work on the first. cp.async with src-size 0 writes
// the zeros outside the image, so no padded copy of the input is made.
//
// What bounds it: at the stem shape, [32, 300, 300, 64] x [3, 3, 64, 64], a
// call is 212 GFLOP on 0.74 GB, above the card's ~295 FLOP/byte ridge, so the
// tensor cores should. wmma issues mma.sync, a fraction of Hopper's wgmma
// rate, and each 16-deep K step of a warp loads six fragments from shared
// memory for eight mma's. A wgmma / TMA redesign is the next step.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kWarpCols = 32;        // output columns per warp: two 16-pixel A fragments
constexpr int kCoutTile = 64;        // output channels per block: four 16-wide B fragments
constexpr int kLdW = kCoutTile + 8;  // weight row stride in shared memory (bf16): 144 B
constexpr int kChanPad = 16;         // pixel stride Cin + 16 (bf16): 32-B aligned at every pixel
constexpr int kMaxWarps = 16;
constexpr int kStage = 16 * 16;      // floats of one warp's epilogue staging buffer

struct Conv {
  const bf16* x;  // [batch, hin, win, cin]
  const bf16* w;  // [3 * kw * cin, cout]: HWIO flattened
  bf16* out;      // [batch, hout, wout, cout]
  int hin, win, cin, cout, hout, wout, pad_h, pad_w;
  int tile_rows, col_groups, tiles_h, tiles_w, ntiles;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = fill ? 16 : 0;  // src-size 0: 16 zero bytes, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Dynamic shared memory: weights | halo buffer 0 | halo buffer 1 | staging.
__host__ __device__ inline int halo_cols(int col_groups, int kw) {
  return kWarpCols * col_groups + kw - 1;
}
__host__ __device__ inline size_t weight_elems(int cin, int kw) {
  return (size_t)3 * kw * cin * kLdW;
}
__host__ __device__ inline size_t halo_elems(int cin, int kw, int tile_rows, int col_groups) {
  return (size_t)(tile_rows + 2) * halo_cols(col_groups, kw) * (cin + kChanPad);
}
size_t smem_bytes(int cin, int kw, int tile_rows, int col_groups) {
  return (weight_elems(cin, kw) + 2 * halo_elems(cin, kw, tile_rows, col_groups)) * sizeof(bf16) +
         (size_t)tile_rows * col_groups * kStage * sizeof(float);
}

struct TileAt {
  int b, oy0, ox0;
};

__device__ __forceinline__ TileAt tile_at(const Conv& a, int t) {
  const int tx = t % a.tiles_w;
  const int rest = t / a.tiles_w;
  return {rest / a.tiles_h, (rest % a.tiles_h) * a.tile_rows, tx * kWarpCols * a.col_groups};
}

// Issue the cp.asyncs that stage tile t's halo into dst, zeros outside the image.
template <int KW>
__device__ __forceinline__ void load_halo(const Conv& a, int t, bf16* dst) {
  const int cols = halo_cols(a.col_groups, KW);
  const int ldx = a.cin + kChanPad;
  const int cvec = a.cin >> 3;
  const TileAt at = tile_at(a, t);
  const int iy0 = at.oy0 - a.pad_h, ix0 = at.ox0 - a.pad_w;
  const int total = (a.tile_rows + 2) * cols * cvec;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int v = i % cvec;
    const int p = i / cvec;
    const int iy = iy0 + p / cols, ix = ix0 + p % cols;
    const bool inside = iy >= 0 && iy < a.hin && ix >= 0 && ix < a.win;
    const bf16* src =
        inside ? a.x + (((size_t)at.b * a.hin + iy) * a.win + ix) * a.cin + v * 8 : a.x;
    cp_async16(dst + (size_t)p * ldx + v * 8, src, inside);
  }
}

template <int KW>
__global__ void __launch_bounds__(kMaxWarps * 32) conv_rows_kernel(const Conv a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const sw = reinterpret_cast<bf16*>(smem);
  const size_t halo = halo_elems(a.cin, KW, a.tile_rows, a.col_groups);
  bf16* const sx0 = sw + weight_elems(a.cin, KW);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const stage = reinterpret_cast<float*>(sx0 + 2 * halo) + warp * kStage;
  const int n0 = blockIdx.y * kCoutTile;

  // This block's 64 output channels of the weights (zeros past cout), then the first halo.
  constexpr int kVecs = kCoutTile / 8;
  for (int i = threadIdx.x; i < 3 * KW * a.cin * kVecs; i += blockDim.x) {
    const int k = i / kVecs, n = n0 + (i % kVecs) * 8;
    const bool inside = n < a.cout;
    cp_async16(sw + (size_t)k * kLdW + (n - n0), inside ? a.w + (size_t)k * a.cout + n : a.w,
               inside);
  }
  int t = blockIdx.x;
  if (t < a.ntiles) load_halo<KW>(a, t, sx0);
  cp_async_commit();

  const int cols = halo_cols(a.col_groups, KW);
  const int ldx = a.cin + kChanPad;
  const int wr = warp / a.col_groups;                // output row within the tile
  const int wc = (warp % a.col_groups) * kWarpCols;  // first output column within the tile
  for (int buf = 0; t < a.ntiles; t += (int)gridDim.x, buf ^= 1) {
    bf16* const cur = sx0 + buf * halo;
    const int next = t + (int)gridDim.x;
    if (next < a.ntiles) load_halo<KW>(a, next, sx0 + (buf ^ 1) * halo);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: this tile (and the weights) landed
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[i][f], 0.0f);

    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < KW; ++dx) {
        const bf16* arow = cur + ((size_t)(wr + dy) * cols + wc + dx) * ldx;
        const bf16* brow = sw + (size_t)(dy * KW + dx) * a.cin * kLdW;
        for (int c0 = 0; c0 < a.cin; c0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa0, fa1;
          wmma::load_matrix_sync(fa0, arow + c0, ldx);
          wmma::load_matrix_sync(fa1, arow + 16 * ldx + c0, ldx);
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, brow + (size_t)c0 * kLdW + f * 16, kLdW);
            wmma::mma_sync(acc[0][f], fa0, fb, acc[0][f]);
            wmma::mma_sync(acc[1][f], fa1, fb, acc[1][f]);
          }
        }
      }
    }

    // Epilogue: each 16 x 16 float fragment through the warp's staging buffer,
    // rounded to bf16 and stored 8 channels (16 B) a lane.
    const TileAt at = tile_at(a, t);
    const int oy = at.oy0 + wr;
    const int px = lane >> 1, ch = (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ox = at.ox0 + wc + i * 16 + px;
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        wmma::store_matrix_sync(stage, acc[i][f], 16, wmma::mem_row_major);
        __syncwarp();
        const int n = n0 + f * 16 + ch;
        if (oy < a.hout && ox < a.wout && n < a.cout) {
          __align__(16) bf16 v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16_rn(stage[px * 16 + ch + e]);
          *reinterpret_cast<uint4*>(a.out + (((size_t)at.b * a.hout + oy) * a.wout + ox) * a.cout +
                                    n) = *reinterpret_cast<const uint4*>(v);
        }
        __syncwarp();
      }
    }
    __syncthreads();  // every warp is done with `cur` before the next iteration refills it
  }
  cp_async_wait<0>();
}

}  // namespace

// x [batch, hin, win, cin] bf16, w [3, kw, cin, cout] bf16 (HWIO), out
// [batch, hout, wout, cout] bf16 with hout = hin + 2 * pad_h - 2 and wout = win;
// all contiguous and 16-byte aligned on the current device. kw = 3 pads W by
// one column on each side (SAME), kw = 1 reads no neighbour column. Needs
// cin % 16 == 0, cout % 8 == 0 and tile_rows * col_groups <= 16 warps.
// Launches on `stream`; returns a cudaError_t (0: launched).
extern "C" int ssds_conv_rows(const void* x, const void* w, void* out, int batch, int hin,
                              int win, int cin, int cout, int kw, int pad_h, int tile_rows,
                              int col_groups, void* stream) {
  if ((kw != 1 && kw != 3) || cin <= 0 || cin % 16 || cout <= 0 || cout % 8 || tile_rows < 1 ||
      col_groups < 1 || tile_rows * col_groups > kMaxWarps || pad_h < 0 || pad_h > 1)
    return (int)cudaErrorInvalidValue;
  Conv a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.out = static_cast<bf16*>(out);
  a.hin = hin;
  a.win = win;
  a.cin = cin;
  a.cout = cout;
  a.pad_h = pad_h;
  a.pad_w = (kw - 1) / 2;
  a.hout = hin + 2 * pad_h - 2;
  a.wout = win;
  a.tile_rows = tile_rows;
  a.col_groups = col_groups;
  if (batch <= 0 || a.hout <= 0 || a.wout <= 0) return 0;
  a.tiles_h = (a.hout + tile_rows - 1) / tile_rows;
  a.tiles_w = (a.wout + kWarpCols * col_groups - 1) / (kWarpCols * col_groups);
  const long long ntiles = (long long)batch * a.tiles_h * a.tiles_w;
  if (ntiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  a.ntiles = (int)ntiles;

  void (*kernel)(const Conv) = kw == 3 ? &conv_rows_kernel<3> : &conv_rows_kernel<1>;
  const size_t smem = smem_bytes(cin, kw, tile_rows, col_groups);
  const int threads = tile_rows * col_groups * 32;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int blocks = a.ntiles < sms * per_sm ? a.ntiles : sms * per_sm;
  kernel<<<dim3(blocks, (cout + kCoutTile - 1) / kCoutTile), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
