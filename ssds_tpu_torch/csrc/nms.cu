// Batched greedy-NMS keep mask for Hopper (sm_90a).
//
// Replaces the TPU kernel ssds_tpu/ops/pallas/nms.py::_nms_kernel. Same
// contract as ssds_tpu_torch/ops/nms.py::nms_mask_torch: for each of M slots
// (image x class) holding N score-descending candidates,
//   keep_j = valid_j && !(exists kept i < j with IoU(i, j) > thr),
// valid_j = score_j > -5e29. Keep masks are bit-identical to the plain
// version: the IoU below uses the exact operation order of
// ops/boxes.py::jaccard ((area_i + area_j) - inter, then inter / union, then
// a strict >), and the library is compiled with -fmad=false so no multiply-
// add is contracted into an FMA.
//
// What bounds it on the card: not bytes (a [672, 200] call reads 0.6 MB) but
// the latency of the N-step dependent propagation loop. The design keeps
// that loop as short as possible: one block per slot; phase 1 spreads the
// N*N IoU tests over all the block's warps and packs them into a suppression
// bit matrix in shared memory (one __ballot_sync per 32 candidates); phase 2
// is one warp whose lanes hold the "removed" bit words in registers, so each
// of the N steps is two shuffles, a bit test and one shared-memory word load.
// M blocks run in parallel over the SMs (the TPU kernel walked 8 slots in
// lockstep per grid step instead).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 512;               // wrapper raises above this
constexpr int kMaxWords = kMaxN / 32;    // 16 suppression words per row
constexpr int kThreads = 256;
constexpr float kValidCutoff = -5e29f;   // NEG_INF / 2

__global__ void __launch_bounds__(kThreads)
nms_mask_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                uint8_t* __restrict__ keep, int n, float thr) {
  __shared__ float4 s_box[kMaxN];
  __shared__ float s_area[kMaxN];
  __shared__ uint32_t s_sup[kMaxN * kMaxWords];  // 32 KB: row i, word w

  const int slot = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int words = (n + 31) >> 5;
  const float4* slot_boxes = reinterpret_cast<const float4*>(boxes) + (size_t)slot * n;
  const float* slot_scores = scores + (size_t)slot * n;

  for (int i = tid; i < n; i += kThreads) {
    const float4 b = slot_boxes[i];
    s_box[i] = b;
    s_area[i] = fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
  }
  __syncthreads();

  // Phase 1: sup[i][j] = IoU(i, j) > thr && j > i, 32 candidates per ballot.
  for (int row = warp; row < n; row += kThreads / 32) {
    const float4 bi = s_box[row];
    const float ai = s_area[row];
    for (int w = 0; w < words; ++w) {
      const int j = (w << 5) + lane;
      bool hit = false;
      if (j > row && j < n) {
        const float4 bj = s_box[j];
        const float iw = fmaxf(fminf(bi.z, bj.z) - fmaxf(bi.x, bj.x), 0.0f);
        const float ih = fmaxf(fminf(bi.w, bj.w) - fmaxf(bi.y, bj.y), 0.0f);
        const float inter = iw * ih;
        const float uni = (ai + s_area[j]) - inter;
        const float iou = uni > 0.0f ? inter / uni : 0.0f;
        hit = iou > thr;
      }
      const uint32_t bits = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_sup[row * kMaxWords + w] = bits;
    }
  }
  __syncthreads();

  // Phase 2: one warp propagates; lane w owns removed/valid word w.
  if (warp != 0) return;
  uint32_t valid = 0;
  for (int t = 0; t < 32; ++t) {
    const int j = (lane << 5) + t;
    if (lane < words && j < n && slot_scores[j] > kValidCutoff) valid |= 1u << t;
  }
  uint32_t removed = 0;
  for (int i = 0; i < n; ++i) {
    const int w = i >> 5;
    const uint32_t live = __shfl_sync(0xffffffffu, valid & ~removed, w);
    if ((live >> (i & 31)) & 1u) {  // keep_i: same value in every lane
      if (lane < words) removed |= s_sup[i * kMaxWords + lane];
    }
  }
  const uint32_t kept = valid & ~removed;
  uint8_t* slot_keep = keep + (size_t)slot * n;
  for (int t = 0; t < 32; ++t) {
    const int j = (lane << 5) + t;
    if (lane < words && j < n) slot_keep[j] = (kept >> t) & 1u;
  }
}

}  // namespace

// boxes [m, n, 4] f32, scores [m, n] f32, keep [m, n] uint8, all contiguous
// on the current device. Launches on `stream`; returns cudaGetLastError().
extern "C" int ssds_nms_mask(const float* boxes, const float* scores, uint8_t* keep,
                             int m, int n, float thr, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (n > kMaxN) return (int)cudaErrorInvalidValue;
  nms_mask_kernel<<<m, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, keep, n, thr);
  return (int)cudaGetLastError();
}
