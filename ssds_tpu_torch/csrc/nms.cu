// Batched greedy-NMS keep mask for Hopper (sm_90a).
//
// Replaces the TPU kernel ssds_tpu/ops/pallas/nms.py:55 _nms_kernel
// (nms_mask_pallas :95, pallas_call :121). Same contract as
// ssds_tpu_torch/ops/nms.py::nms_mask_torch: for each of M slots (image x
// class) holding N <= 512 score-descending candidates,
//   keep_j = valid_j && !(exists kept i < j with IoU(i, j) > thr),
// valid_j = score_j > -5e29. Keep masks are bit-identical to the plain
// version: the IoU below uses the exact operation order of
// ops/boxes.py::jaccard ((area_i + area_j) - inter, then the IEEE division
// inter / union, then a strict >), and the library is compiled with
// -fmad=false so no multiply-add is contracted into an FMA.
//
// What bounds it on the card. The work is tiny (a [672, 200] call is 13.4 M
// IoU tests and 2.8 MB of I/O: 2.6 us at the float32 peak), so latency and
// issue rate bound it. The earlier design (one 256-thread block a slot, 43
// KB of static shared memory sized for N = 512, every word of every row
// tested one ballot at a time, a chain of N shuffle + shared-load pairs)
// took 0.048 ms at [21, 200] and 0.107 ms at [672, 200] on an H100, three
// quarters of it in phase 1: most IoU tests divide 0 by the union, and a
// zero numerator sends the IEEE division down its slow path (ablation
// builds of both designs, PERF.md section 6). What this design does:
//
// - Only pairs that overlap divide; the other lanes divide 1 by 1 and select
//   0, which is what jaccard gives them (0 / union is +0). The division
//   stays the IEEE one, in jaccard's order. At [672, 200] phase 1 is now
//   bound by its issue rate, about 31 instructions a test.
// - The launch plan is chosen on the host from (M, N) and the SM count
//   (plan() below, mirrored by ops/cuda/nms.py::launch_plan): shared memory
//   is sized by N (10.6 KB a slot at N = 200); blocks are 16 warps, two an
//   SM. At small M a thread block cluster of two blocks takes a slot, both
//   testing tiles and writing the words into the first block's shared
//   memory; at large M several slots share a block, so a batch runs in one
//   wave and the slots' chains overlap.
// - Phase 1 tests only the words on or above the diagonal, in 32 x 32 tiles:
//   a warp takes a tile, a lane one row, and a thread builds its whole 32-bit
//   word from 32 IoU tests (no ballot), 4 at a time, their loads and
//   arithmetic before their divisions. Tests stop at n_eff, one past the
//   last valid candidate: later rows are never kept, later columns never
//   kept.
// - Phase 2 walks the chain a word at a time: every lane of the slot's warp
//   resolves the 32 x 32 diagonal block of word w in registers, two
//   dependent instructions a candidate, then lane w' > w ORs the kept rows'
//   word w' into its "removed" word, the 32 loads issued together. The
//   dependent chain is N register steps and N / 32 shuffles.
// - I/O is coalesced: a warp loads 32 boxes (float4) and 32 scores of a
//   word and ballots the valid bits; keep is written 4 bytes a lane.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 512;               // the wrapper raises above this
constexpr int kThreads = 512;            // 16 warps a block
constexpr int kBlocksPerSm = 2;          // with <= 64 registers a thread (launch bounds)
constexpr int kMaxSlots = kThreads / 32; // slots a block: a phase-2 warp each
constexpr int kMaxSmem = 232448;         // dynamic shared memory a block can have
constexpr int kSmSmem = 233472;          // shared memory of an SM
constexpr int kBlockReserve = 1024;      // the runtime's shared memory a block
constexpr int kHeaderWords = 32;         // n_eff of each slot, padded to 128 B
constexpr int kChunk = 4;                // IoU tests in flight a thread
constexpr int kCluster = 2;              // blocks a slot at small M
constexpr float kValidCutoff = -5e29f;   // NEG_INF / 2
constexpr uint32_t kFull = 0xffffffffu;

// One slot's shared memory, in 4-byte words from the slot's base. Boxes and
// areas are padded to whole words of 32 candidates (zero boxes), so a tile
// reads its 32 columns at fixed offsets; the suppression words are stored by
// word, then row: word c of row i at sup + c * stride + i. A warp's 32 rows
// then write 32 consecutive words, and a lane's 32 rows of one word are
// consecutive too; the odd stride puts the lanes of phase 2 on 32 banks.
struct Layout {
  int words;   // ceil(n / 32) suppression / valid words
  int rows;    // 32 * words: candidates padded to whole words
  int stride;  // rows + 1
  int area;    // float [rows], after the float4 boxes [rows] at 0
  int valid;   // uint32 [words]
  int sup;     // uint32 [words][stride]; word c of row i written only for c >= i / 32
  int bytes;   // the slot's bytes, to 16
};

__host__ __device__ inline Layout layout(int n) {
  Layout l;
  l.words = (n + 31) >> 5;
  l.rows = l.words << 5;
  l.stride = l.rows + 1;
  l.area = 4 * l.rows;
  l.valid = l.area + l.rows;
  l.sup = l.valid + l.words;
  l.bytes = ((l.sup + l.words * l.stride) * 4 + 15) / 16 * 16;
  return l;
}

struct Plan {
  int slots, threads, blocks, smem, cluster;
};

// Small M (a cluster of kCluster blocks a slot keeps the grid within
// kBlocksPerSm blocks an SM): a cluster a slot. Otherwise slots a block:
// enough that kBlocksPerSm blocks an SM take every slot in one wave, or,
// where two such blocks do not fit an SM's shared memory, enough for one
// block an SM; never more than fit a block or kMaxSlots.
Plan plan(int m, int n, int sms) {
  const Layout l = layout(n);
  const int fit = (kMaxSmem - kHeaderWords * 4) / l.bytes;
  const int cap = fit < kMaxSlots ? fit : kMaxSlots;
  auto slots_for = [&](int blocks) {
    const int want = (m + blocks - 1) / blocks;
    return want < 1 ? 1 : want < cap ? want : cap;
  };
  Plan p;
  p.cluster = m * kCluster <= kBlocksPerSm * sms ? kCluster : 1;
  p.slots = p.cluster > 1 ? 1 : slots_for(kBlocksPerSm * sms);
  if (kBlocksPerSm * (kHeaderWords * 4 + p.slots * l.bytes + kBlockReserve) > kSmSmem)
    p.slots = slots_for(sms);
  p.threads = kThreads;
  p.blocks = (m + p.slots - 1) / p.slots * p.cluster;
  p.smem = kHeaderWords * 4 + p.slots * l.bytes;
  return p;
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of the cluster; `release` orders its earlier shared-memory
// writes (local or remote) before the other blocks' matching wait.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A 4-byte store into block `rank`'s shared memory at the offset `local`
// has in this block's (distributed shared memory).
__device__ __forceinline__ void store_to_rank(uint32_t* local, int rank, uint32_t v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"((uint32_t)__cvta_generic_to_shared(local)), "r"(rank));
  asm volatile("st.shared::cluster.u32 [%0], %1;" :: "r"(remote), "r"(v) : "memory");
}

// One step of the diagonal block's chain: if `bit` of `kept` is set, clear
// the bits that candidate suppresses (`keep_mask` = ~its row's word). A
// predicated AND, so a step is two dependent instructions.
__device__ __forceinline__ uint32_t resolve_step(uint32_t kept, uint32_t keep_mask,
                                                 uint32_t bit) {
  asm("{\n\t.reg .pred on;\n\t.reg .b32 hit;\n\t"
      "and.b32 hit, %0, %2;\n\t"
      "setp.ne.b32 on, hit, 0;\n\t"
      "@on and.b32 %0, %0, %1;\n\t}"
      : "+r"(kept) : "r"(keep_mask), "r"(bit));
  return kept;
}

// Tile k of a block (warp-uniform): slot s, row block r, word c >= r.
__device__ inline bool tile_at(int k, const int* s_neff, int here, int& s, int& r, int& c) {
  for (s = 0; s < here; ++s) {
    const int we = (s_neff[s] + 31) >> 5;
    const int tiles = we * (we + 1) / 2;
    if (k < tiles) {
      for (r = 0; k >= we - r; ++r) k -= we - r;
      c = r + k;
      return true;
    }
    k -= tiles;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
nms_mask_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                uint8_t* __restrict__ keep, int m, int n, float thr, int slots, int cluster) {
  extern __shared__ __align__(16) uint32_t smem[];
  int* s_neff = reinterpret_cast<int*>(smem);
  const Layout L = layout(n);
  // In a cluster (one slot), every block loads the slot and tests its share
  // of the tiles, writing the words into block 0's shared memory, which
  // walks the chain. The first barrier makes sure every block has started
  // before any writes to another's memory.
  const int rank = cluster > 1 ? cluster_rank() : 0;
  if (cluster > 1) cluster_arrive_relaxed();
  const int slot0 = blockIdx.x / cluster * slots;
  const int here = min(slots, m - slot0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  uint32_t* const slot_smem = smem + kHeaderWords;
  const int slot_words = L.bytes / 4;

  // Load: a warp takes one (slot, word): 32 boxes, their areas, 32 valid bits.
  for (int p = warp; p < here * L.words; p += nwarps) {
    const int s = p / L.words;
    const int w = p - s * L.words;
    const int j = (w << 5) + lane;
    uint32_t* base = slot_smem + s * slot_words;
    bool ok = false;
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // padding: IoU 0 with anything
    if (j < n) {
      const size_t g = (size_t)(slot0 + s) * n + j;
      b = reinterpret_cast<const float4*>(boxes)[g];
      ok = scores[g] > kValidCutoff;
    }
    reinterpret_cast<float4*>(base)[j] = b;
    reinterpret_cast<float*>(base + L.area)[j] = fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
    const uint32_t bits = __ballot_sync(kFull, ok);
    if (lane == 0) base[L.valid + w] = bits;
  }
  __syncthreads();
  if (threadIdx.x < here) {  // n_eff: one past the slot's last valid candidate
    const uint32_t* v = slot_smem + threadIdx.x * slot_words + L.valid;
    int e = 0;
    for (int w = L.words - 1; w >= 0; --w) {
      if (v[w]) {
        e = (w << 5) + 32 - __clz(v[w]);
        break;
      }
    }
    s_neff[threadIdx.x] = e;
  }
  __syncthreads();

  // Phase 1: sup[i][c] bit t = IoU(i, 32c + t) > thr && 32c + t > i, for the
  // tiles (r, c >= r) below n_eff; lane = row within the tile. Tile k goes
  // to warp k % nwarps of block (k / nwarps) % cluster.
  if (cluster > 1) cluster_wait();
  int s, r, c;
  for (int k = warp + rank * nwarps; tile_at(k, s_neff, here, s, r, c); k += nwarps * cluster) {
    uint32_t* base = slot_smem + s * slot_words;
    const int neff = s_neff[s];
    const int i = (r << 5) + lane;
    if (i >= neff) continue;
    uint32_t bits = 0;
    const float4* sb = reinterpret_cast<const float4*>(base);
    const float* sa = reinterpret_cast<const float*>(base + L.area);
    const float4 bi = sb[i];
    const float ai = sa[i];
    const int j0 = c << 5;
    const float4* sbj = sb + j0;
    const float* saj = sa + j0;
    const int cols = neff - j0;  // the tile's columns below n_eff
#pragma unroll
    for (int t0 = 0; t0 < 32; t0 += kChunk) {
      if (t0 >= cols) break;  // warp-uniform
      // kChunk independent tests: their loads and arithmetic first, then the
      // divisions, each of which ends in a branch to its slow path.
      float num[kChunk], den[kChunk];
      uint32_t pos = 0;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float4 bj = sbj[t0 + u];  // past n_eff: padding or masked below
        const float iw = fmaxf(fminf(bi.z, bj.z) - fmaxf(bi.x, bj.x), 0.0f);
        const float ih = fmaxf(fminf(bi.w, bj.w) - fmaxf(bi.y, bj.y), 0.0f);
        num[u] = iw * ih;                   // inter
        den[u] = (ai + saj[t0 + u]) - num[u];  // union
        // jaccard's IoU is inter / union where union > 0, else 0; where inter
        // is 0 the quotient is +0, so only inter > 0 needs the division. The
        // other lanes divide 1 by 1: a zero numerator takes the division's
        // slow path. The empty asm keeps the compiler from dividing the
        // unselected operands.
        const bool p = num[u] > 0.0f && den[u] > 0.0f;
        pos |= (uint32_t)p << u;
        num[u] = p ? num[u] : 1.0f;
        den[u] = p ? den[u] : 1.0f;
        asm("" : "+f"(num[u]), "+f"(den[u]));
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float q = num[u] / den[u];
        const float iou = (pos >> u) & 1u ? q : 0.0f;
        bits |= (uint32_t)(iou > thr) << (t0 + u);
      }
    }
    if (cols < 32) bits &= (1u << cols) - 1u;
    if (c == r) bits &= lane == 31 ? 0u : kFull << (lane + 1);  // only j > i
    if (cluster > 1) {
      store_to_rank(base + L.sup + c * L.stride + i, 0, bits);
    } else {
      base[L.sup + c * L.stride + i] = bits;
    }
  }
  if (cluster > 1) {
    cluster_arrive_release();
    cluster_wait();
    if (rank != 0) return;
  } else {
    __syncthreads();
  }

  // Phase 2: warp s walks slot s's chain; lane w holds valid / removed word w.
  if (warp >= here) return;
  s = warp;
  const uint32_t* base = slot_smem + s * slot_words;
  const uint32_t* sup = base + L.sup;
  const int neff = s_neff[s];
  const int we = (neff + 31) >> 5;
  const uint32_t valid = lane < L.words ? base[L.valid + lane] : 0u;
  uint32_t mine = 0;  // lane w: the kept bits of word w
  uint32_t removed = 0;
  const uint32_t* own = sup + min(lane, L.words - 1) * L.stride;  // lane w': word w' of each row
  for (int w = 0; w < we; ++w) {
    const int row0 = w << 5;
    // The diagonal block, loaded before the shuffle it does not need. Rows
    // past n_eff hold stale words, but their bits are never live.
    const uint32_t* diag = sup + w * L.stride + row0;
    uint32_t d[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) d[t] = diag[t];
    const uint32_t live = __shfl_sync(kFull, valid & ~removed, w);
    if (live == 0) continue;  // uniform: every lane holds the same live word
    uint32_t kept = live;  // a bit still set when its turn comes is kept
#pragma unroll
    for (int t = 0; t < 32; ++t) kept = resolve_step(kept, ~d[t], 1u << t);
    if (lane == w) mine = kept;
    if (lane > w && lane < we) {
      uint32_t acc = 0;
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        if ((kept >> t) & 1u) acc |= own[row0 + t];
      }
      removed |= acc;
    }
  }

  // keep[slot, k] = bit k: 4 bytes a lane where aligned, single bytes at the ends.
  uint8_t* out = keep + (size_t)(slot0 + s) * n;
  const int mis = (int)(reinterpret_cast<uintptr_t>(out) & 3u);
  const int head = min(n, (4 - mis) & 3);
  const int body = (n - head) >> 2;
  const int tail0 = head + 4 * body;
  {
    const uint32_t w0 = __shfl_sync(kFull, mine, 0);
    if (lane < head) out[lane] = (w0 >> lane) & 1u;
    const int k = tail0 + lane;
    const uint32_t wt = __shfl_sync(kFull, mine, (k >> 5) & 31);
    if (k < n) out[k] = (wt >> (k & 31)) & 1u;
  }
  for (int q0 = 0; q0 < body; q0 += 32) {
    const int q = q0 + lane;
    const int k = head + 4 * q;
    const uint32_t lo = __shfl_sync(kFull, mine, (k >> 5) & 31);
    const uint32_t hi = __shfl_sync(kFull, mine, ((k + 3) >> 5) & 31);
    if (q < body) {
      const uint32_t x = __funnelshift_r(lo, hi, k & 31) & 0xfu;
      reinterpret_cast<uint32_t*>(out + k)[0] =
          (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
    }
  }
}

int sm_count(int dev) {
  static int cached[64];
  if (dev < 0 || dev >= 64) return 132;
  if (!cached[dev]) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || v <= 0)
      return -1;
    cached[dev] = v;
  }
  return cached[dev];
}

}  // namespace

// The launch plan for (m, n) on `sms` SMs: out = {slots a block, threads a
// block, blocks, dynamic shared bytes, blocks a cluster}. The tests hold
// ops/cuda/nms.py::launch_plan against it.
extern "C" void ssds_nms_plan(int m, int n, int sms, int* out) {
  const Plan p = plan(m, n, sms);
  out[0] = p.slots;
  out[1] = p.threads;
  out[2] = p.blocks;
  out[3] = p.smem;
  out[4] = p.cluster;
}

// boxes [m, n, 4] f32, scores [m, n] f32, keep [m, n] uint8, all contiguous
// on the current device. Launches on `stream`; returns a cudaError_t.
extern "C" int ssds_nms_mask(const float* boxes, const float* scores, uint8_t* keep,
                             int m, int n, float thr, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (n > kMaxN) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count(dev);
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const Plan p = plan(m, n, sms);
  if (p.smem > 48 * 1024) {
    static bool raised[64];
    if (dev >= 64 || !raised[dev]) {
      err = cudaFuncSetAttribute(nms_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) raised[dev] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, nms_mask_kernel, boxes, scores, keep, m, n, thr, p.slots,
                           p.cluster);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
