// Native host-side data-plane kernels for ssds_tpu.
//
// The reference's augmentation hot loop (lib/utils/data_augment.py:_crop,
// SURVEY.md §2.6) is a Python retry loop: per sample, up to 6 modes x 50
// attempts of ROI sampling + IoU tests + center-inclusion tests. At
// production batch sizes the Python interpreter overhead dominates the host
// pipeline, so the sampling loop lives here behind a C ABI (ctypes-loaded by
// ssds_tpu/data/native.py; the numpy implementation remains as fallback and
// oracle).
//
// Distribution parity, not bitwise parity: the RNG is a xorshift64* seeded
// per call; the sampled distribution matches the reference recipe
// (SURVEY.md §7 "augmentation parity").
//
// Build: make -C native  (g++ -O3 -shared -fPIC)

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ull) {}
  uint64_t next() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545F4914F6CDD1Dull;
  }
  // uniform in [0, 1)
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  double uniform(double lo, double hi) { return lo + (hi - lo) * uniform(); }
  // integer in [0, n)
  int64_t randint(int64_t n) { return static_cast<int64_t>(uniform() * n); }
};

inline float iou(const float* a, const float* roi) {
  const float ix1 = a[0] > roi[0] ? a[0] : roi[0];
  const float iy1 = a[1] > roi[1] ? a[1] : roi[1];
  const float ix2 = a[2] < roi[2] ? a[2] : roi[2];
  const float iy2 = a[3] < roi[3] ? a[3] : roi[3];
  const float iw = ix2 - ix1 > 0.f ? ix2 - ix1 : 0.f;
  const float ih = iy2 - iy1 > 0.f ? iy2 - iy1 : 0.f;
  const float inter = iw * ih;
  const float area_a = (a[2] - a[0]) * (a[3] - a[1]);
  const float area_r = (roi[2] - roi[0]) * (roi[3] - roi[1]);
  const float uni = area_a + area_r - inter;
  return uni > 1e-12f ? inter / uni : 0.f;
}

}  // namespace

extern "C" {

// Sample an IoU-constrained crop ROI for one image.
//
//   boxes    : [n, 4] pixel corner-form GT boxes
//   n        : number of boxes
//   width/height : image size in pixels
//   seed     : RNG seed (callers pass a per-sample counter)
//   roi_out  : [4] chosen ROI (x1, y1, x2, y2) — valid when return == 1
//   mask_out : [n] 1 where the box center falls inside the ROI
//
// Returns 1 if a crop was chosen, 0 for the passthrough (mode None) path.
int ssd_sample_crop(const float* boxes, int64_t n, int64_t width,
                    int64_t height, uint64_t seed, float* roi_out,
                    uint8_t* mask_out) {
  static const float kMinIous[6] = {-1.f, 0.1f, 0.3f, 0.5f, 0.7f, 0.9f};
  Rng rng(seed);
  if (n <= 0) return 0;

  for (;;) {
    const int mode = static_cast<int>(rng.randint(6));
    if (mode == 0) return 0;  // None -> passthrough
    const float min_iou = kMinIous[mode];

    for (int attempt = 0; attempt < 50; ++attempt) {
      const double scale = rng.uniform(0.3, 1.0);
      const double min_ratio = scale * scale > 0.5 ? scale * scale : 0.5;
      const double max_ratio =
          1.0 / (scale * scale) < 2.0 ? 1.0 / (scale * scale) : 2.0;
      const double ratio = std::sqrt(rng.uniform(min_ratio, max_ratio));
      const int64_t w = static_cast<int64_t>(scale * ratio * width);
      const int64_t h = static_cast<int64_t>(scale / ratio * height);
      if (w < 1 || h < 1) continue;
      const int64_t left = rng.randint(width - w + 1);
      const int64_t top = rng.randint(height - h + 1);
      float roi[4] = {static_cast<float>(left), static_cast<float>(top),
                      static_cast<float>(left + w), static_cast<float>(top + h)};

      // constraint: every GT's IoU with the ROI >= min_iou
      bool ok = true;
      for (int64_t i = 0; i < n; ++i) {
        if (iou(boxes + 4 * i, roi) < min_iou) {
          ok = false;
          break;
        }
      }
      if (!ok) continue;

      // keep boxes whose centers fall strictly inside
      bool any = false;
      for (int64_t i = 0; i < n; ++i) {
        const float cx = 0.5f * (boxes[4 * i] + boxes[4 * i + 2]);
        const float cy = 0.5f * (boxes[4 * i + 1] + boxes[4 * i + 3]);
        const bool in = roi[0] < cx && cx < roi[2] && roi[1] < cy && cy < roi[3];
        mask_out[i] = in ? 1 : 0;
        any = any || in;
      }
      if (!any) continue;

      std::memcpy(roi_out, roi, sizeof roi);
      return 1;
    }
  }
}

// Translate + clip boxes into a chosen ROI, in place.
//   boxes : [n, 4] pixel corner-form (already filtered by mask)
void ssd_crop_boxes(float* boxes, int64_t n, const float* roi) {
  for (int64_t i = 0; i < n; ++i) {
    float* b = boxes + 4 * i;
    b[0] = (b[0] > roi[0] ? b[0] : roi[0]) - roi[0];
    b[1] = (b[1] > roi[1] ? b[1] : roi[1]) - roi[1];
    b[2] = (b[2] < roi[2] ? b[2] : roi[2]) - roi[0];
    b[3] = (b[3] < roi[3] ? b[3] : roi[3]) - roi[1];
  }
}

}  // extern "C"
