// Native host-side ingest hot ops for lirec-tpu.
//
// The reference's ingest bottleneck is per-sample Python: face-track ROI
// pooling over [T, C, h, w] feature grids (ref visual_utils/
// visual_features.py:105-135) and dense row assembly. These run here as
// C++ with flat float32 buffers, exposed through ctypes (native/bindings.py)
// with a numpy fallback when the shared library is unavailable.
//
// Build: python -m lirec_tpu_torch.native.build  (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Face->person bbox expansion ratios (ref visual_features.py:115-117).
static const float FH0 = 0.10f, FH1 = 0.25f;
static const float FW0 = 0.35f, FW1 = 0.65f;

// ROI-pool one track: for each element, blow the face bbox up to a person
// bbox, scale to the feature grid, and mean-pool the covered cells.
//   features: [T, C, H, W] float32
//   elems:    n_elems rows of (x, y, w, h, frame) float32
//   out:      [n_elems, C] float32 (zero rows for out-of-range frames)
void roi_pool_tracks(
    const float* features, int64_t T, int64_t C, int64_t H, int64_t W,
    const float* elems, int64_t n_elems,
    float res_h, float res_w, float sampling_fr,
    float* out) {
  const float sh = static_cast<float>(H) / res_h;
  const float sw = static_cast<float>(W) / res_w;
  const int64_t plane = H * W;
  std::memset(out, 0, sizeof(float) * n_elems * C);
  for (int64_t i = 0; i < n_elems; ++i) {
    const float fx = elems[i * 5 + 0] * 0.5f;
    const float fy = elems[i * 5 + 1] * 0.5f;
    const float fw = elems[i * 5 + 2] * 0.5f;
    const float fh = elems[i * 5 + 3] * 0.5f;
    const float frame = elems[i * 5 + 4];
    const float pw = fw / (FW1 - FW0);
    const float ph = fh / (FH1 - FH0);
    const float px = fx - FW0 * pw;
    const float py = fy - FH0 * ph;
    const float spx = px * sw, spw = pw * sw;
    const float spy = py * sh, sph = ph * sh;
    int64_t x0 = std::max<int64_t>(0, (int64_t)std::floor(spx));
    int64_t x1 = std::min<int64_t>(W, (int64_t)std::ceil(spx + spw));
    int64_t y0 = std::max<int64_t>(0, (int64_t)std::floor(spy));
    int64_t y1 = std::min<int64_t>(H, (int64_t)std::ceil(spy + sph));
    const int64_t frame_idx = (int64_t)(frame * sampling_fr);
    if (frame_idx == T) continue;  // ref :130-131 skips exactly ==T
    if (frame_idx < 0 || frame_idx > T) continue;
    const int64_t n_cells = std::max<int64_t>(0, x1 - x0) *
                            std::max<int64_t>(0, y1 - y0);
    if (n_cells == 0) continue;  // mean over empty region -> NaN in numpy;
                                 // callers never hit this on valid bboxes
    const float inv = 1.0f / static_cast<float>(n_cells);
    const float* base = features + frame_idx * C * plane;
    for (int64_t c = 0; c < C; ++c) {
      const float* ch = base + c * plane;
      float acc = 0.0f;
      for (int64_t y = y0; y < y1; ++y) {
        const float* row = ch + y * W;
        for (int64_t x = x0; x < x1; ++x) acc += row[x];
      }
      out[i * C + c] = acc * inv;
    }
  }
}

// Temporal max-pool: [T, D] -> [D].
void temporal_max(const float* x, int64_t T, int64_t D, float* out) {
  std::memcpy(out, x, sizeof(float) * D);
  for (int64_t t = 1; t < T; ++t) {
    const float* row = x + t * D;
    for (int64_t d = 0; d < D; ++d) out[d] = std::max(out[d], row[d]);
  }
}

// Dense row assembly from the deduplicated tables (host-side to_dense /
// export path): out[i] = [text[ci] | vis[ci] | track[ai] | track[bi]].
void pack_rows(
    const float* text, int64_t text_dim,
    const float* visual, int64_t visual_dim,
    const float* track, int64_t track_dim,
    const int32_t* idx,  // [n, 3] (clip, track1, track2)
    int64_t n, float* out) {
  const int64_t row_dim = text_dim + visual_dim + 2 * track_dim;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t c = idx[i * 3 + 0];
    const int32_t a = idx[i * 3 + 1];
    const int32_t b = idx[i * 3 + 2];
    float* dst = out + i * row_dim;
    std::memcpy(dst, text + (int64_t)c * text_dim, sizeof(float) * text_dim);
    dst += text_dim;
    std::memcpy(dst, visual + (int64_t)c * visual_dim,
                sizeof(float) * visual_dim);
    dst += visual_dim;
    std::memcpy(dst, track + (int64_t)a * track_dim,
                sizeof(float) * track_dim);
    dst += track_dim;
    std::memcpy(dst, track + (int64_t)b * track_dim,
                sizeof(float) * track_dim);
  }
}

}  // extern "C"
