// Native host-side event-pipeline kernels (the port's own copy of the JAX
// package's motionpriorcmax_tpu/native/event_ops.cc; the functions and their
// arithmetic are the same, so the outputs are too).
//
// They replace the reference's Numba JIT layer (src/loader/dsec/loader.py
// event-window refine, src/loader/utils/representation.py voxel vote) with
// ahead-of-time C++, and run on the data loader's pool threads: ctypes
// releases the GIL for the call.  The card-side voxelizer of
// --device-voxelize is ops/events.py::voxel_grid_from_events; these are the
// host paths (the host voxel grid, the DSEC event packing, the flow-LUT cell
// sort).
//
// Bound with ctypes (native/__init__.py); plain C ABI, no pybind11.

#include <cstdint>
#include <cmath>
#include <algorithm>

extern "C" {

// First index i with t[i] >= value (lower_bound).  The reference's
// get_time_indices_offsets start/end offsets are both lower_bound queries.
int64_t lower_bound_i64(const int64_t* t, int64_t n, int64_t value) {
  return std::lower_bound(t, t + n, value) - t;
}

// Trilinear (x, y, t) vote into a [num_bins, H, W] grid.
// Coordinates may be fractional; t_norm is in units of bins.
// Semantics match representation.py:95-109 (8-corner vote, value 2p-1).
void voxelize_trilinear(const float* x, const float* y, const float* t_norm,
                        const float* p, int64_t n_events, int64_t num_bins,
                        int64_t height, int64_t width, float* grid /*zeroed*/) {
  for (int64_t i = 0; i < n_events; ++i) {
    const float value = 2.0f * p[i] - 1.0f;
    const float xf = std::floor(x[i]);
    const float yf = std::floor(y[i]);
    const float tf = std::floor(t_norm[i]);
    for (int dx = 0; dx < 2; ++dx) {
      const float xi = xf + dx;
      if (xi < 0 || xi >= width) continue;
      const float wx = 1.0f - std::fabs(xi - x[i]);
      for (int dy = 0; dy < 2; ++dy) {
        const float yi = yf + dy;
        if (yi < 0 || yi >= height) continue;
        const float wy = 1.0f - std::fabs(yi - y[i]);
        for (int dt = 0; dt < 2; ++dt) {
          const float ti = tf + dt;
          if (ti < 0 || ti >= num_bins) continue;
          const float wt = 1.0f - std::fabs(ti - t_norm[i]);
          const int64_t idx =
              (static_cast<int64_t>(ti) * height + static_cast<int64_t>(yi)) *
                  width + static_cast<int64_t>(xi);
          grid[idx] += value * wx * wy * wt;
        }
      }
    }
  }
}

// Two-tap temporal vote for integer pixel coordinates
// (representation.py:85-94 fast path).
void voxelize_temporal(const int32_t* x, const int32_t* y, const float* t_norm,
                       const float* p, int64_t n_events, int64_t num_bins,
                       int64_t height, int64_t width, float* grid /*zeroed*/) {
  for (int64_t i = 0; i < n_events; ++i) {
    if (x[i] < 0 || x[i] >= width || y[i] < 0 || y[i] >= height) continue;
    const float value = 2.0f * p[i] - 1.0f;
    const float tf = std::floor(t_norm[i]);
    const int64_t base = static_cast<int64_t>(y[i]) * width + x[i];
    for (int dt = 0; dt < 2; ++dt) {
      const float ti = tf + dt;
      if (ti < 0 || ti >= num_bins) continue;
      const float wt = 1.0f - std::fabs(ti - t_norm[i]);
      grid[static_cast<int64_t>(ti) * height * width + base] += value * wt;
    }
  }
}

// DSEC per-sample event assembly (loader.py:152-161): rectify via the LUT,
// normalize t to [0, 1], assign voxel-bin indices, bounds-mask, and pack
// (y, x, t, p, bin) float32 rows.  Returns the number of packed rows.
int64_t pack_dsec_events(const uint16_t* x, const uint16_t* y,
                         const int64_t* t, const uint8_t* p, int64_t n_events,
                         const float* rectify_map /* [H][W][2] = (x,y) */,
                         int64_t height, int64_t width, int64_t num_bins,
                         float* out /* [n_events][5] */) {
  if (n_events == 0) return 0;
  const int64_t t0 = t[0];
  int64_t t_span = t[n_events - 1] - t0;
  if (t_span <= 0) t_span = 1;
  const double inv_span = 1.0 / static_cast<double>(t_span);
  int64_t m = 0;
  for (int64_t i = 0; i < n_events; ++i) {
    const int64_t lut = (static_cast<int64_t>(y[i]) * width + x[i]) * 2;
    const float xr = rectify_map[lut];
    const float yr = rectify_map[lut + 1];
    if (yr < 0 || yr >= height || xr < 0 || xr >= width) continue;
    const double tn = static_cast<double>(t[i] - t0) * inv_span;
    // bin = clip(searchsorted(linspace(0,1,nb+1), t) - 1, 0, .) which for
    // uniform edges is floor(t * nb) clipped, except t == exact edge k/nb
    // maps to bin k-1 (searchsorted 'left' semantics).
    int64_t bin = static_cast<int64_t>(std::ceil(tn * num_bins)) - 1;
    if (bin < 0) bin = 0;
    if (bin >= num_bins) bin = num_bins - 1;
    float* row = out + m * 5;
    row[0] = yr;
    row[1] = xr;
    row[2] = static_cast<float>(tn);
    row[3] = static_cast<float>(p[i]);
    row[4] = static_cast<float>(bin);
    ++m;
  }
  return m;
}

// Cell-sort one segment of padded event rows [m][6] by the y-major flow-LUT
// cell id ((y//s)*num_bins + bin)*wq + (x//s) — the key contract of
// data/host_ops.py::lut_cell_keys — and emit per-cell right boundaries.
// Counting sort: O(m + cells), stable, ~20x numpy argsort at 1M events.
// `counts` is caller-provided zeroed scratch of num_cells int32.
void lut_cell_sort_segment(const float* events /*[m][6]*/, int64_t m,
                           int64_t hq, int64_t wq, int64_t num_bins,
                           float superpixel, float* out /*[m][6]*/,
                           int32_t* ends /*[num_cells]*/,
                           int32_t* counts /*[num_cells] zeroed*/,
                           int32_t* keys /*[m] scratch*/) {
  const int64_t cells = hq * num_bins * wq;
  for (int64_t i = 0; i < m; ++i) {
    const float* row = events + i * 6;
    int64_t iy = static_cast<int64_t>(std::floor(row[0] / superpixel));
    int64_t it = static_cast<int64_t>(row[4]);
    int64_t ix = static_cast<int64_t>(std::floor(row[1] / superpixel));
    iy = std::min(std::max(iy, int64_t{0}), hq - 1);
    it = std::min(std::max(it, int64_t{0}), num_bins - 1);
    ix = std::min(std::max(ix, int64_t{0}), wq - 1);
    const int64_t key = (iy * num_bins + it) * wq + ix;
    keys[i] = static_cast<int32_t>(key);
    counts[key] += 1;
  }
  // Exclusive prefix sums -> placement offsets; inclusive -> ends.
  int32_t running = 0;
  for (int64_t c = 0; c < cells; ++c) {
    const int32_t n = counts[c];
    counts[c] = running;          // becomes the write offset
    running += n;
    ends[c] = running;
  }
  for (int64_t i = 0; i < m; ++i) {
    const int64_t dst = counts[keys[i]]++;
    const float* src = events + i * 6;
    float* d = out + dst * 6;
    d[0] = src[0]; d[1] = src[1]; d[2] = src[2];
    d[3] = src[3]; d[4] = src[4]; d[5] = src[5];
  }
}

}  // extern "C"
