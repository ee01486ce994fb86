// Flow-LUT gather (the event warp's lookup) and its backward, the sorted
// segment sum over LUT cells.
//
// Replaces the TPU kernel motionpriorcmax_tpu/ops/pallas/lut_gather.py::
// lut_gather_sorted, which serves twice on the flow-training path:
//   * the warp's forward, ops/events.py::_grid_gather_fwd (:513-523):
//       out[b, e, :] = lut[b, rows[b, e], cols[b, e], :]
//   * the boundary gather of the warp's backward,
//     ops/events.py::_segment_sum_sorted_batch_pallas (:420-468), which
//     forms d lut from a cumulative sum of the event cotangents gathered at
//     the cell boundaries `cell_ends`.
// The TPU kernel is a banded one-hot contraction on the matrix unit.  Here
// the forward is a plain gather, and the backward is one segmented
// reduction: events arrive sorted by flat LUT cell id within each of S
// segments (S = 2 for polarity-packed batches, data/host_ops.py::
// lut_cell_sort), so each cell's events are S contiguous runs:
//
//   flat entry j = s * cells + cell covers events [ends[j - 1], ends[j])
//   (ends[-1] = 0; the first cell of segment s starts at the last end of
//   segment s - 1, events.py:413-417), and
//   d lut[b, cell, :] = sum over its S runs of g[b, e, :].
//
// Each cell's events are summed in a fixed order (segment 0 first):
// deterministic, with the f32 rounding of the cell's own few terms, where
// the JAX cumsum difference carries the rounding of a running sum over the
// whole array.
//
// Bound: memory.  At the flow-training shape (B = 14, M = 2^20 events,
// LUT [1800, 160, 2] f32, S = 2) the forward needs 8 bytes of indices and
// 8 bytes of output per event plus the 32 MB LUT read once: 267 MB, ~80 us
// at 3.35 TB/s.  The backward reads 8 bytes of cotangent per event and the
// 32 MB of cell ends, and writes the 32 MB d lut: 181 MB, ~54 us.
//
// Design: the forward runs one thread per event, reading its row and column
// once and its C channels as one run (coalesced stores of C floats per
// thread).  The backward runs one thread per (batch, cell): neighbouring
// threads walk neighbouring runs of the sorted events (~2 events each at
// the DSEC shape), so their reads coalesce, and no atomics are needed.  A
// run longer than 32 events would serialize one thread (the padding rows
// of a segment all sit in cell 0, ~50k of them): the whole warp sums such a
// run, lanes striding it and a fixed butterfly of shuffles combining them.
// Indices are clamped into range
// before use: the caller's contract is in-range rows, columns and ends,
// and the clamp keeps a broken caller from reading outside the arrays.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lut_gather_kernel(const float* __restrict__ lut, const int* __restrict__ rows,
                  const int* __restrict__ cols, float* __restrict__ out,
                  long long n_events, int m, int r, int x, int c) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_events) return;
  const long long b = i / m;
  const int row = min(max(__ldg(rows + i), 0), r - 1);
  const int col = min(max(__ldg(cols + i), 0), x - 1);
  const float* src = lut + ((b * r + row) * (long long)x + col) * c;
  float* dst = out + i * c;
  for (int ch = 0; ch < c; ++ch) dst[ch] = __ldg(src + ch);
}

// Runs longer than this are summed by the whole warp (padding rows all fall
// in cell 0 of their segment: a run of ~50k events at the DSEC shape).
constexpr int kLongRun = 32;

template <int C>
__global__ void __launch_bounds__(kThreads)
lut_segsum_kernel(const float* __restrict__ g, const int* __restrict__ ends,
                  float* __restrict__ dlut, int batch, int cells, int segs,
                  int m) {
  constexpr unsigned kFull = 0xffffffffu;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  // Every lane stays to the end: the long runs are summed warp-wide.
  const bool live = i < (long long)batch * cells;
  const long long b = live ? i / cells : 0;
  const int cell = live ? (int)(i - b * cells) : 0;
  const int lane = threadIdx.x & 31;
  const int* eb = ends + b * (long long)segs * cells;
  float acc[C];
  for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
  for (int s = 0; s < segs; ++s) {
    int lo = 0, hi = 0;
    if (live) {
      const long long j = (long long)s * cells + cell;
      lo = j == 0 ? 0 : min(max(__ldg(eb + j - 1), 0), m);
      hi = min(max(__ldg(eb + j), lo), m);
    }
    const bool is_long = hi - lo > kLongRun;
    if (!is_long) {
      const float* gb = g + (b * m + lo) * (long long)C;
      for (int e = 0; e < hi - lo; ++e)
        for (int ch = 0; ch < C; ++ch) acc[ch] += __ldg(gb + e * C + ch);
    }
    // Long runs, one at a time in lane order: lanes stride the run
    // (coalesced), then a butterfly of shuffles adds the 32 partial sums
    // in a fixed order, so the result does not depend on scheduling.
    unsigned todo = __ballot_sync(kFull, is_long);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int rlo = __shfl_sync(kFull, lo, src);
      const int rhi = __shfl_sync(kFull, hi, src);
      const long long rb = __shfl_sync(kFull, b, src);
      const float* gr = g + rb * m * (long long)C;
      float part[C];
      for (int ch = 0; ch < C; ++ch) part[ch] = 0.0f;
#pragma unroll 8
      for (int e = rlo + lane; e < rhi; e += 32)
        for (int ch = 0; ch < C; ++ch) part[ch] += __ldg(gr + (long long)e * C + ch);
      for (int off = 16; off > 0; off >>= 1)
        for (int ch = 0; ch < C; ++ch)
          part[ch] += __shfl_xor_sync(kFull, part[ch], off);
      if (lane == src)
        for (int ch = 0; ch < C; ++ch) acc[ch] += part[ch];
    }
  }
  if (live) {
    float* dst = dlut + i * C;
    for (int ch = 0; ch < C; ++ch) dst[ch] = acc[ch];
  }
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// lut [B, R, X, C], rows/cols [B, M] int32, out [B, M, C]; all contiguous.
int lut_gather_fwd(const float* lut, const int* rows, const int* cols,
                   float* out, int batch, int m, int r, int x, int c,
                   void* stream) {
  const long long n = (long long)batch * m;
  if (n == 0) return 0;
  lut_gather_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      lut, rows, cols, out, n, m, r, x, c);
  return (int)cudaGetLastError();
}

// g [B, M, C], ends [B, S * cells] int32, dlut [B, cells, C]; contiguous;
// C in {1, 2, 4, 6, 8} (2 * the number of reference times).
int lut_segsum_bwd(const float* g, const int* ends, float* dlut, int batch,
                   int cells, int segs, int m, int c, void* stream) {
  const long long n = (long long)batch * cells;
  if (n == 0) return 0;
  const dim3 grid(blocks_for(n));
  cudaStream_t st = (cudaStream_t)stream;
  switch (c) {
    case 1: lut_segsum_kernel<1><<<grid, kThreads, 0, st>>>(g, ends, dlut, batch, cells, segs, m); break;
    case 2: lut_segsum_kernel<2><<<grid, kThreads, 0, st>>>(g, ends, dlut, batch, cells, segs, m); break;
    case 4: lut_segsum_kernel<4><<<grid, kThreads, 0, st>>>(g, ends, dlut, batch, cells, segs, m); break;
    case 6: lut_segsum_kernel<6><<<grid, kThreads, 0, st>>>(g, ends, dlut, batch, cells, segs, m); break;
    case 8: lut_segsum_kernel<8><<<grid, kThreads, 0, st>>>(g, ends, dlut, batch, cells, segs, m); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
