// Any-order segment sum over a 2-D grid: the backward of the flow-LUT
// gather when the events are not sorted by LUT cell.
//
// Replaces the TPU kernel motionpriorcmax_tpu/ops/pallas/iwe_vote.py::
// segment_sum_pallas (:481), the 'pallas' backward of ops/events.py::
// grid_gather (:526-531):
//
//   out[b, r, x, c] = sum over events e with rows[b, e] == r and
//                     cols[b, e] == x of g[b, e, c]
//
// On the TPU that is one call of the any-order IWE-vote kernel per channel
// (integer coordinates make its bilinear taps one-hots), with bf16 tap
// tiles on the matrix unit.  Here it is the exact f32 function of the JAX
// 'native' scatter (ops/events.py:557-560).
//
// Bound: memory.  At the flow-training shape (B = 14, M = 2^20, C = 2, LUT
// [1800, 160]) each event with a nonzero cotangent needs its row and
// column (8 bytes) and its C floats (8 bytes), every event its C floats,
// and the 32 MB grid is written once: at most 267 MB, ~80 us at 3.35 TB/s.
// The grid fits in the 50 MB L2, so the atomics resolve there.
//
// Design: the caller zeroes the grid; one thread per event, consecutive
// threads on consecutive events (coalesced loads), C f32 atomic adds into
// the grid.  An event whose C cotangents are all zero makes no atomics and
// does not read its indices: the collate pads each polarity half with rows
// y = x = bin = 0, whose vote weight (valid = 0) gives them a zero
// cotangent, and unskipped they would all add into cell (0, 0), ~48k
// same-address atomics per sample at capacity 2^20.  Adding zero changes
// nothing, so the skip is exact.  The atomics add in a run-dependent order:
// a cell's sum is the same f32 sum as the plain version's up to that order.
// Indices are clamped into range (the caller's contract is in-range
// indices; the clamp keeps a broken caller inside the grid) and offsets
// are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int C>
__global__ void __launch_bounds__(kThreads)
grid_segment_sum_kernel(const int* __restrict__ rows,
                        const int* __restrict__ cols,
                        const float* __restrict__ g, float* __restrict__ out,
                        long long n_events, int m, int r, int x) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_events) return;
  float v[C];
  bool any = false;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    v[ch] = __ldg(g + i * C + ch);
    any |= v[ch] != 0.0f;
  }
  if (!any) return;
  const long long b = i / m;
  const int row = min(max(__ldg(rows + i), 0), r - 1);
  const int col = min(max(__ldg(cols + i), 0), x - 1);
  float* dst = out + ((b * r + row) * (long long)x + col) * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch)
    if (v[ch] != 0.0f) atomicAdd(dst + ch, v[ch]);
}

}  // namespace

extern "C" {

// rows/cols [B, M] int32, g [B, M, C] f32, out [B, R, X, C] f32 zeroed by
// the caller; all contiguous; C in {1, 2, 4, 6, 8} (2 * the number of
// reference times).
int grid_segment_sum(const int* rows, const int* cols, const float* g,
                     float* out, int batch, int m, int r, int x, int c,
                     void* stream) {
  if (batch < 0 || m < 0 || r < 1 || x < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)batch * m;
  if (n == 0) return 0;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  switch (c) {
    case 1: grid_segment_sum_kernel<1><<<blocks, kThreads, 0, st>>>(rows, cols, g, out, n, m, r, x); break;
    case 2: grid_segment_sum_kernel<2><<<blocks, kThreads, 0, st>>>(rows, cols, g, out, n, m, r, x); break;
    case 4: grid_segment_sum_kernel<4><<<blocks, kThreads, 0, st>>>(rows, cols, g, out, n, m, r, x); break;
    case 6: grid_segment_sum_kernel<6><<<blocks, kThreads, 0, st>>>(rows, cols, g, out, n, m, r, x); break;
    case 8: grid_segment_sum_kernel<8><<<blocks, kThreads, 0, st>>>(rows, cols, g, out, n, m, r, x); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
