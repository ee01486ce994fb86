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
// Design: the caller zeroes the grid.  A thread takes 4 consecutive events:
// their C cotangents as C 16-byte loads, and, when all 4 are live, their
// rows and columns as one 16-byte load each (consecutive threads on
// consecutive events: coalesced).  Each live event then adds its C
// cotangents into its cell with one vector reduction (C = 2:
// atomicAdd(float2 *), C = 4 and 8: float4, C = 6: three float2, C = 1: a
// scalar), one L2 request where the scalar atomics made C: the L2 resolves
// requests, not floats, at ~7e10 per second (PERF.md).  An event
// whose C cotangents are all zero makes no request, and a thread whose 4
// events all have zero cotangents reads no index; a thread with some live
// events reads the indices of those alone.  The collate pads each polarity
// half with rows y = x = bin = 0, whose vote weight (valid = 0) gives them
// a zero cotangent; unskipped they would all add into cell (0, 0), ~48k
// same-address requests per sample at capacity 2^20.  Adding zero changes
// nothing, so the skip is exact.  The reductions add in a run-dependent
// order: a cell's sum is the same f32 sum as the plain version's up to
// that order.  Indices are clamped into range (the caller's contract is
// in-range indices; the clamp keeps a broken caller inside the grid) and
// offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEvents = 4;              // events per thread, a multiple of 4

// One event's C cotangents added into its cell (8-byte aligned; 16-byte
// for C = 4, 8): one vector reduction.
template <int C>
__device__ __forceinline__ void red_cell(float* dst, const float* v) {
  if constexpr (C == 1) {
    atomicAdd(dst, v[0]);
  } else if constexpr (C % 4 == 0) {
#pragma unroll
    for (int k = 0; k < C; k += 4)
      atomicAdd(reinterpret_cast<float4*>(dst + k),
                make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]));
  } else {
#pragma unroll
    for (int k = 0; k < C; k += 2)
      atomicAdd(reinterpret_cast<float2*>(dst + k), make_float2(v[k], v[k + 1]));
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
grid_segment_sum_kernel(const int* __restrict__ rows,
                        const int* __restrict__ cols,
                        const float* __restrict__ g, float* __restrict__ out,
                        long long n_events, int m, int r, int x) {
  const long long i0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kEvents;
  if (i0 >= n_events) return;
  const int n = (int)min((long long)kEvents, n_events - i0);
  float v[kEvents * C];
  if (n == kEvents) {                    // 16-byte aligned: i0 % 4 == 0
    const float4* g4 = reinterpret_cast<const float4*>(g + i0 * C);
#pragma unroll
    for (int k = 0; k < kEvents * C / 4; ++k) {
      const float4 t = __ldg(g4 + k);
      v[4 * k] = t.x;
      v[4 * k + 1] = t.y;
      v[4 * k + 2] = t.z;
      v[4 * k + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kEvents * C; ++k)
      v[k] = k < n * C ? __ldg(g + i0 * C + k) : 0.0f;
  }
  bool live[kEvents];
  int n_live = 0;
#pragma unroll
  for (int e = 0; e < kEvents; ++e) {
    bool any = false;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) any |= v[e * C + ch] != 0.0f;
    live[e] = any;
    n_live += any;
  }
  if (n_live == 0) return;
  int row[kEvents], col[kEvents];
  if (n_live == kEvents) {
#pragma unroll
    for (int k = 0; k < kEvents; k += 4) {
      const int4 rv = __ldg(reinterpret_cast<const int4*>(rows + i0 + k));
      const int4 cv = __ldg(reinterpret_cast<const int4*>(cols + i0 + k));
      row[k] = rv.x; row[k + 1] = rv.y; row[k + 2] = rv.z; row[k + 3] = rv.w;
      col[k] = cv.x; col[k + 1] = cv.y; col[k + 2] = cv.z; col[k + 3] = cv.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kEvents; ++e)
      if (live[e]) {
        row[e] = __ldg(rows + i0 + e);
        col[e] = __ldg(cols + i0 + e);
      }
  }
#pragma unroll
  for (int e = 0; e < kEvents; ++e) {
    if (!live[e]) continue;
    const long long b = (i0 + e) / m;
    const int rr = min(max(row[e], 0), r - 1);
    const int cc = min(max(col[e], 0), x - 1);
    red_cell<C>(out + ((b * r + rr) * (long long)x + cc) * C, v + e * C);
  }
}

}  // namespace

extern "C" {

// rows/cols [B, M] int32, g [B, M, C] f32, out [B, R, X, C] f32 zeroed by
// the caller; all contiguous and 16-byte aligned; C in {1, 2, 4, 6, 8}
// (2 * the number of reference times).
int grid_segment_sum(const int* rows, const int* cols, const float* g,
                     float* out, int batch, int m, int r, int x, int c,
                     void* stream) {
  if (batch < 0 || m < 0 || r < 1 || x < 1) return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)rows | (uintptr_t)cols | (uintptr_t)g | (uintptr_t)out) &
       15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)batch * m;
  if (n == 0) return 0;
  const long long threads = (n + kEvents - 1) / kEvents;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
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
