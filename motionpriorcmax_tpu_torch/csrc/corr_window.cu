// Correlation-window lookup for RAFT-Spline, one pyramid level per launch.
//
// Replaces the TPU kernel motionpriorcmax_tpu/ops/pallas/corr_window.py
// (_fwd_kernel, launched by _run_fwd / corr_window_pallas) together with the
// shared-fraction bilinear combine that follows it in
// motionpriorcmax_tpu/models/raft_spline/corr.py::_window_lookup.
//
// What it computes, per query n (one [H2, W2] map each):
//   x0 = floor(cx[n]), y0 = floor(cy[n]), fx = cx - x0, fy = cy - y0
//   window[i][j] = corr[n, y0 - r + i, x0 - r + j]   (0 outside the map),
//                  i, j in [0, 2r + 2)
//   feat[dy * (2r+1) + dx] = (1-fy) * ((1-fx) * w[dy][dx]   + fx * w[dy][dx+1])
//                          +    fy  * ((1-fx) * w[dy+1][dx] + fx * w[dy+1][dx+1])
// and writes feat straight into its channel slab of the [B, C, Q] output:
// query n = (t * B + b) * Q + q goes to channel chan_off + t * K + k at
// position q, the layout of lookup_corr_pyramid's concat + transpose.
//
// Bound: a memory-bound gather.  Counting each needed byte once, a level-1
// launch of the EVIMO2 batch-8 path (N = 5 * 8 * 3072 maps of 48 x 64)
// reads 122,880 * 100 * 4 B = 49.2 MB of window values and ~1 MB of
// coordinates and writes 39.8 MB: ~27 us at 3.35 TB/s.  Each level 2-4
// launch (N = 24,576) is ~5.4 us.  The arithmetic (~7 flops per feature) is
// negligible.
//
// Design: a block of 256 threads owns a tile of 32 consecutive queries and
// works in three phases, so that each query costs one dependent round trip
// to memory, with many loads in flight per thread:
//   A. 32 threads read the tile's centres and keep origin, fractions and the
//      query's output offset in shared memory;
//   B. all threads load the tile's 32 windows (rows of 2r+2 contiguous
//      values) into shared memory, a fully unrolled run of independent loads
//      per thread; the row stride (2r+2)^2 + 1 is odd, so phase C reads
//      them without bank conflicts;
//   C. thread (k, query) computes one feature and stores it; a warp covers
//      one k of 32 consecutive queries: one coalesced 128-byte store into
//      the NCHW output.
// Offsets into the volume and the output are 64-bit (the batch-8 level-1
// volume has 3.8e8 elements; 2^31 is passed near batch 46).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// The lookup radius of every RAFT-Spline config; the only one built.
constexpr int kRadius = 4;
constexpr int kThreads = 256;
constexpr int kTile = 32;                      // queries per block

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_window_lookup_kernel(const T* __restrict__ corr,
                          const float* __restrict__ cx,
                          const float* __restrict__ cy,
                          float* __restrict__ out,
                          long long n_queries, int h2, int w2, int batch,
                          int q_per_map, int c_total, int chan_off) {
  constexpr int R = kRadius;
  constexpr int kWin = 2 * R + 2;
  constexpr int kWin2 = kWin * kWin;
  constexpr int kStride = kWin2 + 1;           // odd: conflict-free phase C
  constexpr int kSide = 2 * R + 1;
  constexpr int kFeat = kSide * kSide;
  __shared__ float s_win[kTile * kStride];
  __shared__ float s_fx[kTile], s_fy[kTile];
  __shared__ int s_x0[kTile], s_y0[kTile];
  __shared__ long long s_base[kTile];

  const long long tile0 = (long long)blockIdx.x * kTile;
  const int tid = threadIdx.x;

  // A. Centres -> origin, fractions, output offset.
  if (tid < kTile) {
    const long long n = tile0 + tid;
    if (n < n_queries) {
      const float x = cx[n];
      const float y = cy[n];
      // Floor in float and keep the fraction from it, as the reference does.
      float xf = floorf(x);
      float yf = floorf(y);
      s_fx[tid] = x - xf;
      s_fy[tid] = y - yf;
      // Clamp the origin before the integer cast: any origin beyond these
      // limits already gives an all-zero window, so the clamp changes
      // nothing in range and keeps a far-out coordinate well defined.
      xf = fminf(fmaxf(xf, (float)(-R - 2)), (float)(w2 + R));
      yf = fminf(fmaxf(yf, (float)(-R - 2)), (float)(h2 + R));
      s_x0[tid] = (int)xf - R;
      s_y0[tid] = (int)yf - R;
      const long long bq = (long long)batch * q_per_map;
      const long long t = n / bq;
      const long long rem = n - t * bq;
      const long long b = rem / q_per_map;
      const long long q = rem - b * q_per_map;
      s_base[tid] = (b * c_total + chan_off + t * kFeat) * q_per_map + q;
    }
  }
  __syncthreads();

  // B. The tile's windows, zero outside the map.
  constexpr int kLoads = (kTile * kWin2 + kThreads - 1) / kThreads;
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int e = tid + it * kThreads;
    if (e < kTile * kWin2) {
      const int ql = e / kWin2;
      const int rem = e - ql * kWin2;
      const int i = rem / kWin;
      const int j = rem - i * kWin;
      const long long n = tile0 + ql;
      float v = 0.0f;
      if (n < n_queries) {
        const int yy = s_y0[ql] + i;
        const int xx = s_x0[ql] + j;
        if (yy >= 0 && yy < h2 && xx >= 0 && xx < w2) {
          v = load_f32(corr + (n * h2 + yy) * (long long)w2 + xx);
        }
      }
      s_win[ql * kStride + rem] = v;
    }
  }
  __syncthreads();

  // C. One feature per (k, query); a warp stores 32 consecutive queries.
  for (int e = tid; e < kFeat * kTile; e += kThreads) {
    const int k = e / kTile;
    const int ql = e - k * kTile;
    if (tile0 + ql >= n_queries) continue;
    const int dy = k / kSide;
    const int dx = k - dy * kSide;
    const float* w = &s_win[ql * kStride + dy * kWin + dx];
    const float fx = s_fx[ql];
    const float fy = s_fy[ql];
    out[s_base[ql] + (long long)k * q_per_map] =
        (1.0f - fy) * ((1.0f - fx) * w[0] + fx * w[1])
        + fy * ((1.0f - fx) * w[kWin] + fx * w[kWin + 1]);
  }
}

template <typename T>
cudaError_t launch(const T* corr, const float* cx, const float* cy, float* out,
                   long long n, int h2, int w2, int batch, int q, int c_total,
                   int chan_off, dim3 grid, cudaStream_t s) {
  corr_window_lookup_kernel<T><<<grid, kThreads, 0, s>>>(
      corr, cx, cy, out, n, h2, w2, batch, q, c_total, chan_off);
  return cudaGetLastError();
}

}  // namespace

extern "C" int corr_window_lookup(const void* corr, int corr_is_bf16,
                                  const float* cx, const float* cy, float* out,
                                  long long n_queries, int h2, int w2,
                                  int radius, int batch, int q_per_map,
                                  int c_total, int chan_off, void* stream) {
  if (radius != kRadius || h2 < 1 || w2 < 1 || batch < 1 ||
      q_per_map < 1 || n_queries < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_queries == 0) return (int)cudaSuccess;
  const long long blocks = (n_queries + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (corr_is_bf16) {
    err = launch(static_cast<const __nv_bfloat16*>(corr), cx, cy, out,
                 n_queries, h2, w2, batch, q_per_map, c_total, chan_off, grid,
                 s);
  } else {
    err = launch(static_cast<const float*>(corr), cx, cy, out, n_queries, h2,
                 w2, batch, q_per_map, c_total, chan_off, grid, s);
  }
  return (int)err;
}
