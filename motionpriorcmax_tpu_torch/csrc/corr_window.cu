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

// ---------------------------------------------------------------------------
// Backward: the transpose of the fused lookup above.
//
// Replaces the TPU kernel motionpriorcmax_tpu/ops/pallas/corr_window.py
// (_bwd_kernel, launched by _vjp_bwd) together with the autodiff transpose
// of the bilinear combine in models/raft_spline/corr.py::_window_lookup.
//
// Per query n, from the feature cotangent g[k] (k = dy * (2r+1) + dx, read
// from its channel slab of the [B, C, Q] cotangent):
//   G[i][j] = sum of the up to four bilinear weights times their g:
//             (1-fy)(1-fx) g[i][j] + (1-fy) fx g[i][j-1]
//             + fy (1-fx) g[i-1][j] + fy fx g[i-1][j-1]   (g = 0 off 0..2r)
//   d corr[n] = G at the window taps (y0 - r + i, x0 - r + j) that lie in
//             the map, 0 everywhere else (out-of-range taps drop theirs),
//             rounded to the volume's dtype
//   d cx[n]  = sum_k g[k] ((1-fy)(w[dy][dx+1] - w[dy][dx])
//                          + fy (w[dy+1][dx+1] - w[dy+1][dx]))
//   d cy[n]  = sum_k g[k] ((1-fx)(w[dy+1][dx] - w[dy][dx])
//                          + fx (w[dy+1][dx+1] - w[dy][dx+1]))
// (fx = cx - floor(cx) carries the coordinate's gradient; floor has none.)
//
// Bound: the d corr write.  At the B=6 training shapes a level-1 launch
// writes 5 * 6 * 3072 maps of 48 x 64 f32, 1.13 GB, against ~67 MB of
// window, cotangent and coordinate reads: ~0.36 ms at 3.35 TB/s; levels 2-4
// write 57, 14 and 4 MB.
//
// Design: a block of 256 threads owns a tile of 32 consecutive queries,
// whole maps, so no two blocks write one address: no atomics, and the
// result is deterministic.
//   A. 32 threads turn the centres into origin and fractions (the forward's
//      clamp and cast) and the cotangent's slab offset;
//   B. all threads stage the 32 windows (re-read from the volume, the
//      forward's phase B) and the 32 x 81 cotangents in shared memory; a
//      warp reads one k of 32 consecutive queries, 128 coalesced bytes;
//   C. thread (query, tap) gathers G; warp w reduces d cx, d cy of queries
//      w, w + 8, ... with shuffles;
//   D. the block writes its 32 maps in one pass, zeros and window taps
//      together, four values per thread store (16 bytes in f32) when the
//      map width is a multiple of 4, each element written exactly once.
// Offsets into the volume, the cotangent and d corr are 64-bit, as in the
// forward (the B=6 level-1 d corr has 2.8e8 elements).

template <typename T>
struct Store4;

template <>
struct Store4<float> {
  __device__ __forceinline__ static void put(float* p, float a, float b,
                                             float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  }
  __device__ __forceinline__ static void put1(float* p, float a) { *p = a; }
};

template <>
struct Store4<__nv_bfloat16> {
  __device__ __forceinline__ static void put(__nv_bfloat16* p, float a,
                                             float b, float c, float d) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
    __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
    uint2 v;
    v.x = *reinterpret_cast<unsigned int*>(&lo);
    v.y = *reinterpret_cast<unsigned int*>(&hi);
    *reinterpret_cast<uint2*>(p) = v;
  }
  __device__ __forceinline__ static void put1(__nv_bfloat16* p, float a) {
    *p = __float2bfloat16_rn(a);
  }
};

template <typename T, bool kVec4>
__global__ void __launch_bounds__(kThreads)
corr_window_lookup_bwd_kernel(const T* __restrict__ corr,
                              const float* __restrict__ cx,
                              const float* __restrict__ cy,
                              const float* __restrict__ g,
                              T* __restrict__ d_corr,
                              float* __restrict__ d_cx,
                              float* __restrict__ d_cy,
                              long long n_queries, int h2, int w2, int batch,
                              int q_per_map, int c_total, int chan_off) {
  constexpr int R = kRadius;
  constexpr int kWin = 2 * R + 2;
  constexpr int kWin2 = kWin * kWin;
  constexpr int kStride = kWin2 + 1;
  constexpr int kSide = 2 * R + 1;
  constexpr int kFeat = kSide * kSide;
  constexpr int kGStride = kFeat + 2;          // odd: conflict-free reads
  constexpr int kWarps = kThreads / 32;
  __shared__ float s_win[kTile * kStride];
  __shared__ float s_g[kTile * kGStride];
  __shared__ float s_cot[kTile * kStride];     // G, the window cotangent
  __shared__ float s_fx[kTile], s_fy[kTile];
  __shared__ int s_x0[kTile], s_y0[kTile];
  __shared__ long long s_base[kTile];

  const long long tile0 = (long long)blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // A. Centres -> origin, fractions, cotangent offset (as the forward).
  if (tid < kTile) {
    const long long n = tile0 + tid;
    if (n < n_queries) {
      const float x = cx[n];
      const float y = cy[n];
      float xf = floorf(x);
      float yf = floorf(y);
      s_fx[tid] = x - xf;
      s_fy[tid] = y - yf;
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
    } else {
      s_fx[tid] = 0.0f;
      s_fy[tid] = 0.0f;
      s_x0[tid] = -(1 << 20);
      s_y0[tid] = -(1 << 20);
      s_base[tid] = 0;
    }
  }
  __syncthreads();

  // B. The tile's windows (zero outside the map) and cotangents.
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
  for (int e = tid; e < kFeat * kTile; e += kThreads) {
    const int k = e / kTile;
    const int ql = e - k * kTile;
    s_g[ql * kGStride + k] =
        (tile0 + ql < n_queries)
            ? g[s_base[ql] + (long long)k * q_per_map] : 0.0f;
  }
  __syncthreads();

  // C1. G[i][j], gathered from the up to four features that read tap (i, j).
  for (int e = tid; e < kTile * kWin2; e += kThreads) {
    const int ql = e / kWin2;
    const int rem = e - ql * kWin2;
    const int i = rem / kWin;
    const int j = rem - i * kWin;
    const float fx = s_fx[ql];
    const float fy = s_fy[ql];
    const float* gq = &s_g[ql * kGStride];
    float acc = 0.0f;
    if (i < kSide && j < kSide) acc += (1.0f - fy) * (1.0f - fx) * gq[i * kSide + j];
    if (i < kSide && j > 0) acc += (1.0f - fy) * fx * gq[i * kSide + j - 1];
    if (i > 0 && j < kSide) acc += fy * (1.0f - fx) * gq[(i - 1) * kSide + j];
    if (i > 0 && j > 0) acc += fy * fx * gq[(i - 1) * kSide + j - 1];
    s_cot[ql * kStride + rem] = acc;
  }
  // C2. d cx, d cy: one warp per query, shuffle reduction.
  for (int ql = warp; ql < kTile; ql += kWarps) {
    const long long n = tile0 + ql;
    if (n >= n_queries) continue;                  // uniform in the warp
    const float fx = s_fx[ql];
    const float fy = s_fy[ql];
    const float* w = &s_win[ql * kStride];
    const float* gq = &s_g[ql * kGStride];
    float ax = 0.0f, ay = 0.0f;
    for (int k = lane; k < kFeat; k += 32) {
      const int dy = k / kSide;
      const int dx = k - dy * kSide;
      const float* p = &w[dy * kWin + dx];
      const float gk = gq[k];
      ax += gk * ((1.0f - fy) * (p[1] - p[0]) + fy * (p[kWin + 1] - p[kWin]));
      ay += gk * ((1.0f - fx) * (p[kWin] - p[0]) + fx * (p[kWin + 1] - p[1]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ax += __shfl_xor_sync(0xffffffffu, ax, off);
      ay += __shfl_xor_sync(0xffffffffu, ay, off);
    }
    if (lane == 0) {
      d_cx[n] = ax;
      d_cy[n] = ay;
    }
  }
  __syncthreads();

  // D. The tile's maps: G at the in-range window taps, zero elsewhere.
  // Offsets inside the tile are 32-bit (the launcher checks kTile * H2 * W2
  // against 2^31); the tile's base is 64-bit.
  const int hw = h2 * w2;
  const int n_maps =
      (n_queries - tile0 < kTile) ? (int)(n_queries - tile0) : kTile;
  T* base = d_corr + tile0 * (long long)hw;
  if (kVec4) {
    const int total4 = n_maps * (hw / 4);
    for (int v = tid; v < total4; v += kThreads) {
      const int e = v * 4;
      const int ql = e / hw;
      const int off = e - ql * hw;
      const int row = off / w2;
      const int col = off - row * w2;
      const int ii = row - s_y0[ql];
      const int jj = col - s_x0[ql];
      float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (ii >= 0 && ii < kWin) {
        const float* gc = &s_cot[ql * kStride + ii * kWin];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (jj + c >= 0 && jj + c < kWin) o[c] = gc[jj + c];
        }
      }
      Store4<T>::put(base + e, o[0], o[1], o[2], o[3]);
    }
  } else {
    const int total = n_maps * hw;
    for (int e = tid; e < total; e += kThreads) {
      const int ql = e / hw;
      const int off = e - ql * hw;
      const int row = off / w2;
      const int col = off - row * w2;
      const int ii = row - s_y0[ql];
      const int jj = col - s_x0[ql];
      float o = 0.0f;
      if (ii >= 0 && ii < kWin && jj >= 0 && jj < kWin) {
        o = s_cot[ql * kStride + ii * kWin + jj];
      }
      Store4<T>::put1(base + e, o);
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const T* corr, const float* cx, const float* cy,
                       const float* g, T* d_corr, float* d_cx, float* d_cy,
                       long long n, int h2, int w2, int batch, int q,
                       int c_total, int chan_off, dim3 grid, cudaStream_t s) {
  if (w2 % 4 == 0) {
    corr_window_lookup_bwd_kernel<T, true><<<grid, kThreads, 0, s>>>(
        corr, cx, cy, g, d_corr, d_cx, d_cy, n, h2, w2, batch, q, c_total,
        chan_off);
  } else {
    corr_window_lookup_bwd_kernel<T, false><<<grid, kThreads, 0, s>>>(
        corr, cx, cy, g, d_corr, d_cx, d_cy, n, h2, w2, batch, q, c_total,
        chan_off);
  }
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

extern "C" int corr_window_lookup_bwd(const void* corr, int corr_is_bf16,
                                      const float* cx, const float* cy,
                                      const float* g, void* d_corr,
                                      float* d_cx, float* d_cy,
                                      long long n_queries, int h2, int w2,
                                      int radius, int batch, int q_per_map,
                                      int c_total, int chan_off,
                                      void* stream) {
  if (radius != kRadius || h2 < 1 || w2 < 1 || batch < 1 ||
      q_per_map < 1 || n_queries < 0 ||
      (long long)kTile * h2 * w2 > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_queries == 0) return (int)cudaSuccess;
  const long long blocks = (n_queries + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (corr_is_bf16) {
    err = launch_bwd(static_cast<const __nv_bfloat16*>(corr), cx, cy, g,
                     static_cast<__nv_bfloat16*>(d_corr), d_cx, d_cy,
                     n_queries, h2, w2, batch, q_per_map, c_total, chan_off,
                     grid, s);
  } else {
    err = launch_bwd(static_cast<const float*>(corr), cx, cy, g,
                     static_cast<float*>(d_corr), d_cx, d_cy, n_queries, h2,
                     w2, batch, q_per_map, c_total, chan_off, grid, s);
  }
  return (int)err;
}
