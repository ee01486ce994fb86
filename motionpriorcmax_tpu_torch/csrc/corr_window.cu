// Correlation-window lookup for RAFT-Spline: every pyramid level in one
// launch.
//
// Replaces the TPU kernel motionpriorcmax_tpu/ops/pallas/corr_window.py
// (_fwd_kernel, launched by _run_fwd / corr_window_pallas) together with the
// shared-fraction bilinear combine that follows it in
// motionpriorcmax_tpu/models/raft_spline/corr.py::_window_lookup.
//
// What it computes, per level and per query n (one [H2, W2] map each):
//   x0 = floor(cx[n]), y0 = floor(cy[n]), fx = cx - x0, fy = cy - y0
//   window[i][j] = corr[n, y0 - r + i, x0 - r + j]   (0 outside the map),
//                  i, j in [0, 2r + 2)
//   feat[dy * (2r+1) + dx] = (1-fy) * ((1-fx) * w[dy][dx]   + fx * w[dy][dx+1])
//                          +    fy  * ((1-fx) * w[dy+1][dx] + fx * w[dy+1][dx+1])
// and writes feat straight into its channel slab of the [B, C, Q] output:
// query n = (t * B + b) * Q + q goes to channel chan_off + t * K + k at
// position q, the layout of lookup_corr_pyramid's concat + transpose.
//
// Bound: a memory-bound gather.  Counting each needed byte once, one
// refinement iteration of the EVIMO2 batch-8 path (level 1: N = 5 * 8 *
// 3072 maps of 48 x 64; levels 2-4: 24,576 maps each) moves ~121 MB: the
// in-range window values, the coordinates and the 81 features per query,
// ~36 us at 3.35 TB/s.  The arithmetic (~7 flops per feature) is
// negligible.  Each 10-value window row starts at an arbitrary offset and
// touches 2-3 32-byte sectors, so DRAM moves ~1.7x the counted bytes, and
// a gather of short rows is bound by the bytes in flight, not by issue.
//
// Design: one launch per call for all levels.  A small descriptor per level
// (volume, centres, map size, channel offset) is passed as one
// __grid_constant__ parameter; the levels' 32-query tiles form one
// concatenated range, level 1 first, so the small levels fill its tail.
// Persistent blocks of 256 threads (as many as fit on the card) walk the
// range with a stride of the grid through a 3-stage ring of window slots
// in shared memory: the windows of the next two tiles are in flight while
// a tile's 81 features are combined and stored.  Windows are staged with
// 4-byte cp.async (LDGSTS) copies, zero-filled (src-size 0) outside the
// map, for any alignment and map size; bf16 rows are copied as pairs
// aligned by address (a volume may start at an odd element), so a row may
// start one value into its staged row (the combine
// reads that offset) and a pair may straddle into a neighbouring row (the
// combine masks columns outside the map).  Per tile:
//   A. 32 threads turn the centres into origin, fractions, output offset
//      and the rows' bf16 pair offsets;
//   B. all threads issue the window copies of the tile two ahead;
//   C. thread (k, query) combines one feature and stores it; a warp covers
//      one k of 32 consecutive queries: one coalesced 128-byte store into
//      the NCHW output.  Slot strides are odd in 4-byte words, so the
//      warp's 32 windows sit in 32 different banks.
// The Hopper tensor-memory accelerator (TMA) can stage the windows too, one
// 3-D tensor-map load per window (tools/corr_window_tma.cu; `kernel_ab.py
// --staging` times both ways on level 1): a load must start at a 16-byte
// aligned column, so a box of 16 x 10 f32 lands for 10 x 10 values into
// 128-byte aligned slots; it is not kept (PERF.md has the times).  Offsets into
// the volume and the output are 64-bit (the batch-8 level-1 volume has
// 3.8e8 elements); origins are clamped before the integer cast.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

// The lookup radius of every RAFT-Spline config; the only one built.
constexpr int kRadius = 4;
constexpr int kThreads = 256;
constexpr int kTile = 32;                      // queries per tile
constexpr int kMaxLevels = 8;
constexpr int kStages = 3;                     // window slots in flight
constexpr int kLevelFields = 7;                // per level in the host table

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A staged window: (2r + 2) rows of kRow values, kSlot 4-byte words per
// window (odd); bf16 rows hold the 6 aligned pairs around the 10 values.
template <typename T> struct Slot;
template <> struct Slot<float> {
  static constexpr int kRow = 10;
  static constexpr int kWords = 101;
};
template <> struct Slot<__nv_bfloat16> {
  static constexpr int kRow = 12;
  static constexpr int kWords = 61;
};

struct LevelDesc {
  const void* corr;             // [N, H2, W2]
  const float* cx;              // [N]
  const float* cy;
  long long n;                  // queries of the level
  long long tile0;              // its first tile in the concatenated range
  int h2, w2, chan_off;
};

struct FwdParams {
  LevelDesc lv[kMaxLevels];
  float* out;
  long long n_tiles;
  int n_levels, batch, q_per_map, c_total;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kStages - 1 groups (the tiles ahead) are pending.
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
}

__device__ __forceinline__ int level_of(const FwdParams& p, long long tile) {
  int l = 0;
  while (l + 1 < p.n_levels && tile >= p.lv[l + 1].tile0) ++l;
  return l;
}

// Per-stage tile state, written in phase A by threads 0..31.
struct TileMeta {
  float fx[kTile], fy[kTile];
  int x0[kTile], y0[kTile];
  int par[kTile];               // bit i: staged row i starts one value in
  int w2;                       // the level's map width
  long long base[kTile];        // output offset of feature 0; -1: no query
};

// A. Centres -> origin, fractions, output offset (tid < kTile).
template <typename T>
__device__ __forceinline__ void stage_meta(const FwdParams& p, long long tile,
                                           TileMeta& m) {
  constexpr int R = kRadius;
  constexpr int kSide = 2 * R + 1;
  constexpr int kFeat = kSide * kSide;
  const int tid = threadIdx.x;
  if (tid >= kTile) return;
  const LevelDesc& L = p.lv[level_of(p, tile)];
  if (tid == 0) m.w2 = L.w2;
  const long long n = (tile - L.tile0) * kTile + tid;
  if (n >= L.n) {
    m.base[tid] = -1;
    m.x0[tid] = -(1 << 20);
    m.y0[tid] = -(1 << 20);
    m.par[tid] = 0;
    return;
  }
  const float x = L.cx[n];
  const float y = L.cy[n];
  // Floor in float and keep the fraction from it, as the reference does.
  float xf = floorf(x);
  float yf = floorf(y);
  m.fx[tid] = x - xf;
  m.fy[tid] = y - yf;
  // Clamp the origin before the integer cast: any origin beyond these
  // limits already gives an all-zero window, so the clamp changes nothing
  // in range and keeps a far-out coordinate well defined.
  xf = fminf(fmaxf(xf, (float)(-R - 2)), (float)(L.w2 + R));
  yf = fminf(fmaxf(yf, (float)(-R - 2)), (float)(L.h2 + R));
  const int x0 = (int)xf - R;
  const int y0 = (int)yf - R;
  m.x0[tid] = x0;
  m.y0[tid] = y0;
  int par = 0;
  if (sizeof(T) == 2) {
    // Parity of the 2-byte word address of each row's first value, the
    // element index (n * H2 + y) * W2 + x0 plus the volume's own offset (a
    // view may start at an odd element): the pair copies start at the
    // 4-byte aligned word at or below it.
    const int w_odd = L.w2 & 1;
    const int n_row = (int)(n & 1) & (L.h2 & 1);
    const int base_odd =
        (int)((reinterpret_cast<uintptr_t>(L.corr) >> 1) & 1);
#pragma unroll
    for (int i = 0; i < 2 * R + 2; ++i) {
      par |= ((((n_row ^ (y0 + i)) & w_odd) ^ x0 ^ base_odd) & 1) << i;
    }
  }
  m.par[tid] = par;
  const long long bq = (long long)p.batch * p.q_per_map;
  const long long t = n / bq;
  const long long rem = n - t * bq;
  const long long b = rem / p.q_per_map;
  const long long q = rem - b * p.q_per_map;
  m.base[tid] = (b * p.c_total + L.chan_off + t * kFeat) * p.q_per_map + q;
}

// B. Issue the copies of one tile's windows into `slot` (all threads).
template <typename T>
__device__ __forceinline__ void stage_windows(const FwdParams& p,
                                              long long tile,
                                              const TileMeta& m,
                                              float* slot) {
  constexpr int kWin = 2 * kRadius + 2;
  constexpr int kRow = Slot<T>::kRow;
  constexpr int kWords = Slot<T>::kWords;
  const int tid = threadIdx.x;
  const LevelDesc& L = p.lv[level_of(p, tile)];
  const long long first = (tile - L.tile0) * kTile;
  const int n_valid = (int)((L.n - first < kTile) ? (L.n - first) : kTile);
  const T* corr = static_cast<const T*>(L.corr);
  const long long h2 = L.h2, w2 = L.w2;
  if (sizeof(T) == 4) {
    // One value per copy: 32 windows x 10 rows x 10 values.
    for (int e = tid; e < kTile * kWin * kWin; e += kThreads) {
      const int ql = e / (kWin * kWin);
      const int rem = e - ql * kWin * kWin;
      const int i = rem / kWin;
      const int j = rem - i * kWin;
      if (ql >= n_valid) break;               // e grows: no later one fits
      const int yy = m.y0[ql] + i;
      const int xx = m.x0[ql] + j;
      const bool in = yy >= 0 && yy < h2 && xx >= 0 && xx < w2;
      const T* src = in ? corr + ((first + ql) * h2 + yy) * w2 + xx : corr;
      cp_async4(smem_u32(slot + ql * kWords + i * kRow + j), src,
                in ? 4 : 0);
    }
  } else {
    // Aligned pairs: 32 windows x 10 rows x 6 pairs cover the 10 values of
    // a row starting at an even element index at or one below its first.
    constexpr int kPairs = kRow / 2;
    const long long total = (long long)L.n * h2 * w2;
    const T* aligned = reinterpret_cast<const T*>(
        reinterpret_cast<uintptr_t>(corr) & ~uintptr_t(3));
    for (int e = tid; e < kTile * kWin * kPairs; e += kThreads) {
      const int ql = e / (kWin * kPairs);
      const int rem = e - ql * kWin * kPairs;
      const int i = rem / kPairs;
      const int pr = rem - i * kPairs;
      if (ql >= n_valid) break;
      const int yy = m.y0[ql] + i;
      const int off = (m.par[ql] >> i) & 1;
      const int c0 = m.x0[ql] - off + 2 * pr;  // column of the pair's first
      int bytes = 0;
      const T* src = aligned;                  // 4-byte aligned, read nothing
      if (yy >= 0 && yy < h2 && c0 + 1 >= 0 && c0 < w2) {
        const long long g = ((first + ql) * h2 + yy) * w2 + c0;
        src = corr + g;
        bytes = (g + 1 < total) ? 4 : 2;       // the volume's last value
      }
      cp_async4(smem_u32(slot + ql * kWords + i * kPairs + pr), src, bytes);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_window_lookup_kernel(const __grid_constant__ FwdParams p) {
  constexpr int R = kRadius;
  constexpr int kSide = 2 * R + 1;
  constexpr int kFeat = kSide * kSide;
  constexpr int kRow = Slot<T>::kRow;
  constexpr int kWords = Slot<T>::kWords;
  __shared__ float s_ring[kStages][kTile * Slot<float>::kWords];
  __shared__ TileMeta s_meta[kStages];

  const int tid = threadIdx.x;
  const long long stride = gridDim.x;
  long long tile = blockIdx.x;
  // Prologue: the first kStages - 1 tiles in flight (an empty group for a
  // tile past the end keeps one group per tile).
  for (int a = 0; a < kStages - 1; ++a) {
    const long long t = tile + a * stride;
    if (t < p.n_tiles) stage_meta<T>(p, t, s_meta[a]);
  }
  __syncthreads();
  for (int a = 0; a < kStages - 1; ++a) {
    const long long t = tile + a * stride;
    if (t < p.n_tiles) stage_windows<T>(p, t, s_meta[a], s_ring[a]);
    cp_async_commit();
  }
  for (int it = 0; tile < p.n_tiles; ++it, tile += stride) {
    const int s = it % kStages;
    const int s_ahead = (it + kStages - 1) % kStages;
    const long long ahead = tile + (kStages - 1) * stride;
    if (ahead < p.n_tiles) stage_meta<T>(p, ahead, s_meta[s_ahead]);
    __syncthreads();
    if (ahead < p.n_tiles) {
      stage_windows<T>(p, ahead, s_meta[s_ahead], s_ring[s_ahead]);
    }
    cp_async_commit();
    cp_async_wait_ahead();                     // this tile's copies landed
    __syncthreads();

    // C. One feature per (k, query); a warp stores 32 consecutive queries.
    const TileMeta& m = s_meta[s];
    const int w2 = m.w2;
    for (int e = tid; e < kFeat * kTile; e += kThreads) {
      const int k = e / kTile;
      const int ql = e - k * kTile;
      const long long base = m.base[ql];
      if (base < 0) continue;
      const int dy = k / kSide;
      const int dx = k - dy * kSide;
      const T* w = reinterpret_cast<const T*>(&s_ring[s][ql * kWords]);
      const int o0 = (m.par[ql] >> dy) & 1;
      const int o1 = (m.par[ql] >> (dy + 1)) & 1;
      const int xa = m.x0[ql] + dx;
      // Columns outside the map read 0 (a bf16 pair may hold a value of
      // the neighbouring row there).
      const bool ca = xa >= 0 && xa < w2;
      const bool cb = xa + 1 >= 0 && xa + 1 < w2;
      const float w00 = ca ? to_f32(w[dy * kRow + o0 + dx]) : 0.0f;
      const float w01 = cb ? to_f32(w[dy * kRow + o0 + dx + 1]) : 0.0f;
      const float w10 = ca ? to_f32(w[(dy + 1) * kRow + o1 + dx]) : 0.0f;
      const float w11 = cb ? to_f32(w[(dy + 1) * kRow + o1 + dx + 1]) : 0.0f;
      const float fx = m.fx[ql];
      const float fy = m.fy[ql];
      p.out[base + (long long)k * p.q_per_map] =
          (1.0f - fy) * ((1.0f - fx) * w00 + fx * w01)
          + fy * ((1.0f - fx) * w10 + fx * w11);
    }
    __syncthreads();                           // stage s is refilled next
  }
}

// Persistent grid: as many blocks as fit on the card, at most one per tile.
// The occupancy is asked once; the SM count comes from the caller's cache.
template <typename T>
cudaError_t launch_fwd(const FwdParams& p, int sms, cudaStream_t s) {
  static int blocks_per_sm = 0;
  if (blocks_per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, corr_window_lookup_kernel<T>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (blocks_per_sm < 1) blocks_per_sm = 1;
  }
  long long grid = (long long)blocks_per_sm * sms;
  if (grid > p.n_tiles) grid = p.n_tiles;
  corr_window_lookup_kernel<T><<<(unsigned)grid, kThreads, 0, s>>>(p);
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

// All levels of one lookup in one launch.  Per level l: the volume corr[l]
// ([N_l, H2_l, W2_l], all f32 or all bf16), the centres cx[l], cy[l]
// ([N_l] f32), N_l = T_l * batch * q_per_map, and its first channel
// chan_off[l] in the [batch, c_total, q_per_map] output.
// table: kLevelFields values per level (volume, cx, cy pointers, query
// count, H2, W2, channel offset); sms: the card's multiprocessor count.
extern "C" int corr_window_lookup_levels(
    int n_levels, const long long* table, int corr_is_bf16, float* out,
    int radius, int batch, int q_per_map, int c_total, int sms,
    void* stream) {
  if (radius != kRadius || n_levels < 1 || n_levels > kMaxLevels ||
      batch < 1 || q_per_map < 1 || sms < 1) {
    return (int)cudaErrorInvalidValue;
  }
  FwdParams p;
  memset(&p, 0, sizeof(p));
  long long tiles = 0;
  int k = 0;
  for (int l = 0; l < n_levels; ++l) {
    const long long* f = table + (long long)l * kLevelFields;
    if (f[3] < 0 || f[4] < 1 || f[5] < 1 || f[4] > 0x7fffffffLL ||
        f[5] > 0x7fffffffLL) {
      return (int)cudaErrorInvalidValue;
    }
    if (f[3] == 0) continue;                   // no tiles: left out
    LevelDesc& L = p.lv[k];
    L.corr = reinterpret_cast<const void*>(f[0]);
    L.cx = reinterpret_cast<const float*>(f[1]);
    L.cy = reinterpret_cast<const float*>(f[2]);
    L.n = f[3];
    L.tile0 = tiles;
    L.h2 = (int)f[4];
    L.w2 = (int)f[5];
    L.chan_off = (int)f[6];
    tiles += (L.n + kTile - 1) / kTile;
    ++k;
  }
  if (k == 0) return (int)cudaSuccess;
  p.n_levels = k;
  p.out = out;
  p.n_tiles = tiles;
  p.batch = batch;
  p.q_per_map = q_per_map;
  p.c_total = c_total;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = corr_is_bf16 ? launch_fwd<__nv_bfloat16>(p, sms, s)
                                       : launch_fwd<float>(p, sms, s);
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
