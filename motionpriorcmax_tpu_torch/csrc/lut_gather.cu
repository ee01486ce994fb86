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
// Design of the forward: one thread per event, reading its row and column
// once and its C channels as one run (coalesced stores of C floats per
// thread).
//
// Design of the backward, two launches, the second a programmatic
// dependent of the first (it starts while the first runs):
//   * pieces: the events of a sample are cut at every multiple of
//     kPiece = 4096.  One warp per piece finds, by a 32-way search of the
//     ends, the run that holds the piece's first event (its head run) and
//     sums that run's events inside the piece into carry[b, piece]: at most
//     kPiece events per warp, 16 loads of 16 bytes in flight per lane, a
//     fixed butterfly of shuffles combining the lanes.
//   * tiles: a block of 128 threads takes kTile = 512 consecutive cells of
//     one sample (4 consecutive cells per thread) and all S segments.  It
//     copies the tile's ends of every segment (ends[j0 - 1 .. j0 + 511],
//     coalesced, cp.async) into shared memory, then streams each segment's
//     contiguous span of g through two 8 KB shared-memory windows with
//     16-byte cp.async copies, the next window in flight while the block
//     sums the current one.  A run's events before its first multiple of
//     kPiece (its first part, < kPiece events) are added from shared memory
//     in event order: by the thread that owns the cell, or, for a part
//     longer than 32 events in one window, by one of the block's warps
//     (lanes striding it, the same butterfly), whose sum the owner adds.
//     The rest of a run (from its first multiple of kPiece on) is the
//     carries of the pieces it heads, which the owner adds in piece order
//     once the piece kernel has finished; windows skip those events.  Each
//     thread writes its 4 cells' d lut once, with 16-byte stores, with no
//     atomics and no zero-fill.
// So no thread or warp walks more than kPiece events of one run, whatever
// the run lengths: the padding rows of a segment (all in cell 0: ~24k at
// the DSEC shape, 2^18 at the traj-train one) are summed by the pieces,
// in parallel, not by one warp.  Every partition point depends on the ends
// alone and every sum is taken in a fixed order, so two calls give the same
// bits; a cell's sum carries the f32 rounding of its own terms (the JAX
// cumsum difference carries that of a running sum over the whole array).
// PERF.md gives the time of each design tried.
// Indices are clamped into range before use: the caller's contract is
// in-range rows and columns and non-decreasing ends, and the clamp keeps a
// broken caller from reading outside the arrays.

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

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPiece = 4096;            // events per piece
constexpr int kTileThreads = 128;
constexpr int kCellsPerThread = 4;      // consecutive cells
constexpr int kTile = kTileThreads * kCellsPerThread;
constexpr int kEndsStride = kTile + 4;  // ints per segment's tile ends
constexpr int kWindowFloats = 2048;     // floats per shared-memory window
constexpr int kLongPart = 32;           // longer parts are summed warp-wide
constexpr int kBatch = 16;              // 16-byte loads in flight per lane

__device__ __forceinline__ int clamp_end(int v, int m) {
  return min(max(v, 0), m);
}

// The first multiple of kPiece at or after a (a >= 0).
__device__ __forceinline__ long long piece_ceil(int a) {
  return ((long long)a + kPiece - 1) & ~(long long)(kPiece - 1);
}

// Sum of part[ch] over the warp's lanes, the same bits in every lane.
template <int C>
__device__ __forceinline__ void warp_sum(float (&part)[C]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      part[ch] += __shfl_xor_sync(kFull, part[ch], off);
}

// part[ch] += v where ch is known at run time only (registers, no local
// memory).
template <int C>
__device__ __forceinline__ void add_at(float (&part)[C], int ch, float v) {
#pragma unroll
  for (int k = 0; k < C; ++k) part[k] += k == ch ? v : 0.0f;
}

// carry[b, q] = the sum of g[b, e, :] over the events e >= q * kPiece of
// the piece that belong to the run holding event q * kPiece (zero past the
// last end).  One warp per piece.
template <int C>
__global__ void __launch_bounds__(kThreads)
lut_segsum_piece_kernel(const float* __restrict__ g,
                        const int* __restrict__ ends,
                        float* __restrict__ carry, int n_ends, int m,
                        int pieces) {
  // The tile kernel may start now; it waits for this grid before it
  // reads the carries.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (q >= pieces) return;                       // the whole warp
  const int b = blockIdx.y;
  const int x = q * kPiece;
  const int* eb = ends + (long long)b * n_ends;
  // The first j with ends[j] > x (n_ends if none): a 32-way search.
  // Invariant: the answer lies in [lo, hi], and hi is n_ends or an entry
  // known to be > x.
  int lo = 0, hi = n_ends;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + (lane + 1) * step - 1;
    const bool above = p >= hi || clamp_end(__ldg(eb + p), m) > x;
    const unsigned vote = __ballot_sync(kFull, above);
    if (vote == 0u) {
      lo = hi;
      break;
    }
    const int l = __ffs(vote) - 1;
    hi = min(hi, lo + (l + 1) * step - 1);
    lo += l * step;
  }
  if (lo < hi) {
    const int p = lo + lane;
    const bool above = p >= hi || clamp_end(__ldg(eb + p), m) > x;
    const unsigned vote = __ballot_sync(kFull, above);
    lo = vote ? lo + __ffs(vote) - 1 : hi;
  }
  const int run_end = lo < n_ends ? clamp_end(__ldg(eb + lo), m) : x;
  const int stop = (int)min((long long)run_end, min((long long)x + kPiece,
                                                     (long long)m));
  // Floats [f0, f1) of g; f0 is a multiple of C.
  const long long f0 = ((long long)b * m + x) * C;
  const long long f1 = ((long long)b * m + max(stop, x)) * C;
  float part[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) part[ch] = 0.0f;
  long long tail = f0;
  if ((128 % C) == 0 && (f0 & 3) == 0) {
    // 16-byte loads, kBatch in flight per lane; float i of chunk k is
    // channel (4k + i) % C, and with k = lane + 32j that is (4 lane + i) % C.
    const float4* g4 = reinterpret_cast<const float4*>(g + f0);
    const int n4 = (int)((f1 - f0) >> 2);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int k0 = 0;
    for (; k0 + 32 * kBatch <= n4; k0 += 32 * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) v[u] = __ldg(g4 + k0 + 32 * u + lane);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        acc.x += v[u].x;
        acc.y += v[u].y;
        acc.z += v[u].z;
        acc.w += v[u].w;
      }
    }
    for (int k = k0 + lane; k < n4; k += 32) {
      const float4 v = __ldg(g4 + k);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    add_at<C>(part, (4 * lane) % C, acc.x);
    add_at<C>(part, (4 * lane + 1) % C, acc.y);
    add_at<C>(part, (4 * lane + 2) % C, acc.z);
    add_at<C>(part, (4 * lane + 3) % C, acc.w);
    tail = f0 + 4LL * n4;
  }
  for (long long f = tail + lane; f < f1; f += 32)
    add_at<C>(part, (int)((f - f0) % C), __ldg(g + f));
  warp_sum<C>(part);
  if (lane == 0) {
    float* dst = carry + ((long long)b * pieces + q) * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) dst[ch] = part[ch];
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The tile's ends of one segment in shared memory: e[i] starts the run of
// the tile's cell i, e[i + 1] ends it.  Moves pos (>= e[0]) past the
// carried events (those from the first multiple of kPiece of their run on)
// and returns it, or `hi` when no event of the first parts is left in
// [pos, hi).
__device__ int skip_carried(const int* e, int pos, int hi) {
  // No multiple of kPiece in [e[0], pos]: no run holding pos carries it.
  if (pos < piece_ceil(e[0])) return pos;
  while (pos < hi) {
    int lo = 0, up = kTile;            // the last i with e[i] <= pos
    while (lo < up) {
      const int mid = (lo + up + 1) >> 1;
      if (e[mid] <= pos) lo = mid; else up = mid - 1;
    }
    if (pos < piece_ceil(e[lo])) return pos;
    const int next = lo < kTile ? e[lo + 1] : hi;
    pos = next > pos ? next : hi;      // non-decreasing ends move on
  }
  return hi;
}

// The next window of the block's walk: from (s, pos) to the first segment
// with a first-part event at or after pos, [pos, end) of at most `cap`
// events; false when the tile is done.  Every thread computes the same.
__device__ bool next_window(const int* se, int segs, int cap, int& s,
                            int& pos, int& end) {
  while (s < segs) {
    const int* e = se + s * kEndsStride;
    const int hi = max(e[kTile], e[0]);
    pos = skip_carried(e, max(pos, e[0]), hi);
    if (pos < hi) {
      end = (int)min((long long)pos + cap, (long long)hi);
      return true;
    }
    if (++s < segs) pos = se[s * kEndsStride];
  }
  return false;
}

// Stage g[b, w0:w1, :] into buf: 16-byte copies of the aligned floats
// around it (g is 16-byte aligned); returns the offset of event w0's first
// float in buf.
template <int C>
__device__ int stage_window(float* buf, const float* g, long long total,
                            long long row0, int w0, int w1) {
  const long long f0 = (row0 + w0) * C, f1 = (row0 + w1) * C;
  const long long a0 = f0 & ~3LL;
  const int n4 = (int)((f1 - a0 + 3) >> 2);
  const float* src = g + a0;
  const long long room = total - a0;   // floats left in g from a0 on
  for (int k = threadIdx.x; k < n4; k += kTileThreads) {
    if (4LL * k + 4 <= room) {
      cp_async16(buf + 4 * k, src + 4 * k);
    } else {
      for (int r = 0; r < 4; ++r)
        if (4LL * k + r < room) cp_async4(buf + 4 * k + r, src + 4 * k + r);
    }
  }
  return (int)(f0 - a0);
}

template <int C>
__global__ void __launch_bounds__(kTileThreads)
lut_segsum_tile_kernel(const float* __restrict__ g,
                       const int* __restrict__ ends,
                       const float* __restrict__ carry,
                       float* __restrict__ dlut, int cells, int segs, int m,
                       int pieces) {
  constexpr int K = kCellsPerThread;
  static_assert(K % 4 == 0, "a thread reads its cells' ends as int4s");
  constexpr int kCap = (kWindowFloats - 8) / C;          // events a window
  extern __shared__ float4 smem4[];
  float* bufs = reinterpret_cast<float*>(smem4);       // 2 windows
  int* se = reinterpret_cast<int*>(bufs + 2 * kWindowFloats);
  // A window's parts longer than kLongPart, (first event, end), and their
  // sums: disjoint runs of its events, so at most kParts.
  constexpr int kParts = kCap / (kLongPart + 1) + 1;
  __shared__ int2 long_parts[kParts];
  __shared__ float long_sums[kParts * C];
  __shared__ int n_long;
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
  const long long row0 = (long long)b * m;
  const long long total = (long long)gridDim.y * m * C;
  if (threadIdx.x == 0) n_long = 0;

  // The tile's ends, every segment: e[s][i] = ends[s * cells + j0 - 1 + i]
  // (0 before the first cell; past the last cell, the segment's last end).
  // Copied by cp.async, every segment's at once, then clamped in place by
  // the thread that copied them.
  const int* eb = ends + (long long)b * segs * cells;
  for (int s = 0; s < segs; ++s) {
    const int* es = eb + (long long)s * cells;
#pragma unroll
    for (int r = 0; r <= kTile / kTileThreads; ++r) {
      const int i = threadIdx.x + r * kTileThreads;
      const int c = j0 - 1 + i;
      if (i > kTile) continue;
      if (s == 0 && c < 0)
        se[i] = 0;
      else
        cp_async4(reinterpret_cast<float*>(se + s * kEndsStride + i),
                  reinterpret_cast<const float*>(es + min(c, cells - 1)));
    }
  }
  cp_async_commit();
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  for (int s = 0; s < segs; ++s)
#pragma unroll
    for (int r = 0; r <= kTile / kTileThreads; ++r) {
      const int i = threadIdx.x + r * kTileThreads;
      if (i <= kTile) se[s * kEndsStride + i] = clamp_end(se[s * kEndsStride + i], m);
    }
  __syncthreads();

  // Whether any of the tile's runs reaches past a multiple of kPiece (then
  // it has carried events and the pieces' carries to add).
  bool carries = false;
  for (int s = 0; s < segs; ++s) {
    const int* e = se + s * kEndsStride;
    carries |= piece_ceil(e[0]) < max(e[kTile], e[0]);
  }

  float acc[K][C];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[k][ch] = 0.0f;

  int s = 0, pos = se[0], end = 0, off = 0, cur = 0;
  bool have = next_window(se, segs, kCap, s, pos, end);
  if (have) off = stage_window<C>(bufs, g, total, row0, pos, end);
  cp_async_commit();
  while (have) {
    int ns = s, npos = end, nend = 0, noff = 0;
    const bool nhave = next_window(se, segs, kCap, ns, npos, nend);
    if (nhave)
      noff = stage_window<C>(bufs + (cur ^ 1) * kWindowFloats, g, total, row0,
                             npos, nend);
    cp_async_commit();
    cp_async_wait_one();                   // this window's copies landed
    __syncthreads();
    const float* buf = bufs + cur * kWindowFloats + off;
    const int* e = se + s * kEndsStride + K * threadIdx.x;
    int ev[K + 1];
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const int4 e4 = *reinterpret_cast<const int4*>(e + k);
      ev[k] = e4.x;
      ev[k + 1] = e4.y;
      ev[k + 2] = e4.z;
      ev[k + 3] = e4.w;
    }
    ev[K] = e[K];
    // This thread's part of the window: its runs' first parts, clipped;
    // the short ones summed here, in event order.
    int lo[K], hi[K];
    bool any_long = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int a = ev[k];
      const long long stop = max(ev[k + 1], a);
      const int first = carries ? (int)min(stop, piece_ceil(a)) : (int)stop;
      lo[k] = max(a, pos);
      hi[k] = min(first, end);
      const int n = hi[k] - lo[k];
      if (n > kLongPart) {
        any_long = true;
      } else {
        const float* p = buf + (lo[k] - pos) * C;
        for (int t = 0; t < n; ++t)
#pragma unroll
          for (int ch = 0; ch < C; ++ch) acc[k][ch] += p[t * C + ch];
      }
    }
    // Longer parts: listed, each summed by one of the block's warps (lanes
    // striding it, the butterfly combining them), then added by its owner.
    // Which warp sums a part does not change its bits.
    if (__syncthreads_or(any_long)) {
      int slot[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        slot[k] = -1;
        if (hi[k] - lo[k] > kLongPart) {
          slot[k] = atomicAdd(&n_long, 1);
          long_parts[slot[k]] = make_int2(lo[k], hi[k]);
        }
      }
      __syncthreads();
      for (int i = threadIdx.x >> 5; i < n_long; i += kTileThreads / 32) {
        const int2 r = long_parts[i];
        float part[C];
#pragma unroll
        for (int ch = 0; ch < C; ++ch) part[ch] = 0.0f;
        for (int t = r.x + lane; t < r.y; t += 32)
#pragma unroll
          for (int ch = 0; ch < C; ++ch) part[ch] += buf[(t - pos) * C + ch];
        warp_sum<C>(part);
        if (lane == 0)
#pragma unroll
          for (int ch = 0; ch < C; ++ch) long_sums[i * C + ch] = part[ch];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (slot[k] >= 0)
#pragma unroll
          for (int ch = 0; ch < C; ++ch)
            acc[k][ch] += long_sums[slot[k] * C + ch];
      __syncthreads();                     // before the list is reused
      if (threadIdx.x == 0) n_long = 0;
    }
    s = ns;
    pos = npos;
    end = nend;
    off = noff;
    have = nhave;
    cur ^= 1;
  }

  // The carries of the pieces each run heads, in piece order, once the
  // piece kernel has finished (block (0, 0) always waits, so this grid
  // never ends before that one).
  if (carries || (blockIdx.x | blockIdx.y) == 0)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (carries) {
    const float* cb = carry + (long long)b * pieces * C;
    for (int t = 0; t < segs; ++t) {
      const int* e = se + t * kEndsStride + K * threadIdx.x;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int a = e[k], stop = max(e[k + 1], a);
        const long long q1 =
            min(piece_ceil(stop) / kPiece, (long long)pieces);
        for (long long q = piece_ceil(a) / kPiece; q < q1; ++q)
#pragma unroll
          for (int ch = 0; ch < C; ++ch) acc[k][ch] += __ldg(cb + q * C + ch);
      }
    }
  }

  // The thread's K cells, K * C consecutive floats: 16-byte stores when
  // they are aligned and all in range.
  const int cell0 = j0 + K * threadIdx.x;
  float* dst = dlut + ((long long)b * cells + cell0) * C;
  if (cell0 + K <= cells && ((long long)b * cells * C) % 4 == 0) {
#pragma unroll
    for (int v = 0; v < K * C / 4; ++v) {
      const int f = 4 * v;   // floats f .. f + 3 of the K * C
      reinterpret_cast<float4*>(dst)[v] =
          make_float4(acc[f / C][f % C], acc[(f + 1) / C][(f + 1) % C],
                      acc[(f + 2) / C][(f + 2) % C],
                      acc[(f + 3) / C][(f + 3) % C]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (cell0 + k < cells)
#pragma unroll
        for (int ch = 0; ch < C; ++ch) dst[k * C + ch] = acc[k][ch];
  }
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

// Shared memory of the tile kernel: two windows and the tile's ends.
size_t tile_smem(int segs) {
  return 2 * kWindowFloats * sizeof(float) +
         (size_t)segs * kEndsStride * sizeof(int);
}

template <int C>
int segsum(const float* g, const int* ends, float* carry, float* dlut,
                  int batch, int cells, int segs, int m, cudaStream_t st) {
  const int pieces = (int)(((long long)m + kPiece - 1) / kPiece);
  if (pieces > 0) {
    const dim3 grid((pieces + kThreads / 32 - 1) / (kThreads / 32), batch);
    lut_segsum_piece_kernel<C><<<grid, kThreads, 0, st>>>(
        g, ends, carry, segs * cells, m, pieces);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = tile_smem(segs);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lut_segsum_tile_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // Launched as the piece kernel's programmatic dependent: its blocks
  // start while the pieces run and wait for them only to read the carries.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((cells + kTile - 1) / kTile, batch);
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pieces > 0 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, lut_segsum_tile_kernel<C>, g, ends, (const float*)carry, dlut,
      cells, segs, m, pieces);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

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

// The carry scratch lut_segsum_bwd needs, in floats: B * ceil(M / 4096) * C.
long long lut_segsum_carry_floats(int batch, int m, int c) {
  return (long long)batch * (((long long)m + kPiece - 1) / kPiece) * c;
}

// g [B, M, C] (16-byte aligned), ends [B, S * cells] int32, carry (the
// scratch above), dlut [B, cells, C]; contiguous; C in {1, 2, 4, 6, 8}
// (2 * the number of reference times).  Two launches on `stream`.
int lut_segsum_bwd(const float* g, const int* ends, float* carry,
                   float* dlut, int batch, int cells, int segs, int m, int c,
                   void* stream) {
  if ((long long)batch * cells == 0) return 0;
  if (batch > 65535 || segs < 1 || tile_smem(segs) > 227 * 1024 ||
      ((uintptr_t)g & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (c) {
    case 1: return segsum<1>(g, ends, carry, dlut, batch, cells, segs, m, st);
    case 2: return segsum<2>(g, ends, carry, dlut, batch, cells, segs, m, st);
    case 4: return segsum<4>(g, ends, carry, dlut, batch, cells, segs, m, st);
    case 6: return segsum<6>(g, ends, carry, dlut, batch, cells, segs, m, st);
    case 8: return segsum<8>(g, ends, carry, dlut, batch, cells, segs, m, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
