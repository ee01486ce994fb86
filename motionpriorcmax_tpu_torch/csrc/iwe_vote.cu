// Bilinear vote of warped events into an image (IWE), forward and backward.
//
// Replaces the TPU kernels of motionpriorcmax_tpu/ops/pallas/iwe_vote.py:
//   iwe_vote_pallas_sorted (_banded_fwd_call / _banded_bwd_call), the vote
//   of cell-sorted events on the flow-training path, and
//   iwe_vote_pallas (_full_fwd_call / _full_bwd_call), the same function on
//   unsorted events.
// Those build one-hot tap tiles for the TPU's matrix unit, in bf16.  These
// kernels compute the exact f32 function of the JAX 'direct' path
// (motionpriorcmax_tpu/ops/events.py::iwe_bilinear_vote) instead:
//
//   f = floor(c + 1e-6), (fy, fx) = c - f, (y1, x1) = int(f)
//   out[b, y1 + dy, x1 + dx] += wy_dy * wx_dx * v     for dy, dx in {0, 1},
//   wy_0 = 1 - fy, wy_1 = fy (x alike), each corner masked to the image.
//
// The backward gives, with G the image cotangent at the four (masked) taps
// and a_k = G_k * v, what autodiff of the 'direct' path gives:
//   d fy = wx_0 (a_10 - a_00) + wx_1 (a_11 - a_01)
//   d fx = wy_0 (a_01 - a_00) + wy_1 (a_11 - a_10)
//   d v  = sum_k wy * wx * G_k
// (the TPU kernel spells out the same sums, iwe_vote.py:328-372).
//
// Bound: memory.  Forward, per event 12 bytes in (coords, weight) and four
// taps into the image; at the flow-training shape (B = 14, M = 2^19 per
// polarity half, 480 x 640) the needed bytes are 88 MB of events plus the
// 17 MB image written once: ~31 us at 3.35 TB/s.  The image fits in the
// 50 MB L2, so a design with one f32 atomic per tap (26.6 M per launch at
// that shape) runs at the L2's atomic rate, ~1e11 atomics/s: ~270 us.
// Backward, per event 12 bytes in (the coordinates of live events only)
// and 8 (+4 for d weight) bytes out, and the image read once: 161 MB at
// that shape, ~48 us.  No atomics: deterministic.
//
// Forward design: one launch; a block of 1024 threads takes a chunk of
// 4096 consecutive events of one batch row (4 per thread, held in
// registers; two blocks per SM, 64 warps, 32 registers) and chooses per
// chunk and per tap where each tap goes.
//   (a) Paired taps: an event's two taps on one image row, (x1, x1 + 1),
//       go to device memory as ONE 16-byte vector reduction
//       (atomicAdd(float4*, float4), compute capability 9.x; the SASS is
//       one REDG.E.ADD.F32x4.FTZ.RN.STRONG.GPU) on the aligned 4-float
//       segment of the flat image that holds them, its other lanes +0.0;
//       a pair that straddles two segments (flat index % 4 == 3), or has
//       only one column in the image, takes scalar atomics.  Segments are
//       aligned on the flat index, so any W works.  ~2.5 requests per
//       event instead of 4, in any event order.
//   (b) A row band in shared memory: the block finds its chunk's lowest
//       and highest live tap rows lo, hi (a live tap: weight != 0, row and
//       column in the image) and its live taps, starts the band at
//       rs = clamp((lo / 8) * 8, 0, max(H - R, 0)) as the TPU kernel's
//       _row_windows (iwe_vote.py:260-276) does, R = band_rows rows (39 at
//       W = 640: 100 KB, two blocks per SM), and counts the live taps in
//       rows [rs, top], top = min(hi, rs + R - 1).  If they are at least
//       3/4 of the chunk's live taps and one per 8 pixels of rows [lo, top]
//       (else the band's zero-fill and flush cost more than its taps
//       save), the band is used: rows [lo, top] are zeroed in shared
//       memory, each tap in them is added there, and every other tap takes
//       (a).  The fallback is per tap: a straggler costs its own
//       reduction, never the chunk's band.  A chunk with no live tap
//       returns at once.  Band rows are band_stride(W) floats apart (W + 3
//       rounded up to 4, + 4 when a multiple of 32: rows on other banks),
//       each at its flat start's offset modulo 4 floats, so a row's
//       16-byte aligned middle in shared memory matches the image's for
//       any W.  The shared adds are float atomics, a compare-and-swap loop
//       on this card (ATOMS.CAST.SPIN); when 8 or more lanes of a warp
//       repeat their left neighbour's pixel pair (a hot pixel's run in
//       sorted order), the warp first sums equal pairs (__match_any_sync
//       and a shuffle tree), so such a run costs one shared add per warp,
//       not a 32-way spin.  The band is flushed with Hopper's bulk
//       reduce-add (cp.reduce.async.bulk.global.shared::cta.bulk_group.
//       add.f32, SASS UBLKRED.G.S.ADD.F32.RN), one call per band row in
//       [lo, top], each issued by its own thread after every thread's
//       fence.proxy.async.shared::cta and a barrier, and waited for
//       (cp.async.bulk.wait_group.read 0) before that thread exits; a
//       row's unaligned head and tail (< 4 floats each) take scalar
//       atomics.
// Cell-sorted chunks (the loader's LUT-cell order: a chunk is about one
// 4-pixel cell row over all 15 bins) fit their band; unsorted chunks
// spread over the whole image, and chunks with a wide flow over more rows
// than the band holds: they take (a) alone.  Sums are in run-dependent
// order, as with any atomics.
//
// Backward design: one thread per event, four 4-byte reads of its taps,
// the cotangent image read where it lies (any batch stride: autograd hands
// each polarity half a view into the stacked [B, 2, H, W] cotangent).  On
// cell-sorted events a warp's taps share lines and its reads hit the L1.
// In any order each tap row is a line of its own: a row's two reads merge
// in the L1, and the L2 serves ~2.25 sector requests per event (2 rows,
// 1/8 of the pairs across two sectors) besides the stream of coords,
// weights and d coords that it carries too.  The two add up rather than
// overlap: the unsorted call takes ~2.7x the bound.  Measured on the card
// and not kept (25 variants, PERF.md, section 6): several events per
// thread, a tap row's pair as one 16-byte load, a persistent grid, the
// image in a cluster's distributed shared memory, and a cooperative launch
// that lays the image out as row pairs (an event's taps in one 16-byte
// read) after a vote of the warps; none was faster on events in any order
// without being slower on cell-sorted or skewed ones.
//
// Coordinates are clamped before the float-to-int cast to [-3, size + 2]:
// every tap of a clamped coordinate is still out of the image, as every tap
// of the original was, so the clamp changes no result and the cast is
// always defined (early training warps events by up to ~1e9 px).  Per-batch
// strides let the caller vote one polarity half of a larger event array
// without a copy.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                   // backward
constexpr int kFwdThreads = 1024;
constexpr int kPerThread = 4;                   // events per forward thread
constexpr int kChunk = kFwdThreads * kPerThread;  // events per forward block
// A chunk uses its band when the band holds at least kBandShareNum /
// kBandShareDen of its live taps and at least one per kMinPixelsPerTap
// pixels of the rows it flushes.
constexpr long long kBandShareNum = 3, kBandShareDen = 4;
constexpr long long kMinPixelsPerTap = 8;
constexpr int kHotRepeats = 8;    // lanes repeating a pair: sum the warp

struct Taps {
  int y1, x1;
  float wy0, wy1, wx0, wx1;
  bool m00, m10, m01, m11;
};

__device__ __forceinline__ Taps make_taps(float y, float x, int h, int w) {
  y = fminf(fmaxf(y, -3.0f), (float)h + 2.0f);
  x = fminf(fmaxf(x, -3.0f), (float)w + 2.0f);
  const float fly = floorf(y + 1e-6f);
  const float flx = floorf(x + 1e-6f);
  const float fy = y - fly;
  const float fx = x - flx;
  Taps t;
  t.y1 = (int)fly;
  t.x1 = (int)flx;
  t.wy0 = 1.0f - fy;
  t.wy1 = fy;
  t.wx0 = 1.0f - fx;
  t.wx1 = fx;
  const bool my0 = t.y1 >= 0 && t.y1 < h;
  const bool my1 = t.y1 + 1 >= 0 && t.y1 + 1 < h;
  const bool mx0 = t.x1 >= 0 && t.x1 < w;
  const bool mx1 = t.x1 + 1 >= 0 && t.x1 + 1 < w;
  t.m00 = my0 && mx0;
  t.m10 = my1 && mx0;
  t.m01 = my0 && mx1;
  t.m11 = my1 && mx1;
  return t;
}

// The pair (p, p + 1) of one row of the flat image, masked per column:
// one 16-byte vector reduction when both lie in one aligned 4-float
// segment, else scalar atomics.
__device__ __forceinline__ void red_pair(float* out, long long p, float a,
                                         float b, bool ma, bool mb) {
  if (ma && mb && (p & 3) != 3) {
    const int o = (int)(p & 3);
    const float4 v = make_float4(o == 0 ? a : 0.0f,
                                 o == 0 ? b : (o == 1 ? a : 0.0f),
                                 o == 1 ? b : (o == 2 ? a : 0.0f),
                                 o == 2 ? b : 0.0f);
    atomicAdd(reinterpret_cast<float4*>(out + (p - o)), v);
    return;
  }
  if (ma) atomicAdd(out + p, a);
  if (mb) atomicAdd(out + p + 1, b);
}

// Sum x over the lanes of each group of `peers` (from __match_any_sync);
// the group's lowest lane gets the sum.  All 32 lanes must call it.
__device__ __forceinline__ float2 sum_peers(unsigned peers, float2 x) {
  const int lane = threadIdx.x & 31;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = lane == 31 ? 0u : peers & (0xfffffffeu << lane);
  // A tree over the ranks: each step a lane adds its next remaining peer,
  // then the odd ranks (already added) drop out and the ranks halve.
  while (__any_sync(0xffffffffu, above != 0u)) {
    const int next = __ffs(above);
    const int src = next ? next - 1 : lane;
    const float tx = __shfl_sync(0xffffffffu, x.x, src);
    const float ty = __shfl_sync(0xffffffffu, x.y, src);
    if (next) {
      x.x += tx;
      x.y += ty;
    }
    above &= ~__ballot_sync(0xffffffffu, rank & 1u);
    rank >>= 1;
  }
  return x;
}

__device__ __forceinline__ void bulk_reduce_add(float* gmem, const float* smem,
                                                unsigned bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;\n" ::"l"(gmem), "r"(s), "r"(bytes) : "memory");
}

// Floats between band rows: W + 3 rounded up to 4 floats (a row starts at
// its flat offset modulo 4), plus 4 when that is a multiple of 32 banks.
__host__ __device__ __forceinline__ int band_stride(int w) {
  const int s = (w + 6) & ~3;
  return s % 32 == 0 ? s + 4 : s;
}

__global__ void __launch_bounds__(kFwdThreads, 2)
iwe_vote_fwd_kernel(const float* __restrict__ coords,
                    const float* __restrict__ weight,
                    float* __restrict__ out, int m, int chunks_per_row,
                    long long coords_bstride, long long weight_bstride,
                    int h, int w, int band_rows) {
  extern __shared__ __align__(16) float band[];
  __shared__ int s_lo, s_hi, s_nlive, s_nband;
  const int b = blockIdx.x / chunks_per_row;
  const int e0 = (blockIdx.x - b * chunks_per_row) * kChunk;
  const float* cb = coords + b * coords_bstride;
  const float* wb = weight + b * weight_bstride;
  const long long base = (long long)b * h * w;     // image b's flat start
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    s_lo = INT_MAX;
    s_hi = -1;
    s_nlive = s_nband = 0;
  }

  // Load the chunk (coalesced: lane-consecutive events), find its live tap
  // rows and count its live taps.  rows[j] packs event j's first tap row
  // (+ 3, >= 0) and its live taps on that row and the next.
  float ey[kPerThread], ex[kPerThread], ev[kPerThread];
  int rows[kPerThread];
  int lo = INT_MAX, hi = -1, nlive = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = e0 + j * kFwdThreads + threadIdx.x;
    ey[j] = ex[j] = ev[j] = 0.0f;
    rows[j] = 0;
    if (e < m) {
      ev[j] = __ldg(wb + e);
      const float2 yx = __ldg(reinterpret_cast<const float2*>(cb + 2 * e));
      ey[j] = yx.x;
      ex[j] = yx.y;
    }
    if (ev[j] != 0.0f) {
      const Taps t = make_taps(ey[j], ex[j], h, w);
      const int c0 = (int)t.m00 + (int)t.m01, c1 = (int)t.m10 + (int)t.m11;
      rows[j] = ((t.y1 + 3) << 4) | (c1 << 2) | c0;
      nlive += c0 + c1;
      if (c0) {
        lo = min(lo, t.y1);
        hi = max(hi, t.y1);
      }
      if (c1) {
        lo = min(lo, t.y1 + 1);
        hi = max(hi, t.y1 + 1);
      }
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, d));
    nlive += __shfl_xor_sync(0xffffffffu, nlive, d);
  }
  __syncthreads();                           // s_* initialised
  if (lane == 0 && hi >= 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
    atomicAdd(&s_nlive, nlive);
  }
  __syncthreads();
  lo = s_lo;
  hi = s_hi;
  if (hi < 0) return;                        // no live tap in the chunk

  // The band [rs, rs + R) and the count of live taps in rows [lo, top].
  const int rs = min(max((lo / 8) * 8, 0), max(h - band_rows, 0));
  const int top = min(hi, rs + band_rows - 1);
  if (band_rows > 0) {
    int n = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int y1 = (rows[j] >> 4) - 3;
      if (y1 >= rs && y1 <= top) n += rows[j] & 3;
      if (y1 + 1 >= rs && y1 + 1 <= top) n += (rows[j] >> 2) & 3;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) n += __shfl_xor_sync(0xffffffffu, n, d);
    if (lane == 0 && n > 0) atomicAdd(&s_nband, n);
    __syncthreads();
  }
  const long long nband = s_nband;
  const bool use_band =
      band_rows > 0 && kBandShareDen * nband >= kBandShareNum * s_nlive &&
      kMinPixelsPerTap * nband >= (long long)(top - lo + 1) * w;

  // Image row r sits in band slot r - rs, `stride` floats apart, at its
  // flat start's offset modulo 4 floats: band and image agree modulo 16
  // bytes, and rows land on other banks.
  const int stride = band_stride(w);
  if (use_band) {
    float4* b4 = reinterpret_cast<float4*>(band);
    for (int i = (lo - rs) * stride / 4 + threadIdx.x;
         i < (top - rs + 1) * stride / 4; i += kFwdThreads) {
      b4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
  }

  // Vote: each row's pair to the band or to device memory.
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const Taps t = make_taps(ey[j], ex[j], h, w);
    const float v = ev[j];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int r = t.y1 + dy;
      const bool ma = v != 0.0f && (dy ? t.m10 : t.m00);
      const bool mb = v != 0.0f && (dy ? t.m11 : t.m01);
      const float wy = dy ? t.wy1 : t.wy0;
      float2 ab = make_float2(ma ? wy * t.wx0 * v : 0.0f,
                              mb ? wy * t.wx1 * v : 0.0f);
      const long long p = base + (long long)r * w + t.x1;
      const bool to_band = use_band && (ma || mb) && r >= rs && r <= top;
      if ((ma || mb) && !to_band) red_pair(out, p, ab.x, ab.y, ma, mb);
      if (use_band) {                        // block-uniform
        // Lanes on the same pixel pair (i, i + 1) sum first when a quarter
        // of the warp repeats its left neighbour's pair (a hot pixel's
        // run in sorted order); i >= -1, so other lanes' keys match
        // nothing.
        const int i = (r - rs) * stride + (int)((p - t.x1) & 3) + t.x1;
        const int key = to_band ? i : INT_MIN + lane;
        const int left = __shfl_up_sync(0xffffffffu, key, 1);
        const unsigned repeats =
            __ballot_sync(0xffffffffu, lane > 0 && to_band && left == key);
        unsigned below = 0u;
        if (__popc(repeats) >= kHotRepeats) {
          const unsigned peers = __match_any_sync(0xffffffffu, key);
          ab = sum_peers(peers, ab);
          below = peers & ((1u << lane) - 1u);
        }
        if (to_band && below == 0u) {
          if (ab.x != 0.0f) atomicAdd(band + i, ab.x);
          if (ab.y != 0.0f) atomicAdd(band + i + 1, ab.y);
        }
      }
    }
  }
  if (!use_band) return;

  // Flush rows [lo, top], a row per thread: its 16-byte aligned middle by
  // one bulk reduce-add, its head and tail (< 4 floats each) by scalar
  // atomics.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  for (int r = lo + threadIdx.x; r <= top; r += kFwdThreads) {
    const long long g = base + (long long)r * w;       // row r's flat start
    const float* row = band + (r - rs) * stride + (int)(g & 3);
    const int a = (int)(((g + 3) & ~3LL) - g);         // aligned [a, z)
    const int z = (int)(((g + w) & ~3LL) - g);
    const bool bulk = z > a;
    if (bulk) {
      bulk_reduce_add(out + g + a, row + a, (unsigned)(z - a) * 4u);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    for (int x = 0; x < w; ++x) {
      if (bulk && x == a) x = z;
      if (x < w && row[x] != 0.0f) atomicAdd(out + g + x, row[x]);
    }
    if (bulk) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

__global__ void __launch_bounds__(kThreads)
iwe_vote_bwd_kernel(const float* __restrict__ coords,
                    const float* __restrict__ weight,
                    const float* __restrict__ grad,
                    float* __restrict__ dcoords,
                    float* __restrict__ dweight,     // may be null
                    long long n_events, int m, long long coords_bstride,
                    long long weight_bstride, long long grad_bstride, int h,
                    int w) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_events) return;
  const long long b = i / m;
  const long long e = i - b * m;
  const float v = __ldg(weight + b * weight_bstride + e);
  float2* dc = reinterpret_cast<float2*>(dcoords) + i;
  if (v == 0.0f && dweight == nullptr) {
    *dc = make_float2(0.0f, 0.0f);
    return;
  }
  const float2 yx = __ldg(reinterpret_cast<const float2*>(
      coords + b * coords_bstride + 2 * e));
  const Taps t = make_taps(yx.x, yx.y, h, w);
  const float* g = grad + b * grad_bstride + (long long)t.y1 * w + t.x1;
  const float g00 = t.m00 ? __ldg(g) : 0.0f;
  const float g10 = t.m10 ? __ldg(g + w) : 0.0f;
  const float g01 = t.m01 ? __ldg(g + 1) : 0.0f;
  const float g11 = t.m11 ? __ldg(g + w + 1) : 0.0f;
  const float a00 = g00 * v, a10 = g10 * v, a01 = g01 * v, a11 = g11 * v;
  *dc = make_float2(t.wx0 * (a10 - a00) + t.wx1 * (a11 - a01),
                    t.wy0 * (a01 - a00) + t.wy1 * (a11 - a10));
  if (dweight != nullptr) {
    dweight[i] = t.wy0 * t.wx0 * g00 + t.wy1 * t.wx0 * g10
               + t.wy0 * t.wx1 * g01 + t.wy1 * t.wx1 * g11;
  }
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// out [B, H, W] f32, contiguous and 16-byte aligned, must be zeroed by the
// caller.  coords: B rows of M (y, x) f32 pairs, row b at
// coords + b * coords_bstride; weight likewise.  band_rows: rows of the
// shared-memory band (at most H; 0: no band, every tap by (a)).
int iwe_vote_fwd(const float* coords, const float* weight, float* out,
                 int batch, int m, long long coords_bstride,
                 long long weight_bstride, int h, int w, int band_rows,
                 void* stream) {
  if ((long long)batch * m == 0) return 0;
  const int chunks = (m + kChunk - 1) / kChunk;
  const size_t smem = (size_t)band_rows * band_stride(w) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      iwe_vote_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  iwe_vote_fwd_kernel<<<(unsigned)batch * chunks, kFwdThreads, smem,
                        (cudaStream_t)stream>>>(
      coords, weight, out, m, chunks, coords_bstride, weight_bstride, h, w,
      band_rows);
  return (int)cudaGetLastError();
}

// Events per forward block: the chunk of the banded plain twin.
int iwe_vote_fwd_chunk(void) { return kChunk; }

// grad: B images of H x W f32, each contiguous, image b at
// grad + b * grad_bstride; dcoords [B, M, 2] and dweight [B, M] (or null)
// contiguous outputs.
int iwe_vote_bwd(const float* coords, const float* weight, const float* grad,
                 float* dcoords, float* dweight, int batch, int m,
                 long long coords_bstride, long long weight_bstride,
                 long long grad_bstride, int h, int w, void* stream) {
  const long long n = (long long)batch * m;
  if (n == 0) return 0;
  iwe_vote_bwd_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      coords, weight, grad, dcoords, dweight, n, m, coords_bstride,
      weight_bstride, grad_bstride, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
