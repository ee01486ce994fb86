// Banded exponential-kernel (softmax) interpolation of per-trajectory values
// onto a query grid, forward and backward.
//
// Replaces the TPU kernels of motionpriorcmax_tpu/ops/pallas/softmax_interp.py:
//   _run_fwd (pallas_call :276) and _vjp_bwd (pallas_call :357), the two
//   halves of softmax_interp_pallas (:297), the flow-LUT interpolation of
//   losses/focus.py with knn_method='softmax'.
//
// Per group g (batch x bin) and query q, over the db slots n that the band
// scans for q's block of 512 queries ([lo, hi), computed in PyTorch by
// ops/cuda/softmax_interp.py::scan_slots, the TPU kernel's _tile_band):
//
//   w[q, n]   = exp2(-((qy - dy)^2 + (qx - dx)^2)),  coordinates prescaled
//               by rscale = sqrt(log2(e) / temp)  (the TPU's 'vpu' form)
//   den[g, q] = sum_n w[q, n]
//   out[g, q] = sum_n w[q, n] vals[g, n] / max(den, 1e-30)
//   backward: dvals[g, n] = sum_q w[q, n] gs[g, q],
//             gs = g_out / max(den, 1e-30)
//
// No max-subtraction: every exponent is <= 0, and a query whose scanned
// points are all far away gets den = 0 and out = 0 (not NaN, not its
// nearest point).  The squared distance is taken in difference form: the
// expansion q.q + d.d - 2 q.d loses px^2-scale bits at ~640 px coordinates.
// With BF16 the exponent and the weight are rounded to bf16, and so are the
// values (forward) and gs (backward); sums stay f32 (the TPU kernel's
// exp_dtype=bfloat16).
//
// Bound: operations, over the pairs these inputs need.  At the flow-training
// shape (G = 210, Q = N = 19,200, C = 2, per-bin band, temp 25) the band
// scans ~2.1e10 (query, slot) pairs per pass, but a pair whose prescaled
// squared distance is above ~150 has an f32 weight of exactly 0 (exp2 of
// less than -150 is below half the least denormal): at temp 25 that is any
// pair more than ~51 px apart, ~91% of the scanned pairs.  The ~1.8e9 pairs
// left cost one exp2 each on the special-function units (16 per SM per
// clock): ~0.43 ms per pass on an H100 (chip_smoke.py phase 15 prints the
// counts and the bound).
//
// The cull.  A pair is skipped only when a lower bound of its prescaled
// squared distance is at least kCut = 152: its weight is then exactly 0 in
// f32 and in bf16 (exp2f(-151) is a quarter of the least denormal, and
// bf16 rounds to zero from 2^-134 down), with a margin of 2 over the
// rounding of the bound and of exp2f.  Only zero terms go, and every sum
// keeps its order: out, den and dvals are the ones a scan of the whole
// band gives, bit for bit (a zero may change sign).  NaN coordinates are
// never culled.  ops/cuda/softmax_interp.py::softmax_interp_culled_plain
// runs the same partition in PyTorch; given a counter, the entry points
// launch a build of each kernel (COUNT) that adds up the pairs it computes,
// which chip_smoke.py holds against the twin's count.
//
// Forward design: a block of 512 threads is one band block (512 queries,
// one scanned range [lo, hi)).  It sorts its queries along a Morton curve
// of their prescaled coordinates (cells of 1 / kInvCell units), so each
// warp's 32 queries are a compact patch, and each warp keeps the bounding
// box of its patch.  The range's db slots are staged through shared
// memory in tiles; each warp tests every staged point against its box (32
// points per ballot) and copies the points that may live, in slot order,
// into a per-warp buffer; when the buffer is nearly full every lane adds
// the buffered points to its query's sums.  A slot far from the patch,
// such as a trajectory thrown out of the image, costs its test.
//
// Backward design: a block of 1024 threads takes 1024 consecutive db slots
// (one band tile: the ranges are multiples of 1024 or N) and sorts them
// along the same Morton curve, so each warp's 32 slots lie close together.
// It walks the 512-query blocks whose ranges meet its slots in ascending
// order, staging bwd_chunk(C) of them per barrier (dynamic shared memory,
// two blocks per SM): each block's prescaled queries and gs, and the
// bounding box of each strip of 8 consecutive queries.  Per query block a
// lane is near when its slot is in the block's range and within the cut
// of the block's box; the warp takes the box of its near slots, keeps the
// strips within the cut of that box (two ballots), and the near lanes add
// the kept strips' queries in ascending query order.  Sums run in the
// order of the scan of the whole band, with no atomics: the same bits in
// every call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBandQ = 512;       // queries per band block (the TPU's BQ)
constexpr int kBandN = 1024;      // db slots per band tile (the TPU's BN)
constexpr int kMaxC = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kCut = 152.0f;    // prescaled squared distance of a sure 0
constexpr float kInvCell = 2.0f;  // Morton cells per prescaled unit
constexpr unsigned long long kPadKey = 0xffffffffull << 32;  // padding

// Forward: a block is one band block, a thread one query.
constexpr int kFwdThreads = kBandQ;
constexpr int kFwdWarps = kFwdThreads / 32;
// Backward: a block is one band tile, a thread one db slot.
constexpr int kBwdThreads = kBandN;
constexpr int kStrip = 8;                  // queries per strip
constexpr int kStrips = kBandQ / kStrip;   // 64: two ballots

// Floats per staged point: y, x and C values, even (8-byte rows).
__host__ __device__ constexpr int row_floats(int c) {
  return (2 + c + 1) & ~1;
}
// Slots staged per tile and points buffered per warp (forward), sized so
// the static shared memory stays under 48 KB for every C.
__host__ __device__ constexpr int fwd_tile(int c) {
  return c <= 2 ? 1024 : c <= 4 ? 512 : 384;
}
__host__ __device__ constexpr int warp_buffer(int c) {
  return c <= 4 ? 64 : 32;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__device__ __forceinline__ float weight(float qy, float qx, float dy,
                                        float dx) {
  const float ey = qy - dy;
  const float ex = qx - dx;
  float e = -(ey * ey + ex * ex);
  if (BF16) e = bf16_round(e);
  float w = exp2f(e);
  if (BF16) w = bf16_round(w);
  return w;
}

// Whether a pair at (a lower bound of) prescaled squared distance d2 may
// have a nonzero weight; NaN may.
__device__ __forceinline__ bool may_live(float d2) { return !(d2 >= kCut); }

// dy^2 + dx^2 rounded after each operation (no fused multiply-add), as
// the partition's PyTorch twin computes it.
__device__ __forceinline__ float sum_sq(float dy, float dx) {
  return __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
}

// Squared distance of (y, x) to the box [y0, y1] x [x0, x1] (0 inside; a
// NaN coordinate gives 0, an empty box +inf).
__device__ __forceinline__ float box_d2(float y, float x, float y0, float y1,
                                        float x0, float x1) {
  const float dy = fmaxf(fmaxf(y0 - y, y - y1), 0.0f);
  const float dx = fmaxf(fmaxf(x0 - x, x - x1), 0.0f);
  return sum_sq(dy, dx);
}

// Squared gap between the boxes a = (y0, y1, x0, x1) and [y0, y1] x [x0, x1].
__device__ __forceinline__ float gap_d2(float4 a, float y0, float y1,
                                        float x0, float x1) {
  const float dy = fmaxf(fmaxf(a.x - y1, y0 - a.y), 0.0f);
  const float dx = fmaxf(fmaxf(a.z - x1, x0 - a.w), 0.0f);
  return sum_sq(dy, dx);
}

// A coordinate's contribution to a bounding box: a NaN spans everything.
__device__ __forceinline__ void box_add(float v, float& lo, float& hi) {
  lo = fminf(lo, isnan(v) ? -CUDART_INF_F : v);
  hi = fmaxf(hi, isnan(v) ? CUDART_INF_F : v);
}

// min / max of the four box bounds over the lanes of each aligned group of
// `width` lanes (32: the warp).
__device__ __forceinline__ void box_reduce(float& y0, float& y1, float& x0,
                                           float& x1, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    y0 = fminf(y0, __shfl_xor_sync(kFull, y0, off));
    y1 = fmaxf(y1, __shfl_xor_sync(kFull, y1, off));
    x0 = fminf(x0, __shfl_xor_sync(kFull, x0, off));
    x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, off));
  }
}

// Morton code of a prescaled point: 16-bit cells of 1 / kInvCell units,
// 32768 at the origin, clamped (far points take the edge cells; NaN 0).
__device__ __forceinline__ unsigned spread_bits(unsigned v) {
  v &= 0xffffu;
  v = (v | (v << 8)) & 0x00ff00ffu;
  v = (v | (v << 4)) & 0x0f0f0f0fu;
  v = (v | (v << 2)) & 0x33333333u;
  v = (v | (v << 1)) & 0x55555555u;
  return v;
}

__device__ __forceinline__ unsigned morton_cell(float v) {
  return (unsigned)fminf(fmaxf(floorf(v * kInvCell) + 32768.0f, 0.0f),
                         65535.0f);
}

__device__ __forceinline__ unsigned morton(float y, float x) {
  return (spread_bits(morton_cell(y)) << 1) | spread_bits(morton_cell(x));
}

// Ascending bitonic sort of one 64-bit key per thread over a block of N
// threads (N a power of two): thread t returns the t-th smallest key.
// Partners within a warp swap by shuffles, others through `s` (N keys).
template <int N>
__device__ __forceinline__ unsigned long long block_sort(
    unsigned long long key, unsigned long long* s) {
  const int t = threadIdx.x;
#pragma unroll 1
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll 1
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned long long other;
      if (j >= 32) {
        s[t] = key;
        __syncthreads();
        other = s[t ^ j];
        __syncthreads();
      } else {
        other = __shfl_xor_sync(kFull, key, j);
      }
      const bool ascending = (t & k) == 0;
      const bool lower = (t & j) == 0;
      key = (lower == ascending) ? min(key, other) : max(key, other);
    }
  }
  return key;
}

// COUNT: adds the (query, slot) pairs the block computes to *pairs.
template <int C, bool BF16, bool COUNT>
__global__ void __launch_bounds__(kFwdThreads)
softmax_interp_fwd_kernel(const float* __restrict__ queries,  // [Q, 2]
                          const float* __restrict__ db,       // [G, N, 2]
                          const float* __restrict__ vals,     // [G, N, C]
                          const int* __restrict__ slots,      // [G, nqb, 2]
                          float* __restrict__ out,            // [G, Q, C]
                          float* __restrict__ den_out,        // [G, Q]
                          unsigned long long* __restrict__ pairs,
                          int q_count, int n, int nqb, float rscale) {
  constexpr int S = row_floats(C);
  constexpr int T = fwd_tile(C);
  constexpr int B = warp_buffer(C);
  __shared__ unsigned long long s_keys[kFwdThreads];
  __shared__ float2 s_q[kFwdThreads];
  __shared__ __align__(16) float s_tile[T * S];
  __shared__ __align__(16) float s_buf[kFwdWarps][B * S];
  const int g = blockIdx.y;
  const int q0 = blockIdx.x * kBandQ;
  const int cnt_q = min(kBandQ, q_count - q0);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int* range = slots + ((long long)g * nqb + blockIdx.x) * 2;
  const int lo = range[0];
  const int hi = range[1];

  // The block's queries along the Morton curve, ties and padding threads
  // (code 0xffffffff) in thread order.
  unsigned long long key = kPadKey | t;
  if (t < cnt_q) {
    const float2 p = __ldg(reinterpret_cast<const float2*>(queries) + q0 + t);
    const float py = p.x * rscale;
    const float px = p.y * rscale;
    s_q[t] = make_float2(py, px);
    key = ((unsigned long long)morton(py, px) << 32) | t;
  }
  key = block_sort<kFwdThreads>(key, s_keys);
  const int i = (int)(key & 0xffffffffu);
  const bool live = i < cnt_q;
  float qy = 0.0f, qx = 0.0f;
  float y0 = CUDART_INF_F, y1 = -CUDART_INF_F;
  float x0 = CUDART_INF_F, x1 = -CUDART_INF_F;
  if (live) {
    const float2 p = s_q[i];
    qy = p.x;
    qx = p.y;
    box_add(qy, y0, y1);
    box_add(qx, x0, x1);
  }
  box_reduce(y0, y1, x0, x1, 32);

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  float den = 0.0f;
  float* buf = s_buf[t >> 5];
  int nbuf = 0;
  unsigned walked = 0;  // points walked (COUNT)
  // Adds the buffered points, in slot order, to this lane's sums.
  auto walk = [&]() {
    __syncwarp();
#pragma unroll 4
    for (int k = 0; k < nbuf; ++k) {
      const float* e = buf + k * S;
      const float w = weight<BF16>(qy, qx, e[0], e[1]);
      den += w;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = fmaf(w, e[2 + c], acc[c]);
    }
    __syncwarp();
    if (COUNT) walked += nbuf;
    nbuf = 0;
  };

  const float2* dbg = reinterpret_cast<const float2*>(db) + (long long)g * n;
  const float* vg = vals + (long long)g * n * C;
  const unsigned below = (1u << lane) - 1u;
  for (int t0 = lo; t0 < hi; t0 += T) {
    const int cnt = min(T, hi - t0);
    // Rows past the range up to a multiple of 32 are far sentinels with
    // zero values (a NaN query's box takes them in: they add 0).
    const int rows = (cnt + 31) & ~31;
    __syncthreads();
    for (int j = t; j < rows; j += kFwdThreads) {
      float* e = s_tile + j * S;
      if (j < cnt) {
        const float2 d = __ldg(dbg + t0 + j);
        e[0] = d.x * rscale;
        e[1] = d.y * rscale;
        const float* v = vg + (long long)(t0 + j) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float x = __ldg(v + c);
          e[2 + c] = BF16 ? bf16_round(x) : x;
        }
      } else {
        e[0] = CUDART_INF_F;
        e[1] = CUDART_INF_F;
#pragma unroll
        for (int c = 0; c < C; ++c) e[2 + c] = 0.0f;
      }
    }
    __syncthreads();
    const float2* src = reinterpret_cast<const float2*>(s_tile + lane * S);
    for (int j0 = 0; j0 < rows; j0 += 32, src += 16 * S) {
      float2 row[S / 2];
#pragma unroll
      for (int f = 0; f < S / 2; ++f) row[f] = src[f];
      const bool keep = may_live(box_d2(row[0].x, row[0].y, y0, y1, x0, x1));
      const unsigned vote = __ballot_sync(kFull, keep);
      if (keep) {
        float2* dst = reinterpret_cast<float2*>(
            buf + (nbuf + __popc(vote & below)) * S);
#pragma unroll
        for (int f = 0; f < S / 2; ++f) dst[f] = row[f];
      }
      nbuf += __popc(vote);
      if (nbuf > B - 32) walk();
    }
  }
  walk();
  if (COUNT) {
    const unsigned lanes = __popc(__ballot_sync(kFull, live));
    if (lane == 0 && walked != 0u && lanes != 0u) {
      atomicAdd(pairs, (unsigned long long)walked * lanes);
    }
  }
  if (live) {
    const int q = q0 + i;
    const float inv = 1.0f / fmaxf(den, 1e-30f);
    float* o = out + ((long long)g * q_count + q) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = acc[c] * inv;
    den_out[(long long)g * q_count + q] = den;
  }
}

// Query blocks staged per barrier (backward: about 64 KB of rows) and the
// dynamic shared memory that takes, their rows and strip boxes, or the
// sort's keys and points before them, whichever is larger.
__host__ __device__ constexpr int bwd_chunk(int c) {
  return (64 * 1024) / (kBandQ * row_floats(c) * 4);
}
__host__ __device__ constexpr int bwd_smem(int c) {
  return bwd_chunk(c) * (kBandQ * row_floats(c) * 4 + kStrips * 16)
      > kBwdThreads * 16
      ? bwd_chunk(c) * (kBandQ * row_floats(c) * 4 + kStrips * 16)
      : kBwdThreads * 16;
}

// COUNT: adds the (query, slot) pairs the block computes to *pairs.
template <int C, bool BF16, bool COUNT>
__global__ void __launch_bounds__(kBwdThreads, 2)
softmax_interp_bwd_kernel(const float* __restrict__ queries,  // [Q, 2]
                          const float* __restrict__ db,       // [G, N, 2]
                          const float* __restrict__ gs,       // [G, Q, C]
                          const int* __restrict__ slots,      // [G, nqb, 2]
                          float* __restrict__ dvals,          // [G, N, C]
                          unsigned long long* __restrict__ pairs,
                          int q_count, int n, int nqb, float rscale) {
  constexpr int S = row_floats(C);
  constexpr int K = bwd_chunk(C);
  extern __shared__ __align__(16) float smem[];
  // Before the walk: the sort's keys and the tile's points.
  unsigned long long* s_keys = reinterpret_cast<unsigned long long*>(smem);
  float2* s_pt = reinterpret_cast<float2*>(smem + 2 * kBwdThreads);
  // During the walk: K staged query blocks' rows and strip boxes.
  float* s_q = smem;
  float4* s_box = reinterpret_cast<float4*>(smem + K * kBandQ * S);
  const int g = blockIdx.y;
  const int tile_lo = blockIdx.x * kBwdThreads;
  const int cnt_s = min(kBwdThreads, n - tile_lo);
  const int tile_hi = tile_lo + cnt_s;
  const int t = threadIdx.x;
  const int lane = t & 31;

  // The tile's slots along the Morton curve, ties and padding threads
  // (code 0xffffffff) in thread order.
  unsigned long long key = kPadKey | t;
  if (t < cnt_s) {
    const float2 d = __ldg(reinterpret_cast<const float2*>(db)
                           + (long long)g * n + tile_lo + t);
    const float py = d.x * rscale;
    const float px = d.y * rscale;
    s_pt[t] = make_float2(py, px);
    key = ((unsigned long long)morton(py, px) << 32) | t;
  }
  key = block_sort<kBwdThreads>(key, s_keys);
  const int i = (int)(key & 0xffffffffu);
  const bool live = i < cnt_s;
  const int slot = tile_lo + i;
  float dy = 0.0f, dx = 0.0f;
  if (live) {
    const float2 p = s_pt[i];
    dy = p.x;
    dx = p.y;
  }

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  unsigned walked = 0;  // queries added (COUNT)
  const int* ranges = slots + (long long)g * nqb * 2;
  const float* gsg = gs + (long long)g * q_count * C;
  // The query blocks whose ranges meet the tile, in ascending order, K at
  // a time (the same for the whole block).
  int qb = 0;
  while (true) {
    int chunk[K];
    int k_count = 0;
    for (; qb < nqb && k_count < K; ++qb) {
      const int lo = __ldg(ranges + 2 * qb);
      const int hi = __ldg(ranges + 2 * qb + 1);
      if (hi > tile_lo && lo < tile_hi) chunk[k_count++] = qb;
    }
    if (k_count == 0) break;
    __syncthreads();
    // Stage query r of the chunk (r = t, t + 1024, ...) with its strip's
    // box; 8 consecutive lanes hold one strip.
    for (int r = t; r < K * kBandQ; r += kBwdThreads) {
      const int k = r / kBandQ;
      const int j = r - k * kBandQ;
      float b0 = CUDART_INF_F, b1 = -CUDART_INF_F;
      float b2 = CUDART_INF_F, b3 = -CUDART_INF_F;
      if (k < k_count) {
        const int q = chunk[k] * kBandQ + j;
        if (q < q_count) {
          const float2 p = __ldg(reinterpret_cast<const float2*>(queries) + q);
          float* e = s_q + r * S;
          const float py = p.x * rscale;
          const float px = p.y * rscale;
          e[0] = py;
          e[1] = px;
          box_add(py, b0, b1);
          box_add(px, b2, b3);
          const float* v = gsg + (long long)q * C;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float x = __ldg(v + c);
            e[2 + c] = BF16 ? bf16_round(x) : x;
          }
        }
      }
      box_reduce(b0, b1, b2, b3, kStrip);
      if ((r & (kStrip - 1)) == 0) {
        s_box[r / kStrip] = make_float4(b0, b1, b2, b3);
      }
    }
    __syncthreads();
    for (int k = 0; k < k_count; ++k) {
      const int qb_k = chunk[k];
      const int lo = __ldg(ranges + 2 * qb_k);
      const int hi = __ldg(ranges + 2 * qb_k + 1);
      const int cnt = min(kBandQ, q_count - qb_k * kBandQ);
      const float* sq = s_q + k * kBandQ * S;
      const float4* sbox = s_box + k * kStrips;
      // The query block's box, from its strips' boxes.
      const float4 sa = sbox[lane];
      const float4 sb = sbox[lane + 32];
      float y0 = fminf(sa.x, sb.x), y1 = fmaxf(sa.y, sb.y);
      float x0 = fminf(sa.z, sb.z), x1 = fmaxf(sa.w, sb.w);
      box_reduce(y0, y1, x0, x1, 32);
      const bool near = live && slot >= lo && slot < hi
          && may_live(box_d2(dy, dx, y0, y1, x0, x1));
      if (!__any_sync(kFull, near)) continue;
      // The box of the warp's near slots, and the strips within the cut.
      y0 = CUDART_INF_F, y1 = -CUDART_INF_F;
      x0 = CUDART_INF_F, x1 = -CUDART_INF_F;
      if (near) {
        box_add(dy, y0, y1);
        box_add(dx, x0, x1);
      }
      box_reduce(y0, y1, x0, x1, 32);
      const unsigned lo_strips =
          __ballot_sync(kFull, may_live(gap_d2(sa, y0, y1, x0, x1)));
      const unsigned hi_strips =
          __ballot_sync(kFull, may_live(gap_d2(sb, y0, y1, x0, x1)));
      unsigned long long strips =
          ((unsigned long long)hi_strips << 32) | lo_strips;
      if (near) {
        // Adds staged query j to this lane's sums.
        auto add = [&](int j) {
          const float* e = sq + j * S;
          const float w = weight<BF16>(e[0], e[1], dy, dx);
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] = fmaf(w, e[2 + c], acc[c]);
        };
        while (strips) {
          const int j0 = (__ffsll((long long)strips) - 1) * kStrip;
          strips &= strips - 1;
          if (j0 + kStrip <= cnt) {
#pragma unroll
            for (int j = 0; j < kStrip; ++j) add(j0 + j);
            if (COUNT) walked += kStrip;
          } else {
            for (int j = j0; j < cnt; ++j) add(j);
            if (COUNT && j0 < cnt) walked += cnt - j0;
          }
        }
      }
    }
  }
  if (COUNT) {
    unsigned long long sum = walked;
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(kFull, sum, off);
    }
    if (lane == 0 && sum != 0ull) atomicAdd(pairs, sum);
  }
  if (live) {
    float* o = dvals + ((long long)g * n + slot) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = acc[c];
  }
}

template <int C, bool BF16>
int launch_fwd(const float* queries, const float* db, const float* vals,
               const int* slots, float* out, float* den,
               unsigned long long* pairs, int g, int q, int n, int nqb,
               float rscale, cudaStream_t stream) {
  const dim3 grid(nqb, g);
  if (pairs != nullptr) {
    softmax_interp_fwd_kernel<C, BF16, true><<<grid, kFwdThreads, 0, stream>>>(
        queries, db, vals, slots, out, den, pairs, q, n, nqb, rscale);
  } else {
    softmax_interp_fwd_kernel<C, BF16, false>
        <<<grid, kFwdThreads, 0, stream>>>(queries, db, vals, slots, out, den,
                                           pairs, q, n, nqb, rscale);
  }
  return 0;
}

template <int C, bool BF16>
int launch_bwd(const float* queries, const float* db, const float* gs,
               const int* slots, float* dvals, unsigned long long* pairs,
               int g, int q, int n, int nqb, float rscale,
               cudaStream_t stream) {
  constexpr int smem = bwd_smem(C);
  const dim3 grid((n + kBwdThreads - 1) / kBwdThreads, g);
  if (pairs != nullptr) {
    softmax_interp_bwd_kernel<C, BF16, true>
        <<<grid, kBwdThreads, smem, stream>>>(queries, db, gs, slots, dvals,
                                              pairs, q, n, nqb, rscale);
  } else {
    softmax_interp_bwd_kernel<C, BF16, false>
        <<<grid, kBwdThreads, smem, stream>>>(queries, db, gs, slots, dvals,
                                              pairs, q, n, nqb, rscale);
  }
  return 0;
}

// Lets every backward kernel of C channels take its dynamic shared memory.
template <int C>
cudaError_t allow_bwd_smem() {
  const void* fns[] = {
      (const void*)softmax_interp_bwd_kernel<C, false, false>,
      (const void*)softmax_interp_bwd_kernel<C, false, true>,
      (const void*)softmax_interp_bwd_kernel<C, true, false>,
      (const void*)softmax_interp_bwd_kernel<C, true, true>};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bwd_smem(C));
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

#define SI_DISPATCH(FN, BF16, C_RUNTIME, ...)              \
  switch (C_RUNTIME) {                                     \
    case 1: err = FN<1, BF16>(__VA_ARGS__); break;         \
    case 2: err = FN<2, BF16>(__VA_ARGS__); break;         \
    case 3: err = FN<3, BF16>(__VA_ARGS__); break;         \
    case 4: err = FN<4, BF16>(__VA_ARGS__); break;         \
    case 5: err = FN<5, BF16>(__VA_ARGS__); break;         \
    case 6: err = FN<6, BF16>(__VA_ARGS__); break;         \
    case 7: err = FN<7, BF16>(__VA_ARGS__); break;         \
    case 8: err = FN<8, BF16>(__VA_ARGS__); break;         \
    default: return (int)cudaErrorInvalidValue;            \
  }

bool bad_shape(int g, int q, int n, int nqb, int c) {
  return g < 0 || g > 65535 || q < 0 || n < 0 || c < 1 || c > kMaxC
      || nqb != (q + kBandQ - 1) / kBandQ;
}

}  // namespace

extern "C" {

// Once per device, before its first softmax_interp_bwd: lets the backward
// kernels take their dynamic shared memory.
int softmax_interp_setup(void) {
  const cudaError_t errs[] = {allow_bwd_smem<1>(), allow_bwd_smem<2>(),
                              allow_bwd_smem<3>(), allow_bwd_smem<4>(),
                              allow_bwd_smem<5>(), allow_bwd_smem<6>(),
                              allow_bwd_smem<7>(), allow_bwd_smem<8>()};
  for (const cudaError_t err : errs) {
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// queries [Q, 2], db [G, N, 2], vals [G, N, C] f32 and slots [G, nqb, 2]
// int32 (nqb = ceil(Q / 512)), all contiguous; writes out [G, Q, C] and
// den [G, Q].  bf16 != 0 rounds as the TPU kernel's bfloat16 exp_dtype.
// pairs: null, or a counter on the card that the kernel adds the (query,
// slot) pairs it computes to (a build of the kernel with the count).
int softmax_interp_fwd(const float* queries, const float* db,
                       const float* vals, const int* slots, float* out,
                       float* den, unsigned long long* pairs, int g, int q,
                       int n, int c, int nqb, float rscale, int bf16,
                       void* stream) {
  if (bad_shape(g, q, n, nqb, c)) return (int)cudaErrorInvalidValue;
  if (g == 0 || q == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int err = 0;
  if (bf16) {
    SI_DISPATCH(launch_fwd, true, c, queries, db, vals, slots, out, den,
                pairs, g, q, n, nqb, rscale, s);
  } else {
    SI_DISPATCH(launch_fwd, false, c, queries, db, vals, slots, out, den,
                pairs, g, q, n, nqb, rscale, s);
  }
  return err != 0 ? err : (int)cudaGetLastError();
}

// gs [G, Q, C] f32 (the output cotangent over max(den, 1e-30)) contiguous;
// writes every entry of dvals [G, N, C]; pairs as in softmax_interp_fwd.
// softmax_interp_setup has run on the current device.
int softmax_interp_bwd(const float* queries, const float* db, const float* gs,
                       const int* slots, float* dvals,
                       unsigned long long* pairs, int g, int q, int n, int c,
                       int nqb, float rscale, int bf16, void* stream) {
  if (bad_shape(g, q, n, nqb, c)) return (int)cudaErrorInvalidValue;
  if (g == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int err = 0;
  if (bf16) {
    SI_DISPATCH(launch_bwd, true, c, queries, db, gs, slots, dvals, pairs, g,
                q, n, nqb, rscale, s);
  } else {
    SI_DISPATCH(launch_bwd, false, c, queries, db, gs, slots, dvals, pairs, g,
                q, n, nqb, rscale, s);
  }
  return err != 0 ? err : (int)cudaGetLastError();
}

}  // extern "C"
