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
//   backward: dvals[g, n] = sum_q w[q, n] gs[g, q],  gs = g_out / max(den, 1e-30)
//
// No max-subtraction: every exponent is <= 0, and a query whose scanned
// points are all far away gets den = 0 and out = 0 (not NaN, not its
// nearest point).  The squared distance is taken in difference form: the
// expansion q.q + d.d - 2 q.d loses px^2-scale bits at ~640 px coordinates.
// With BF16 the exponent and the weight are rounded to bf16, and so are the
// values (forward) and gs (backward); sums stay f32 (the TPU kernel's
// exp_dtype=bfloat16).
//
// Bound: operations.  At the flow-training shape (G = 210, Q = N = 19,200,
// C = 2, per-bin band) each pass scans ~2.1e10 (query, slot) pairs; each
// pair costs one exp2 on the special-function units (16 per SM per clock)
// and ~7 f32 instructions (128 per SM per clock), so the SFU rate sets
// ~5 ms per pass on an H100.  Bytes are ~0.1 GB per pass, under 0.05 ms.
//
// Design: forward, one thread per query, 256 queries per block (half a
// band block, so one scanned range per block); the range's db slots are
// staged through shared memory in tiles of 512, prescaled (and rounded),
// and every thread keeps its C + 1 running sums in registers.  Backward,
// one thread per db slot, 256 slots per block; the block walks the 512-query
// blocks whose ranges meet its slots (any query order: the ranges are
// tested, not assumed monotone), stages each block's prescaled queries and
// gs in shared memory, and sums in a fixed order: no atomics, deterministic.
// Slot ranges are multiples of 1024 or N, so a block's threads agree on
// whether a range covers them, up to the last partial tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBandQ = 512;     // queries per band block (the TPU's BQ)
constexpr int kTile = 512;      // db slots staged per pass (forward)
constexpr int kMaxC = 8;

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

template <int C, bool BF16>
__global__ void __launch_bounds__(kThreads)
softmax_interp_fwd_kernel(const float* __restrict__ queries,  // [Q, 2]
                          const float* __restrict__ db,       // [G, N, 2]
                          const float* __restrict__ vals,     // [G, N, C]
                          const int* __restrict__ slots,      // [G, nqb, 2]
                          float* __restrict__ out,            // [G, Q, C]
                          float* __restrict__ den_out,        // [G, Q]
                          int q_count, int n, int nqb, float rscale) {
  __shared__ float s_y[kTile];
  __shared__ float s_x[kTile];
  __shared__ float s_v[kTile * C];
  const int g = blockIdx.y;
  const int q0 = blockIdx.x * kThreads;
  const int q = q0 + threadIdx.x;
  const int* range = slots + ((long long)g * nqb + q0 / kBandQ) * 2;
  const int lo = range[0];
  const int hi = range[1];
  const bool live = q < q_count;
  float qy = 0.0f, qx = 0.0f;
  if (live) {
    const float2 p = __ldg(reinterpret_cast<const float2*>(queries) + q);
    qy = p.x * rscale;
    qx = p.y * rscale;
  }
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  float den = 0.0f;
  const float2* dbg = reinterpret_cast<const float2*>(db) + (long long)g * n;
  const float* vg = vals + (long long)g * n * C;
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int cnt = min(kTile, hi - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      const float2 d = __ldg(dbg + t0 + i);
      s_y[i] = d.x * rscale;
      s_x[i] = d.y * rscale;
    }
    for (int i = threadIdx.x; i < cnt * C; i += kThreads) {
      const float v = __ldg(vg + (long long)t0 * C + i);
      s_v[i] = BF16 ? bf16_round(v) : v;
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < cnt; ++j) {
        const float w = weight<BF16>(qy, qx, s_y[j], s_x[j]);
        den += w;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = fmaf(w, s_v[j * C + c], acc[c]);
      }
    }
  }
  if (live) {
    const float inv = 1.0f / fmaxf(den, 1e-30f);
    float* o = out + ((long long)g * q_count + q) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = acc[c] * inv;
    den_out[(long long)g * q_count + q] = den;
  }
}

template <int C, bool BF16>
__global__ void __launch_bounds__(kThreads)
softmax_interp_bwd_kernel(const float* __restrict__ queries,  // [Q, 2]
                          const float* __restrict__ db,       // [G, N, 2]
                          const float* __restrict__ gs,       // [G, Q, C]
                          const int* __restrict__ slots,      // [G, nqb, 2]
                          float* __restrict__ dvals,          // [G, N, C]
                          int q_count, int n, int nqb, float rscale) {
  __shared__ float s_y[kBandQ];
  __shared__ float s_x[kBandQ];
  __shared__ float s_g[kBandQ * C];
  const int g = blockIdx.y;
  const int tile_lo = blockIdx.x * kThreads;
  const int tile_hi = min(tile_lo + kThreads, n);
  const int slot = tile_lo + threadIdx.x;
  const bool live = slot < n;
  float dy = 0.0f, dx = 0.0f;
  if (live) {
    const float2 d = __ldg(reinterpret_cast<const float2*>(db)
                           + (long long)g * n + slot);
    dy = d.x * rscale;
    dx = d.y * rscale;
  }
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  const int* ranges = slots + (long long)g * nqb * 2;
  const float* gsg = gs + (long long)g * q_count * C;
  for (int qb = 0; qb < nqb; ++qb) {
    const int lo = __ldg(ranges + 2 * qb);
    const int hi = __ldg(ranges + 2 * qb + 1);
    if (hi <= tile_lo || lo >= tile_hi) continue;   // the same for the block
    const int qs = qb * kBandQ;
    const int cnt = min(kBandQ, q_count - qs);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      const float2 p = __ldg(reinterpret_cast<const float2*>(queries) + qs + i);
      s_y[i] = p.x * rscale;
      s_x[i] = p.y * rscale;
    }
    for (int i = threadIdx.x; i < cnt * C; i += kThreads) {
      const float v = __ldg(gsg + (long long)qs * C + i);
      s_g[i] = BF16 ? bf16_round(v) : v;
    }
    __syncthreads();
    if (live && slot >= lo && slot < hi) {
      for (int j = 0; j < cnt; ++j) {
        const float w = weight<BF16>(s_y[j], s_x[j], dy, dx);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = fmaf(w, s_g[j * C + c], acc[c]);
      }
    }
  }
  if (live) {
    float* o = dvals + ((long long)g * n + slot) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = acc[c];
  }
}

template <int C, bool BF16>
void launch_fwd(const float* queries, const float* db, const float* vals,
                const int* slots, float* out, float* den, int g, int q,
                int n, int nqb, float rscale, cudaStream_t stream) {
  const dim3 grid((q + kThreads - 1) / kThreads, g);
  softmax_interp_fwd_kernel<C, BF16><<<grid, kThreads, 0, stream>>>(
      queries, db, vals, slots, out, den, q, n, nqb, rscale);
}

template <int C, bool BF16>
void launch_bwd(const float* queries, const float* db, const float* gs,
                const int* slots, float* dvals, int g, int q, int n, int nqb,
                float rscale, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, g);
  softmax_interp_bwd_kernel<C, BF16><<<grid, kThreads, 0, stream>>>(
      queries, db, gs, slots, dvals, q, n, nqb, rscale);
}

#define SI_DISPATCH(FN, BF16, C_RUNTIME, ...)              \
  switch (C_RUNTIME) {                                     \
    case 1: FN<1, BF16>(__VA_ARGS__); break;               \
    case 2: FN<2, BF16>(__VA_ARGS__); break;               \
    case 3: FN<3, BF16>(__VA_ARGS__); break;               \
    case 4: FN<4, BF16>(__VA_ARGS__); break;               \
    case 5: FN<5, BF16>(__VA_ARGS__); break;               \
    case 6: FN<6, BF16>(__VA_ARGS__); break;               \
    case 7: FN<7, BF16>(__VA_ARGS__); break;               \
    case 8: FN<8, BF16>(__VA_ARGS__); break;               \
    default: return (int)cudaErrorInvalidValue;            \
  }

bool bad_shape(int g, int q, int n, int nqb, int c) {
  return g < 0 || g > 65535 || q < 0 || n < 0 || c < 1 || c > kMaxC
      || nqb != (q + kBandQ - 1) / kBandQ;
}

}  // namespace

extern "C" {

// queries [Q, 2], db [G, N, 2], vals [G, N, C] f32 and slots [G, nqb, 2]
// int32 (nqb = ceil(Q / 512)), all contiguous; writes out [G, Q, C] and
// den [G, Q].  bf16 != 0 rounds as the TPU kernel's bfloat16 exp_dtype.
int softmax_interp_fwd(const float* queries, const float* db,
                       const float* vals, const int* slots, float* out,
                       float* den, int g, int q, int n, int c, int nqb,
                       float rscale, int bf16, void* stream) {
  if (bad_shape(g, q, n, nqb, c)) return (int)cudaErrorInvalidValue;
  if (g == 0 || q == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    SI_DISPATCH(launch_fwd, true, c, queries, db, vals, slots, out, den, g, q,
                n, nqb, rscale, s);
  } else {
    SI_DISPATCH(launch_fwd, false, c, queries, db, vals, slots, out, den, g,
                q, n, nqb, rscale, s);
  }
  return (int)cudaGetLastError();
}

// gs [G, Q, C] f32 (the output cotangent over max(den, 1e-30)) contiguous;
// writes every entry of dvals [G, N, C].
int softmax_interp_bwd(const float* queries, const float* db, const float* gs,
                       const int* slots, float* dvals, int g, int q, int n,
                       int c, int nqb, float rscale, int bf16, void* stream) {
  if (bad_shape(g, q, n, nqb, c)) return (int)cudaErrorInvalidValue;
  if (g == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    SI_DISPATCH(launch_bwd, true, c, queries, db, gs, slots, dvals, g, q, n,
                nqb, rscale, s);
  } else {
    SI_DISPATCH(launch_bwd, false, c, queries, db, gs, slots, dvals, g, q, n,
                nqb, rscale, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
