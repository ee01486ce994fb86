// Exact K nearest neighbours of 2-D points, the distance and the top-K
// selection fused: the focus loss's KNN over all database points
// (ops/knn.py::knn_blocked, knn_method 'exact' and 'approx').
//
// Replaces no TPU kernel: the JAX package leaves this KNN to XLA
// (lax.top_k over a materialised distance block).  It was added because the
// port's PyTorch version of that, distance blocks of ~1 GiB, three
// elementwise passes over each and torch.topk's radix select, took 89% of
// the exact flow-training step.
//
// For each group g, query q and database point n:
//
//   l2: v = (qq - 2 cross) + dd, the expanded form the PyTorch version
//       ranks by (ops/cuda/knn_topk.py::pairwise_dist), with its roundings:
//         qq    = q0 q0 + q1 q1,  dd = p0 p0 + p1 p1   (each product rounded,
//                                                       then the sum)
//         cross = fmaf(q1, p1, q0 p0)                   (cuBLAS's two-term
//                                                       FFMA chain)
//         v     = fmaf(-2, cross, qq) + dd              (the doubling is
//                                                       exact, so the fma
//                                                       is torch's subtract)
//   l1: v = |q0 - p0| + |q1 - p1|
//
// and the K smallest (v, n) pairs in lexicographic order: at equal v the
// lower index wins, so the set does not depend on the order of the scan.
// v is ordered as torch orders floats (NaN last).  Output, nearest first:
// idx [G, Q, K] int64 and dist [G, Q, K] f32, dist refined by direct
// subtraction for l2, (q0 - p0)^2 + (q1 - p1)^2, and v itself for l1.  No
// product is contracted into an fma except where written above
// (__fmul_rn / __fadd_rn / __fmaf_rn).
//
// Bound: operations.  Each (query, point) pair costs 5 f32 lane operations
// (the product, the two fmas, the add, the compare with the running K-th
// value); at the flow-training shape (G = 210, Q = N = 19,200) that is
// 3.9e11 over 132 SMs x 128 lanes x 1.98 GHz: 11.6 ms.  Bytes are small: a
// group's points are 150 KB, all groups' 32 MB, within the 50 MB L2; the
// outputs (12 bytes per neighbour) are 1.5 GB, ~0.46 ms at 3.35 TB/s.
//
// Design: a block of kThreads threads takes one group and kThreads
// consecutive queries, one per thread.  Each query keeps its K nearest as
// a sorted list of 64-bit keys (order key of v << 32 | n) in registers, K
// padded up to the list length KMAX (16, 32 or 64) by keys of 0 at the
// front (they never move), and its current K-th value as a float
// threshold.  The block streams the group's points through shared memory
// in chunks of kChunk, with dd computed once per point at staging; every
// thread reads the same point (a broadcast 16-byte load of y, x, dd, n).
// Each thread tests kGroup points at a time against its threshold and
// branches once per group: a pair above the threshold costs the 5
// operations; a pair at or below it (or NaN) takes the slow path, which
// compares the full key and, if smaller than the list's last, inserts it
// by an unrolled compare-and-shift.  The scan starts about two grid rows
// (2 sqrt(N) points) before the block's own queries, mapped to the
// database by the index ratio N / Q, and wraps around: database and
// queries are row-major tiles of the same grid in the focus loss, so the
// thresholds are tight after a band of rows.  Every point is scanned
// exactly once whatever the data, so the result is exact for any flow;
// the start only changes how often the slow path runs.
//
// K above 64 runs in passes of up to 64 slots, one launch each, in
// order: a later pass takes the smallest keys above a floor, the key of
// the previous pass's last neighbour (its value recomputed from the index
// it wrote, by the same operations), so the passes write consecutive
// slices of one sorted list.  Each pass scans every point again.  More
// than 65,535 groups (the grid's y limit) run in chunks of groups.
//
// What bounds it on the card (PERF.md, section 6): at the flow shape the scan
// alone takes ~27 ms, held by the 16-byte broadcast loads (two queries
// per thread halve them but cost the occupancy the lists' registers
// need), and the insertions another ~11 ms: ~130 per query, most within
// the first thousand points, where a warp's lanes insert at different
// points.  Deferring insertions to batch a warp's lanes and bubble
// insertion with an early exit were slower; a 3-operation pre-test with a
// rounding margin gained 4%, and lost 1.7x where far points widen the
// margin of a chunk.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 2048;
constexpr int kGroup = 8;
constexpr unsigned long long kEmpty = ~0ull;

// Floats as unsigned ints in torch's order: -inf < ... < -0 < +0 < ... <
// +inf < NaN (every NaN the largest key).
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(v);
  if (v != v) return 0xffffffffu;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The inverse of order_key; the largest key gives NaN, which no compare
// rejects (the list is not full yet).
__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

__device__ __forceinline__ float sq_norm(float a, float b) {
  return __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
}

// The ranking value of a query (q0, q1, qq) and a staged point p = (p0, p1,
// dd, n).
template <bool L1>
__device__ __forceinline__ float rank_value(float q0, float q1, float qq,
                                            float4 p) {
  if (L1) return __fadd_rn(fabsf(__fsub_rn(q0, p.x)),
                           fabsf(__fsub_rn(q1, p.y)));
  const float cross = __fmaf_rn(q1, p.y, __fmul_rn(q0, p.x));
  return __fadd_rn(__fmaf_rn(-2.0f, cross, qq), p.z);
}

// The distance written out: refined by direct subtraction (l2), or the
// ranking value itself (l1).
template <bool L1>
__device__ __forceinline__ float out_dist(float q0, float q1, float2 p) {
  const float d0 = __fsub_rn(q0, p.x), d1 = __fsub_rn(q1, p.y);
  if (L1) return __fadd_rn(fabsf(d0), fabsf(d1));
  return sq_norm(d0, d1);
}

// Insert c into the ascending list l, given c < l[KMAX - 1].
template <int KMAX>
__device__ __forceinline__ void insert(unsigned long long (&l)[KMAX],
                                       unsigned long long c) {
#pragma unroll
  for (int j = KMAX - 1; j > 0; --j)
    l[j] = c < l[j - 1] ? l[j - 1] : (c < l[j] ? c : l[j]);
  l[0] = c < l[0] ? c : l[0];
}

// Test the kGroup staged points at pts against the query, then send each
// at or below the threshold through the slow path, which with FLOOR takes
// only keys above `lo`.
template <int KMAX, int NP, bool L1, bool FLOOR>
__device__ __forceinline__ void scan(const float4* pts, float q0, float q1,
                                     float qq, unsigned long long lo,
                                     float& thr,
                                     unsigned long long (&list)[KMAX]) {
  float4 p[NP];
  float v[NP];
  bool any = false;
#pragma unroll
  for (int a = 0; a < NP; ++a) p[a] = pts[a];
#pragma unroll
  for (int a = 0; a < NP; ++a) {
    v[a] = rank_value<L1>(q0, q1, qq, p[a]);
    any |= !(v[a] > thr);
  }
  if (!any) return;
#pragma unroll
  for (int a = 0; a < NP; ++a) {
    if (v[a] > thr) continue;
    const unsigned long long c =
        ((unsigned long long)order_key(v[a]) << 32) | __float_as_uint(p[a].w);
    if (c < list[KMAX - 1] && (!FLOOR || c > lo)) {
      insert<KMAX>(list, c);
      thr = key_value((uint32_t)(list[KMAX - 1] >> 32));
    }
  }
}

// One pass writes slots [koff, koff + k) of each query's row of kstride;
// with FLOOR (koff > 0) it reads the row's slot koff - 1 for its floor.
// A minimum of 1 block per SM: the register allocator then keeps ~110
// registers (K = 32), and the scan runs 5% faster than with the 96 it
// takes by default.
template <int KMAX, bool L1, bool FLOOR>
__global__ void __launch_bounds__(kThreads, 1)
knn_topk_kernel(const float2* __restrict__ queries,
                const float2* __restrict__ db, long long* __restrict__ out_idx,
                float* __restrict__ out_dist_, int nq, int n, int k,
                int kstride, int koff, int lead) {
  __shared__ float4 pts[kChunk];
  const float2* gdb = db + (long long)blockIdx.y * n;
  const int q_lo = blockIdx.x * kThreads;
  const int q = q_lo + (int)threadIdx.x;
  const int qc = min(q, nq - 1);

  const float2 c = queries[qc];
  const float q0 = c.x, q1 = c.y, qq = sq_norm(c.x, c.y);
  const long long row = ((long long)blockIdx.y * nq + qc) * kstride;
  unsigned long long lo = 0;
  if (FLOOR) {
    const uint32_t m = (uint32_t)out_idx[row + koff - 1];
    const float2 p = gdb[m];
    const float v = rank_value<L1>(
        q0, q1, qq, make_float4(p.x, p.y, sq_norm(p.x, p.y), 0.0f));
    lo = ((unsigned long long)order_key(v) << 32) | m;
  }
  float thr = key_value(0xffffffffu);
  unsigned long long list[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) list[j] = j < KMAX - k ? 0ull : kEmpty;

  long long s = ((long long)q_lo * n / nq - lead) % n;
  const int start = (int)(s < 0 ? s + n : s);

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int cnt = min(kChunk, n - c0);
    __syncthreads();                    // the previous chunk is consumed
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      uint32_t m = (uint32_t)start + c0 + j;
      if (m >= (uint32_t)n) m -= n;
      const float2 p = gdb[m];
      pts[j] = make_float4(p.x, p.y, sq_norm(p.x, p.y), __uint_as_float(m));
    }
    __syncthreads();
    int j = 0;
#pragma unroll 1
    for (; j + kGroup <= cnt; j += kGroup)
      scan<KMAX, kGroup, L1, FLOOR>(pts + j, q0, q1, qq, lo, thr, list);
    for (; j < cnt; ++j)
      scan<KMAX, 1, L1, FLOOR>(pts + j, q0, q1, qq, lo, thr, list);
  }

  if (q >= nq) return;
  const long long base = row + koff - (KMAX - k);
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < KMAX - k) continue;
    const uint32_t m = (uint32_t)list[j];
    out_idx[base + j] = m;
    out_dist_[base + j] = out_dist<L1>(q0, q1, gdb[m]);
  }
}

template <int KMAX, bool L1, bool FLOOR>
void run_pass(dim3 grid, cudaStream_t stream, const float2* queries,
           const float2* db, long long* idx, float* dist, int nq, int n,
           int k, int kstride, int koff, int lead) {
  knn_topk_kernel<KMAX, L1, FLOOR><<<grid, kThreads, 0, stream>>>(
      queries, db, idx, dist, nq, n, k, kstride, koff, lead);
}

// One pass over g groups: slots [koff, koff + k) of rows of kstride.
template <int KMAX>
int launch(const float* queries, const float* db, long long* idx,
           float* dist, int g, int nq, int n, int k, int kstride, int koff,
           int l1, cudaStream_t stream) {
  const dim3 grid((nq + kThreads - 1) / kThreads, g);
  const int lead = (int)(2.0 * sqrt((double)n));
  const float2* q2 = reinterpret_cast<const float2*>(queries);
  const float2* d2 = reinterpret_cast<const float2*>(db);
  auto* f = l1 ? (koff ? run_pass<KMAX, true, true>
                       : run_pass<KMAX, true, false>)
               : (koff ? run_pass<KMAX, false, true>
                       : run_pass<KMAX, false, false>);
  f(grid, stream, q2, d2, idx, dist, nq, n, k, kstride, koff, lead);
  return (int)cudaGetLastError();
}

constexpr int kPassK = 64;          // the longest list: one pass
constexpr int kMaxGroups = 65535;   // gridDim.y

}  // namespace

extern "C" {

// queries [Q, 2], db [G, N, 2] f32 (8-byte aligned), idx [G, Q, K] int64,
// dist [G, Q, K] f32; all contiguous; 1 <= K <= N; l1: 0 for squared l2,
// 1 for l1.  ceil(K / 64) launches per chunk of 65,535 groups, in order
// on `stream`.
int knn_topk(const float* queries, const float* db, long long* idx,
             float* dist, int g, int nq, int n, int k, int l1, void* stream) {
  if ((long long)g * nq == 0) return 0;
  if (k < 1 || k > n || ((uintptr_t)queries & 7) != 0 ||
      ((uintptr_t)db & 7) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  for (int g0 = 0; g0 < g; g0 += kMaxGroups) {
    const int gc = min(kMaxGroups, g - g0);
    const float* d = db + (long long)g0 * n * 2;
    long long* i = idx + (long long)g0 * nq * k;
    float* o = dist + (long long)g0 * nq * k;
    for (int off = 0; off < k; off += kPassK) {
      const int kp = min(kPassK, k - off);
      const int err =
          kp <= 16 ? launch<16>(queries, d, i, o, gc, nq, n, kp, k, off, l1, st)
          : kp <= 32
              ? launch<32>(queries, d, i, o, gc, nq, n, kp, k, off, l1, st)
              : launch<64>(queries, d, i, o, gc, nq, n, kp, k, off, l1, st);
      if (err != 0) return err;
    }
  }
  return 0;
}

}  // extern "C"
