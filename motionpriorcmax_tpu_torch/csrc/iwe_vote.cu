// Bilinear vote of warped events into an image (IWE), forward and backward.
//
// Replaces the TPU kernels of motionpriorcmax_tpu/ops/pallas/iwe_vote.py:
//   iwe_vote_pallas_sorted (_banded_fwd_call / _banded_bwd_call), the vote
//   of cell-sorted events on the flow-training path, and
//   iwe_vote_pallas (_full_fwd_call / _full_bwd_call), the same function on
//   unsorted events.
// Those build one-hot tap tiles for the TPU's matrix unit, in bf16.  This
// kernel computes the exact f32 function of the JAX 'direct' path
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
// 4-byte atomic adds into the image; at the flow-training shape (B = 14,
// M = 2^19 per polarity half, 480 x 640) the needed bytes are 88 MB of
// events plus the 17 MB image written once: ~31 us at 3.35 TB/s.  The
// atomics land in L2 (the image fits in its 50 MB), so their rate and
// same-address conflicts, not device memory, set the time.  Backward, per
// event 12 bytes in, four 4-byte image reads (L2-resident) and 8 (+4 for
// d weight) bytes out, no atomics: deterministic.
//
// Design: one thread per event, consecutive threads on consecutive events
// (coalesced 8-byte coordinate loads and stores).  Events of zero weight
// (padding, masked borders) make no atomics.  Coordinates are clamped
// before the float-to-int cast to [-3, size + 2]: every tap of a clamped
// coordinate is still out of the image, as every tap of the original was,
// so the clamp changes no result and the cast is always defined (early
// training warps events by up to ~1e9 px).  Per-batch strides let the
// caller vote one polarity half of a larger event array without a copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads)
iwe_vote_fwd_kernel(const float* __restrict__ coords,
                    const float* __restrict__ weight,
                    float* __restrict__ out, long long n_events, int m,
                    long long coords_bstride, long long weight_bstride,
                    int h, int w) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_events) return;
  const long long b = i / m;
  const long long e = i - b * m;
  const float v = __ldg(weight + b * weight_bstride + e);
  if (v == 0.0f) return;
  const float2 yx = __ldg(reinterpret_cast<const float2*>(
      coords + b * coords_bstride + 2 * e));
  const Taps t = make_taps(yx.x, yx.y, h, w);
  float* img = out + b * (long long)h * w + (long long)t.y1 * w + t.x1;
  if (t.m00) atomicAdd(img, t.wy0 * t.wx0 * v);
  if (t.m10) atomicAdd(img + w, t.wy1 * t.wx0 * v);
  if (t.m01) atomicAdd(img + 1, t.wy0 * t.wx1 * v);
  if (t.m11) atomicAdd(img + w + 1, t.wy1 * t.wx1 * v);
}

__global__ void __launch_bounds__(kThreads)
iwe_vote_bwd_kernel(const float* __restrict__ coords,
                    const float* __restrict__ weight,
                    const float* __restrict__ grad,
                    float* __restrict__ dcoords,
                    float* __restrict__ dweight,     // may be null
                    long long n_events, int m, long long coords_bstride,
                    long long weight_bstride, int h, int w) {
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
  const float* g = grad + b * (long long)h * w + (long long)t.y1 * w + t.x1;
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

// out [B, H, W] f32 must be zeroed by the caller.  coords: B rows of M
// (y, x) f32 pairs, row b at coords + b * coords_bstride; weight likewise.
int iwe_vote_fwd(const float* coords, const float* weight, float* out,
                 int batch, int m, long long coords_bstride,
                 long long weight_bstride, int h, int w, void* stream) {
  const long long n = (long long)batch * m;
  if (n == 0) return 0;
  iwe_vote_fwd_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      coords, weight, out, n, m, coords_bstride, weight_bstride, h, w);
  return (int)cudaGetLastError();
}

// grad [B, H, W] f32 contiguous; dcoords [B, M, 2] and dweight [B, M]
// (or null) contiguous outputs.
int iwe_vote_bwd(const float* coords, const float* weight, const float* grad,
                 float* dcoords, float* dweight, int batch, int m,
                 long long coords_bstride, long long weight_bstride, int h,
                 int w, void* stream) {
  const long long n = (long long)batch * m;
  if (n == 0) return 0;
  iwe_vote_bwd_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      coords, weight, grad, dcoords, dweight, n, m, coords_bstride,
      weight_bstride, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
