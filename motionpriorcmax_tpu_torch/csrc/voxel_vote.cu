// Trilinear vote of events into voxel grids (forward only).
//
// Replaces the TPU kernel of motionpriorcmax_tpu/ops/pallas/voxel_vote.py:
//   voxel_vote_pallas_sorted (pallas_call :242), the on-device voxelization
//   of cell-sorted events (flow-train --device-voxelize).
// That kernel builds bf16 one-hot tap tiles on an interleaved canvas for the
// TPU's matrix unit.  This kernel computes the exact f32 function of the JAX
// scatter voxelizer (motionpriorcmax_tpu/ops/events.py::
// voxel_grid_from_events) instead, for event rows (y, x, t, p, bin, valid)
// with t in [0, 1]:
//
//   t_norm = t * (nbins - 1), value = (2p - 1) * valid
//   out[b, ti, yi, xi] += value * wx * wy * wt   for the 8 floor / floor + 1
//   taps, w = 1 - |tap - coordinate|, each axis masked to its range.
//
// Bound: memory.  At the flow-training shape (B = 14, M = 2^20, 15 x 480 x
// 640) the needed bytes are 352 MB of events read once and 258 MB of grids
// written once: ~0.18 ms at 3.35 TB/s.  The 1.2e8 atomics land in grids
// larger than the 50 MB L2; the cell sort (y // 4, bin, x // 4) keeps a
// block's taps within a few superpixel rows of one grid, so they hit L2.
//
// Design: one thread per event, consecutive threads on consecutive events
// (three 8-byte loads per 24-byte row), eight f32 atomics; events of zero
// value (padding) make none.  Right for any event order; only speed needs
// the sort.  Coordinates are clamped before the float-to-int cast to
// [-3, size + 2], where both taps of an axis are still outside its range,
// as they were before the clamp, so no result changes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
voxel_vote_kernel(const float* __restrict__ events, float* __restrict__ out,
                  long long n_events, int m, int nbins, int h, int w) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_events) return;
  const float2* row = reinterpret_cast<const float2*>(events + 6 * i);
  const float2 yx = __ldg(row);
  const float2 tp = __ldg(row + 1);
  const float2 bv = __ldg(row + 2);
  const float value = (2.0f * tp.y - 1.0f) * bv.y;
  if (value == 0.0f) return;
  const float y = fminf(fmaxf(yx.x, -3.0f), (float)h + 2.0f);
  const float x = fminf(fmaxf(yx.y, -3.0f), (float)w + 2.0f);
  const float t = fminf(fmaxf(tp.x * (float)(nbins - 1), -3.0f),
                        (float)nbins + 2.0f);
  const float x0 = floorf(x), y0 = floorf(y), t0 = floorf(t);
  const long long b = i / m;
  float* grid = out + b * (long long)nbins * h * w;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const float xi = x0 + dx;
    const float wx = 1.0f - fabsf(xi - x);
    if (!(xi >= 0.0f && xi < (float)w)) continue;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float yi = y0 + dy;
      const float wy = 1.0f - fabsf(yi - y);
      if (!(yi >= 0.0f && yi < (float)h)) continue;
#pragma unroll
      for (int dt = 0; dt < 2; ++dt) {
        const float ti = t0 + dt;
        const float wt = 1.0f - fabsf(ti - t);
        if (!(ti >= 0.0f && ti < (float)nbins)) continue;
        const long long idx = ((long long)ti * h + (long long)yi) * w
                            + (long long)xi;
        atomicAdd(grid + idx, value * wx * wy * wt);
      }
    }
  }
}

}  // namespace

extern "C" {

// events [B, M, 6] f32 contiguous; out [B, nbins, H, W] f32 zeroed by the
// caller.
int voxel_vote(const float* events, float* out, int batch, int m, int nbins,
               int h, int w, void* stream) {
  if (batch < 0 || m < 0 || nbins < 1 || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)batch * m;
  if (n == 0) return 0;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  voxel_vote_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      events, out, n, m, nbins, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
