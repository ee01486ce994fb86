// flax's BatchNorm over NCHW activations, with the ReLU after it fused where
// the caller applies one: the per-channel reductions and the elementwise
// passes of models/norm.py::FlaxBatchNorm2d, forward and backward.
//
// Replaces no TPU kernel: the JAX package leaves this norm to XLA's fusion.
// It was added because the port's PyTorch version (an f32 copy of the
// input, x * x, two means, the subtract, multiply, add, the cast back, the
// ReLU, and as many passes again through autograd) took more than half of
// the bf16 flow-training step.
//
// The arithmetic (ops/cuda/flax_batch_norm.py computes the C-length part,
// the statistics from the sums, with torch between the launches):
//
//   forward   sums  Σx, Σx²                       per channel over (N, H, W)
//             y   = (x - mean) * mul + bias       mul = rsqrt(var + eps) w,
//                                                  f32, each op rounded as
//                                                  torch's elementwise ops
//                                                  round it (no fma)
//             out = T(y), then max(out, 0) where the ReLU is fused
//   backward  g   = dy, zero where the fused ReLU's output was not > 0
//                   (the forward's output recomputed, bit for bit)
//             sums  Σg, Σg (x - mean)             per channel
//             dx  = T(mul ((g - gmean) - (x - mean) k)), each op rounded
//                   gmean = Σg / n, k = r² Σg (x - mean) / n (0 where the
//                   variance was clamped; both 0 in eval mode)
//
// T is the input's dtype (bf16 or f32).  Each product in a sum (x², g d) is
// rounded to f32, as the formula's elementwise product is.  A thread sums
// its 32 terms in f64 for an f32 input (in f32 for bf16, whose values and
// squares are exact in f32), blocks and the second stage sum in f64, and
// each sum is rounded to f32 once: an f32 input's sums are the formula's
// terms' exact sums, rounded, so they differ from the PyTorch formula's
// only by the rounding of torch's own f32 reductions (a supervised step's
// L1 loss turns any rounding of the statistics into sign flips).
//
// Bound: bytes.  The UNet's 18 norms of one B=14, 480x640 bf16 step see
// 2.1e9 elements; the forward reads each twice (sums, then apply) and
// writes it once, 6 bytes; the backward reads x and dy twice and writes dx,
// 10 bytes: 34 GB, ~10 ms at 3.35 TB/s.
//
// Design: every launch walks each channel as one sequence of N * H * W
// elements (sample-major; a 16-byte vector never crosses a plane when H W
// is a multiple of its width), so a channel of 1,200 pixels per sample
// takes as many blocks as one of 307,200 takes per 8,192 elements: grid
// (ceil(N H W / 8192), C), 256 threads, each thread 32 elements as 16-byte
// loads issued together.  The reductions are two-stage and deterministic:
// each block writes its partial sums, one per (quantity, channel, block),
// and a second launch sums each row of partials, a warp per row, in a
// fixed order; no float atomics, so two calls give the same bits.  Inputs
// not 16-byte aligned, or with H W not a multiple of the vector, take the
// same kernels with scalar loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 32;                     // elements per thread
constexpr int kBlockElems = kThreads * kPerThread; // 8192 per block
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V values of T, loaded and stored as one access (16 bytes for the vector
// path, one element for the scalar path).
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// The element at position j of channel c's (sample, pixel) sequence.
__device__ __forceinline__ long long offset_of(int j, int c, int channels,
                                               int hw) {
  const int n = j / hw;
  return ((long long)n * channels + c) * hw + (j - n * hw);
}

// y = (x - mean) * mul + bias, rounded as the PyTorch version rounds it,
// cast to T, then the ReLU where fused (a NaN passes, as torch.relu's).
template <typename T, bool RELU>
__device__ __forceinline__ T norm_out(float d, float mul, float bias) {
  T y = from_f<T>(__fadd_rn(__fmul_rn(d, mul), bias));
  if (RELU && to_f(y) <= 0.0f) y = from_f<T>(0.0f);
  return y;
}

// A thread's accumulator of its own terms.
template <typename T>
struct AccOf {
  using type = double;
};
template <>
struct AccOf<__nv_bfloat16> {
  using type = float;
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's two sums into part[(q * C + c) * nblk + block], q = 0, 1.
__device__ __forceinline__ void write_partials(double a, double b,
                                               double* part, int c,
                                               int channels) {
  __shared__ double red[2][kWarps];
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double sa = 0.0, sb = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sa += red[0][w];
      sb += red[1][w];
    }
    const long long nblk = gridDim.x;
    part[(long long)c * nblk + blockIdx.x] = sa;
    part[((long long)channels + c) * nblk + blockIdx.x] = sb;
  }
}

// Forward, first stage: partial Σx and Σx² of one block of a channel.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
flax_bn_stats_kernel(const T* __restrict__ x, double* __restrict__ part,
                     int channels, int hw, int nhw) {
  using Acc = typename AccOf<T>::type;
  constexpr int kVecs = kPerThread / V;
  const int c = blockIdx.y;
  const int j0 = blockIdx.x * kBlockElems + threadIdx.x * V;
  Pack<T, V> xv[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int j = j0 + k * kThreads * V;
    if (j < nhw)
      xv[k] = *reinterpret_cast<const Pack<T, V>*>(
          x + offset_of(j, c, channels, hw));
  }
  Acc s = 0, s2 = 0;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    if (j0 + k * kThreads * V >= nhw) continue;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float v = to_f(xv[k].v[e]);
      s += (Acc)v;
      s2 += (Acc)__fmul_rn(v, v);
    }
  }
  write_partials(s, s2, part, c, channels);
}

// Backward, first stage: partial Σg and Σg (x - mean) of one block.
// coef [3][C]: mean, mul, bias.
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(kThreads)
flax_bn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const float* __restrict__ coef,
                          double* __restrict__ part, int channels, int hw,
                          int nhw) {
  using Acc = typename AccOf<T>::type;
  constexpr int kVecs = kPerThread / V;
  const int c = blockIdx.y;
  const float mean = coef[c], mul = coef[channels + c],
              bias = coef[2 * channels + c];
  const int j0 = blockIdx.x * kBlockElems + threadIdx.x * V;
  Pack<T, V> xv[kVecs], gv[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int j = j0 + k * kThreads * V;
    if (j < nhw) {
      const long long o = offset_of(j, c, channels, hw);
      xv[k] = *reinterpret_cast<const Pack<T, V>*>(x + o);
      gv[k] = *reinterpret_cast<const Pack<T, V>*>(dy + o);
    }
  }
  Acc sg = 0, sgd = 0;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    if (j0 + k * kThreads * V >= nhw) continue;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = __fsub_rn(to_f(xv[k].v[e]), mean);
      float g = to_f(gv[k].v[e]);
      if (RELU && !(to_f(norm_out<T, true>(d, mul, bias)) > 0.0f)) g = 0.0f;
      sg += (Acc)g;
      sgd += (Acc)__fmul_rn(g, d);
    }
  }
  write_partials(sg, sgd, part, c, channels);
}

// Second stage: out[row] = the sum of part[row][0 .. nblk), a warp per
// row, lanes strided then a butterfly: a fixed order, rounded to f32 once.
__global__ void __launch_bounds__(kThreads)
flax_bn_partials_kernel(const double* __restrict__ part,
                        float* __restrict__ out, int rows, int nblk) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const double* p = part + (long long)row * nblk;
  double s = 0.0;
  for (int i = lane; i < nblk; i += 32) s += p[i];
  s = warp_sum(s);
  if (lane == 0) out[row] = (float)s;
}

// Forward apply.  coef [3][C]: mean, mul, bias.
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(kThreads)
flax_bn_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const float* __restrict__ coef, int channels, int hw,
                     int nhw) {
  constexpr int kVecs = kPerThread / V;
  const int c = blockIdx.y;
  const float mean = coef[c], mul = coef[channels + c],
              bias = coef[2 * channels + c];
  const int j0 = blockIdx.x * kBlockElems + threadIdx.x * V;
  Pack<T, V> xv[kVecs];
  long long off[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int j = j0 + k * kThreads * V;
    if (j < nhw) {
      off[k] = offset_of(j, c, channels, hw);
      xv[k] = *reinterpret_cast<const Pack<T, V>*>(x + off[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    if (j0 + k * kThreads * V >= nhw) continue;
    Pack<T, V> out;
#pragma unroll
    for (int e = 0; e < V; ++e)
      out.v[e] = norm_out<T, RELU>(__fsub_rn(to_f(xv[k].v[e]), mean), mul,
                                   bias);
    *reinterpret_cast<Pack<T, V>*>(y + off[k]) = out;
  }
}

// Backward apply.  coef [5][C]: mean, mul, bias, gmean, k.
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(kThreads)
flax_bn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         T* __restrict__ dx, const float* __restrict__ coef,
                         int channels, int hw, int nhw) {
  constexpr int kVecs = kPerThread / V;
  const int c = blockIdx.y;
  const float mean = coef[c], mul = coef[channels + c],
              bias = coef[2 * channels + c], gmean = coef[3 * channels + c],
              kk = coef[4 * channels + c];
  const int j0 = blockIdx.x * kBlockElems + threadIdx.x * V;
  Pack<T, V> xv[kVecs], gv[kVecs];
  long long off[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int j = j0 + k * kThreads * V;
    if (j < nhw) {
      off[k] = offset_of(j, c, channels, hw);
      xv[k] = *reinterpret_cast<const Pack<T, V>*>(x + off[k]);
      gv[k] = *reinterpret_cast<const Pack<T, V>*>(dy + off[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    if (j0 + k * kThreads * V >= nhw) continue;
    Pack<T, V> out;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = __fsub_rn(to_f(xv[k].v[e]), mean);
      float g = to_f(gv[k].v[e]);
      if (RELU && !(to_f(norm_out<T, true>(d, mul, bias)) > 0.0f)) g = 0.0f;
      out.v[e] = from_f<T>(
          __fmul_rn(mul, __fsub_rn(__fsub_rn(g, gmean), __fmul_rn(d, kk))));
    }
    *reinterpret_cast<Pack<T, V>*>(dx + off[k]) = out;
  }
}

enum DType { kF32 = 0, kBF16 = 1 };

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The shape checks every entry point makes; the grid of its launches.
int grid_of(int n, int c, int hw, int nblk, dim3* grid) {
  if (n < 1 || c < 1 || hw < 1 || c > 65535) return (int)cudaErrorInvalidValue;
  const long long nhw = (long long)n * hw;
  if (nhw > (1LL << 31) - 1 - kBlockElems) return (int)cudaErrorInvalidValue;
  if ((long long)nblk * kBlockElems < nhw ||
      (long long)(nblk - 1) * kBlockElems >= nhw)
    return (int)cudaErrorInvalidValue;
  *grid = dim3(nblk, c);
  return 0;
}

int sum_partials(const double* part, float* out, int c, int nblk,
                 cudaStream_t st) {
  const int rows = 2 * c;
  flax_bn_partials_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      part, out, rows, nblk);
  return (int)cudaGetLastError();
}

template <typename T>
int stats(const T* x, double* part, float* out, int n, int c, int hw, int nblk,
          cudaStream_t st) {
  dim3 grid;
  if (int err = grid_of(n, c, hw, nblk, &grid)) return err;
  constexpr int V = 16 / sizeof(T);
  if (aligned16(x) && hw % V == 0)
    flax_bn_stats_kernel<T, V><<<grid, kThreads, 0, st>>>(x, part, c, hw, n * hw);
  else
    flax_bn_stats_kernel<T, 1><<<grid, kThreads, 0, st>>>(x, part, c, hw, n * hw);
  if (int err = (int)cudaGetLastError()) return err;
  return sum_partials(part, out, c, nblk, st);
}

template <typename T, bool RELU>
int bwd_reduce(const T* x, const T* dy, const float* coef, double* part,
               float* out, int n, int c, int hw, int nblk, cudaStream_t st) {
  dim3 grid;
  if (int err = grid_of(n, c, hw, nblk, &grid)) return err;
  constexpr int V = 16 / sizeof(T);
  if (aligned16(x) && aligned16(dy) && hw % V == 0)
    flax_bn_bwd_reduce_kernel<T, V, RELU><<<grid, kThreads, 0, st>>>(
        x, dy, coef, part, c, hw, n * hw);
  else
    flax_bn_bwd_reduce_kernel<T, 1, RELU><<<grid, kThreads, 0, st>>>(
        x, dy, coef, part, c, hw, n * hw);
  if (int err = (int)cudaGetLastError()) return err;
  return sum_partials(part, out, c, nblk, st);
}

template <typename T, bool RELU>
int apply(const T* x, T* y, const float* coef, int n, int c, int hw, int nblk,
          cudaStream_t st) {
  dim3 grid;
  if (int err = grid_of(n, c, hw, nblk, &grid)) return err;
  constexpr int V = 16 / sizeof(T);
  if (aligned16(x) && aligned16(y) && hw % V == 0)
    flax_bn_apply_kernel<T, V, RELU><<<grid, kThreads, 0, st>>>(
        x, y, coef, c, hw, n * hw);
  else
    flax_bn_apply_kernel<T, 1, RELU><<<grid, kThreads, 0, st>>>(
        x, y, coef, c, hw, n * hw);
  return (int)cudaGetLastError();
}

template <typename T, bool RELU>
int bwd_apply(const T* x, const T* dy, T* dx, const float* coef, int n, int c,
              int hw, int nblk, cudaStream_t st) {
  dim3 grid;
  if (int err = grid_of(n, c, hw, nblk, &grid)) return err;
  constexpr int V = 16 / sizeof(T);
  if (aligned16(x) && aligned16(dy) && aligned16(dx) && hw % V == 0)
    flax_bn_bwd_apply_kernel<T, V, RELU><<<grid, kThreads, 0, st>>>(
        x, dy, dx, coef, c, hw, n * hw);
  else
    flax_bn_bwd_apply_kernel<T, 1, RELU><<<grid, kThreads, 0, st>>>(
        x, dy, dx, coef, c, hw, n * hw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The entry points: x, dy, y, dx [N, C, H W] contiguous in dtype (0 f32,
// 1 bf16); coef f32 [3][C] (mean, mul, bias) or [5][C] (and gmean, k);
// part f64 [2][C][nblk] scratch, out f32 [2][C]; nblk = ceil(N H W / 8192)
// (flax_bn_block_elems()).  Each returns the launches' cudaError_t.

int flax_bn_block_elems() { return kBlockElems; }

int flax_bn_stats(const void* x, double* part, float* out, int dtype, int n,
                  int c, int hw, int nblk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return stats((const float*)x, part, out, n, c, hw, nblk, st);
  if (dtype == kBF16)
    return stats((const __nv_bfloat16*)x, part, out, n, c, hw, nblk, st);
  return (int)cudaErrorInvalidValue;
}

int flax_bn_bwd_reduce(const void* x, const void* dy, const float* coef,
                       double* part, float* out, int dtype, int relu, int n,
                       int c, int hw, int nblk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  using B = __nv_bfloat16;
  if (dtype == kF32)
    return relu ? bwd_reduce<float, true>((const float*)x, (const float*)dy,
                                          coef, part, out, n, c, hw, nblk, st)
                : bwd_reduce<float, false>((const float*)x, (const float*)dy,
                                           coef, part, out, n, c, hw, nblk, st);
  if (dtype == kBF16)
    return relu ? bwd_reduce<B, true>((const B*)x, (const B*)dy, coef, part,
                                      out, n, c, hw, nblk, st)
                : bwd_reduce<B, false>((const B*)x, (const B*)dy, coef, part,
                                       out, n, c, hw, nblk, st);
  return (int)cudaErrorInvalidValue;
}

int flax_bn_apply(const void* x, void* y, const float* coef, int dtype,
                  int relu, int n, int c, int hw, int nblk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  using B = __nv_bfloat16;
  if (dtype == kF32)
    return relu ? apply<float, true>((const float*)x, (float*)y, coef, n, c,
                                     hw, nblk, st)
                : apply<float, false>((const float*)x, (float*)y, coef, n, c,
                                      hw, nblk, st);
  if (dtype == kBF16)
    return relu ? apply<B, true>((const B*)x, (B*)y, coef, n, c, hw, nblk, st)
                : apply<B, false>((const B*)x, (B*)y, coef, n, c, hw, nblk,
                                  st);
  return (int)cudaErrorInvalidValue;
}

int flax_bn_bwd_apply(const void* x, const void* dy, void* dx,
                      const float* coef, int dtype, int relu, int n, int c,
                      int hw, int nblk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  using B = __nv_bfloat16;
  if (dtype == kF32)
    return relu ? bwd_apply<float, true>((const float*)x, (const float*)dy,
                                         (float*)dx, coef, n, c, hw, nblk, st)
                : bwd_apply<float, false>((const float*)x, (const float*)dy,
                                          (float*)dx, coef, n, c, hw, nblk,
                                          st);
  if (dtype == kBF16)
    return relu ? bwd_apply<B, true>((const B*)x, (const B*)dy, (B*)dx, coef,
                                     n, c, hw, nblk, st)
                : bwd_apply<B, false>((const B*)x, (const B*)dy, (B*)dx, coef,
                                      n, c, hw, nblk, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
