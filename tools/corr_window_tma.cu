// The corr-window lookup of one pyramid level with its windows staged by the
// Hopper tensor-memory accelerator (TMA): a measurement variant, not part of
// the port.  `kernel_ab.py --staging` builds it beside
// motionpriorcmax_tpu_torch/csrc/corr_window.cu, whose windows are staged
// by 4-byte cp.async copies, and times both on the B=8 level-1 shapes of
// the traj-val path.  Same function, same output layout, same persistent
// 3-stage ring as the port's forward kernel; only the staging differs:
//
//   * one 3-D tensor-map load (cp.async.bulk.tensor) per window over the
//     level's [N, H2, W2] f32 volume, completing on the stage's mbarrier;
//     out-of-range parts of a box are zero-filled, the lookup's "0 outside
//     the map";
//   * a load must start at a 16-byte aligned column, so the box is 16
//     columns x 10 rows from the aligned column at or below the window's
//     first (640 bytes land for the 400 the window needs) and the combine
//     reads from that column offset;
//   * the box destination must be 128-byte aligned, so slots are 640 bytes
//     apart and 32 windows at one (dy, dx) would sit in 4 banks: the
//     combine reads query-major (a warp covers consecutive features of one
//     query) into a [81][33] shared output tile, and a second pass stores
//     it with the port's coalesced NCHW stores.
//
// The tensor map is encoded on the host with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library needs no -lcuda.
// Needs W2 * 4 bytes a multiple of 16 (every level of the 384 x 512 configs).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRadius = 4;
constexpr int kThreads = 256;
constexpr int kTile = 32;
constexpr int kStages = 3;
constexpr int kWin = 2 * kRadius + 2;         // 10 rows
constexpr int kBoxW = 16;                     // columns per box
constexpr int kSlotFloats = kBoxW * kWin;     // 640 bytes
constexpr int kSide = 2 * kRadius + 1;
constexpr int kFeat = kSide * kSide;
constexpr int kOutStride = kTile + 1;

struct Params {
  const float* cx;
  const float* cy;
  float* out;
  long long n, n_tiles;
  int h2, w2, batch, q_per_map, c_total, chan_off;
};

struct Meta {
  float fx[kTile], fy[kTile];
  int x0[kTile], col[kTile];                  // col: x0 - the box's column
  long long base[kTile];
  int n_valid;
};

struct Smem {
  float ring[kStages][kTile * kSlotFloats];   // 128-byte aligned slots
  float out[kFeat * kOutStride];
  Meta meta[kStages];
  uint64_t bar[kStages];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Centres -> origin, fractions, output offset (threads < kTile), and the
// box loads of the tile's windows by the same threads (one each).
__device__ __forceinline__ void stage(const Params& p, const CUtensorMap* map,
                                      long long tile, Meta& m, float* slots,
                                      uint64_t* bar) {
  const int tid = threadIdx.x;
  if (tid >= kTile) return;
  const long long first = tile * kTile;
  const int n_valid = (int)((p.n - first < kTile) ? (p.n - first) : kTile);
  if (tid == 0) {
    m.n_valid = n_valid;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(bar)),
        "r"(n_valid * kSlotFloats * 4)
        : "memory");
  }
  __syncwarp();
  const long long n = first + tid;
  if (tid >= n_valid) {
    m.base[tid] = -1;
    return;
  }
  const float x = p.cx[n];
  const float y = p.cy[n];
  float xf = floorf(x);
  float yf = floorf(y);
  m.fx[tid] = x - xf;
  m.fy[tid] = y - yf;
  xf = fminf(fmaxf(xf, (float)(-kRadius - 2)), (float)(p.w2 + kRadius));
  yf = fminf(fmaxf(yf, (float)(-kRadius - 2)), (float)(p.h2 + kRadius));
  const int x0 = (int)xf - kRadius;
  const int y0 = (int)yf - kRadius;
  const int xs = x0 & ~3;                     // 16-byte aligned column
  m.x0[tid] = x0;
  m.col[tid] = x0 - xs;
  const long long bq = (long long)p.batch * p.q_per_map;
  const long long t = n / bq;
  const long long rem = n - t * bq;
  const long long b = rem / p.q_per_map;
  const long long q = rem - b * p.q_per_map;
  m.base[tid] = (b * p.c_total + p.chan_off + t * kFeat) * p.q_per_map + q;
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(slots + tid * kSlotFloats)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(xs),
      "r"(y0), "r"((int)n)
      : "memory");
}

__device__ __forceinline__ void wait_stage(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__global__ void __launch_bounds__(kThreads)
corr_window_tma_kernel(const __grid_constant__ CUtensorMap map,
                       const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(&s.bar[i]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long stride = gridDim.x;
  long long tile = blockIdx.x;
  for (int a = 0; a < kStages - 1; ++a) {
    const long long t = tile + a * stride;
    if (t < p.n_tiles) stage(p, &map, t, s.meta[a], s.ring[a], &s.bar[a]);
  }
  for (int it = 0; tile < p.n_tiles; ++it, tile += stride) {
    const int st = it % kStages;
    const int ahead_st = (it + kStages - 1) % kStages;
    const long long ahead = tile + (kStages - 1) * stride;
    if (ahead < p.n_tiles) {
      // The slots were read by the generic proxy last round; order those
      // reads before the async proxy's writes.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      stage(p, &map, ahead, s.meta[ahead_st], s.ring[ahead_st],
            &s.bar[ahead_st]);
    }
    wait_stage(&s.bar[st], (it / kStages) & 1);
    __syncthreads();                           // meta of this stage visible
    const Meta& m = s.meta[st];
    // Query-major combine into the shared output tile.
    for (int e = tid; e < kFeat * kTile; e += kThreads) {
      const int ql = e / kFeat;
      const int k = e - ql * kFeat;
      if (ql >= m.n_valid) break;
      const int dy = k / kSide;
      const int dx = k - dy * kSide;
      const float* w = s.ring[st] + ql * kSlotFloats + m.col[ql] + dx;
      const float fx = m.fx[ql];
      const float fy = m.fy[ql];
      const float w00 = w[dy * kBoxW];
      const float w01 = w[dy * kBoxW + 1];
      const float w10 = w[(dy + 1) * kBoxW];
      const float w11 = w[(dy + 1) * kBoxW + 1];
      s.out[k * kOutStride + ql] = (1.0f - fy) * ((1.0f - fx) * w00 + fx * w01)
                                   + fy * ((1.0f - fx) * w10 + fx * w11);
    }
    __syncthreads();
    // A warp stores one k of 32 consecutive queries: 128 coalesced bytes.
    for (int e = tid; e < kFeat * kTile; e += kThreads) {
      const int k = e / kTile;
      const int ql = e - k * kTile;
      const long long base = m.base[ql];
      if (base >= 0) {
        p.out[base + (long long)k * p.q_per_map] = s.out[k * kOutStride + ql];
      }
    }
    __syncthreads();                           // stage st is refilled next
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                         12000, cudaEnableDefault,
                                         &q) != cudaSuccess) {
      return nullptr;
    }
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &q) != cudaSuccess) {
      return nullptr;
    }
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

}  // namespace

// corr [N, H2, W2] f32 (16-byte aligned, W2 * 4 a multiple of 16), cx, cy
// [N] f32; writes channels chan_off + t * 81 + k of out [B, C, Q].
// Returns a cudaError_t, or -1 when the tensor map cannot be made.
extern "C" int corr_window_tma_level(const float* corr, const float* cx,
                                     const float* cy, long long n, int h2,
                                     int w2, float* out, int batch,
                                     int q_per_map, int c_total, int chan_off,
                                     int sms, void* stream) {
  if (n <= 0) return 0;
  if ((w2 * 4) % 16 != 0 || (reinterpret_cast<uintptr_t>(corr) & 15) != 0 ||
      n > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  EncodeTiled encode = encoder();
  if (encode == nullptr) return -1;
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)w2, (cuuint64_t)h2, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)w2 * 4,
                                 (cuuint64_t)h2 * w2 * 4};
  const cuuint32_t box[3] = {kBoxW, kWin, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<float*>(corr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return -1;
  }
  Params p;
  p.cx = cx;
  p.cy = cy;
  p.out = out;
  p.n = n;
  p.n_tiles = (n + kTile - 1) / kTile;
  p.h2 = h2;
  p.w2 = w2;
  p.batch = batch;
  p.q_per_map = q_per_map;
  p.c_total = c_total;
  p.chan_off = chan_off;
  const int bytes = (int)sizeof(Smem);
  static int blocks_per_sm = 0;
  if (blocks_per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        corr_window_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, corr_window_tma_kernel, kThreads, bytes);
    if (err != cudaSuccess) return (int)err;
    if (blocks_per_sm < 1) blocks_per_sm = 1;
  }
  long long grid = (long long)blocks_per_sm * sms;
  if (grid > p.n_tiles) grid = p.n_tiles;
  corr_window_tma_kernel<<<(unsigned)grid, kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(map, p);
  return (int)cudaGetLastError();
}
