// Trilinear vote of events into voxel grids (forward only), through
// shared-memory tiles: every output element is written exactly once, and
// no atomic touches a float.
//
// Replaces the TPU kernel of motionpriorcmax_tpu/ops/pallas/voxel_vote.py:
//   voxel_vote_pallas_sorted (pallas_call :242), the on-device voxelization
//   of cell-sorted events (flow-train --device-voxelize).
// That kernel builds bf16 one-hot tap tiles on an interleaved canvas for the
// TPU's matrix unit.  This one computes the exact f32 function of the JAX
// scatter voxelizer (motionpriorcmax_tpu/ops/events.py::
// voxel_grid_from_events) instead, for event rows (y, x, t, p, bin, valid)
// with t in [0, 1], in any order:
//
//   t_norm = t * (nbins - 1), value = (2p - 1) * valid
//   out[b, ti, yi, xi] += value * wx * wy * wt   for the 8 floor / floor + 1
//   taps, w = 1 - |tap - coordinate|, each axis masked to its range.
//
// Bound: memory.  At the flow-training shape (B = 14, M = 2^20, 15 x 480 x
// 640) the needed bytes are 352 MB of events read once and 258 MB of grids
// written once: ~0.18 ms at 3.35 TB/s.  One f32 atomic per tap into grids
// five times the 50 MB L2 ran at the L2's atomic rate (1.2e8 atomics,
// 1.3-1.6 ms); a float atomic on shared memory is a compare-and-swap loop
// on this card (ATOMS.CAST.SPIN), no faster.  So no tap is an atomic here:
// the taps are sorted to the thread that owns their voxel.
//
// Design: a tile is all nbins bins of TY x TX pixels of one sample (TX a
// multiple of 4; 15 x 16 x 64 f32 = 60 KB at the flow shape), chosen by
// the caller.  Each live event (value != 0 with an in-range tap on every
// axis) has a home tile, the one of its first in-range x and y tap, and a
// category: whether its taps cross into the tile to the right, below, or
// both.  It makes one 16-byte record (y, x, t_norm, value), clamped as
// below, so the records never exceed the events and need no count on the
// host.
//   1. count: a block of 4096 events counts (home tile, category) in a
//      shared-memory histogram (integer atomics, warp-aggregated with
//      __match_any_sync, so a hot pixel costs one per warp), then makes one
//      global add per counter and keeps the add's old value: its offset
//      inside the counter's range.
//   2. scan: one block turns the B x tiles x 4 counts into the ranges'
//      starts (a tile's range holds interior, down, both, right records,
//      in that order).
//   3. scatter: the same blocks re-read their events, sort their records
//      by counter in shared memory and write each counter's run to its
//      range at the block's offset: runs of consecutive records, not one
//      scattered 16-byte store per event.
//   4. accumulate: a block per tile reads its own records and the crossing
//      ones of its left (both, right), upper (down, both) and upper-left
//      (both) neighbours, 2048 at a time: it sorts them into shared memory
//      by floor pixel (a counting sort), then the thread that owns a pixel
//      adds the taps of the records whose floor is that pixel or its left,
//      upper or upper-left neighbour into its own nbins values in shared
//      memory; plain adds, each voxel by one thread.  The tile is
//      then written with 16-byte stores.  Blocks run in clusters of 4
//      consecutive tiles.  When a tile of the cluster reads 32768 records
//      or more (a hot tile, where the events concentrate), the cluster
//      takes its 4 tiles one after another with all 4 blocks on each: a
//      block sums every 4th chunk of the tile's records (so a hot pixel's
//      run is shared too) into its own shared memory, and the 4 partial
//      tiles are summed through distributed
//      shared memory (each block a quarter of the tile) before the single
//      store, so one hot tile does not stall one block.
// No global atomic touches the output and the output needs no zero-fill.
// A voxel's votes are added in the order of the sorted records, which
// depends on the order in which the blocks of passes 1 and 3 reach the
// counters: run-dependent, as with atomics.  Coordinates are clamped before
// the float-to-int cast to [-3, size + 2], where both taps of an axis are
// still outside its range, as they were before the clamp, so no result
// changes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBinThreads = 512;          // passes 1 and 3
constexpr int kPerThread = 8;             // events per pass-3 thread
constexpr int kChunk = kBinThreads * kPerThread;  // events per block
constexpr int kScanThreads = 1024;
constexpr int kAccThreads = 512;          // pass 4
constexpr int kAccChunk = 2048;           // records sorted at a time
constexpr int kCluster = 4;               // tiles (blocks) per cluster
constexpr int kHotRecords = 32768;        // a cluster shares its work past this
constexpr int kMaxTileFloats = 15360;     // 60 KB of shared memory per tile
constexpr int kMaxTiles = 8192;           // per sample: 4 counters each

// Categories of an event in its home tile: which neighbours also read it.
constexpr int kInterior = 0, kDown = 1, kBoth = 2, kRight = 3;

struct Geo {
  long long m;                            // events per sample
  int nbins, h, w, ty, tx, tiles_x, tiles;
  int chunks;                             // pass-1 blocks per sample
};

// An event's record and counter (home tile * 4 + category); false when it
// votes nothing (value 0, or no in-range tap on some axis).
__device__ __forceinline__ bool classify(const float* row, const Geo& g,
                                         float4& rec, int& counter) {
  const float2* r2 = reinterpret_cast<const float2*>(row);
  const float2 yx = __ldg(r2);
  const float2 tp = __ldg(r2 + 1);
  const float2 bv = __ldg(r2 + 2);
  const float value = (2.0f * tp.y - 1.0f) * bv.y;
  if (value == 0.0f) return false;
  const float y = fminf(fmaxf(yx.x, -3.0f), (float)g.h + 2.0f);
  const float x = fminf(fmaxf(yx.y, -3.0f), (float)g.w + 2.0f);
  const float t = fminf(fmaxf(tp.x * (float)(g.nbins - 1), -3.0f),
                        (float)g.nbins + 2.0f);
  const int x0 = (int)floorf(x);
  const int y0 = (int)floorf(y);
  const int t0 = (int)floorf(t);
  if (x0 < -1 || x0 >= g.w || y0 < -1 || y0 >= g.h || t0 < -1 ||
      t0 >= g.nbins) {
    return false;
  }
  const bool cross_x = x0 >= 0 && x0 + 1 < g.w && (x0 + 1) % g.tx == 0;
  const bool cross_y = y0 >= 0 && y0 + 1 < g.h && (y0 + 1) % g.ty == 0;
  const int home = (max(y0, 0) / g.ty) * g.tiles_x + max(x0, 0) / g.tx;
  counter = home * 4 + (cross_y ? (cross_x ? kBoth : kDown)
                                : (cross_x ? kRight : kInterior));
  rec = make_float4(y, x, t, value);
  return true;
}

// In-place exclusive scan of data[0..n) by a whole block of kThreadsB
// threads; data[n] receives the total.  The caller synchronizes the block
// before; the scan ends with the block synchronized.
template <int kThreadsB>
__device__ void block_exclusive_scan(int* data, int n) {
  __shared__ int s_warp[kThreadsB / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = (n + kThreadsB - 1) / kThreadsB;
  const int lo = min(tid * per, n);
  const int hi = min(lo + per, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += data[i];
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kThreadsB / 32 ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane < kThreadsB / 32) s_warp[lane] = v;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? s_warp[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = data[i];
    data[i] = run;
    run += c;
  }
  if (tid == kThreadsB - 1) data[n] = run;
  __syncthreads();
}

__global__ void __launch_bounds__(kBinThreads)
voxel_count_kernel(const float* __restrict__ events, int* __restrict__ counts,
                   int* __restrict__ block_off, Geo g) {
  extern __shared__ int s_hist[];
  const int n_ctr = 4 * g.tiles;
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < n_ctr; i += kBinThreads) s_hist[i] = 0;
  __syncthreads();
  const float* ev = events + (long long)b * g.m * 6;
  const long long e0 = (long long)chunk * kChunk;
  const long long e1 = min(e0 + kChunk, g.m);
  // The same number of rounds in every thread: the warp vote needs all.
  for (long long base = e0; base < e1; base += kBinThreads) {
    const long long e = base + threadIdx.x;
    float4 rec;
    int ctr = -1;
    if (e >= e1 || !classify(ev + 6 * e, g, rec, ctr)) ctr = -1;
    const unsigned peers = __match_any_sync(0xffffffffu, ctr);
    if (ctr >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(&s_hist[ctr], __popc(peers));
    }
  }
  __syncthreads();
  int* cnt = counts + (long long)b * n_ctr;
  int* off = block_off + ((long long)b * g.chunks + chunk) * n_ctr;
  for (int i = threadIdx.x; i < n_ctr; i += kBinThreads) {
    const int c = s_hist[i];
    off[i] = c ? atomicAdd(cnt + i, c) : 0;
  }
}

// Exclusive scan of n counts into seg[0..n] (seg[n] = the total), one block.
__global__ void __launch_bounds__(kScanThreads)
voxel_scan_kernel(const int* __restrict__ counts, int* __restrict__ seg,
                  int n) {
  for (int i = threadIdx.x; i < n; i += kScanThreads) seg[i] = counts[i];
  __syncthreads();
  block_exclusive_scan<kScanThreads>(seg, n);
}

__global__ void __launch_bounds__(kBinThreads, 2)
voxel_scatter_kernel(const float* __restrict__ events,
                     const int* __restrict__ seg,
                     const int* __restrict__ block_off,
                     float4* __restrict__ records, Geo g) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  float4* s_rec = reinterpret_cast<float4*>(s_raw);            // [kChunk]
  int* s_ctr = reinterpret_cast<int*>(s_rec + kChunk);          // [kChunk]
  int* s_pos = s_ctr + kChunk;                                  // [n_ctr + 1]
  const int n_ctr = 4 * g.tiles;
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < n_ctr; i += kBinThreads) s_pos[i] = 0;
  __syncthreads();
  const float* ev = events + (long long)b * g.m * 6;
  const long long e0 = (long long)chunk * kChunk;
  float4 rec[kPerThread];
  int ctr[kPerThread], rank[kPerThread];
  // Count, keeping each event's rank among the block's events of its
  // counter (warp-aggregated: one shared atomic per counter and warp).
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long e = e0 + k * kBinThreads + threadIdx.x;
    ctr[k] = -1;
    if (e >= g.m || !classify(ev + 6 * e, g, rec[k], ctr[k])) ctr[k] = -1;
    const unsigned peers = __match_any_sync(0xffffffffu, ctr[k]);
    const int leader = __ffs(peers) - 1;
    int first = 0;
    if (ctr[k] >= 0 && lane == leader) {
      first = atomicAdd(&s_pos[ctr[k]], __popc(peers));
    }
    rank[k] = __shfl_sync(0xffffffffu, first, leader)
              + __popc(peers & ((1u << lane) - 1u));
  }
  __syncthreads();
  block_exclusive_scan<kBinThreads>(s_pos, n_ctr);
  // Sort into shared memory by counter.
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (ctr[k] >= 0) {
      const int i = s_pos[ctr[k]] + rank[k];
      s_rec[i] = rec[k];
      s_ctr[i] = ctr[k];
    }
  }
  __syncthreads();
  // Write each counter's run at the block's offset in its range.
  const int n_rec = s_pos[n_ctr];
  const int* sg = seg + (long long)b * n_ctr;
  const int* off = block_off + ((long long)b * g.chunks + chunk) * n_ctr;
  for (int i = threadIdx.x; i < n_rec; i += kBinThreads) {
    const int c = s_ctr[i];
    records[sg[c] + off[c] + (i - s_pos[c])] = s_rec[i];
  }
}

// The pixel bounds of tile `cell` (= b * tiles + tile) of the grid.
struct TileBox {
  int b, ylo, yhi, xlo, xhi;
};

__device__ __forceinline__ TileBox tile_box(const Geo& g, long long cell) {
  TileBox t;
  t.b = (int)(cell / g.tiles);
  const int tile = (int)(cell - (long long)t.b * g.tiles);
  const int tyi = tile / g.tiles_x;
  const int txi = tile - tyi * g.tiles_x;
  t.ylo = tyi * g.ty;
  t.yhi = min(t.ylo + g.ty, g.h);
  t.xlo = txi * g.tx;
  t.xhi = min(t.xlo + g.tx, g.w);
  return t;
}

// Store the 4 tile values at float4 index i of a [nbins][ty][tx] tile that
// fall inside the grid.
__device__ __forceinline__ void store4(float* out, const Geo& g,
                                       const TileBox& box, int i,
                                       const float4 v) {
  const int e = 4 * i;
  const int per_bin = g.ty * g.tx;
  const int bin = e / per_bin;
  const int rem = e - bin * per_bin;
  const int ly = rem / g.tx;
  const int lx = rem - ly * g.tx;
  const int yy = box.ylo + ly;
  const int xx = box.xlo + lx;
  if (yy >= box.yhi || xx >= box.xhi) return;
  float* o = out + (((long long)box.b * g.nbins + bin) * g.h + yy) * g.w + xx;
  if ((g.w & 3) == 0) {
    // W and the tile's first column are multiples of 4: all 4 in range.
    *reinterpret_cast<float4*>(o) = v;
  } else {
    const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (xx + c < box.xhi) o[c] = vals[c];
    }
  }
}

// Add a tile's records (ranges lo / len, `total` in all) into the block's
// tile s_tile [nbins][ty][tx], in chunks of kAccChunk starting at `first`
// and every `step`: sort each chunk's records into shared memory by floor
// pixel (key (y0 - ylo + 1) * (tx + 1) + x0 - xlo + 1), then the thread
// that owns a pixel adds the taps of the records of its own key and of the
// keys left, above and above-left of it.
__device__ void accumulate(float* s_tile, float4* s_rec, int* s_key_start,
                           const float4* __restrict__ records,
                           const int* lo, const int* len, long long total,
                           long long first, long long step,
                           const TileBox& box, const Geo& g) {
  constexpr int kPer = kAccChunk / kAccThreads;
  const int tid = threadIdx.x;
  const int kw = g.tx + 1;
  const int n_keys = (g.ty + 1) * kw;
  const int per_bin = g.ty * g.tx;
  for (long long c0 = first; c0 < total; c0 += step) {
    const int n = (int)min((long long)kAccChunk, total - c0);
    for (int i = tid; i < n_keys; i += kAccThreads) s_key_start[i] = 0;
    __syncthreads();
    float4 rec[kPer];
    int key[kPer], rank[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int v = k * kAccThreads + tid;
      key[k] = -1;
      if (v < n) {
        // Item c0 + v of the concatenated ranges.
        long long item = c0 + v;
        int r = 0;
        while (item >= len[r]) {
          item -= len[r];
          ++r;
        }
        rec[k] = records[lo[r] + item];
        const int kx = (int)floorf(rec[k].y) - box.xlo + 1;
        const int ky = (int)floorf(rec[k].x) - box.ylo + 1;
        key[k] = ky * kw + kx;
        rank[k] = atomicAdd(&s_key_start[key[k]], 1);
      }
    }
    __syncthreads();
    block_exclusive_scan<kAccThreads>(s_key_start, n_keys);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (key[k] >= 0) s_rec[s_key_start[key[k]] + rank[k]] = rec[k];
    }
    __syncthreads();
    // The taps dx = 0 / 1 of a pixel come from the records whose floor is
    // at its column / the one left of it; likewise in y: the keys of the
    // floors (y, x - 1), (y, x) and (y - 1, x - 1), (y - 1, x), two runs of
    // consecutive keys.
    for (int p = tid; p < per_bin; p += kAccThreads) {
      const int ly = p / g.tx;
      const int lx = p - ly * g.tx;
      const int yy = box.ylo + ly;
      const int xx = box.xlo + lx;
      if (yy >= box.yhi || xx >= box.xhi) continue;
      const float px = (float)xx;
      const float py = (float)yy;
      const int ka = (ly + 1) * kw + lx;
      const int kb = ly * kw + lx;
      const int a0 = s_key_start[ka];
      const int na = s_key_start[ka + 2] - a0;
      const int b0 = s_key_start[kb];
      const int n = na + s_key_start[kb + 2] - b0;
      for (int i = 0; i < n; ++i) {
        const float4 r = s_rec[i < na ? a0 + i : b0 + (i - na)];
        const float y = r.x, x = r.y, tn = r.z, value = r.w;
        const float wx = 1.0f - fabsf(px - x);
        const float wy = 1.0f - fabsf(py - y);
        const float t0 = floorf(tn);
#pragma unroll
        for (int dt = 0; dt < 2; ++dt) {
          const float ti = t0 + dt;
          const float wt = 1.0f - fabsf(ti - tn);
          const int tii = (int)ti;
          if (tii < 0 || tii >= g.nbins) continue;
          s_tile[tii * per_bin + p] += value * wx * wy * wt;
        }
      }
    }
    __syncthreads();
  }
}

// Shared memory of the accumulate pass besides its dynamic part.
struct AccRanges {
  int lo[kCluster][4], len[kCluster][4];  // the cluster's tiles' records
};

__global__ void __launch_bounds__(kAccThreads, 2)
voxel_accum_kernel(const float4* __restrict__ records,
                   const int* __restrict__ seg, float* __restrict__ out,
                   Geo g, long long n_cells) {
  extern __shared__ __align__(16) float s_tile[];
  __shared__ AccRanges s;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long cell = blockIdx.x;
  const long long cell0 = cell - rank;     // the cluster's first tile
  const int tid = threadIdx.x;
  const int n_tile = g.nbins * g.ty * g.tx;
  float4* s_rec = reinterpret_cast<float4*>(s_tile + n_tile);
  int* s_key_start = reinterpret_cast<int*>(s_rec + kAccChunk);

  // The record ranges each tile of the cluster reads: its own, and the
  // crossing categories of its left, upper and upper-left neighbours.
  if (tid < kCluster) {
    int lo[4] = {0, 0, 0, 0}, len[4] = {0, 0, 0, 0};
    const long long c = cell0 + tid;
    if (c < n_cells) {
      const int b = (int)(c / g.tiles);
      const int tile = (int)(c - (long long)b * g.tiles);
      const int tyi = tile / g.tiles_x;
      const int txi = tile - tyi * g.tiles_x;
      const int* sg = seg + (long long)b * 4 * g.tiles;
      lo[0] = sg[4 * tile];
      len[0] = sg[4 * tile + 4] - lo[0];
      if (txi > 0) {
        const int l = tile - 1;
        lo[1] = sg[4 * l + kBoth];
        len[1] = sg[4 * l + 4] - lo[1];              // both, right
      }
      if (tyi > 0) {
        const int u = tile - g.tiles_x;
        lo[2] = sg[4 * u + kDown];
        len[2] = sg[4 * u + kRight] - lo[2];         // down, both
      }
      if (txi > 0 && tyi > 0) {
        const int d = tile - g.tiles_x - 1;
        lo[3] = sg[4 * d + kBoth];
        len[3] = sg[4 * d + kRight] - lo[3];         // both
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      s.lo[tid][r] = lo[r];
      s.len[tid][r] = len[r];
    }
  }
  __syncthreads();
  // hot is the same in every block of the cluster: they read the same seg.
  bool hot = false;
#pragma unroll
  for (int j = 0; j < kCluster; ++j) {
    hot = hot || s.len[j][0] + s.len[j][1] + s.len[j][2] + s.len[j][3]
                     >= kHotRecords;
  }

  float4* t4 = reinterpret_cast<float4*>(s_tile);
  if (!hot) {
    // Each block its own tile.
    if (cell >= n_cells) return;
    for (int i = tid; i < n_tile / 4; i += kAccThreads) {
      t4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    const TileBox box = tile_box(g, cell);
    const long long total = (long long)s.len[rank][0] + s.len[rank][1]
                            + s.len[rank][2] + s.len[rank][3];
    accumulate(s_tile, s_rec, s_key_start, records, s.lo[rank], s.len[rank],
               total, 0, kAccChunk, box, g);
    __syncthreads();
    for (int i = tid; i < n_tile / 4; i += kAccThreads) {
      store4(out, g, box, i, t4[i]);
    }
    return;
  }
  // A hot cluster takes its tiles one after another, all blocks on each:
  // block `rank` sums chunks rank, rank + 4, ... of the tile's records into
  // its own shared memory, then every block sums a quarter of the tile over
  // the 4 partial tiles through distributed shared memory and stores it.
  for (int j = 0; j < kCluster; ++j) {
    if (cell0 + j >= n_cells) break;            // the same in every block
    for (int i = tid; i < n_tile / 4; i += kAccThreads) {
      t4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    const TileBox box = tile_box(g, cell0 + j);
    const long long total = (long long)s.len[j][0] + s.len[j][1]
                            + s.len[j][2] + s.len[j][3];
    accumulate(s_tile, s_rec, s_key_start, records, s.lo[j], s.len[j],
               total, (long long)rank * kAccChunk,
               (long long)kCluster * kAccChunk, box, g);
    cluster.sync();                             // the partial tiles are whole
    const int n4 = n_tile / 4;
    const float4* part[kCluster];
#pragma unroll
    for (int q = 0; q < kCluster; ++q) {
      part[q] = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(s_tile, q));
    }
    for (int i = n4 * rank / kCluster + tid; i < n4 * (rank + 1) / kCluster;
         i += kAccThreads) {
      float4 acc = part[0][i];
#pragma unroll
      for (int q = 1; q < kCluster; ++q) {
        const float4 v = part[q][i];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      store4(out, g, box, i, acc);
    }
    cluster.sync();                             // no one reads them any more
  }
}

// Let fn take as much dynamic shared memory as the card allows a block.
cudaError_t allow_smem(const void* fn, int optin) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin - (int)a.sharedSizeBytes);
}

}  // namespace

extern "C" {

// Scratch size, in int32 values, for a call.
long long voxel_vote_int_scratch(int batch, int m, int h, int w, int ty,
                                 int tx) {
  const long long tiles = (long long)((h + ty - 1) / ty) * ((w + tx - 1) / tx);
  const long long chunks = (m + kChunk - 1) / kChunk;
  return 4 * tiles * batch * (2 + chunks) + 1;
}

// Once per device, before its first voxel_vote: lets the three kernels
// with dynamic shared memory take up to the card's per-block limit.
int voxel_vote_setup(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) err = allow_smem((const void*)voxel_count_kernel, optin);
  if (err == cudaSuccess) {
    err = allow_smem((const void*)voxel_scatter_kernel, optin);
  }
  if (err == cudaSuccess) err = allow_smem((const void*)voxel_accum_kernel, optin);
  return (int)err;
}

// events [B, M, 6] f32 contiguous; out [B, nbins, H, W] f32, written
// whole (no zero-fill needed); records: B * M 16-byte records; ints:
// voxel_vote_int_scratch(...) int32 values.  voxel_vote_setup has run on
// the current device.  Tile TY x TX pixels, TX a
// multiple of 4, nbins * TY * TX <= 15360.
int voxel_vote(const float* events, float* out, int batch, int m, int nbins,
               int h, int w, int ty, int tx, void* records, int* ints,
               void* stream) {
  if (batch < 0 || batch > 65535 || m < 0 || nbins < 1 || h < 1 || w < 1 ||
      ty < 1 || tx < 4 || tx % 4 != 0 ||
      (long long)nbins * ty * tx > kMaxTileFloats ||
      (long long)batch * m > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  Geo g;
  g.m = m;
  g.nbins = nbins;
  g.h = h;
  g.w = w;
  g.ty = ty;
  g.tx = tx;
  g.tiles_x = (w + tx - 1) / tx;
  const long long tiles = (long long)((h + ty - 1) / ty) * g.tiles_x;
  if (tiles > kMaxTiles || 4 * tiles * batch > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  g.tiles = (int)tiles;
  g.chunks = (m + kChunk - 1) / kChunk;
  if (batch == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_ctr = 4 * g.tiles * batch;
  int* counts = ints;
  int* seg = counts + n_ctr;                 // n_ctr + 1 values
  int* block_off = seg + n_ctr + 1;
  float4* recs = static_cast<float4*>(records);
  const int hist_bytes = 4 * g.tiles * (int)sizeof(int);
  const int scatter_bytes = kChunk * (int)(sizeof(float4) + sizeof(int))
                            + hist_bytes + (int)sizeof(int);
  cudaError_t err = cudaMemsetAsync(counts, 0, n_ctr * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (m > 0) {
    const dim3 grid(g.chunks, batch);
    voxel_count_kernel<<<grid, kBinThreads, hist_bytes, s>>>(events, counts,
                                                             block_off, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    voxel_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, seg, n_ctr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    voxel_scatter_kernel<<<grid, kBinThreads, scatter_bytes, s>>>(
        events, seg, block_off, recs, g);
  } else {
    voxel_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, seg, n_ctr);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const long long n_cells = (long long)batch * g.tiles;
  const int acc_bytes = nbins * ty * tx * (int)sizeof(float)
                        + kAccChunk * (int)sizeof(float4)
                        + ((ty + 1) * (tx + 1) + 1) * (int)sizeof(int);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n_cells + kCluster - 1) / kCluster * kCluster));
  cfg.blockDim = dim3(kAccThreads);
  cfg.dynamicSmemBytes = acc_bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, voxel_accum_kernel,
                           static_cast<const float4*>(recs),
                           static_cast<const int*>(seg), out, g, n_cells);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
