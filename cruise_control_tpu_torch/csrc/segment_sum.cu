// K12 segment_sum: per-segment float32 sums that add in index order.
//
// Replaces the float `jax.ops.segment_sum` of the reference's compiled
// programs (cruise_control_tpu/model/state.py broker_load :140,
// potential_leadership_load :224, disk_load :234, host_load / rack_load
// :148-156; analyzer/context.py :386 and :523; goals/intra_broker.py
// :139-142) and, with `init`, `arr.at[idx].add(vals)`.  XLA:CPU adds a
// scatter's updates in index order, so for segment s and column c
//     out[s, c] = init[s, c] (or +0.0), then + x[i, c] for every i with
//                 ids[i] == s, in increasing i, each add rounded (fadd_rn)
// Ids outside [0, n) are dropped.  The plain version is
// ops.segment_sum_plain (ops.scatter_add_seq_plain with `init`).
//
// Bound on this card: the bytes (each entry's row and id read once, each
// output written once) and the chain: a segment's adds depend on each
// other, so the longest segment of L entries takes at least L dependent
// adds (4 cycles each).  One segment of 600,000 entries cannot take less
// than about 1.2 ms, whatever the bytes allow.
//
// Design: ONE launch per call (a cooperative launch; a plain one when the
// plan needs one block), four phases separated by grid barriers, no host
// sync and no library sort: each phase's loads are issued in batches, so
// that a phase waits on a few memory round trips and not one per entry.
//   1. rank: a block per tile (about 2,048 entries; fewer, longer tiles
//      when n is large, so tiles * n stays at most 2^20).  Each of up to 8
//      warps ranks its own stretch of the tile, the next 256 ids loading
//      while 256 are ranked: __match_any_sync groups equal ids, and a
//      running count per segment (the warp's own table in shared memory)
//      gives each entry its rank among the earlier entries of its segment
//      in the stretch.  The block then turns the warps' counts into
//      per-warp offsets and the tile's counts (a [tiles, n] histogram),
//      and adds each entry's warp offset to its rank.  Warps per tile: as
//      many tables of n counts as fit in 200 KB, at most 8 (one table of
//      up to 224 KB at n = 57,344).
//   2. offsets: the warps of a block take groups of 32 segments, up to 8
//      warps to a group, each over at most 32 tiles held in registers;
//      they scan the histogram into per-tile offsets and count each
//      segment, and a warp scan gives each segment its start inside its
//      group of 32.
//   3. place: every block scans the group totals in shared memory; each
//      entry's row goes to start + tile offset + rank (8 entries a thread
//      at once, a row of 4 floats as one 16-byte store), so every
//      segment's rows lie contiguous and in index order.
//   4. walk, by the average segment length (the wrapper's choice):
//      - 64 entries or more: a warp per segment stages the segment's rows
//        (512 floats a stage, 4 stages in flight) into a shared-memory
//        ring with cp.async, and one lane per column adds them with
//        __fadd_rn (a row of one float: four terms a 16-byte load) while
//        the next stages land, so the chain waits on the adds and not on
//        the loads.  A long segment keeps one warp: its adds are one
//        chain, which more threads cannot shorten.
//      - fewer: a thread per (segment, column) adds its run, 8 loads in
//        flight (also for rows wider than 32 columns).
// A block of 256 threads; the cooperative grid is at most 2 blocks an SM
// and at most what the work needs.  Integer atomics and barriers only:
// the result does not depend on the order the threads run in.  Phases 3
// and 4 read what other blocks wrote in phase 2 after a grid barrier:
// with plain loads where this SM has not cached those lines earlier in
// the launch, else through L2 (__ldcg).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;          // walk: stages in flight per warp
constexpr int kStageFloats = 512;   // walk: floats a stage
constexpr int kMaxSegments = 57344;
constexpr int kRankSmem = 200 * 1024;  // rank tables, unless one needs more
constexpr int kHistBudget = 1 << 20;   // tiles * n at most
constexpr int kTileMin = 2048;
constexpr int kMaxGrid = 264;
constexpr int kMaxTiles = 256;    // phase 2 keeps 32 tiles a warp

struct Plan {
  int tile, tiles, ng, warps_rank, lane_walk, dyn, ring_off;
  long long hist_off, rank_off, count_off, local_off, group_off, xs_off,
      bytes;
};

long long align256(long long b) { return (b + 255) / 256 * 256; }

Plan make_plan(int N, int n, int M, int lane_walk) {
  Plan p{};
  p.ng = (n + 31) / 32;
  if (N > 0) {
    long long cap = kHistBudget / n;
    if (cap < 1) cap = 1;
    if (cap > kMaxTiles) cap = kMaxTiles;
    long long tiles = (N + kTileMin - 1) / kTileMin;
    if (tiles > cap) tiles = cap;
    long long tile = (N + tiles - 1) / tiles;
    tile = (tile + 31) / 32 * 32;
    p.tile = (int)tile;
    p.tiles = (int)((N + tile - 1) / tile);
  }
  int wr = kRankSmem / (4 * n);
  if (wr < 1) wr = 1;
  if (wr > kWarps) wr = kWarps;
  p.warps_rank = wr;
  p.lane_walk = lane_walk || M > 32;
  p.ring_off = (int)((4LL * p.ng + 15) / 16 * 16);
  const int walk = p.ring_off +
                   (p.lane_walk ? 0 : kWarps * kStages * kStageFloats * 4);
  const int rank = 4 * wr * n;
  p.dyn = rank > walk ? rank : walk;
  long long off = 0;
  p.hist_off = off;
  off += align256(4LL * p.tiles * n);
  p.rank_off = off;
  off += align256(4LL * N);
  p.count_off = off;
  off += align256(4LL * n);
  p.local_off = off;
  off += align256(4LL * n);
  p.group_off = off;
  off += align256(4LL * p.ng);
  p.xs_off = off;
  off += align256(4LL * N * M);
  p.bytes = off;
  return p;
}

struct Args {
  const float* x;
  const void* ids;
  const float* init;
  float* out;
  int* hist;    // [tiles, n]: per-tile counts, then per-tile offsets
  int* rank;    // [N]: rank inside the segment's run of the tile, or -1
  int* count;   // [n]: entries per segment
  int* local;   // [n]: start inside the segment's group of 32
  int* group;   // [ng]: entries per group of 32 segments
  float* xs;    // [N, M]: rows placed by segment, in index order
  int N, n, M, tile, tiles, ng, warps_rank, lane_walk, ring_off;
};

__device__ __forceinline__ void grid_barrier() {
  if (gridDim.x == 1) {
    __syncthreads();
  } else {
    cg::this_grid().sync();
  }
}

template <typename IdT>
__device__ __forceinline__ int valid_key(const IdT* ids, int i, int n) {
  const IdT s = ids[i];
  return (s >= 0 && s < (IdT)n) ? (int)s : -1;
}

// Phase 1 for tile t; cnt: warps_rank tables of n counts.
template <typename IdT>
__device__ void rank_tile(const Args& a, const IdT* ids, int t, int* cnt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = a.n;
  const int wr = a.warps_rank;
  for (int k = threadIdx.x; k < wr * n; k += kThreads) cnt[k] = 0;
  __syncthreads();
  const int base = t * a.tile;
  const int end = (int)min((long long)base + a.tile, (long long)a.N);
  const int per = ((a.tile + wr - 1) / wr + 31) / 32 * 32;
  const int lo = (int)min((long long)base + (long long)warp * per,
                          (long long)end);
  const int hi = (int)min((long long)lo + per, (long long)end);
  const unsigned int before_mask = (1u << lane) - 1u;
  if (warp < wr) {
    int* run = cnt + warp * n;
    // 256 ids a batch, the next batch loading while this one is ranked
    int nxt[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = lo + j * 32 + lane;
      nxt[j] = i < hi ? valid_key(ids, i, n) : -1;
    }
    for (int g0 = lo; g0 < hi; g0 += 256) {
      int key[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        key[j] = nxt[j];
        const int i = g0 + 256 + j * 32 + lane;
        nxt[j] = i < hi ? valid_key(ids, i, n) : -1;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (g0 + j * 32 < hi) {  // warp-uniform
          const int i = g0 + j * 32 + lane;
          const unsigned int peers = __match_any_sync(0xffffffffu, key[j]);
          const int before = __popc(peers & before_mask);
          const int same = __popc(peers);
          int cur = 0;
          if (key[j] >= 0) cur = run[key[j]];
          __syncwarp();
          if (key[j] >= 0 && before == same - 1) run[key[j]] = cur + same;
          __syncwarp();
          if (i < hi) a.rank[i] = key[j] >= 0 ? cur + before : -1;
        }
      }
    }
  }
  __syncthreads();
  // the warps' counts become offsets over the earlier warps; the tile's
  // counts go to the histogram
  for (int s = threadIdx.x; s < n; s += kThreads) {
    int acc = 0;
    for (int w = 0; w < wr; ++w) {
      const int c = cnt[w * n + s];
      cnt[w * n + s] = acc;
      acc += c;
    }
    a.hist[(long long)t * n + s] = acc;
  }
  __syncthreads();
  if (warp < wr && warp > 0) {
    const int* off = cnt + warp * n;
    for (int i0 = lo + lane; i0 < hi; i0 += 256) {
      int r[8];
      int k[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = i0 + j * 32;
        r[j] = i < hi ? a.rank[i] : -1;
        k[j] = i < hi ? valid_key(ids, i, n) : -1;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (r[j] >= 0) a.rank[i0 + j * 32] = r[j] + off[k[j]];
    }
  }
  __syncthreads();
}

// Phase 2: the block's warps take groups of 32 segments (a lane each),
// wpg warps to a group, each over its share of the tiles.
__device__ void tile_offsets(const Args& a, int g0, int wpg,
                             int (*part)[32]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = warp % wpg;
  const int g = g0 + warp / wpg;
  const int s = g * 32 + lane;
  const int tc = (a.tiles + wpg - 1) / wpg;
  const int t0 = min(sub * tc, a.tiles);
  const int t1 = min(t0 + tc, a.tiles);
  const bool live = s < a.n;
  // at most 32 tiles a warp (tiles <= 256): the counts stay in registers
  int v[32];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int t = t0 + k;
    v[k] = (live && t < t1) ? __ldcg(a.hist + (long long)t * a.n + s) : 0;
    sum += v[k];
  }
  part[warp][lane] = sum;
  __syncthreads();
  int off = 0;
  int total = 0;
  for (int w = warp - sub; w < warp - sub + wpg; ++w) {
    const int u = part[w][lane];
    if (w < warp) off += u;
    total += u;
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int t = t0 + k;
    if (live && t < t1) a.hist[(long long)t * a.n + s] = off;
    off += v[k];
  }
  if (sub == 0 && g < a.ng) {
    int incl = total;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (live) {
      a.count[s] = total;
      a.local[s] = incl - total;
    }
    if (lane == 31) a.group[g] = incl;
  }
  __syncthreads();
}

// gp[g] = the entries of the groups before g (every block, in shared
// memory).
__device__ void group_starts(const Args& a, int* gp, int* wsum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (a.ng + kThreads - 1) / kThreads;
  const int lo = min((int)threadIdx.x * per, a.ng);
  const int hi = min(lo + per, a.ng);
  int local = 0;
  for (int k = lo; k < hi; ++k) local += __ldcg(a.group + k);
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kWarps ? wsum[lane] : 0;
    int w_incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w_incl, d);
      if (lane >= d) w_incl += u;
    }
    if (lane < kWarps) wsum[lane] = w_incl - v;
  }
  __syncthreads();
  int acc = wsum[warp] + incl - local;
  for (int k = lo; k < hi; ++k) {
    gp[k] = acc;
    acc += __ldcg(a.group + k);
  }
  __syncthreads();
}

// Phase 3 for tile t: 8 entries a thread at once, so their loads overlap.
template <typename IdT>
__device__ void place_tile(const Args& a, const IdT* ids, int t,
                           const int* gp) {
  const int base = t * a.tile;
  const int end = (int)min((long long)base + a.tile, (long long)a.N);
  const int M = a.M;
  for (int i0 = base + threadIdx.x; i0 < end; i0 += 8 * kThreads) {
    int r[8];
    int k[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * kThreads;
      r[j] = i < end ? a.rank[i] : -1;
      k[j] = i < end ? valid_key(ids, i, a.n) : -1;
    }
    long long slot[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      slot[j] = -1;
      if (r[j] >= 0)
        slot[j] = (long long)gp[k[j] >> 5] + a.local[k[j]] +
                  a.hist[(long long)t * a.n + k[j]] + r[j];
    }
    if (M <= 4) {
      float v[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* src = a.x + (long long)(i0 + j * kThreads) * M;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v[j][c] = (slot[j] >= 0 && c < M) ? src[c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* dst = a.xs + slot[j] * M;
        if (slot[j] < 0) continue;
        if (M == 4) {  // one 16-byte store: xs is 256-byte aligned
          *reinterpret_cast<float4*>(dst) =
              make_float4(v[j][0], v[j][1], v[j][2], v[j][3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c < M) dst[c] = v[j][c];
        }
      }
    } else {
      for (int j = 0; j < 8; ++j) {
        if (slot[j] < 0) continue;
        const float* src = a.x + (long long)(i0 + j * kThreads) * M;
        float* dst = a.xs + slot[j] * M;
        for (int c = 0; c < M; ++c) dst[c] = src[c];
      }
    }
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned int d =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// `rows` terms p[e * M], e < rows, added to acc in order; the next 8
// terms load while the current 8 are added.
__device__ __forceinline__ float fold_column(float acc, const float* p,
                                             int rows, int M) {
  int e = 0;
  if (rows >= 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = p[j * M];
    for (e = 8; e + 8 <= rows; e += 8) {
      float u[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) u[j] = p[(e + j) * M];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = __fadd_rn(acc, v[j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = u[j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = __fadd_rn(acc, v[j]);
  }
  for (; e < rows; ++e) acc = __fadd_rn(acc, p[e * M]);
  return acc;
}

// fold_column for rows of one float: four terms a 16-byte load (p is
// 16-byte aligned).
__device__ __forceinline__ float fold_single(float acc, const float* p,
                                             int rows) {
  const float4* q = reinterpret_cast<const float4*>(p);
  int e = 0;
  if (rows >= 8) {
    float4 u0 = q[0];
    float4 u1 = q[1];
    for (e = 8; e + 8 <= rows; e += 8) {
      const float4 w0 = q[e / 4];
      const float4 w1 = q[e / 4 + 1];
      acc = __fadd_rn(acc, u0.x);
      acc = __fadd_rn(acc, u0.y);
      acc = __fadd_rn(acc, u0.z);
      acc = __fadd_rn(acc, u0.w);
      acc = __fadd_rn(acc, u1.x);
      acc = __fadd_rn(acc, u1.y);
      acc = __fadd_rn(acc, u1.z);
      acc = __fadd_rn(acc, u1.w);
      u0 = w0;
      u1 = w1;
    }
    acc = __fadd_rn(acc, u0.x);
    acc = __fadd_rn(acc, u0.y);
    acc = __fadd_rn(acc, u0.z);
    acc = __fadd_rn(acc, u0.w);
    acc = __fadd_rn(acc, u1.x);
    acc = __fadd_rn(acc, u1.y);
    acc = __fadd_rn(acc, u1.z);
    acc = __fadd_rn(acc, u1.w);
  }
  for (; e < rows; ++e) acc = __fadd_rn(acc, p[e]);
  return acc;
}

// Phase 4, a warp per segment: chunk q of the segment (K rows) goes to
// stage q % kStages of the warp's ring.
__device__ void walk_warp(const Args& a, const int* gp, float* ring, int s) {
  const int lane = threadIdx.x & 31;
  const int M = a.M;
  const int beg = gp[s >> 5] + __ldcg(a.local + s);
  const int len = __ldcg(a.count + s);
  const int K = kStageFloats / M;
  const int chunks = (len + K - 1) / K;
  const float* src = a.xs + (long long)beg * M;
  float acc = 0.f;
  if (lane < M && a.init) acc = a.init[(long long)s * M + lane];
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < chunks) {
      const int nf = min(K, len - q * K) * M;
      const float* from = src + (long long)q * K * M;
      float* to = ring + q * kStageFloats;
      for (int f = lane; f < nf; f += 32) cp_async4(to + f, from + f);
    }
    cp_async_commit();
  }
  for (int q = 0; q < chunks; ++q) {
    const int qn = q + kStages - 1;
    if (qn < chunks) {
      const int nf = min(K, len - qn * K) * M;
      const float* from = src + (long long)qn * K * M;
      float* to = ring + (qn % kStages) * kStageFloats;
      for (int f = lane; f < nf; f += 32) cp_async4(to + f, from + f);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    if (lane < M) {
      const float* st = ring + (q % kStages) * kStageFloats + lane;
      const int rows = min(K, len - q * K);
      acc = M == 1 ? fold_single(acc, st, rows)
                   : fold_column(acc, st, rows, M);
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  if (lane < M) a.out[(long long)s * M + lane] = acc;
}

// Phase 4, a thread per (segment, column).
__device__ void walk_lanes(const Args& a, const int* gp) {
  const int M = a.M;
  const long long total = (long long)a.n * M;
  for (long long p = blockIdx.x * (long long)kThreads + threadIdx.x;
       p < total; p += (long long)gridDim.x * kThreads) {
    const int s = (int)(p / M);
    const int c = (int)(p - (long long)s * M);
    float acc = a.init ? a.init[p] : 0.f;
    long long k = gp[s >> 5] + __ldcg(a.local + s);
    const long long hi = k + __ldcg(a.count + s);
    for (; k + 8 <= hi; k += 8) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __ldcg(a.xs + (k + j) * M + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = __fadd_rn(acc, v[j]);
    }
    for (; k < hi; ++k) acc = __fadd_rn(acc, __ldcg(a.xs + k * M + c));
    a.out[p] = acc;
  }
}

template <typename IdT>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ int part[kWarps][32];
  __shared__ int wsum[kWarps];
  const IdT* ids = static_cast<const IdT*>(a.ids);
  int* cnt = reinterpret_cast<int*>(dyn);
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x)
    rank_tile<IdT>(a, ids, t, cnt);
  grid_barrier();
  int wpg = 1;
  while (wpg < kWarps && wpg * 32 < a.tiles) wpg *= 2;
  const int gpp = kWarps / wpg;
  for (int g0 = blockIdx.x * gpp; g0 < a.ng; g0 += gridDim.x * gpp)
    tile_offsets(a, g0, wpg, part);
  grid_barrier();
  int* gp = reinterpret_cast<int*>(dyn);
  group_starts(a, gp, wsum);
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x)
    place_tile<IdT>(a, ids, t, gp);
  grid_barrier();
  if (a.lane_walk) {
    walk_lanes(a, gp);
  } else {
    const int warp = threadIdx.x >> 5;
    float* ring = reinterpret_cast<float*>(dyn + a.ring_off) +
                  warp * kStages * kStageFloats;
    for (int s = blockIdx.x * kWarps + warp; s < a.n;
         s += gridDim.x * kWarps)
      walk_warp(a, gp, ring, s);
  }
}

struct DeviceInfo {
  int sms = 0;
  int coop = 0;
  bool smem_set[2] = {false, false};
  int occ_dyn[2][8];
  int occ_blocks[2][8];
  int occ_n[2] = {0, 0};
};
DeviceInfo g_dev[16];
std::mutex g_dev_lock;

// Blocks a cooperative launch may hold at `dyn` bytes of shared memory.
template <typename IdT>
int capacity(int dyn, int which, int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 16) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(g_dev_lock);
  DeviceInfo& d = g_dev[dev];
  if (d.sms == 0) {
    e = cudaDeviceGetAttribute(&d.coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      d.sms = 0;
      return (int)e;
    }
  }
  if (!d.smem_set[which]) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e == cudaSuccess) {
      cudaFuncAttributes attr;
      e = cudaFuncGetAttributes(&attr, segment_sum_kernel<IdT>);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(segment_sum_kernel<IdT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - (int)attr.sharedSizeBytes);
    }
    if (e != cudaSuccess) return (int)e;
    d.smem_set[which] = true;
  }
  for (int k = 0; k < d.occ_n[which]; ++k) {
    if (d.occ_dyn[which][k] == dyn) {
      *blocks = d.occ_blocks[which][k];
      return 0;
    }
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, segment_sum_kernel<IdT>, kThreads, dyn);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (per_sm > 2) per_sm = 2;
  *blocks = d.coop ? d.sms * per_sm : 1;
  const int k = d.occ_n[which] < 8 ? d.occ_n[which]++ : 7;
  d.occ_dyn[which][k] = dyn;
  d.occ_blocks[which][k] = *blocks;
  return 0;
}

template <typename IdT>
int launch(Args a, const Plan& p, int which, cudaStream_t st) {
  int cap = 0;
  int err = capacity<IdT>(p.dyn, which, &cap);
  if (err != 0) return err;
  long long want = a.lane_walk ? ((long long)a.n * a.M + 1023) / 1024
                               : ((long long)a.n + 31) / 32;
  if (want < a.tiles) want = a.tiles;
  if (want > kMaxGrid) want = kMaxGrid;
  if (want > cap) want = cap;
  if (want < 1) want = 1;
  if (want == 1) {
    segment_sum_kernel<IdT><<<1, kThreads, p.dyn, st>>>(a);
    return (int)cudaGetLastError();
  }
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)segment_sum_kernel<IdT>, dim3((unsigned int)want),
      dim3(kThreads), params, (size_t)p.dyn, st);
}

}  // namespace

// Bytes of scratch that cc_segment_sum needs for N entries into n segments
// of rows of M floats.
extern "C" long long cc_segment_sum_scratch(int N, int n, int M) {
  if (N < 0 || n <= 0 || n > kMaxSegments || M <= 0) return -1;
  return make_plan(N, n, M, 1).bytes;
}

// x f32[N, M], ids i32 or i64 [N] (ids64), init f32[n, M] or null, out
// f32[n, M]; scratch of cc_segment_sum_scratch(N, n, M) bytes, 256-byte
// aligned.  n at most 57,344.  lane_walk 1: the walk takes a thread per
// (segment, column), 0: a warp per segment (the wrapper picks by the
// average segment length; rows wider than 32 columns always take lanes).
extern "C" int cc_segment_sum(const float* x, const void* ids, int ids64,
                              int N, int n, int M, const float* init,
                              void* scratch, long long scratch_bytes,
                              int lane_walk, float* out, void* stream) {
  if (n <= 0 || M <= 0) return 0;
  if (N < 0 || n > kMaxSegments) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(N, n, M, lane_walk);
  if (scratch_bytes < p.bytes) return (int)cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  Args a;
  a.x = x;
  a.ids = ids;
  a.init = init;
  a.out = out;
  a.hist = reinterpret_cast<int*>(base + p.hist_off);
  a.rank = reinterpret_cast<int*>(base + p.rank_off);
  a.count = reinterpret_cast<int*>(base + p.count_off);
  a.local = reinterpret_cast<int*>(base + p.local_off);
  a.group = reinterpret_cast<int*>(base + p.group_off);
  a.xs = reinterpret_cast<float*>(base + p.xs_off);
  a.N = N;
  a.n = n;
  a.M = M;
  a.tile = p.tile;
  a.tiles = p.tiles;
  a.ng = p.ng;
  a.warps_rank = p.warps_rank;
  a.lane_walk = p.lane_walk;
  a.ring_off = p.ring_off;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ids64 ? launch<long long>(a, p, 1, st) : launch<int>(a, p, 0, st);
}
