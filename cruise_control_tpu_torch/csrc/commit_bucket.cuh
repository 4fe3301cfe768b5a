// Shared by K3 (commit_moves.cu) and K5 (commit_leadership.cu): one stable
// bucketing of a commit batch's 2n ends by broker, and the per-broker walk
// over it.
//
// Both commits add per-broker float sums in the reference's order: its
// one fused scatter over [sources; destinations] (_scatter_pm,
// cruise_control_tpu/analyzer/context.py) adds, at each broker, the
// removals of the batch in batch order and then its arrivals in batch
// order.  That is exactly a stable bucketing of the 2n keys
//     key i     = the source broker of move i      (a "departure"),
//     key n + i = the destination broker of move i (an "arrival"),
// followed by an in-order walk of each bucket.  A dropped move has no key
// in either bucket.
//
// The bucketing here is O(n + B) and needs no host sync and no library
// sort.  Departures of broker b go to virtual bucket b and arrivals to
// virtual bucket B + b (V = 2B buckets), so a bucket's walk order is
// "its departures, then its arrivals" by construction.  The batch is cut
// into tiles of M = wr * 32 * ch moves (wr ranking warps, ch = 1 to 4
// moves a lane: the fewest that keep the tiles to about 64; M at most
// 1,024); a block buckets one tile at a time:
//   * each of wr warps ranks its own stretch of the tile, 32 moves at a
//     time: __match_any_sync groups the lanes with equal keys, and a
//     running count per virtual bucket (the warp's own table of V
//     16-bit counters in shared memory) gives each key its rank among
//     the earlier keys of its bucket in the stretch;
//   * the block turns the warps' counts into per-warp offsets, scans the
//     tile's counts over the V buckets and writes each bucket's (start in
//     the tile, count) to meta[tile][v]; each key's position in the tile
//     is start + warp offset + rank, and the kernel writes the key's row
//     (what the walk adds and writes) there.
// So a tile's rows lie bucket by bucket, each bucket in batch order, and
// a broker's keys in batch order are its departure segments of tiles
// 0..T-1 followed by its arrival segments of tiles 0..T-1.  After one grid
// barrier a warp per broker reads its 2T (start, count) pairs, scans them
// into a prefix in shared memory, and maps its e-th key to a row by a
// binary search over that prefix: its walk loads 32 rows at once and then
// adds them in order.  The warps take brokers blockIdx.x, blockIdx.x +
// grid, ..., so that the walks spread over the SMs.  Table slots are
// found in registers (chunk_slots): the warp holds its row's first 1,024
// slots, all loaded at once.
//
// No tile-wide prefix over the grid is needed, so the whole commit is one
// launch with one grid barrier: a cooperative launch, or a plain one when
// the grid is one block.  Integer atomics and barriers only: nothing
// depends on the order the blocks run in.
//
// Limits (make_plan refuses the rest; the wrappers then raise ValueError,
// and no path falls back): a ranking warp keeps 2B 16-bit counters in a
// 200 KB shared-memory budget beside the tile's 4-byte bucket counts, so
// wr_max = min(8, (204,800 - 8B) / 4B) ranking warps fit, and none from
// B = 17,067 brokers up.  A batch is at most kMaxTiles = 1,024 tiles of at
// most 128 wr_max moves: 1,048,576 moves up to 5,120 brokers, falling
// with wr_max to 262,144 at 10,241-12,800 brokers and 131,072 at
// 12,801-17,066.  The main path's largest calls (K3: 10,400 moves, K5:
// 41,600 transfers, both at 2,600 brokers) lie far inside.
//
// Everything here has internal linkage (each source that includes it
// keeps its own copy).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>

namespace ccb {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 4;          // most moves a lane buckets in a tile
constexpr int kTargetTiles = 64;
constexpr int kMaxTiles = 1024;
constexpr int kSmemBudget = 200 * 1024;
constexpr int kRowRegs = 32;        // row slots a lane holds: 1,024 a warp
constexpr int kStage = 8;           // floats of a key's staged row

struct Plan {
  int V, wr, ch, M, T, dyn;
  long long meta_off, rows_off, bytes;
};

inline long long align256(long long b) { return (b + 255) / 256 * 256; }

// The plan for n moves into num_b brokers with rows of `rw` floats; false
// when the batch does not fit (too many brokers for a table of counters in
// shared memory, or more than kMaxTiles tiles).
inline bool make_plan(int n, int num_b, int rw, Plan* p) {
  if (n < 0 || num_b <= 0) return false;
  p->V = 2 * num_b;
  long long wr_max = (kSmemBudget - 4LL * p->V) / (2LL * p->V);
  if (wr_max < 1) return false;
  if (wr_max > kWarps) wr_max = kWarps;
  // the fewest ranking warps, then moves a lane, that keep the batch to
  // about kTargetTiles tiles: a tile's shared-memory work grows with wr,
  // its chains of loads with ch, and the walk's reads with the tiles
  const long long want = (n + kTargetTiles - 1) / kTargetTiles;
  long long wr = (want + 31) / 32;
  if (wr < 1) wr = 1;
  if (wr > wr_max) wr = wr_max;
  long long ch = (want + 32 * wr - 1) / (32 * wr);
  if (ch < 1) ch = 1;
  if (ch > kChunks) ch = kChunks;
  p->wr = (int)wr;
  p->ch = (int)ch;
  p->M = p->wr * 32 * p->ch;
  p->T = (n + p->M - 1) / p->M;
  if (p->T > kMaxTiles) return false;
  const int phase0 = 4 * p->V + 2 * p->wr * p->V;
  const int walk = kWarps * (4 * (4 * p->T + 2) + 4 * 32 * kStage);
  p->dyn = phase0 > walk ? phase0 : walk;
  long long off = 0;
  p->meta_off = off;
  off += align256(4LL * p->T * p->V);
  p->rows_off = off;
  off += align256(4LL * p->T * 2 * p->M * rw);
  p->bytes = off;
  return true;
}

struct Bucketing {
  int n, num_b, V, wr, ch, M, T;
  int* meta;     // [T, V]: (start of the bucket in the tile << 16) | count
  float* rows;   // [T, 2M, rw]: the keys' rows, bucket by bucket
};

inline Bucketing bucketing(const Plan& p, int n, int num_b, void* scratch) {
  unsigned char* base = static_cast<unsigned char*>(scratch);
  Bucketing bk;
  bk.n = n;
  bk.num_b = num_b;
  bk.V = p.V;
  bk.wr = p.wr;
  bk.ch = p.ch;
  bk.M = p.M;
  bk.T = p.T;
  bk.meta = reinterpret_cast<int*>(base + p.meta_off);
  bk.rows = reinterpret_cast<float*>(base + p.rows_off);
  return bk;
}

__device__ __forceinline__ void grid_barrier() {
  if (gridDim.x == 1) {
    __syncthreads();
  } else {
    cg::this_grid().sync();
  }
}

// The move this lane buckets as its chunk c of tile t, or -1.
__device__ __forceinline__ int tile_move(const Bucketing& bk, int t, int c) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= bk.wr || c >= bk.ch) return -1;
  const long long i = (long long)t * bk.M + warp * 32 * bk.ch + c * 32 +
                      lane;
  return i < bk.n ? (int)i : -1;
}

// Rank of this lane's key among the earlier keys of its bucket in the
// warp's stretch (-1: no key); `run` is the warp's table of counters.
__device__ __forceinline__ int rank_key(unsigned short* run, int key) {
  const int lane = threadIdx.x & 31;
  const unsigned int peers = __match_any_sync(0xffffffffu, key);
  const int before = __popc(peers & ((1u << lane) - 1u));
  const int same = __popc(peers);
  int cur = 0;
  if (key >= 0) cur = run[key];
  __syncwarp();
  if (key >= 0 && before == same - 1) run[key] = (unsigned short)(cur + same);
  __syncwarp();
  return cur + before;
}

// Buckets tile t.  kd / ka: this lane's departure and arrival keys (a
// broker, B + a broker, or -1) of its moves tile_move(bk, t, c); pd / pa
// get each key's row index in bk.rows (-1: no key).  Every thread of the
// block calls it; it ends with a block barrier.
__device__ void bucket_tile(const Bucketing& bk, int t,
                            const int (&kd)[kChunks],
                            const int (&ka)[kChunks], unsigned char* smem,
                            int (&pd)[kChunks], int (&pa)[kChunks]) {
  __shared__ int wsum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int V = bk.V;
  int* base = reinterpret_cast<int*>(smem);  // [V]
  unsigned short* cnt =
      reinterpret_cast<unsigned short*>(smem + 4LL * V);  // [wr, V]
  // V is even, so the tables are whole 32-bit words
  unsigned int* cnt_words = reinterpret_cast<unsigned int*>(cnt);
  for (int k = threadIdx.x; k < bk.wr * V / 2; k += kThreads)
    cnt_words[k] = 0u;
  __syncthreads();
  int rd[kChunks];
  int ra[kChunks];
  if (warp < bk.wr) {
    unsigned short* run = cnt + (long long)warp * V;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c < bk.ch) {  // block-uniform
        rd[c] = rank_key(run, kd[c]);
        ra[c] = rank_key(run, ka[c]);
      }
    }
  }
  __syncthreads();
  // the warps' counts become offsets over the earlier warps (each
  // bucket's counts loaded at once), and the tile's count of each bucket
  // goes to base
  for (int v = threadIdx.x; v < V; v += kThreads) {
    int c[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      c[w] = w < bk.wr ? cnt[(long long)w * V + v] : 0;
    int acc = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < bk.wr) cnt[(long long)w * V + v] = (unsigned short)acc;
      acc += c[w];
    }
    base[v] = acc;
  }
  __syncthreads();
  // exclusive scan of the tile's counts over the buckets: each thread a
  // contiguous run, then the warps, then the block
  const int per = (V + kThreads - 1) / kThreads;
  const int lo = min((int)threadIdx.x * per, V);
  const int hi = min(lo + per, V);
  int local = 0;
  for (int k = lo; k < hi; ++k) local += base[k];
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int acc = incl - local;
  for (int w = 0; w < warp; ++w) acc += wsum[w];
  for (int k = lo; k < hi; ++k) {
    const int c = base[k];
    base[k] = acc;
    acc += c;
  }
  __syncthreads();
  // (start, count) of each bucket, coalesced; the tile's keys in all
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += wsum[w];
  int* meta = bk.meta + (long long)t * V;
  for (int v = threadIdx.x; v < V; v += kThreads) {
    const int start = base[v];
    const int next = v + 1 < V ? base[v + 1] : total;
    meta[v] = (start << 16) | (next - start);
  }
  const int row0 = t * 2 * bk.M;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    pd[c] = pa[c] = -1;
    if (warp < bk.wr && c < bk.ch) {
      if (kd[c] >= 0)
        pd[c] = row0 + base[kd[c]] + cnt[(long long)warp * V + kd[c]] + rd[c];
      if (ka[c] >= 0)
        pa[c] = row0 + base[ka[c]] + cnt[(long long)warp * V + ka[c]] + ra[c];
    }
  }
  __syncthreads();
}

// Broker b's 2T segments (departures of tiles 0..T-1, then arrivals of
// tiles 0..T-1), read by the whole warp: seg[s] their (start << 16) |
// count, pre[s] the broker's keys before segment s, pre[2T] = L.  Returns
// L; *ldep = the broker's departures (its first *ldep keys).
__device__ int broker_segments(const Bucketing& bk, int b, int* pre,
                               int* seg, int* ldep) {
  const int lane = threadIdx.x & 31;
  const int S2 = 2 * bk.T;
  // the loads first, four a lane at a time, so they overlap
  for (int s0 = lane; s0 < S2; s0 += 128) {
    int m[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + 32 * j;
      m[j] = 0;
      if (s < S2) {
        const int t = s < bk.T ? s : s - bk.T;
        const int v = s < bk.T ? b : bk.num_b + b;
        m[j] = __ldcg(bk.meta + (long long)t * bk.V + v);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (s0 + 32 * j < S2) seg[s0 + 32 * j] = m[j];
  }
  __syncwarp();
  int carry = 0;
  for (int s0 = 0; s0 < S2; s0 += 32) {
    const int s = s0 + lane;
    const int c = s < S2 ? (seg[s] & 0xffff) : 0;
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += u;
    }
    if (s < S2) pre[s] = carry + incl - c;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) pre[S2] = carry;
  __syncwarp();
  *ldep = pre[bk.T];
  return carry;
}

// The row index (in bk.rows) of broker b's key e (0 <= e < L), by a
// binary search for the segment holding it; no memory but shared.
__device__ __forceinline__ int entry_row(const Bucketing& bk, const int* pre,
                                         const int* seg, int e) {
  int lo = 0;
  int hi = 2 * bk.T;  // pre[lo] <= e < pre[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pre[mid] <= e) lo = mid;
    else hi = mid;
  }
  const int t = lo < bk.T ? lo : lo - bk.T;
  return t * 2 * bk.M + (seg[lo] >> 16) + (e - pre[lo]);
}

// The first kRowRegs * 32 slots of a table row, held by a warp: slot
// k * 32 + lane in v[k] (-1 past the row's end), all loads in flight at
// once.
struct RowWindow {
  int v[kRowRegs];
};

// A load the compiler keeps where it is written (it may not sink it into
// the loop that reads the window, one memory round trip a search).
__device__ __forceinline__ int load_pinned(const int* p) {
  int v;
  asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void row_load(RowWindow& w, const int* row,
                                         int S) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kRowRegs; ++k) {
    const int j = k * 32 + lane;
    w.v[k] = j < S ? load_pinned(row + j) : -1;
  }
}

// Lowers `mine` to slot base + l where lane l's value vk equals `r`
// (the 32 values of one register of the row, broadcast in turn).
__device__ __forceinline__ void scan32(int vk, int r, int base, int& mine) {
#pragma unroll
  for (int l = 0; l < 32; ++l) {
    const int v = __shfl_sync(0xffffffffu, vk, l);
    if (v == r && mine < 0) mine = base + l;
  }
}

// This lane's first slot holding r in the window, or INT_MAX: 32
// independent compares folded into a mask.
__device__ __forceinline__ int window_first(const int (&v)[kRowRegs], int r) {
  unsigned int m = 0u;
#pragma unroll
  for (int k = 0; k < kRowRegs; ++k) m |= (v[k] == r ? 1u : 0u) << k;
  return m ? (__ffs(m) - 1) * 32 + (threadIdx.x & 31) : INT_MAX;
}

// The first slot in the row of each lane's replica `rid` among the lanes
// of `live` (-1 elsewhere, or where the row lacks it), for that lane.  The
// row's replicas all sit below its fill pointer; `used` = min(fill, S).
// Two ways, by which takes fewer instructions: for a few ids the whole
// warp searches the window for one id after another (about 100
// instructions each, four at a time); for more, the warp broadcasts its
// live slots one by one and every lane compares them with its own id (one
// pass for all 32 ids, about 3 * used instructions).  Slots past the
// window are read 32 at a time.
__device__ __forceinline__ int chunk_slots(const RowWindow& w, const int* row,
                                           int S, int fill, unsigned int live,
                                           int rid) {
  if (live == 0u) return -1;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int used = min(fill, S);
  int mine = -1;
  if (__popc(live) * 128 < 3 * used && used <= kRowRegs * 32) {
    while (live != 0u) {
      int j[4], best[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        j[q] = live ? __ffs(live) - 1 : -1;
        live &= live - 1u;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = __shfl_sync(0xffffffffu, rid, j[q] < 0 ? 0 : j[q]);
        best[q] = __reduce_min_sync(0xffffffffu, window_first(w.v, r));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (lane == j[q]) mine = best[q] == INT_MAX ? -1 : best[q];
    }
    return mine;
  }
  const int r = (live >> lane) & 1u ? rid : -2;  // -2 matches no slot
#pragma unroll
  for (int k = 0; k < kRowRegs; ++k) {
    if (k * 32 >= used) break;  // warp-uniform
    scan32(w.v[k], r, k * 32, mine);
  }
  for (int base = kRowRegs * 32; base < used; base += 32) {
    const int j = base + lane;
    scan32(j < used ? row[j] : -1, r, base, mine);
  }
  return mine;
}

// Per-device launch facts of one kernel: its SM count, whether the device
// takes cooperative launches, and the co-resident blocks at each shared
// memory size asked for so far.
struct Occupancy {
  int sms = 0;
  int coop = 0;
  bool smem_set = false;
  int n = 0;
  int dyn[8];
  int blocks[8];
};

// Blocks a cooperative launch of `kernel` may hold at `dyn` bytes of
// dynamic shared memory (1 where the device takes no cooperative launch).
inline int capacity(const void* kernel, Occupancy* table, std::mutex& lock,
                    int dyn, int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 16) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(lock);
  Occupancy& d = table[dev];
  if (d.sms == 0) {
    e = cudaDeviceGetAttribute(&d.coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      d.sms = 0;
      return (int)e;
    }
  }
  if (!d.smem_set) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e == cudaSuccess) {
      cudaFuncAttributes attr;
      e = cudaFuncGetAttributes(&attr, kernel);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - (int)attr.sharedSizeBytes);
    }
    if (e != cudaSuccess) return (int)e;
    d.smem_set = true;
  }
  for (int k = 0; k < d.n; ++k) {
    if (d.dyn[k] == dyn) {
      *blocks = d.blocks[k];
      return 0;
    }
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    dyn);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = d.coop ? d.sms * per_sm : 1;
  const int k = d.n < 8 ? d.n++ : 7;
  d.dyn[k] = dyn;
  d.blocks[k] = *blocks;
  return 0;
}

// One launch of `kernel(args)`: a block per tile and a warp per broker,
// at most what may be co-resident; cooperative unless one block.
template <typename Args>
int launch(const void* kernel, Occupancy* table, std::mutex& lock,
           Args args, const Plan& p, int num_b, cudaStream_t st) {
  int cap = 0;
  int err = capacity(kernel, table, lock, p.dyn, &cap);
  if (err != 0) return err;
  // a block per tile, and walking warps spread over the SMs: about two
  // a block (each block's warps take brokers blockIdx.x, + grid, ...)
  long long want = ((long long)num_b + 1) / 2;
  if (want < p.T) want = p.T;
  if (want > cap) want = cap;
  if (want < 1) want = 1;
  void* params[] = {&args};
  if (want == 1)
    return (int)cudaLaunchKernel(kernel, dim3(1), dim3(kThreads), params,
                                 (size_t)p.dyn, st);
  return (int)cudaLaunchCooperativeKernel(kernel, dim3((unsigned int)want),
                                          dim3(kThreads), params,
                                          (size_t)p.dyn, st);
}

}  // namespace
}  // namespace ccb
