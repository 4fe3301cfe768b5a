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
// Design, five launches on one stream, no host sync and no library sort:
//   1. tile_rank: one warp per tile of `tile` entries walks its tile 32 at
//      a time; __match_any_sync groups equal ids, so each entry's rank
//      among the earlier entries of its segment inside the tile is a
//      running count in shared memory plus its rank in the group.  The
//      tile's per-segment counts go to a [tiles, n] histogram.
//   2. tile_offsets: a thread per segment turns its histogram column into
//      exclusive offsets over the tiles, and counts the segment.
//   3. segment_starts: one block scans the counts into segment starts.
//   4. place: each entry's row is copied to start + tile offset + rank, so
//      every segment's rows lie contiguous and in index order.
//   5. walk: a thread per (segment, column) adds its run in order.
// Bound: memory, each entry's row and id read once and each output written
// once; but the walk is serial, so a long segment bounds the time (one
// segment of R entries costs R dependent adds).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return blocks < 4096 ? (blocks > 0 ? (int)blocks : 1) : 4096;
}

template <typename IdT>
__global__ void tile_rank_kernel(const IdT* __restrict__ ids, int N, int n,
                                 int tile, int* __restrict__ hist,
                                 int* __restrict__ rank) {
  extern __shared__ int run[];  // n running counts
  const int lane = threadIdx.x;
  for (int s = lane; s < n; s += 32) run[s] = 0;
  __syncwarp();
  const int base = blockIdx.x * tile;
  const int end = min(base + tile, N);
  const unsigned before_mask = (1u << lane) - 1u;
  for (int g = base; g < end; g += 32) {
    const int i = g + lane;
    int key = -1;
    if (i < end) {
      const IdT s = ids[i];
      if (s >= 0 && s < (IdT)n) key = (int)s;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int before = __popc(peers & before_mask);
    const int cnt = __popc(peers);
    int cur = 0;
    if (key >= 0) {
      cur = run[key];
      rank[i] = cur + before;
    }
    __syncwarp();
    if (key >= 0 && before == cnt - 1) run[key] = cur + cnt;
    __syncwarp();
  }
  int* row = hist + (long long)blockIdx.x * n;
  for (int s = lane; s < n; s += 32) row[s] = run[s];
}

__global__ void tile_offsets_kernel(int* __restrict__ hist, int tiles, int n,
                                    int* __restrict__ count) {
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < n;
       s += gridDim.x * blockDim.x) {
    int acc = 0;
    for (int t = 0; t < tiles; ++t) {
      int* p = hist + (long long)t * n + s;
      const int c = *p;
      *p = acc;
      acc += c;
    }
    count[s] = acc;
  }
}

// One block of 1024 threads: start[s] = sum of count[0..s), start[n] the
// total.
__global__ void segment_starts_kernel(const int* __restrict__ count, int n,
                                      int* __restrict__ start) {
  __shared__ int warp_off[32];
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, n);
  const int hi = min(lo + per, n);
  int local = 0;
  for (int s = lo; s < hi; ++s) local += count[s];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = local;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_off[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < (int)(blockDim.x >> 5) ? warp_off[lane] : 0;
    int w_incl = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w_incl, d);
      if (lane >= d) w_incl += u;
    }
    warp_off[lane] = w_incl - v;
  }
  __syncthreads();
  int acc = warp_off[warp] + incl - local;
  for (int s = lo; s < hi; ++s) {
    start[s] = acc;
    acc += count[s];
  }
  if (threadIdx.x == blockDim.x - 1) start[n] = acc;
}

template <typename IdT>
__global__ void place_kernel(const IdT* __restrict__ ids,
                             const float* __restrict__ x, int N, int n, int M,
                             int tile, const int* __restrict__ hist,
                             const int* __restrict__ rank,
                             const int* __restrict__ start,
                             float* __restrict__ xs) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += gridDim.x * blockDim.x) {
    const IdT s = ids[i];
    if (s < 0 || s >= (IdT)n) continue;
    const long long slot = (long long)start[s] +
                           hist[(long long)(i / tile) * n + (int)s] + rank[i];
    const float* src = x + (long long)i * M;
    float* dst = xs + slot * M;
    for (int c = 0; c < M; ++c) dst[c] = src[c];
  }
}

__global__ void walk_kernel(const float* __restrict__ xs,
                            const int* __restrict__ start, int n, int M,
                            const float* __restrict__ init,
                            float* __restrict__ out) {
  const long long total = (long long)n * M;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int s = (int)(t / M);
    const int c = (int)(t % M);
    float acc = init ? init[t] : 0.f;
    long long k = start[s];
    const long long hi = start[s + 1];
    for (; k + 8 <= hi; k += 8) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = xs[(k + j) * M + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = __fadd_rn(acc, v[j]);
    }
    for (; k < hi; ++k) acc = __fadd_rn(acc, xs[k * M + c]);
    out[t] = acc;
  }
}

template <typename IdT>
int launch(const float* x, const IdT* ids, int N, int n, int M,
           const float* init, int tile, int* hist, int* rank, int* count,
           int* start, float* xs, float* out, cudaStream_t st) {
  const int tiles = (N + tile - 1) / tile;
  if (N > 0) {
    const size_t smem = sizeof(int) * (size_t)n;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          tile_rank_kernel<IdT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    tile_rank_kernel<IdT><<<tiles, 32, smem, st>>>(ids, N, n, tile, hist,
                                                   rank);
  }
  tile_offsets_kernel<<<grid_for(n), kThreads, 0, st>>>(hist, tiles, n,
                                                         count);
  segment_starts_kernel<<<1, 1024, 0, st>>>(count, n, start);
  if (N > 0)
    place_kernel<IdT><<<grid_for(N), kThreads, 0, st>>>(
        ids, x, N, n, M, tile, hist, rank, start, xs);
  walk_kernel<<<grid_for((long long)n * M), kThreads, 0, st>>>(
      xs, start, n, M, init, out);
  return (int)cudaGetLastError();
}

}  // namespace

// x f32[N, M], ids i32 or i64 [N] (ids64), init f32[n, M] or null, out
// f32[n, M].  Scratch: hist i32[ceil(N / tile) * n], rank i32[N], count
// i32[n], start i32[n + 1], xs f32[N * M].  tile a multiple of 32; n at
// most 57,344 (the tile's running counts live in shared memory).
extern "C" int cc_segment_sum(const float* x, const void* ids, int ids64,
                              int N, int n, int M, const float* init,
                              int tile, int* hist, int* rank, int* count,
                              int* start, float* xs, float* out,
                              void* stream) {
  if (n <= 0 || M <= 0) return 0;
  if (tile <= 0 || tile % 32 != 0 || n > 57344) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ids64)
    return launch(x, static_cast<const long long*>(ids), N, n, M, init, tile,
                  hist, rank, count, start, xs, out, st);
  return launch(x, static_cast<const int*>(ids), N, n, M, init, tile, hist,
                rank, count, start, xs, out, st);
}
