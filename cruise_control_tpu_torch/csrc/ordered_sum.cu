// K13 ordered_sum: float32 column sums of x[n, m] in XLA:CPU's order.
//
// Replaces the float `jnp.sum(..., axis=0)` of the reference's compiled
// programs: compute_stats (cruise_control_tpu/model/stats.py :67-75,
// :137-145), cluster_load / cluster_capacity (model/state.py :409-418),
// the leadership bounds (analyzer/leadership.py :418), the count goals'
// averages and rotation_salt's float mix.  XLA:CPU reduces a long axis in
// windows: while more than 32 terms remain, they are zero-padded to a
// multiple of 32, (w*32 - n)//2 zeros before the data and the rest after,
// and each window of 32 is added sequentially from +0.0; the last <= 32
// terms are added sequentially from +0.0, except a single term, which XLA
// copies (a -0.0 stays -0.0).  The plain version is ops.sum_f32_plain.
// A sum that starts from +0.0 is never -0.0, so adding a padding zero
// leaves it unchanged: the spread path's padding rows hold +0.0.
//
// Bound on this card: bytes (each input read once, each output written
// once); a column of n terms also takes about log32(n) dependent levels of
// 32 adds, which sets the time of a small plane.
//
// Design, one launch per call in both paths (the wrapper picks by shape):
//   column path (n <= 4,096, or more than 32,768 columns): a block per
//     column; its threads take the windows of a level, each adding its 32
//     terms with __fadd_rn, and meet at a barrier; the next level reads
//     the window sums from the wrapper's scratch; thread 0 adds the last
//     <= 32 terms.  The small planes of the stats are latency-bound, and
//     one short launch of a few blocks serves them best.
//   spread path (n > 4,096): a block per column would put a [600,000, 4]
//     plane on four SMs, each pulling every sector of the interleaved
//     plane through its L1.  Here a block takes one second-level window
//     (32 first-level windows, 1,024 rows) of up to 8 columns, so a
//     [600,000, 4] plane runs 586 blocks over the 132 SMs.  The block
//     stages its rows in shared memory with coalesced loads (the rows are
//     contiguous in x), adds the 32 first-level windows (a thread per
//     window and column, from a bank-conflict-free layout) and then the
//     second-level window, and writes that sum to the scratch.  The upper
//     levels (586 terms a column at 600,000 rows) finish in the same
//     launch: the last block of each column tile to finish, counted by an
//     atomic counter that this block resets to 0 (so the next launch and a
//     CUDA-graph replay start from 0), folds them.  One launch rather than
//     a small second one: no second launch gap on the card and no second
//     launch on the host, whose time the solve pays.  The counters come
//     in sets, and the wrapper gives each (device, stream) its own set
//     (`slot`), so launches on two streams never share a counter; the
//     launches of one stream run in order, and a graph's replays run in
//     order too.

#include <cuda_runtime.h>

namespace {

constexpr int kTileCols = 8;             // spread path: columns a block
constexpr int kSpreadThreads = 256;
constexpr int kMaxColumnTiles = 4096;    // spread path: counters a set
constexpr int kCounterSlots = 72;        // spread path: counter sets

__device__ unsigned int g_tile_done[kCounterSlots * kMaxColumnTiles];

// Window i of one level: the terms src[r * stride], r in
// [i*32 - lo, i*32 - lo + 32) and inside [0, len), added in order from
// +0.0.
__device__ __forceinline__ float window_sum(const float* src, long long stride,
                                            int len, int i, int lo) {
  float acc = 0.f;
  const int r0 = i * 32 - lo;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int r = r0 + j;
    const float v = (r >= 0 && r < len) ? src[r * stride] : 0.f;
    acc = __fadd_rn(acc, v);
  }
  return acc;
}

__device__ __forceinline__ float window_sum_cg(const float* src, int len,
                                               int i, int lo) {
  float acc = 0.f;
  const int r0 = i * 32 - lo;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int r = r0 + j;
    const float v = (r >= 0 && r < len) ? __ldcg(src + r) : 0.f;
    acc = __fadd_rn(acc, v);
  }
  return acc;
}

// A block per column; the window sums of each level go to the column's
// scratch.
__global__ void column_kernel(const float* __restrict__ x, int n, int m,
                              float* __restrict__ scratch,
                              long long scratch_per_col,
                              float* __restrict__ out) {
  const int col = blockIdx.x;
  float* sc = scratch + scratch_per_col * col;
  const float* src = x + col;
  long long stride = m;
  int len = n;
  while (len > 32) {
    const int w = (len + 31) / 32;
    const int lo = (w * 32 - len) / 2;
    for (int i = threadIdx.x; i < w; i += blockDim.x)
      sc[i] = window_sum(src, stride, len, i, lo);
    __syncthreads();
    src = sc;
    stride = 1;
    sc += w;
    len = w;
  }
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int j = 0; j < len; ++j) acc = __fadd_rn(acc, src[j * stride]);
    out[col] = len == 1 ? src[0] : acc;
  }
}

// grid (second-level windows w1, column tiles).  Column c's scratch holds
// its w1 second-level sums, then the sums of each level above.
__global__ void __launch_bounds__(kSpreadThreads)
    spread_kernel(const float* __restrict__ x, int n, int m,
                  float* __restrict__ scratch, long long scratch_per_col,
                  int slot, float* __restrict__ out) {
  // window k of the block at k * 33 * tm: the stride is tm (mod 32), so
  // the threads (k, c), t = k * tm + c, read 32 distinct banks
  __shared__ float rows[32 * 33 * kTileCols];
  __shared__ float first[32 * kTileCols];
  __shared__ int last;
  const int t = threadIdx.x;
  const int w0 = (n + 31) / 32;
  const int lo0 = (w0 * 32 - n) / 2;
  const int w1 = (w0 + 31) / 32;
  const int lo1 = (w1 * 32 - w0) / 2;
  const int sb = blockIdx.x;
  const int ct = blockIdx.y;
  const int c0 = ct * kTileCols;
  const int tm = min(kTileCols, m - c0);
  const int S = 33 * tm;
  // the block's 1,024 rows: first-level windows sb*32 - lo1 + k, k < 32
  const long long r0 = ((long long)sb * 32 - lo1) * 32 - lo0;
  const int elems = 1024 * tm;
#pragma unroll 8
  for (int e = t; e < elems; e += kSpreadThreads) {
    const int rr = e / tm;
    const int cc = e - rr * tm;
    const long long r = r0 + rr;
    float v = 0.f;
    if (r >= 0 && r < n) v = x[r * m + c0 + cc];
    rows[(rr >> 5) * S + (rr & 31) * tm + cc] = v;
  }
  __syncthreads();
  // first level: rows outside [0, n) hold +0.0, which leaves a sum from
  // +0.0 unchanged (the padding)
  if (t < 32 * tm) {
    const int k = t / tm;
    const int c = t - k * tm;
    const float* p = rows + k * S + c;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) acc = __fadd_rn(acc, p[j * tm]);
    first[k * tm + c] = acc;
  }
  __syncthreads();
  // second level: first-level windows outside [0, w0) are padding, and
  // their rows all lie outside [0, n), so their sums are +0.0
  if (t < tm) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 32; ++k) acc = __fadd_rn(acc, first[k * tm + t]);
    scratch[(long long)(c0 + t) * scratch_per_col + sb] = acc;
  }
  __threadfence();
  __syncthreads();
  if (t == 0) {
    unsigned int* counter = g_tile_done + slot * kMaxColumnTiles + ct;
    const unsigned int done = atomicAdd(counter, 1u);
    last = done == gridDim.x - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the levels above, for the tile's columns, in the scratch
  long long off = 0;
  int len = w1;
  while (len > 32) {
    const int w = (len + 31) / 32;
    const int lo = (w * 32 - len) / 2;
    for (int p = t; p < w * tm; p += kSpreadThreads) {
      const int c = p / w;
      const int i = p - c * w;
      float* col = scratch + (long long)(c0 + c) * scratch_per_col + off;
      col[len + i] = window_sum_cg(col, len, i, lo);
    }
    __syncthreads();
    off += len;
    len = w;
  }
  if (t < tm) {
    const float* col = scratch + (long long)(c0 + t) * scratch_per_col + off;
    float acc = 0.f;
    for (int j = 0; j < len; ++j) acc = __fadd_rn(acc, __ldcg(col + j));
    out[c0 + t] = acc;
  }
}

}  // namespace

// x f32[n, m] row-major, out f32[m].  spread 0: the column path, a block
// per column; 1: the spread path (n > 1,024 and at most 32,768 columns).
// scratch f32[m * scratch_per_col], where scratch_per_col is the sum of
// the window counts of every level with more than 32 terms (0, and
// scratch null, when n <= 32).  slot: the spread path's counter set, one
// for each stream that launches it (0 <= slot < 72).
extern "C" int cc_ordered_sum(const float* x, int n, int m, float* scratch,
                              long long scratch_per_col, int spread,
                              int slot, float* out, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (spread) {
    const int tiles = (m + kTileCols - 1) / kTileCols;
    if (n <= 1024 || tiles > kMaxColumnTiles || scratch == nullptr ||
        slot < 0 || slot >= kCounterSlots)
      return (int)cudaErrorInvalidValue;
    const int w1 = ((n + 31) / 32 + 31) / 32;
    spread_kernel<<<dim3(w1, tiles), kSpreadThreads, 0, st>>>(
        x, n, m, scratch, scratch_per_col, slot, out);
    return (int)cudaGetLastError();
  }
  const int windows = (n + 31) / 32;
  int threads = ((windows + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  if (scratch_per_col > 0 && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  column_kernel<<<m, threads, 0, st>>>(x, n, m, scratch, scratch_per_col,
                                       out);
  return (int)cudaGetLastError();
}
