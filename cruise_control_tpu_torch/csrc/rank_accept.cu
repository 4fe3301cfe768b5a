// K8 rank_accept: gain-ranked prefix acceptance per destination broker,
// with its lexsort and, where the caller asks, the pass commit.
//
// Replaces rank_accept and the segment_rank it calls
// (cruise_control_tpu/analyzer/kernels.py), lexsort included, and the
// commit that follows it in assign_destinations' multi-commit passes and
// leadership_round's run_tail: `taken_cnt.at[kept_d].add(1)` and
// `cum_d[t].at[kept_d].add(where(keep, w_c, 0))`.
//
// The sort.  seg = has ? dest : B.  The order is jnp.lexsort((arange,
// -gain, seg)): by segment, gain descending, index ascending.  Each
// candidate gets a unique 64-bit key (rank_key below; rank_key in
// analyzer/kernels.py is its plain mirror):
//   bits 48-63  seg (B <= 65,534, checked by the wrapper)
//   bits 16-47  the complemented order-preserving bits of the gain, with
//               -0.0 made +0.0 first (jnp.lexsort ties them)
//   bits  0-15  the candidate index (C <= 4096 here)
// so ascending keys are the lexsort order.  A caller may pass that order
// instead (`order`, int64[C]); then the kernel does not sort.
//
// The acceptance, in sorted position i with o = order[i]:
//   seg_s[i]  = seg[o];   segc = min(seg_s[i], B - 1)
//   start[i]  = the first sorted position of seg_s[i]'s segment (the
//               segments are contiguous, so a binary search over seg_s)
//   pos       = i - start[i]
//   ok        = seg_s < B && pos + taken[segc] < cap[segc]
//   first_free= pos == 0 && taken[segc] == 0
//   fits      = AND over the T terms of
//                 (cum[t][segc] + within_before) + w_s <= hr[t][segc],
//               w_s = seg_s < B ? d_w[t][o] : 0 over the whole sorted row,
//               cs = inclusive cumsum of w_s in XLA:CPU's order
//               (ops.cumsum_f32_plain: sequential within blocks of 16, the
//               zero-padded block totals scanned by the same rule
//               recursively, each
//               block's exclusive carry added to its sums), excl = cs - w_s,
//               within_before = excl - excl[start]
//   ok       &= first_free || fits
//   ok       &= no position of the segment before i failed (the prefix cut:
//               the first failing position is an integer atomicMin, exact
//               in any thread order)
//   out[o]    = ok && has[o]
//
// The commit (commit != 0).  A destination's accepted candidates are the
// prefix [start, first_bad) of its sorted run.  Each accepted candidate
// counts the prefix's candidates of lower index (its rank in candidate
// order) and writes its index at that rank; then one thread per
// (destination, term) adds the prefix's weights in that order, one
// __fadd_rn at a time, onto the old cumulant -- the sequential scatter
// XLA:CPU runs, so the bits equal ops.scatter_add_seq's -- and one thread
// per destination adds the prefix's length to taken.  The fits test has
// read cum and taken before: they are updated in place afterwards.
//
// Every float operation is a single rounding (__fadd_rn / __fsub_rn), so
// nvcc can neither reassociate nor contract them, and the scan runs over
// the whole C-long row, invalid tail included: the block boundaries set
// the rounding.
//
// Design.  C <= 4096 (every call of the 200-broker paths): one launch of
// one block of 1024 threads does the key build, the sort, the acceptance
// and the commit, everything in shared memory (about 118 KB at C = 4096).
// Only the candidates with a destination are sorted (a pass after the
// first has few).  The sort is bitonic; its strides below 32 stay inside
// a warp and run on registers with __shfl_xor_sync, so a 4,096-key sort
// takes 40 barrier stages instead of 78.  Larger C (the capacity goals'
// full-width fallback, the rack goal's table branch at 2,600 brokers: C =
// 4 B): the caller's torch lexsort gives the order, then the same steps
// run as separate launches over global scratch -- a gather, one launch per
// scan level up and down, a fits pass with the atomicMin and the output
// pass; the commit follows as one launch (commit_walk_kernel): a block per
// range of destinations walks the accepted flags in candidate order, a
// tile at a time, and each destination's lane adds its weights in that
// order (a destination's prefix can be as long as its table room there,
// too long to order by counting).
//
// Bound: bytes.  Per candidate the destination, gain, flag and T weights
// in and the flag out, per broker the counts and 2 T floats in and, with
// the commit, the count and T floats out: about 30 KB at C = 2048, T = 3,
// B = 200 -- far below one launch.  The kernel's value is taking the
// sort's, the acceptance's and the commit's launches and host syncs off
// the host.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 1024;
constexpr int kSmallMax = 4096;
constexpr int kMaxLevels = 8;

constexpr uint8_t kCapOk = 1;     // valid segment, arrival under cap
constexpr uint8_t kFirstFree = 2;
constexpr uint8_t kFits = 4;

constexpr int kCommitThreads = 512;  // destinations per commit block
constexpr int kCommitPer = 2;        // its candidates per thread and tile
constexpr int kCommitTerms = 8;      // terms per walk of the commit

__device__ __forceinline__ int ceil16(int n) { return (n + 15) >> 4; }

__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// K8's sort key (see the header); -0.0 is made +0.0 first
__device__ __forceinline__ u64 rank_key(int seg, float gain, int i) {
  const float g = gain == 0.0f ? 0.0f : gain;
  return ((u64)(uint32_t)seg << 48) | ((u64)(~order_bits(g)) << 16) |
         (u64)(uint32_t)i;
}

// Ascending bitonic sort of s[0, n2) (n2 a power of two >= 32) by the
// whole block.  Strides >= 32 exchange through shared memory, one barrier
// each; the strides below 32 of each merge run in registers with shuffles
// (n2 and the block are multiples of 32, so every warp runs its loop
// whole).
__device__ void block_sort(u64* s, int n2) {
  const int tid = threadIdx.x;
  for (int size = 2; size <= n2; size <<= 1) {
    int stride = size >> 1;
    for (; stride >= 32; stride >>= 1) {
      // one thread per compare-exchange pair (e, e + stride)
      for (int q = tid; q < (n2 >> 1); q += blockDim.x) {
        const int e = ((q & ~(stride - 1)) << 1) | (q & (stride - 1));
        const int p = e + stride;
        const u64 a = s[e];
        const u64 b = s[p];
        const bool asc = (e & size) == 0;
        if (asc ? (a > b) : (a < b)) {
          s[e] = b;
          s[p] = a;
        }
      }
      __syncthreads();
    }
    for (int e = tid; e < n2; e += blockDim.x) {
      u64 v = s[e];
      const bool asc = (e & size) == 0;
      for (int st = stride; st > 0; st >>= 1) {
        const u64 o = __shfl_xor_sync(0xffffffffu, v, st);
        // the lower position of a pair keeps the min when ascending
        const bool keep_min = ((e & st) == 0) == asc;
        v = keep_min ? (o < v ? o : v) : (o > v ? o : v);
      }
      s[e] = v;
    }
    __syncthreads();
  }
}

// lower_bound of seg_s[i] in seg_s[0, i]
__device__ __forceinline__ int segment_start(const int* seg_s, int i) {
  const int s = seg_s[i];
  int lo = 0, hi = i;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg_s[mid] < s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One 16-block of a scan level: sequential sums of in[16 b ..] into
// out[16 b ..] (in place allowed), zero padding past n, and the block's
// total (pads included) into tot[b] when tot is given.
__device__ __forceinline__ void scan_block16(const float* in, float* out,
                                             float* tot, int n, int b) {
  const int base = b << 4;
  float acc = in[base];
  out[base] = acc;
  for (int j = 1; j < 16; ++j) {
    const int idx = base + j;
    if (idx < n) {
      acc = __fadd_rn(acc, in[idx]);
      out[idx] = acc;
    } else {
      acc = __fadd_rn(acc, 0.0f);
    }
  }
  if (tot != nullptr) tot[b] = acc;
}

// The top level (n <= 16): plainly sequential, in place.
__device__ __forceinline__ void scan_top(float* y, int n) {
  for (int j = 1; j < n; ++j) y[j] = __fadd_rn(y[j - 1], y[j]);
}

// The commit's ordering step for the accepted candidate at sorted position
// i (segment start s0, first failing position bad): its rank by candidate
// index inside the accepted prefix [s0, min(bad, segment end)), where its
// index goes in buf.
__device__ __forceinline__ void place_in_index_order(
    const int* ord_s, const int* seg_s, int C, int i, int s0, int bad,
    int* buf) {
  const int seg = seg_s[i];
  const int o = ord_s[i];
  const int lim = min(bad, C);
  int rank = 0;
  for (int j = s0; j < lim && seg_s[j] == seg; ++j) rank += ord_s[j] < o;
  buf[s0 + rank] = o;
}

// The commit of the segment that starts at sorted position i, when it has
// an accepted prefix: the prefix's length onto taken, and for each term
// its weights in candidate order (buf) onto cum[t], eight loads in flight
// ahead of the ordered adds.
__device__ __forceinline__ void commit_segment(
    int i, int C, int B, int T, const int* seg_s, const int* start,
    const int* first_bad, const int* buf, const float* __restrict__ dw,
    int* taken, float* cum) {
  const int seg = seg_s[i];
  if (seg >= B || start[i] != i || first_bad[i] <= i) return;
  const int lim = min(first_bad[i], C);
  int end = i + 1;
  while (end < lim && seg_s[end] == seg) ++end;
  taken[seg] += end - i;
  for (int t = 0; t < T; ++t) {
    const float* w = dw + (size_t)t * C;
    float acc = cum[(size_t)t * B + seg];
    for (int j = i; j < end; j += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = j + u < end ? w[buf[j + u]] : 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (j + u < end) acc = __fadd_rn(acc, v[u]);
      }
    }
    cum[(size_t)t * B + seg] = acc;
  }
}

// ---------------------------------------------------------------------------
// C <= 4096: one block
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int sort_width(int C) {
  int n2 = 32;
  while (n2 < C) n2 <<= 1;
  return n2;
}

__global__ void __launch_bounds__(kThreads)
rank_accept_small(int C, int B, int T, const int64_t* __restrict__ order,
                  const int* __restrict__ dest,
                  const float* __restrict__ gain,
                  const uint8_t* __restrict__ has, int* taken,
                  const int* __restrict__ cap, float* cum,
                  const float* __restrict__ dw,
                  const float* __restrict__ hr, bool commit,
                  uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);
  int* buf = reinterpret_cast<int*>(smem);     // the keys' room, reused
  int* ord_s = reinterpret_cast<int*>(keys + sort_width(C));
  int* seg_s = ord_s + C;
  int* start = seg_s + C;
  float* ws = reinterpret_cast<float*>(start + C);
  float* cs = ws + C;                 // level 0's sums, then the levels'
  int* first_bad = reinterpret_cast<int*>(cs);  // after the scans
  uint8_t* flag = reinterpret_cast<uint8_t*>(cs + C + C / 8 + 64);
  const int tid = threadIdx.x;

  if (order == nullptr) {
    // Only the candidates with a destination are sorted; the others
    // (segment B) fill the positions after them in any order: their flags
    // are 0 and their weights 0, so neither the acceptance nor the scan's
    // rounding depends on that order.  Warp-aggregated appends.
    __shared__ int n_valid, n_invalid;
    if (tid == 0) {
      n_valid = 0;
      n_invalid = 0;
    }
    __syncthreads();
    const int lane = tid & 31;
    const unsigned below = (1u << lane) - 1u;
    for (int i0 = 0; i0 < C; i0 += kThreads) {
      const int i = i0 + tid;
      const bool in = i < C;
      const bool valid = in && has[i];
      const unsigned vb = __ballot_sync(0xffffffffu, valid);
      const unsigned ib = __ballot_sync(0xffffffffu, in && !valid);
      int vbase = 0, ibase = 0;
      if (lane == 0) {
        if (vb) vbase = atomicAdd(&n_valid, __popc(vb));
        if (ib) ibase = atomicAdd(&n_invalid, __popc(ib));
      }
      vbase = __shfl_sync(0xffffffffu, vbase, 0);
      ibase = __shfl_sync(0xffffffffu, ibase, 0);
      if (valid) {
        keys[vbase + __popc(vb & below)] = rank_key(dest[i], gain[i], i);
      } else if (in) {
        const int q = C - 1 - (ibase + __popc(ib & below));
        ord_s[q] = i;
        seg_s[q] = B;
      }
    }
    __syncthreads();
    const int nv = n_valid;
    const int n2v = sort_width(nv);
    // padding keys of all ones sort last: no real segment is 0xFFFF
    for (int i = nv + tid; i < n2v; i += kThreads) keys[i] = ~0ull;
    __syncthreads();
    block_sort(keys, n2v);
    for (int i = tid; i < nv; i += kThreads) {
      const u64 k = keys[i];
      ord_s[i] = (int)(k & 0xFFFFull);
      seg_s[i] = (int)(k >> 48);
    }
  } else {
    for (int i = tid; i < C; i += kThreads) {
      const int o = (int)order[i];
      ord_s[i] = o;
      seg_s[i] = has[o] ? dest[o] : B;
    }
  }
  __syncthreads();
  for (int i = tid; i < C; i += kThreads) {
    const int s0 = segment_start(seg_s, i);
    start[i] = s0;
    const int seg = seg_s[i];
    const int segc = min(seg, B - 1);
    const int pos = i - s0;
    const int tk = taken[segc];
    uint8_t f = kFits;
    if (seg < B && pos + tk < cap[segc]) f |= kCapOk;
    if (pos == 0 && tk == 0) f |= kFirstFree;
    flag[i] = f;
  }

  // level sizes and offsets inside cs: level 0 is cs[0, C)
  int n_lv[kMaxLevels];
  int off[kMaxLevels];
  int levels = 1;
  n_lv[0] = C;
  off[0] = 0;
  while (n_lv[levels - 1] > 16) {
    n_lv[levels] = ceil16(n_lv[levels - 1]);
    off[levels] = off[levels - 1] + n_lv[levels - 1];
    ++levels;
  }

  for (int t = 0; t < T; ++t) {
    __syncthreads();  // the previous term is done with ws / cs
    for (int i = tid; i < C; i += kThreads) {
      ws[i] = seg_s[i] < B ? dw[(size_t)t * C + ord_s[i]] : 0.0f;
    }
    __syncthreads();
    if (levels == 1) {
      if (tid == 0) {
        for (int j = 0; j < C; ++j) cs[j] = ws[j];
        scan_top(cs, C);
      }
    } else {
      // up: level l's blocks, totals into level l + 1
      for (int l = 0; l + 1 < levels; ++l) {
        const float* in = l == 0 ? ws : cs + off[l];
        for (int b = tid; b < n_lv[l + 1]; b += kThreads) {
          scan_block16(in, cs + off[l], cs + off[l + 1], n_lv[l], b);
        }
        __syncthreads();
      }
      if (tid == 0) scan_top(cs + off[levels - 1], n_lv[levels - 1]);
      __syncthreads();
      // down: each block of level l adds level l + 1's exclusive carry
      for (int l = levels - 2; l >= 0; --l) {
        float* y = cs + off[l];
        const float* up = cs + off[l + 1];
        for (int i = tid; i < n_lv[l]; i += kThreads) {
          const int blk = i >> 4;
          y[i] = __fadd_rn(y[i], blk ? up[blk - 1] : 0.0f);
        }
        __syncthreads();
      }
    }
    __syncthreads();
    for (int i = tid; i < C; i += kThreads) {
      const int s0 = start[i];
      const int segc = min(seg_s[i], B - 1);
      const float excl = __fsub_rn(cs[i], ws[i]);
      const float base = __fsub_rn(cs[s0], ws[s0]);
      const float before = __fsub_rn(excl, base);
      const float lhs =
          __fadd_rn(__fadd_rn(cum[(size_t)t * B + segc], before), ws[i]);
      if (!(lhs <= hr[(size_t)t * B + segc])) flag[i] &= (uint8_t)~kFits;
    }
  }
  __syncthreads();

  // the prefix cut: first failing position per segment, by its start
  for (int i = tid; i < C; i += kThreads) first_bad[i] = INT_MAX;
  __syncthreads();
  for (int i = tid; i < C; i += kThreads) {
    const uint8_t f = flag[i];
    const bool ok = (f & kCapOk) && (f & (kFirstFree | kFits));
    if (seg_s[i] < B && !ok) atomicMin(&first_bad[start[i]], i);
  }
  __syncthreads();
  for (int i = tid; i < C; i += kThreads) {
    const uint8_t f = flag[i];
    const int s0 = start[i];
    const bool ok = (f & kCapOk) && (f & (kFirstFree | kFits)) &&
                    i < first_bad[s0];
    const int o = ord_s[i];
    const bool acc = ok && has[o];
    out[o] = acc ? 1 : 0;
    if (commit && acc) {
      place_in_index_order(ord_s, seg_s, C, i, s0, first_bad[s0], buf);
    }
  }
  if (!commit) return;
  __syncthreads();
  for (int i = tid; i < C; i += kThreads) {
    commit_segment(i, C, B, T, seg_s, start, first_bad, buf, dw, taken, cum);
  }
}

size_t small_smem_bytes(int C) {
  // the keys (8 bytes a sorted slot), ord_s, seg_s, start, ws (C each),
  // cs with its levels (< C + C / 8 + 64), the flags (C bytes)
  return (size_t)sort_width(C) * 8 + (size_t)C * 4 * 4 +
         ((size_t)C + C / 8 + 64) * 4 + (size_t)C;
}

// ---------------------------------------------------------------------------
// C > 4096: the same steps over global scratch, after the caller's sort
// ---------------------------------------------------------------------------

__global__ void gather_kernel(int C, int B, int T,
                              const int64_t* __restrict__ order,
                              const int* __restrict__ dest,
                              const uint8_t* __restrict__ has,
                              const float* __restrict__ dw,
                              int* __restrict__ ord_s,
                              int* __restrict__ seg_s,
                              int* __restrict__ first_bad,
                              float* __restrict__ ws) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int o = (int)order[i];
  const int seg = has[o] ? dest[o] : B;
  ord_s[i] = o;
  seg_s[i] = seg;
  first_bad[i] = INT_MAX;
  for (int t = 0; t < T; ++t) {
    ws[(size_t)t * C + i] = seg < B ? dw[(size_t)t * C + o] : 0.0f;
  }
}

// one scan level up: per term, the 16-blocks of `in` (stride in_stride)
// into `out` (stride L) and their totals into `tot` (stride L)
__global__ void scan_up_kernel(int T, int n, const float* __restrict__ in,
                               size_t in_stride, float* out, float* tot,
                               size_t L) {
  const int m = ceil16(n);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= T * m) return;
  const int t = g / m;
  const int b = g - t * m;
  scan_block16(in + t * in_stride, out + t * L, tot + t * L, n, b);
}

__global__ void scan_top_kernel(int T, float* y, size_t L, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < T) scan_top(y + t * L, n);
}

__global__ void scan_down_kernel(int T, int n, float* y, const float* up,
                                 size_t L) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= T * n) return;
  const int t = g / n;
  const int i = g - t * n;
  const int blk = i >> 4;
  float* yt = y + t * L;
  yt[i] = __fadd_rn(yt[i], blk ? up[t * L + blk - 1] : 0.0f);
}

__global__ void fits_kernel(int C, int B, int T, const int* __restrict__ seg_s,
                            const int* __restrict__ taken,
                            const int* __restrict__ cap,
                            const float* __restrict__ cum,
                            const float* __restrict__ hr,
                            const float* __restrict__ ws,
                            const float* __restrict__ cs, size_t L,
                            int* __restrict__ start_out,
                            int* __restrict__ first_bad,
                            uint8_t* __restrict__ ok_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int s0 = segment_start(seg_s, i);
  start_out[i] = s0;
  const int seg = seg_s[i];
  const int segc = min(seg, B - 1);
  const int pos = i - s0;
  const int tk = taken[segc];
  const bool cap_ok = seg < B && pos + tk < cap[segc];
  const bool first_free = pos == 0 && tk == 0;
  bool fits = true;
  for (int t = 0; t < T; ++t) {
    const float* w = ws + (size_t)t * C;
    const float* c = cs + (size_t)t * L;
    const float excl = __fsub_rn(c[i], w[i]);
    const float base = __fsub_rn(c[s0], w[s0]);
    const float before = __fsub_rn(excl, base);
    const float lhs =
        __fadd_rn(__fadd_rn(cum[(size_t)t * B + segc], before), w[i]);
    fits = fits && (lhs <= hr[(size_t)t * B + segc]);
  }
  const bool ok = cap_ok && (first_free || fits);
  ok_out[i] = ok ? 1 : 0;
  if (seg < B && !ok) atomicMin(&first_bad[s0], i);
}

__global__ void output_kernel(int C, const int* __restrict__ ord_s,
                              const uint8_t* __restrict__ has,
                              const int* __restrict__ start,
                              const int* __restrict__ first_bad,
                              const uint8_t* __restrict__ ok,
                              uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int o = ord_s[i];
  out[o] = (ok[i] && i < first_bad[start[i]] && has[o]) ? 1 : 0;
}

// The commit after the large path.  Block b owns destinations [b * 512,
// b * 512 + 512), warp w of it the 32 from b * 512 + 32 w, one lane each.
// The block walks the candidates in index order, a tile of 1024 at a time
// (two consecutive ones a thread, their flags, destinations and weights
// loaded a tile ahead): the tile's candidates accepted at one of its
// destinations are compacted in order, with their weights, into shared
// memory (a block-wide exclusive scan of the threads' counts).  Each warp
// then reads that list 32 entries at a time and takes the entries that
// are its own in list order, the owning lane adding the weights onto its
// cumulants in registers, one __fadd_rn at a time -- candidate order, as
// the sequential scatter.  Terms go kCommitTerms at a time (the walk
// repeats for more).
__global__ void __launch_bounds__(kCommitThreads)
commit_walk_kernel(int C, int B, int T, const int* __restrict__ dest,
                   const uint8_t* __restrict__ out,
                   const float* __restrict__ dw, int* taken, float* cum) {
  constexpr int kWarps = kCommitThreads / 32;
  constexpr int kTile = kCommitThreads * kCommitPer;
  __shared__ int list_d[kTile];
  __shared__ float list_w[kCommitTerms][kTile];
  __shared__ int warp_base[kWarps];
  __shared__ int tile_total;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d0 = blockIdx.x * kCommitThreads;
  const int d = d0 + tid;
  for (int t0 = 0; t0 < (T > 0 ? T : 1); t0 += kCommitTerms) {
    const int nt = min(T - t0, kCommitTerms);  // 0 when T == 0
    float acc[kCommitTerms];
#pragma unroll
    for (int t = 0; t < kCommitTerms; ++t) {
      acc[t] = t < nt && d < B ? cum[(size_t)(t0 + t) * B + d] : 0.0f;
    }
    // candidate i's kept destination (-1 where it was not accepted) and
    // weights, loaded without waiting on each other
    int nk[kCommitPer];
    float nw[kCommitPer][kCommitTerms];
    auto load = [&](int base) {
#pragma unroll
      for (int u = 0; u < kCommitPer; ++u) {
        const int i = base + kCommitPer * tid + u;
        const bool in = i < C;
        const int di = in ? dest[i] : -1;
        nk[u] = in && out[i] ? di : -1;
#pragma unroll
        for (int t = 0; t < kCommitTerms; ++t) {
          nw[u][t] = in && t < nt ? dw[(size_t)(t0 + t) * C + i] : 0.0f;
        }
      }
    };
    load(0);
    int n = 0;
    for (int base = 0; base < C; base += kTile) {
      int kd[kCommitPer];
      float w[kCommitPer][kCommitTerms];
      int cnt = 0;
#pragma unroll
      for (int u = 0; u < kCommitPer; ++u) {
        kd[u] = nk[u] >= d0 && nk[u] < d0 + kCommitThreads ? nk[u] : -1;
        cnt += kd[u] >= 0;
#pragma unroll
        for (int t = 0; t < kCommitTerms; ++t) w[u][t] = nw[u][t];
      }
      load(base + kTile);
      // exclusive scan of the counts in thread order: warps, then warp sums
      int incl = cnt;
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      if (lane == 31) warp_base[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        const int v = lane < kWarps ? warp_base[lane] : 0;
        int sum = v;
        for (int off = 1; off < 32; off <<= 1) {
          const int x = __shfl_up_sync(0xffffffffu, sum, off);
          if (lane >= off) sum += x;
        }
        if (lane < kWarps) warp_base[lane] = sum - v;
        if (lane == 31) tile_total = sum;
      }
      __syncthreads();
      int q = warp_base[warp] + incl - cnt;
#pragma unroll
      for (int u = 0; u < kCommitPer; ++u) {
        if (kd[u] >= 0) {
          list_d[q] = kd[u];
#pragma unroll
          for (int t = 0; t < kCommitTerms; ++t) {
            if (t < nt) list_w[t][q] = w[u][t];
          }
          ++q;
        }
      }
      __syncthreads();
      const int m = tile_total;
      for (int j = 0; j < m; j += 32) {
        const int e = j + lane < m ? list_d[j + lane] : -1;
        const bool own = e >= 0 && ((e - d0) >> 5) == warp;
        unsigned bal = __ballot_sync(0xffffffffu, own);
        if (bal == 0) continue;
        float wv[kCommitTerms];
#pragma unroll
        for (int t = 0; t < kCommitTerms; ++t) {
          wv[t] = own && t < nt ? list_w[t][j + lane] : 0.0f;
        }
        while (bal != 0) {
          const int b = __ffs(bal) - 1;
          bal &= bal - 1;
          const bool mine = __shfl_sync(0xffffffffu, e, b) == d;
          n += mine;
#pragma unroll
          for (int t = 0; t < kCommitTerms; ++t) {
            if (t >= nt) break;  // nt is the same in every lane
            const float v = __shfl_sync(0xffffffffu, wv[t], b);
            if (mine) acc[t] = __fadd_rn(acc[t], v);
          }
        }
      }
      __syncthreads();  // the tile's list is read before the next overwrites
    }
    if (d >= B) continue;
#pragma unroll
    for (int t = 0; t < kCommitTerms; ++t) {
      if (t < nt) cum[(size_t)(t0 + t) * B + d] = acc[t];
    }
    if (t0 == 0 && n > 0) taken[d] += n;
  }
}

inline int grid(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

// Opt rank_accept_small in to its widest shared memory, once per device
// (a launch above the default 48 KB needs it).
bool g_smem_set[16];

int small_smem_opt_in() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 16 && g_smem_set[dev]) return 0;
  e = cudaFuncSetAttribute(rank_accept_small,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)small_smem_bytes(kSmallMax));
  if (e != cudaSuccess) return (int)e;
  if (dev < 16) g_smem_set[dev] = true;
  return 0;
}

}  // namespace

// Scratch floats the large path needs per term: the level-0 sums and every
// level's totals.
extern "C" long long cc_rank_accept_level_floats(int C) {
  long long total = C;
  long long n = C;
  while (n > 16) {
    n = (n + 15) / 16;
    total += n;
  }
  return total;
}

// dest i32[C], gain f32[C], has u8[C], taken / cap i32[B], cum / hr
// f32[T, B], dw f32[T, C] in candidate order; out u8[C].  `order` (i64[C],
// the lexsort order) may be null for C <= 4096: the kernel sorts then.
// With commit != 0, taken and cum are updated in place (above C = 4096 by
// one more launch, commit_walk_kernel).  The large path (C > 4096, order
// required) needs scratch: ints i32[4 C] (sorted
// candidates, segments, starts, first failing positions), ok u8[C], ws
// f32[T C], cs f32[T L] with L = cc_rank_accept_level_floats(C); the small
// path ignores it.  C * (T + 1) must stay below 2**31.
extern "C" int cc_rank_accept(int C, int B, int T, const int64_t* order,
                              const int* dest, const float* gain,
                              const uint8_t* has, int* taken, const int* cap,
                              float* cum, const float* dw, const float* hr,
                              int commit, int* scratch_i,
                              uint8_t* scratch_ok, float* scratch_ws,
                              float* scratch_cs, uint8_t* out,
                              void* stream) {
  if (C <= 0) return 0;
  if (B < 1 || B > 65534) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= kSmallMax) {
    const size_t bytes = small_smem_bytes(C);
    if (bytes > 48 * 1024) {
      const int e = small_smem_opt_in();
      if (e != 0) return e;
    }
    rank_accept_small<<<1, kThreads, bytes, st>>>(C, B, T, order, dest, gain,
                                                  has, taken, cap, cum, dw,
                                                  hr, commit != 0, out);
    return (int)cudaGetLastError();
  }
  if (order == nullptr) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const size_t L = (size_t)cc_rank_accept_level_floats(C);
  int* ord_s = scratch_i;
  int* seg_s = scratch_i + C;
  int* start = scratch_i + 2 * (size_t)C;
  int* first_bad = scratch_i + 3 * (size_t)C;
  gather_kernel<<<grid(C, threads), threads, 0, st>>>(
      C, B, T, order, dest, has, dw, ord_s, seg_s, first_bad, scratch_ws);
  if (T > 0) {
    int n_lv[kMaxLevels];
    size_t off[kMaxLevels];
    int levels = 1;
    n_lv[0] = C;
    off[0] = 0;
    while (n_lv[levels - 1] > 16) {
      if (levels == kMaxLevels) return (int)cudaErrorInvalidValue;
      n_lv[levels] = (n_lv[levels - 1] + 15) / 16;
      off[levels] = off[levels - 1] + n_lv[levels - 1];
      ++levels;
    }
    for (int l = 0; l + 1 < levels; ++l) {
      const float* in = l == 0 ? scratch_ws : scratch_cs + off[l];
      const size_t in_stride = l == 0 ? (size_t)C : L;
      scan_up_kernel<<<grid((long long)T * n_lv[l + 1], threads), threads, 0,
                       st>>>(T, n_lv[l], in, in_stride, scratch_cs + off[l],
                             scratch_cs + off[l + 1], L);
    }
    scan_top_kernel<<<grid(T, 32), 32, 0, st>>>(
        T, scratch_cs + off[levels - 1], L, n_lv[levels - 1]);
    for (int l = levels - 2; l >= 0; --l) {
      scan_down_kernel<<<grid((long long)T * n_lv[l], threads), threads, 0,
                         st>>>(T, n_lv[l], scratch_cs + off[l],
                               scratch_cs + off[l + 1], L);
    }
  }
  fits_kernel<<<grid(C, threads), threads, 0, st>>>(
      C, B, T, seg_s, taken, cap, cum, hr, scratch_ws, scratch_cs, L, start,
      first_bad, scratch_ok);
  output_kernel<<<grid(C, threads), threads, 0, st>>>(
      C, ord_s, has, start, first_bad, scratch_ok, out);
  if (commit) {
    commit_walk_kernel<<<grid(B, kCommitThreads), kCommitThreads, 0, st>>>(
        C, B, T, dest, out, dw, taken, cum);
  }
  return (int)cudaGetLastError();
}
