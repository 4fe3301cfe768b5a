// Shared by K6 (sweep_pick.cu) and K7 (forced_select.cu): jax.lax.top_k's
// selection of the k largest of a list of unique 64-bit keys inside a
// cooperative launch, k <= kMaxK.
//
// A key is a float's order-preserving bits (XLA's total order: -0.0 below
// +0.0, -inf lowest) in the high word over the complemented element index
// in the low word, so keys are unique and keys descending are exactly
// top_k's order: score descending, ties to the lower index.  Only the
// elements whose score is above -inf enter the list ("listed"); when k or
// fewer are listed, the list is the selection and the tail is the k - n
// lowest-index unlisted elements, all inside [0, k).
//
// The launch's phases, each followed by a grid barrier (the caller's):
//   * append (select_append, every warp whole): each listed key into the
//     list (warp-aggregated atomics on the list's length) and its first
//     8-bit digit into the first histogram (shared-memory counts folded
//     into global ones, select_flush);
//   * when more than k keys are listed, a radix select of the k-th
//     largest key, one 8-bit digit a phase (select_pass, q = 1..7): every
//     block derives the previous digit from its global histogram by the
//     same suffix scan in its own shared memory (so no block waits on
//     another's choice), then counts the next digit of the keys that
//     match the prefix.  It stops as soon as the keys matching the prefix
//     are exactly the rank left: then every key >= the prefix is
//     selected.  All blocks see the same counts, so they skip the same
//     phases and barriers;
//   * the compaction of the k selected keys (select_compact, only after a
//     select);
//   * the order (select_order): each of a few blocks loads the <= kMaxK
//     selected keys into shared memory and emits each key at its rank,
//     the count of larger keys (exact: the keys are unique), kGroup
//     threads to a key; then every block emits its stretch of the tail
//     (select_tail) by block-wide counts over [0, k).
// Integer atomics only: the result is independent of thread order.
//
// Everything here has internal linkage (each source that includes it
// keeps its own copy).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tks {
namespace {

typedef unsigned long long u64;

constexpr int kMaxK = 4096;
constexpr int kPasses = 8;
constexpr int kGroup = 8;  // threads per key in the order phase
// digit counts, then two counters: the list's length, the compaction
// cursor
constexpr int kHistWords = kPasses * 256 + 2;

struct Select {
  u64 prefix;   // digits chosen so far
  u64 mask;     // the bits they cover
  int k_rem;    // rank of the k-th key among the keys matching prefix
  int derived;  // digits derived
  int done;     // the keys >= prefix are exactly the k largest
};

__device__ __forceinline__ void select_init(Select& st, int k) {
  st.prefix = 0;
  st.mask = 0;
  st.k_rem = k;
  st.derived = 0;
  st.done = 0;
}

// XLA's total order on float32 as unsigned integers: -0.0 below +0.0
__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 select_key(float score, int i) {
  return ((u64)order_bits(score) << 32) | (u64)(~(uint32_t)i);
}

__device__ __forceinline__ int select_index(u64 key) {
  return (int)(~(uint32_t)(key & 0xFFFFFFFFull));
}

__device__ __forceinline__ int* select_counters(int* hist) {
  return hist + kPasses * 256;
}

__device__ __forceinline__ int select_len(int* hist) {
  return __ldcg(select_counters(hist));
}

// block 0 zeroes the histograms and counters
__device__ __forceinline__ void select_zero(int* hist) {
  if (blockIdx.x != 0) return;
  for (int t = threadIdx.x; t < kHistWords; t += blockDim.x) hist[t] = 0;
}

// the shared-memory digit counts of this block into the global ones
__device__ __forceinline__ void select_flush(int* sh, int* global) {
  __syncthreads();
  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    if (sh[t] != 0) atomicAdd(&global[t], sh[t]);
  }
}

// Warp-aggregated append of the listed keys (every lane of the warp
// calls it), each counted into the block's first-digit counts `sh`.
__device__ __forceinline__ void select_append(bool ok, u64 key, u64* list,
                                              int* hist, int* sh) {
  const int lane = threadIdx.x & 31;
  const unsigned ballot = __ballot_sync(0xffffffffu, ok);
  if (ballot == 0) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(select_counters(hist), __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (ok) {
    list[base + __popc(ballot & ((1u << lane) - 1u))] = key;
    atomicAdd(&sh[(int)(key >> 56)], 1);
  }
}

// Derive digit st.derived from its global histogram: every block runs the
// same suffix scan in its own shared memory, so every block makes the same
// choice.  (A one-warp scan of eight bins a lane measured slower on the
// card.)
__device__ void select_derive_next(int* hist, Select& st) {
  __shared__ int suf[257];
  const int d = st.derived;
  const int shift = 56 - 8 * d;
  const int t = threadIdx.x;
  if (t < 256) suf[t] = __ldcg(hist + d * 256 + t);
  if (t == 0) suf[256] = 0;
  __syncthreads();
  for (int off = 1; off < 256; off <<= 1) {
    const int v = (t < 256 && t + off < 256) ? suf[t + off] : 0;
    __syncthreads();
    if (t < 256) suf[t] += v;
    __syncthreads();
  }
  const int k_rem = st.k_rem;
  __syncthreads();
  if (t < 256) {
    const int above = suf[t + 1];
    if (suf[t] >= k_rem && above < k_rem) {
      st.prefix |= (u64)t << shift;
      st.mask |= (u64)0xFFu << shift;
      st.k_rem = k_rem - above;
      st.done = (suf[t] - above == k_rem - above) ? 1 : 0;
      st.derived = d + 1;
    }
  }
  __syncthreads();
}

__device__ void select_derive_through(int* hist, Select& st, int digits) {
  while (!st.done && st.derived < digits) select_derive_next(hist, st);
}

// Histogram pass q (1..7) over the listed keys that match the prefix;
// false (uniformly) when no select is needed or it is done.
__device__ bool select_pass(const u64* list, int* hist, int k, int q,
                            Select& st, int* sh) {
  const int n = select_len(hist);
  if (n <= k) return false;
  select_derive_through(hist, st, q);
  if (st.done) return false;
  for (int t = threadIdx.x; t < 256; t += blockDim.x) sh[t] = 0;
  __syncthreads();
  const int shift = 56 - 8 * q;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    const u64 key = __ldcg(list + j);
    if ((key & st.mask) == st.prefix) {
      atomicAdd(&sh[(int)((key >> shift) & 0xFFu)], 1);
    }
  }
  select_flush(sh, hist + q * 256);
  return true;
}

// The k selected keys into sel_keys (in no order); false (uniformly) when
// k or fewer keys are listed.
__device__ bool select_compact(const u64* list, int* hist, int k,
                               Select& st, u64* sel_keys) {
  const int n = select_len(hist);
  if (n <= k) return false;
  select_derive_through(hist, st, kPasses);
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    const u64 key = __ldcg(list + j);
    if (key >= st.prefix) {
      sel_keys[atomicAdd(select_counters(hist) + 1, 1)] = key;
    }
  }
  return true;
}

// The order: emit(rank, key) for each of the min(n, k) selected keys, in
// the first blocks; `keys` is a shared array of kMaxK.  Returns true when
// a select ran (so there is no tail).
template <class Emit>
__device__ bool select_order(const u64* list, int* hist, const u64* sel_keys,
                             int k, u64* keys, Emit& emit) {
  const int n = select_len(hist);
  const bool selected = n > k;
  const int s = selected ? k : n;
  const u64* src = selected ? sel_keys : list;
  const int per_block = blockDim.x / kGroup;
  if (blockIdx.x * per_block < s) {
    for (int j = threadIdx.x; j < s; j += blockDim.x) {
      keys[j] = __ldcg(src + j);
    }
    __syncthreads();
    const int sub = threadIdx.x % kGroup;
    for (int g0 = blockIdx.x * per_block; g0 < s;
         g0 += gridDim.x * per_block) {
      const int g = g0 + threadIdx.x / kGroup;
      // a group's kGroup lanes sit in one warp; every lane of the warp
      // takes part in the shuffles
      const u64 key = g < s ? keys[g] : 0ull;
      int rank = 0;
      if (g < s) {
        for (int j = sub; j < s; j += kGroup) rank += keys[j] > key;
      }
      for (int off = kGroup / 2; off > 0; off >>= 1) {
        rank += __shfl_xor_sync(0xffffffffu, rank, off, kGroup);
      }
      if (g < s && sub == 0) emit(rank, key);
    }
  }
  return selected;
}

// block-wide sum of v; every thread of the block calls it, and gets the
// sum.  `tmp` holds 33 ints.
__device__ __forceinline__ int select_block_sum(int v, int* tmp) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  __syncthreads();
  if (lane == 0) tmp[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    int w = threadIdx.x < (int)(blockDim.x >> 5) ? tmp[threadIdx.x] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      w += __shfl_xor_sync(0xffffffffu, w, off);
    }
    if (threadIdx.x == 0) tmp[32] = w;
  }
  __syncthreads();
  return tmp[32];
}

// block-wide exclusive prefix count of `flag`, and the block's total in
// *total; every thread of the block calls it.  `tmp` holds 33 ints.
__device__ __forceinline__ int select_block_prefix(bool flag, int* tmp,
                                                   int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int below = __popc(ballot & ((1u << lane) - 1u));
  __syncthreads();
  if (lane == 0) tmp[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int v = lane < nw ? tmp[lane] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane < nw) tmp[lane] = incl - v;
    if (lane == 31) tmp[32] = incl;
  }
  __syncthreads();
  *total = tmp[32];
  return tmp[warp] + below;
}

// The tail, over every block: emit_tail(pos, i) for the k - n
// lowest-index elements i with !listed(i), pos = n, n + 1, ... in index
// order.  Block b takes a stretch of [0, k); it counts the unlisted
// elements before its stretch itself (at most k flags), then places its
// own by a block-wide prefix count.  `tmp` holds 33 ints; blockDim.x is a
// multiple of 32.
template <class Listed, class EmitTail>
__device__ void select_tail(int* hist, int k, int* tmp, Listed& listed,
                            EmitTail& emit_tail) {
  const int n = select_len(hist);
  if (n >= k) return;
  const int per = (k + gridDim.x - 1) / gridDim.x;
  const int lo = blockIdx.x * per;
  const int hi = min(lo + per, k);
  if (lo >= hi) return;
  int before = 0;
  for (int i = threadIdx.x; i < lo; i += blockDim.x) before += !listed(i);
  int base = n + select_block_sum(before, tmp);
  for (int i0 = lo; i0 < hi && base < k; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool un = i < hi && !listed(i);
    int total = 0;
    const int pos = base + select_block_prefix(un, tmp, &total);
    if (un && pos < k) emit_tail(pos, i);
    base += total;
  }
}

}  // namespace
}  // namespace tks
