// K7 forced_select: the candidate selection of a table-less forced-move
// round.
//
// Replaces the table-less branch of forced_move_round
// (cruise_control_tpu/analyzer/kernels.py, the `else` branch of the
// broker-table test) with the feasible_dest_exists guard it calls:
//
//   forced_ok[r] = forced[r] & (best[r] >= w[r]), where best[r] is the
//       largest top_h[j] over the top headroom brokers top_b[j] that hold
//       no replica of r's partition (-inf when every one does);
//   score[r]     = forced_ok[r] ? w[r] + 1 : -inf;
//   cand_r       = jax.lax.top_k(score, k) indices: score descending, ties
//       (the -inf tail included) to the lower replica index;
//   cand_has     = forced_ok[cand_r].
//
// With k == 0 only forced_ok is computed (the guard of the table branch's
// guarded_pick, whose top-k is then K1's): one plain launch of the guard
// phase.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel), two
// blocks of 512 threads on each SM, its phases separated by grid-wide
// barriers (cooperative_groups); no one-block stage.
//   0. init: block 0 zeroes the histograms and counters.
//   1. guard: a thread per replica computes forced_ok (the partition's
//      sibling brokers as a bit mask over the <= 32 top brokers) and, for
//      a guarded replica, a unique 64-bit key -- the score's
//      order-preserving bits (w + 1 rounded on its own, __fadd_rn) in the
//      high word, the complemented replica index in the low word, so keys
//      descending are exactly top_k's order -- appended to a list
//      (warp-aggregated atomics) and counted into the first digit's
//      histogram (shared-memory counts folded into global ones).  Only
//      guarded replicas enter the list: every other score is -inf.
//   2-8. when more than k replicas are guarded, a radix select of the k-th
//      largest key over the list, one 8-bit digit per phase: every block
//      derives the previous digit from its global histogram by the same
//      suffix scan in its own shared memory (so no block waits on
//      another's choice), then counts the next digit of the keys that
//      match the prefix.  It stops as soon as the keys matching the prefix
//      are exactly the rank left: then every key >= the prefix is
//      selected.  All blocks see the same counts, so they skip the same
//      phases and barriers.
//   9. compaction of the k selected keys (only after a select).
//  10. the order: each of a few blocks loads the <= 4096 selected keys
//      into shared memory and writes each key at its rank, the count of
//      larger keys (exact: the keys are unique), eight threads to a key.
//      When k or fewer replicas are guarded (the usual heal round: R =
//      60,000 at 0.5 % forced guards about 300), the list is the selection
//      and the tail is the k - n lowest-index unguarded replicas, all
//      inside [0, k): the last block finds them by one block-wide prefix
//      count.
// Integer atomics only: the result is independent of thread order.
//
// Bound: bytes.  Per replica the flags, weight, partition id, the sibling
// row and the siblings' brokers, plus k outputs: about 20 MB at R =
// 600,000, 6 us at the card's 3.35 TB/s; about 2 MB at R = 60,000.  The
// barriers, a few microseconds each, set the time at these sizes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxK = 4096;
constexpr int kPasses = 8;
constexpr int kGroup = 8;          // threads per key in the order phase
constexpr int kPhaseInit = 0;
constexpr int kPhaseGuard = 1;
constexpr int kPhaseCompact = 9;
constexpr int kPhaseOrder = 10;
constexpr int kPhases = 11;

typedef unsigned long long u64;

struct Args {
  int R, RF, nb_top, k;
  const uint8_t* forced;
  const float* w;
  const int* replica_partition;
  const int* replica_broker;
  const int* partition_replicas;
  const int* top_b;
  const float* top_h;
  uint8_t* forced_ok;
  u64* list;        // guarded keys, R slots
  int* hist;        // kPasses * 256 digit counts, then the counters
  u64* sel_keys;    // the k selected keys (after a select)
  int* cand_r;
  uint8_t* cand_has;
};

// counters after the histograms: the list's length, the compaction cursor
__device__ __forceinline__ int* counters(const Args& a) {
  return a.hist + kPasses * 256;
}

struct Select {
  u64 prefix;   // digits chosen so far
  u64 mask;     // the bits they cover
  int k_rem;    // rank of the k-th key among the keys matching prefix
  int derived;  // digits derived
  int done;     // the keys >= prefix are exactly the k largest
};

__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ int list_len(const Args& a) {
  return __ldcg(counters(a));
}

// the shared-memory digit counts of this block into the global ones
__device__ __forceinline__ void flush_hist(int* sh, int* global) {
  __syncthreads();
  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    if (sh[t] != 0) atomicAdd(&global[t], sh[t]);
  }
}

__device__ void phase_init(const Args& a) {
  if (blockIdx.x != 0) return;
  for (int t = threadIdx.x; t < kPasses * 256 + 2; t += blockDim.x) {
    a.hist[t] = 0;
  }
}

__device__ void phase_guard(const Args& a, int* sh) {
  const bool keys = a.k > 0;
  if (keys) {
    for (int t = threadIdx.x; t < 256; t += blockDim.x) sh[t] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  for (int i0 = blockIdx.x * blockDim.x; i0 < a.R;
       i0 += gridDim.x * blockDim.x) {
    const int i = i0 + threadIdx.x;
    bool ok = false;
    float wi = 0.0f;
    if (i < a.R && a.forced[i]) {
      wi = a.w[i];
      const int* sib =
          a.partition_replicas + (size_t)a.replica_partition[i] * a.RF;
      uint32_t blocked = 0;
      for (int q = 0; q < a.RF; ++q) {
        const int s = sib[q];
        if (s < 0) continue;
        const int sb = a.replica_broker[s];
        for (int j = 0; j < a.nb_top; ++j) {
          if (a.top_b[j] == sb) blocked |= 1u << j;
        }
      }
      float best = -INFINITY;
      for (int j = 0; j < a.nb_top; ++j) {
        if (!((blocked >> j) & 1u)) best = fmaxf(best, a.top_h[j]);
      }
      ok = best >= wi;
    }
    if (i < a.R) a.forced_ok[i] = ok ? 1 : 0;
    if (!keys) continue;
    // warp-aggregated append of the guarded keys
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    if (ballot == 0) continue;
    int base = 0;
    if (lane == 0) base = atomicAdd(counters(a), __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (ok) {
      const u64 key = ((u64)order_bits(__fadd_rn(wi, 1.0f)) << 32) |
                      (u64)(~(uint32_t)i);
      a.list[base + __popc(ballot & ((1u << lane) - 1u))] = key;
      atomicAdd(&sh[(int)(key >> 56)], 1);
    }
  }
  if (keys) flush_hist(sh, a.hist);
}

// Derive digit st.derived from its global histogram: every block runs the
// same suffix scan, so every block makes the same choice.
__device__ void derive_next(const Args& a, Select& st, int* suf) {
  const int d = st.derived;
  const int shift = 56 - 8 * d;
  const int t = threadIdx.x;
  if (t < 256) suf[t] = __ldcg(a.hist + d * 256 + t);
  if (t == 0) suf[256] = 0;
  __syncthreads();
  // inclusive suffix sums: suf[t] = number of keys with digit >= t
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

__device__ void derive_through(const Args& a, Select& st, int* suf,
                               int digits) {
  while (!st.done && st.derived < digits) derive_next(a, st, suf);
}

// histogram pass q (1..7) over the listed keys that match the prefix;
// false (uniformly) when no select is needed or it is done
__device__ bool phase_pass(const Args& a, int q, Select& st, int* sh,
                           int* suf) {
  const int n = list_len(a);
  if (n <= a.k) return false;
  derive_through(a, st, suf, q);
  if (st.done) return false;
  for (int t = threadIdx.x; t < 256; t += blockDim.x) sh[t] = 0;
  __syncthreads();
  const int shift = 56 - 8 * q;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    const u64 key = __ldcg(a.list + j);
    if ((key & st.mask) == st.prefix) {
      atomicAdd(&sh[(int)((key >> shift) & 0xFFu)], 1);
    }
  }
  flush_hist(sh, a.hist + q * 256);
  return true;
}

__device__ bool phase_compact(const Args& a, Select& st, int* suf) {
  const int n = list_len(a);
  if (n <= a.k) return false;
  derive_through(a, st, suf, kPasses);
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    const u64 key = __ldcg(a.list + j);
    if (key >= st.prefix) a.sel_keys[atomicAdd(counters(a) + 1, 1)] = key;
  }
  return true;
}

__device__ void phase_order(const Args& a, u64* keys, int* scan) {
  const int n = list_len(a);
  const bool selected = n > a.k;
  const int s = selected ? a.k : n;
  const u64* src = selected ? a.sel_keys : a.list;
  // ranks: kGroup threads to a key, in the first blocks
  const int per_block = kThreads / kGroup;
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
      if (g < s && sub == 0) {
        a.cand_r[rank] = (int)(~(uint32_t)(key & 0xFFFFFFFFull));
        a.cand_has[rank] = 1;
      }
    }
  }
  if (selected || blockIdx.x != gridDim.x - 1) return;
  // the tail: the k - n lowest-index unguarded replicas, all in [0, k)
  __syncthreads();
  const int m = a.k - n;
  if (m == 0) return;
  const int per = (a.k + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, a.k);
  int cnt = 0;
  for (int i = lo; i < hi; ++i) cnt += __ldcg(a.forced_ok + i) == 0;
  scan[threadIdx.x] = cnt;
  __syncthreads();
  for (int off = 1; off < (int)blockDim.x; off <<= 1) {
    const int v = threadIdx.x >= off ? scan[threadIdx.x - off] : 0;
    __syncthreads();
    scan[threadIdx.x] += v;
    __syncthreads();
  }
  int r = scan[threadIdx.x] - cnt;  // unguarded replicas before lo
  for (int i = lo; i < hi && r < m; ++i) {
    if (__ldcg(a.forced_ok + i) == 0) {
      a.cand_r[n + r] = i;
      a.cand_has[n + r] = 0;
      ++r;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
forced_select_kernel(Args a, int phase_lo, int phase_hi) {
  __shared__ u64 keys[kMaxK];
  __shared__ int sh[256];
  __shared__ int suf[257 > kThreads ? 257 : kThreads];
  __shared__ Select st;
  if (threadIdx.x == 0) {
    st.prefix = 0;
    st.mask = 0;
    st.k_rem = a.k;
    st.derived = 0;
    st.done = 0;
  }
  __syncthreads();
  for (int ph = phase_lo; ph < phase_hi; ++ph) {
    bool barrier = true;
    if (ph == kPhaseInit) {
      phase_init(a);
    } else if (ph == kPhaseGuard) {
      phase_guard(a, sh);
    } else if (ph < kPhaseCompact) {
      barrier = phase_pass(a, ph - 1, st, sh, suf);
    } else if (ph == kPhaseCompact) {
      barrier = phase_compact(a, st, suf);
    } else if (ph == kPhaseOrder) {
      phase_order(a, keys, suf);
    }
    __syncthreads();
    if (barrier && ph + 1 < phase_hi) cg::this_grid().sync();
  }
}

int g_blocks[16];  // cooperative grid size per device, 0 until queried

int coop_blocks(int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 16 && g_blocks[dev] > 0) {
    *blocks = g_blocks[dev];
    return 0;
  }
  int sms = 0, coop = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, forced_select_kernel, kThreads, 0);
  }
  if (e != cudaSuccess) return (int)e;
  if (!coop || per_sm < 1) return (int)cudaErrorNotSupported;
  *blocks = sms * (per_sm < 2 ? per_sm : 2);
  if (dev < 16) g_blocks[dev] = *blocks;
  return 0;
}

}  // namespace

// forced u8[R], w f32[R], replica_partition / replica_broker i32[R],
// partition_replicas i32[P, RF], top_b i32[nb_top], top_h f32[nb_top];
// out forced_ok u8[R] and, for k > 0, cand_r i32[k], cand_has u8[k].
// Scratch for k > 0: list u64[R], hist i32[8 * 256 + 2], sel_keys u64[k].
// k > 0 is one cooperative launch.
extern "C" int cc_forced_select(
    int R, int RF, int nb_top, int k, const uint8_t* forced,
    const float* w, const int* replica_partition, const int* replica_broker,
    const int* partition_replicas, const int* top_b, const float* top_h,
    uint8_t* forced_ok, u64* list, int* hist, u64* sel_keys, int* cand_r,
    uint8_t* cand_has, void* stream) {
  if (R <= 0) return 0;
  if (nb_top > 32 || k < 0 || k > kMaxK || k > R) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{R,        RF,       nb_top,  k,      forced,   w,
         replica_partition,  replica_broker,  partition_replicas,
         top_b,    top_h,    forced_ok,       list,   hist,     sel_keys,
         cand_r,   cand_has};
  if (k == 0) {
    // one phase: no grid barrier, so a plain launch
    const int blocks = (R + kThreads - 1) / kThreads;
    forced_select_kernel<<<blocks, kThreads, 0, st>>>(a, kPhaseGuard,
                                                      kPhaseGuard + 1);
    return (int)cudaGetLastError();
  }
  int blocks = 0;
  int err = coop_blocks(&blocks);
  if (err != 0) return err;
  int lo = kPhaseInit, hi = kPhases;
  void* params[] = {&a, &lo, &hi};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)forced_select_kernel, dim3(blocks), dim3(kThreads), params,
      0, st);
}
