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
// guarded_pick, whose top-k is then K1's).
//
// Design: simple and exact, one launch per stage.
//   1. guard_key_kernel, a thread per replica: the guard over the
//      partition's sibling brokers (a bit mask over the <= 32 top
//      brokers), the score (w + 1 rounded on its own, __fadd_rn, so nvcc
//      cannot contract it), and a unique 64-bit key: the score's
//      order-preserving bits in the high word, the complemented replica
//      index in the low word.  Keys descending is exactly top_k's order.
//   2. radix select of the k-th largest key: eight passes of 8-bit
//      digits, each a histogram of the keys that match the prefix found
//      so far (shared-memory counts folded into global counts, integer
//      atomics only: exact and independent of order) and a one-block
//      suffix scan that picks the digit and the rank left inside it.
//   3. compact_kernel, a thread per replica: the k keys >= the k-th key
//      (the keys are unique, so exactly k) land in a scratch list in any
//      order.
//   4. sort_kernel, one block: a bitonic sort of the k <= 4096 keys in
//      shared memory (32 KB), descending, then the ids and flags.
// No float atomics anywhere.
//
// Bound: bytes.  Per replica the flags, weight, partition id, the sibling
// row and the siblings' brokers, plus k outputs: about 20 MB at R =
// 600,000.  The select passes re-read the 8-byte keys (4.8 MB at R =
// 600,000, resident in the 50 MB L2); the launches, about twenty of a few
// microseconds, set the time at these sizes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSortThreads = 1024;
constexpr int kMaxK = 4096;
constexpr int kPasses = 8;
constexpr int kMaxBlocks = 528;  // 4 per SM on 132 SMs

typedef unsigned long long u64;

struct Select {
  u64 prefix;  // digits chosen so far
  u64 mask;    // the bits they cover
  int k_rem;   // rank of the k-th key among the keys matching prefix
  int count;   // compaction cursor
};

__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void guard_key_kernel(int R, int RF, int nb_top,
                                 const uint8_t* __restrict__ forced,
                                 const float* __restrict__ w,
                                 const int* __restrict__ replica_partition,
                                 const int* __restrict__ replica_broker,
                                 const int* __restrict__ partition_replicas,
                                 const int* __restrict__ top_b,
                                 const float* __restrict__ top_h,
                                 uint8_t* __restrict__ forced_ok,
                                 u64* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  bool ok = false;
  const float wi = w[i];
  if (forced[i]) {
    const int* sib = partition_replicas + (size_t)replica_partition[i] * RF;
    uint32_t blocked = 0;
    for (int q = 0; q < RF; ++q) {
      const int s = sib[q];
      if (s < 0) continue;
      const int sb = replica_broker[s];
      for (int j = 0; j < nb_top; ++j) {
        if (top_b[j] == sb) blocked |= 1u << j;
      }
    }
    float best = -INFINITY;
    for (int j = 0; j < nb_top; ++j) {
      if (!((blocked >> j) & 1u)) best = fmaxf(best, top_h[j]);
    }
    ok = best >= wi;
  }
  if (forced_ok != nullptr) forced_ok[i] = ok ? 1 : 0;
  if (keys != nullptr) {
    const float score = ok ? __fadd_rn(wi, 1.0f) : -INFINITY;
    keys[i] = ((u64)order_bits(score) << 32) | (u64)(~(uint32_t)i);
  }
}

__global__ void init_kernel(Select* sel, int* hist, int k) {
  for (int t = threadIdx.x; t < kPasses * 256; t += blockDim.x) hist[t] = 0;
  if (threadIdx.x == 0) {
    sel->prefix = 0;
    sel->mask = 0;
    sel->k_rem = k;
    sel->count = 0;
  }
}

__global__ void hist_kernel(int R, const u64* __restrict__ keys,
                            const Select* __restrict__ sel,
                            int* __restrict__ hist, int shift) {
  __shared__ int sh[256];
  for (int t = threadIdx.x; t < 256; t += blockDim.x) sh[t] = 0;
  __syncthreads();
  const u64 prefix = sel->prefix;
  const u64 mask = sel->mask;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < R;
       i += gridDim.x * blockDim.x) {
    const u64 key = keys[i];
    if ((key & mask) == prefix) {
      atomicAdd(&sh[(int)((key >> shift) & 0xFFu)], 1);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    if (sh[t] != 0) atomicAdd(&hist[t], sh[t]);
  }
}

// One block of 256 threads: digit t is the one whose keys hold the
// k_rem-th largest of the keys matching the prefix.
__global__ void select_kernel(Select* sel, const int* __restrict__ hist,
                              int shift) {
  __shared__ int suf[257];
  const int t = threadIdx.x;
  const int k_rem = sel->k_rem;
  suf[t] = hist[t];
  if (t == 0) suf[256] = 0;
  __syncthreads();
  // inclusive suffix sums: suf[t] = number of keys with digit >= t
  for (int off = 1; off < 256; off <<= 1) {
    const int v = (t + off < 256) ? suf[t + off] : 0;
    __syncthreads();
    suf[t] += v;
    __syncthreads();
  }
  const int above = suf[t + 1];
  if (suf[t] >= k_rem && above < k_rem) {
    sel->prefix |= (u64)t << shift;
    sel->mask |= (u64)0xFFu << shift;
    sel->k_rem = k_rem - above;
  }
}

__global__ void compact_kernel(int R, int k, const u64* __restrict__ keys,
                               Select* sel, u64* __restrict__ out_keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const u64 key = keys[i];
  if (key >= sel->prefix) {
    const int pos = atomicAdd(&sel->count, 1);
    if (pos < k) out_keys[pos] = key;
  }
}

__global__ void sort_kernel(int k, const u64* __restrict__ in_keys,
                            const uint8_t* __restrict__ forced_ok,
                            int* __restrict__ cand_r,
                            uint8_t* __restrict__ cand_has) {
  __shared__ u64 s[kMaxK];
  int n = 1;
  while (n < k) n <<= 1;
  // padding keys of 0 sort last: no real key is 0 (its high word would be
  // a NaN's)
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    s[t] = t < k ? in_keys[t] : 0ull;
  }
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const int p = t ^ stride;
        if (p > t) {
          const u64 a = s[t];
          const u64 b = s[p];
          const bool desc = (t & size) == 0;
          if (desc ? (a < b) : (a > b)) {
            s[t] = b;
            s[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    const int idx = (int)(~(uint32_t)(s[t] & 0xFFFFFFFFull));
    cand_r[t] = idx;
    cand_has[t] = forced_ok[idx];
  }
}

int blocks_for(long long threads) {
  return (int)((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int cc_forced_select(
    int R, int RF, int nb_top, int k, const uint8_t* forced, const float* w,
    const int* replica_partition, const int* replica_broker,
    const int* partition_replicas, const int* top_b, const float* top_h,
    uint8_t* forced_ok, u64* keys, int* hist, void* sel_buf,
    u64* out_keys, int* cand_r, uint8_t* cand_has, void* stream) {
  if (R <= 0) return 0;
  if (nb_top > 32 || k < 0 || k > kMaxK || k > R) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Select* sel = static_cast<Select*>(sel_buf);
  guard_key_kernel<<<blocks_for(R), kThreads, 0, st>>>(
      R, RF, nb_top, forced, w, replica_partition, replica_broker,
      partition_replicas, top_b, top_h, forced_ok, k > 0 ? keys : nullptr);
  int err = (int)cudaGetLastError();
  if (err != 0 || k == 0) return err;
  init_kernel<<<1, 256, 0, st>>>(sel, hist, k);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int hblocks = blocks_for(R) < kMaxBlocks ? blocks_for(R) : kMaxBlocks;
  for (int p = 0; p < kPasses; ++p) {
    const int shift = 56 - 8 * p;
    hist_kernel<<<hblocks, kThreads, 0, st>>>(R, keys, sel, hist + p * 256,
                                              shift);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    select_kernel<<<1, 256, 0, st>>>(sel, hist + p * 256, shift);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  compact_kernel<<<blocks_for(R), kThreads, 0, st>>>(R, k, keys, sel,
                                                     out_keys);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  sort_kernel<<<1, kSortThreads, 0, st>>>(k, out_keys, forced_ok, cand_r,
                                          cand_has);
  return (int)cudaGetLastError();
}
