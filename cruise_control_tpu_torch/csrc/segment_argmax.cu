// K9 segment_argmax: per segment, the lowest index of the max-score valid
// element; and, for resolve_dest_conflicts, whether each element is its
// segment's winner.
//
// Replaces per_segment_argmax (cruise_control_tpu/analyzer/kernels.py),
// which the move, swap, leadership and forced rounds call directly and
// through resolve_dest_conflicts, and which the intra-broker disk round
// calls three times.  For segment s over the elements i with segment[i]
// == s (ids outside [0, S) are dropped, as jax.ops.segment_max drops
// them):
//     masked[i] = valid[i] ? score[i] : NEG
//     max[s]    = max masked[i]          (-inf for an empty segment)
//     has[s]    = max[s] > NEG / 2
//     arg[s]    = has[s] ? the lowest i with valid[i] and masked[i] ==
//                 max[s] : -1
// The reference's `masked >= seg_max` ties -0.0 with +0.0, so -0.0 is
// canonicalised to +0.0 before packing.  When has[s] holds, the winner is
// valid: invalid elements sit at NEG, below NEG / 2.
//
// Two entries:
//  * cc_segment_argmax (dense): arg, max and has for all S segments.
//  * cc_segment_keep: keep[i] = valid[i] && segment[i] in [0, S) && i is
//    arg[segment[i]] -- resolve_dest_conflicts' mask with seg = valid ?
//    dest : 0.  Only the valid elements enter the fold (an invalid one
//    sits at NEG and can win no segment that has a winner), and nothing S
//    long is written or read: the work is O(n) at any S.
//
// Design: one 64-bit key per element, the score's order-preserving uint32
// in the high half and ~i in the low half (so the lowest index wins a
// tie), folded per segment with an integer atomicMax: exact in any thread
// order.  A zero key marks an empty segment (every element's key has a
// non-zero low half below 2**31 elements).  One launch a call, no memset:
//  * one block of 1024 threads when n <= 4096 (and, for the dense entry,
//    S <= 1024), each thread's elements held in registers: the keys in
//    shared memory when S <= 4096, else in the caller's global key
//    scratch; one barrier, then the decode (keep: a second barrier before
//    the global keys are cleared).
//  * otherwise one cooperative grid (at most two blocks an SM).  With
//    `share` > 0 each block folds `share` elements or more into S shared
//    keys (opt-in shared memory, up to 227 KB) and merges the non-zero
//    ones into the global scratch, one atomicMax a key; with `share` 0
//    every element folds straight into the global scratch.  A grid-wide
//    barrier; then the whole grid decodes (a thread a segment, dense) or
//    checks each element against its segment's key (keep; a second
//    barrier before the keys are cleared).  The caller picks `share`
//    (chip_smoke.py phase 2 times each fold).
// The global scratch (S keys, owned by the wrapper, one per device and
// stream) is zero between calls: the decode clears every key it set.
//
// Bound: memory.  Each element's score, id and flag are read once (9 or
// 13 bytes), and the outputs written once: 9 bytes a segment (dense) or
// 1 byte an element (keep).  Global atomics touch L2 only.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e30f;
constexpr float kNegHalf = -5e29f;
constexpr int kThreads = 1024;
constexpr int kOneBlockMax = 4096;
constexpr int kOneBlockDenseS = 1024;
constexpr int kSharedKeys = 4096;      // one block: keys in shared memory
constexpr int kMaxSmem = 232448;       // 227 KB, sm_90's opt-in limit
constexpr int kMinShare = 2048;        // elements a grid block folds, at least
constexpr int kBatch = 4;              // elements a thread loads at once

typedef unsigned long long u64;

struct Args {
  const float* score;
  const void* segment;  // int32 or int64 [n]
  int seg64;
  const uint8_t* valid;
  int n, S;
  int shared_keys;      // fold into shared memory (first)
  u64* keys;            // global scratch: S keys, zero between calls
  int* arg;             // dense outputs
  float* max_out;
  uint8_t* has;
  uint8_t* keep;        // keep output
};

__device__ __forceinline__ uint32_t order_key(float f) {
  if (f == 0.f) f = 0.f;  // -0.0 ties +0.0
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// element i's segment and key; false when it takes no part in the fold.
// Its three loads are unconditional, so a batch of elements has them all
// in flight at once.
template <bool KEEP>
__device__ __forceinline__ bool element(const Args& a, int i, int* s,
                                        u64* key) {
  const long long sg =
      a.seg64 ? static_cast<const long long*>(a.segment)[i]
              : (long long)static_cast<const int*>(a.segment)[i];
  const bool v = a.valid[i];
  const float sc = a.score[i];
  *s = (int)sg;
  *key = ((u64)order_key(v ? sc : kNeg) << 32) | (uint32_t)(~(uint32_t)i);
  return sg >= 0 && sg < a.S && (!KEEP || v);
}

// f(i, s, key) for the elements first, first + step, ... below end that
// take part in the fold (`all`: every element, with a flag), kBatch of
// them loaded before any is used
template <bool KEEP, bool ALL = false, typename F>
__device__ __forceinline__ void for_elements(const Args& a, int first,
                                             int end, int step, F f) {
  for (int i0 = first; i0 < end; i0 += kBatch * step) {
    int s[kBatch];
    u64 key[kBatch];
    bool in[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * step;
      in[u] = i < end && element<KEEP>(a, i, s + u, key + u);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * step;
      if (ALL ? i < end : in[u]) f(i, in[u], s[u], key[u]);
    }
  }
}

__device__ __forceinline__ bool wins(u64 seg_key, u64 key) {
  return seg_key == key && order_value((uint32_t)(key >> 32)) > kNegHalf;
}

// the decode of the dense outputs (keys in shared memory, or the global
// scratch, cleared as read), or of the grid's keep mask
template <bool KEEP>
__device__ __forceinline__ void decode(const Args& a, const u64* keys,
                                       bool global, int first, int step) {
  if (KEEP) {
    for_elements<true, true>(a, first, a.n, step,
                             [&](int i, bool in, int s, u64 key) {
      a.keep[i] = in && wins(__ldcg(keys + s), key);
    });
    return;
  }
  for (int s = first; s < a.S; s += step) {
    const u64 key = global ? __ldcg(keys + s) : keys[s];
    if (key == 0ull) {
      a.arg[s] = -1;
      a.max_out[s] = -__int_as_float(0x7f800000);  // -inf
      a.has[s] = 0;
      continue;
    }
    if (global) a.keys[s] = 0ull;
    const float v = order_value((uint32_t)(key >> 32));
    const bool h = v > kNegHalf;
    a.max_out[s] = v;
    a.has[s] = h;
    a.arg[s] = h ? (int)(~(uint32_t)(key & 0xFFFFFFFFull)) : -1;
  }
}

// the keep entry's clean-up: zero the keys its elements set
__device__ __forceinline__ void clear_keys(const Args& a, int first,
                                           int step) {
  for_elements<true>(a, first, a.n, step,
                     [&](int, bool, int s, u64) { a.keys[s] = 0ull; });
}

extern __shared__ u64 s_keys[];

// each thread folds, and (keep) checks, the elements t, t + 1024, ...:
// at most kBatch of them, held in registers across the barrier
template <bool KEEP>
__global__ void __launch_bounds__(kThreads) one_block_kernel(Args a) {
  static_assert(kOneBlockMax <= kBatch * kThreads, "one batch a thread");
  const int t = threadIdx.x;
  if (a.shared_keys) {
    for (int s = t; s < a.S; s += kThreads) s_keys[s] = 0ull;
    __syncthreads();
  }
  u64* keys = a.shared_keys ? s_keys : a.keys;
  int s[kBatch];
  u64 key[kBatch];
  bool in[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int i = t + u * kThreads;
    in[u] = i < a.n && element<KEEP>(a, i, s + u, key + u);
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    if (in[u]) atomicMax(keys + s[u], key[u]);
  __syncthreads();
  if (!KEEP) {
    decode<false>(a, keys, false, t, kThreads);
    return;
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int i = t + u * kThreads;
    if (i < a.n)
      a.keep[i] = in[u] && wins(a.shared_keys ? keys[s[u]]
                                              : __ldcg(keys + s[u]),
                                key[u]);
  }
  if (!a.shared_keys) {
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (in[u]) keys[s[u]] = 0ull;
  }
}

template <bool KEEP>
__global__ void __launch_bounds__(kThreads) grid_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x;
  const int share = (a.n + gridDim.x - 1) / gridDim.x;
  const int lo = blockIdx.x * share;
  const int hi = min(a.n, lo + share);
  if (a.shared_keys) {
    for (int s = t; s < a.S; s += kThreads) s_keys[s] = 0;
    __syncthreads();
  }
  u64* fold = a.shared_keys ? s_keys : a.keys;
  for_elements<KEEP>(a, lo + t, hi, kThreads,
                     [&](int, bool, int s, u64 key) {
    atomicMax(fold + s, key);
  });
  if (a.shared_keys) {
    __syncthreads();
    for (int s = t; s < a.S; s += kThreads) {
      const u64 k = s_keys[s];
      if (k) atomicMax(a.keys + s, k);
    }
  }
  grid.sync();
  const int first = blockIdx.x * kThreads + t;
  const int step = gridDim.x * kThreads;
  decode<KEEP>(a, a.keys, true, first, step);
  if (KEEP) {
    grid.sync();
    clear_keys(a, first, step);
  }
}

// per device: the opt-in shared memory set on the grid kernels, and the
// last (entry, shared bytes) occupancy asked
struct DeviceState {
  bool attrs;
  int smem[2], per_sm[2], sms;
};
DeviceState g_dev[16];

int prepare(int dev) {
  DeviceState& d = g_dev[dev];
  if (d.attrs) return 0;
  const void* fns[] = {(const void*)grid_kernel<true>,
                       (const void*)grid_kernel<false>};
  for (const void* f : fns) {
    const cudaError_t e = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
  }
  const cudaError_t e =
      cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  d.smem[0] = d.smem[1] = -1;
  d.attrs = true;
  return 0;
}

// the cooperative grid's most blocks at `smem` shared bytes a block
int grid_blocks(int dev, bool keep, size_t smem, int* blocks) {
  DeviceState& d = g_dev[dev];
  if (d.smem[keep] != (int)smem) {
    int per_sm = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, keep ? grid_kernel<true> : grid_kernel<false>, kThreads,
        smem);
    if (e != cudaSuccess) return (int)e;
    d.per_sm[keep] = per_sm < 2 ? per_sm : 2;
    d.smem[keep] = (int)smem;
  }
  *blocks = d.sms * d.per_sm[keep];
  return *blocks < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

int launch(bool keep, Args a, int share, void* stream) {
  if (a.n <= 0 && (keep || a.S <= 0)) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 16) return (int)cudaErrorInvalidDevice;
  int err = prepare(dev);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.n <= kOneBlockMax && (keep || a.S <= kOneBlockDenseS)) {
    a.shared_keys = a.S <= kSharedKeys;
    if (!a.shared_keys && a.keys == nullptr)
      return (int)cudaErrorInvalidValue;
    const size_t smem = a.shared_keys ? 8 * (size_t)a.S : 0;
    if (keep)
      one_block_kernel<true><<<1, kThreads, smem, st>>>(a);
    else
      one_block_kernel<false><<<1, kThreads, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  if (a.keys == nullptr) return (int)cudaErrorInvalidValue;
  a.shared_keys = share > 0;
  const size_t smem = a.shared_keys ? 8 * (size_t)a.S : 0;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  int most = 0;
  err = grid_blocks(dev, keep, smem, &most);
  if (err) return err;
  const long long per = share > kMinShare ? share : kMinShare;
  long long blocks = (a.n + per - 1) / per;
  // the dense decode spreads its S segments over the grid too
  if (!keep && blocks < (a.S + kThreads - 1) / kThreads)
    blocks = (a.S + kThreads - 1) / kThreads;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      keep ? (const void*)grid_kernel<true> : (const void*)grid_kernel<false>,
      dim3((unsigned)blocks), dim3(kThreads), params, smem, st);
}

}  // namespace

// scratch: S keys, all zero, needed when the launch folds into global
// memory: n > 4096, or S > 4096, or a dense call with S > 1024 (may be
// null otherwise); left zero.  share: the grid path's elements a block
// folds into shared keys (0: straight into the scratch; 8 S bytes must
// fit in 227 KB).  segment: int32, or int64 when seg64.
extern "C" int cc_segment_argmax(const float* score, const void* segment,
                                 int seg64, const uint8_t* valid, int n,
                                 int S, unsigned long long* scratch,
                                 int share, int* arg, float* max_out,
                                 uint8_t* has, void* stream) {
  Args a{score, segment, seg64, valid, n, S, 0, scratch, arg, max_out, has,
         nullptr};
  return launch(false, a, share, stream);
}

extern "C" int cc_segment_keep(const float* score, const void* segment,
                               int seg64, const uint8_t* valid, int n, int S,
                               unsigned long long* scratch, int share,
                               uint8_t* keep, void* stream) {
  Args a{score, segment, seg64, valid, n, S, 0, scratch, nullptr, nullptr,
         nullptr, keep};
  return launch(true, a, share, stream);
}
