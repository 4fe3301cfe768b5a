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
// barriers (cooperative_groups); no one-block stage.  The selection is
// topk_select.cuh's (shared with K6):
//   0. init: block 0 zeroes the histograms and counters.
//   1. guard: a thread per replica computes forced_ok (the partition's
//      sibling brokers as a bit mask over the <= 32 top brokers) and, for
//      a guarded replica, its key -- the score w + 1 (rounded on its own,
//      __fadd_rn) over the replica index -- appended to the list and
//      counted into the first digit's histogram.  Only guarded replicas
//      enter the list: every other score is -inf.
//   2-8. when more than k replicas are guarded, the radix select of the
//      k-th largest key, one 8-bit digit per phase.
//   9. compaction of the k selected keys (only after a select).
//  10. the order: each selected key written at its rank; when k or fewer
//      replicas are guarded (the usual heal round: R = 60,000 at 0.5 %
//      forced guards about 300), the list is the selection and the tail
//      is the k - n lowest-index unguarded replicas.
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

#include "topk_select.cuh"

namespace cg = cooperative_groups;

namespace {

using tks::u64;

constexpr int kThreads = 512;
constexpr int kMaxK = tks::kMaxK;
constexpr int kPhaseInit = 0;
constexpr int kPhaseGuard = 1;
constexpr int kPhaseCompact = 9;
constexpr int kPhaseOrder = 10;
constexpr int kPhases = 11;

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
  int* hist;        // tks::kHistWords: digit counts, then the counters
  u64* sel_keys;    // the k selected keys (after a select)
  int* cand_r;
  uint8_t* cand_has;
};

__device__ void phase_guard(const Args& a, int* sh) {
  const bool keys = a.k > 0;
  if (keys) {
    for (int t = threadIdx.x; t < 256; t += blockDim.x) sh[t] = 0;
    __syncthreads();
  }
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
    tks::select_append(ok, tks::select_key(__fadd_rn(wi, 1.0f), i), a.list,
                       a.hist, sh);
  }
  if (keys) tks::select_flush(sh, a.hist);
}

struct EmitCand {
  const Args& a;
  __device__ void operator()(int rank, u64 key) const {
    a.cand_r[rank] = tks::select_index(key);
    a.cand_has[rank] = 1;
  }
};

struct Guarded {
  const Args& a;
  __device__ bool operator()(int i) const {
    return __ldcg(a.forced_ok + i) != 0;
  }
};

struct EmitTail {
  const Args& a;
  __device__ void operator()(int pos, int i) const {
    a.cand_r[pos] = i;
    a.cand_has[pos] = 0;
  }
};

__global__ void __launch_bounds__(kThreads)
forced_select_kernel(Args a, int phase_lo, int phase_hi) {
  __shared__ u64 keys[kMaxK];
  __shared__ int sh[256];
  __shared__ int tmp[33];
  __shared__ tks::Select st;
  if (threadIdx.x == 0) tks::select_init(st, a.k);
  __syncthreads();
  for (int ph = phase_lo; ph < phase_hi; ++ph) {
    bool barrier = true;
    if (ph == kPhaseInit) {
      tks::select_zero(a.hist);
    } else if (ph == kPhaseGuard) {
      phase_guard(a, sh);
    } else if (ph < kPhaseCompact) {
      barrier = tks::select_pass(a.list, a.hist, a.k, ph - 1, st, sh);
    } else if (ph == kPhaseCompact) {
      barrier = tks::select_compact(a.list, a.hist, a.k, st, a.sel_keys);
    } else if (ph == kPhaseOrder) {
      EmitCand emit{a};
      if (!tks::select_order(a.list, a.hist, a.sel_keys, a.k, keys, emit)) {
        Guarded listed{a};
        EmitTail tail{a};
        tks::select_tail(a.hist, a.k, tmp, listed, tail);
      }
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

// The widest k.
extern "C" int cc_forced_select_max_k() { return kMaxK; }

// forced u8[R], w f32[R], replica_partition / replica_broker i32[R],
// partition_replicas i32[P, RF], top_b i32[nb_top], top_h f32[nb_top];
// out forced_ok u8[R] and, for k > 0, cand_r i32[k], cand_has u8[k].
// Scratch for k > 0: list u64[R], hist i32[tks::kHistWords], sel_keys
// u64[k].
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
