// K11 dest_feasibility: the move rounds' candidate x destination
// preference plane and the candidate-level destination guard.
//
// Replaces, in cruise_control_tpu/analyzer/kernels.py:
//  * _dest_feasibility with the preference plane the move round, the
//    forced-move round and the pre-balance build around it (entry
//    cc_dest_pref).  For candidate replica r = cand_r[c] and destination
//    d = dest_ids[k], the structural terms are
//        struct(c, k) = dest_ok[d] && d != replica_broker[r]
//                       && no sibling replica of r's partition on d
//    (the sibling test only when partition_replicas is given; sibling
//    brokers are -1 where partition_replicas is -1), and
//        pref[c, k] = (cand_has[c] && struct(c, k)
//                      && w_c[c] <= dest_headroom[d]  (when given)
//                      && accept[c, k]                (when given))
//                     ? dest_pref[d] : NEG
//    `accept` is the composed acceptance stack (torch ops: it calls the
//    prior goals' callbacks), read through its strides, so a broadcast
//    [C, 1], [1, K] or 0-d plane is never materialised.  No arithmetic,
//    so the plane is exact.
//  * cand_has_dest's and feasible_dest_exists' guard (entry cc_dest_has),
//    top_headroom included: the top nt = min(RF + 2, B) brokers by
//    headroom (ineligible ones at -inf) in jax.lax.top_k's order: XLA's
//    total order (-0.0 below +0.0), ties to the lower broker id, then
//        best[c] = max over the top j of (top_b[j] is the broker of one of
//                  r's partition's replicas ? -inf : top_h[j])
//        out[c]  = best[c] >= w_c[c]
//    with r = cand_r[c], or r = c over every replica when cand_r is null.
//    Only eligible brokers can raise best above -inf, so the selection
//    runs over them alone.
//
// Design.  Plane: a warp per candidate row, eight rows a block (grid-
// stride); lanes 0..RF-1 load the candidate's sibling brokers once into
// shared memory, then the warp sweeps the row four entries a lane
// (16-byte reads of dest_ids, 4-byte reads of a contiguous acceptance
// row, 16-byte stores when K % 4 == 0), the destinations'
// flags, preferences and headrooms gathered from L1.  No 64-bit
// division.  Candidate and destination ids are read as int32 or int64,
// so the caller converts neither.  Guard: every block selects the top
// brokers itself -- each warp the top nt of its share of the brokers by
// nt warp-wide maxima over 64-bit keys (the headroom's order-preserving
// bits over the complemented broker id, so keys are unique and their
// order is the sort's), warp 0 the top nt of those -- then a thread per
// candidate (grid-stride, two blocks an SM) tests its RF sibling brokers
// against them in registers.  (Staging the destination columns in shared
// memory, and warps that load candidates while others select, measured
// no faster on the card.)
//
// Bound: memory.  The preference plane is 4*C*K output bytes and the
// acceptance plane's C*K read, with each candidate's broker and RF sibling
// brokers read once and the destination columns from L1/L2; the guard
// reads each candidate's ids and its sibling row, plus the broker vectors
// a block (a few kB from L2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRF = 16;
constexpr int kMaxTop = kMaxRF + 2;
constexpr int kMaxBlocks = 1056;
// each guard block selects the top brokers anew: two blocks an SM
constexpr int kMaxGuardBlocks = 264;
constexpr float kNeg = -1e30f;

typedef unsigned long long u64;

struct RowArgs {
  int C, K, RF;
  const void* cand_r;    // int32 or int64 [C]
  int cand64;
  const void* dest_ids;  // int32 or int64 [K]
  int ids64;
  const uint8_t* dest_ok;
  const int* replica_broker;
  const int* replica_partition;
  const int* partition_replicas;  // null: no sibling test
  // float vectors with element strides
  const uint8_t* cand_has;        // null: every row
  const float* w_c;               // null: no headroom test
  long long w_stride;
  const float* dest_headroom;
  long long hr_stride;
  const uint8_t* accept;          // null: no acceptance plane
  long long acc_c, acc_k;         // its strides
  const float* dest_pref;
  long long pref_stride;
  float* out;
  int vec;      // K % 4 == 0, dest_ids and the plane 16-byte aligned
  int acc_vec;  // accept read four bytes at a time
};

__device__ __forceinline__ int dest_at(const RowArgs& a, int k) {
  return a.ids64 ? (int)static_cast<const long long*>(a.dest_ids)[k]
                 : static_cast<const int*>(a.dest_ids)[k];
}

// the candidate's replica id
__device__ __forceinline__ int cand_at(const void* cand_r, int cand64,
                                       int c) {
  return cand64 ? (int)static_cast<const long long*>(cand_r)[c]
                : static_cast<const int*>(cand_r)[c];
}

__global__ void __launch_bounds__(kThreads) dest_pref_kernel(RowArgs a) {
  __shared__ int s_sib[kWarps][kMaxRF];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nsib = a.partition_replicas ? a.RF : 0;
  for (int c = blockIdx.x * kWarps + w; c < a.C; c += gridDim.x * kWarps) {
    const int r = cand_at(a.cand_r, a.cand64, c);
    const int own = a.replica_broker[r];
    if (lane < nsib) {
      const int s =
          a.partition_replicas[(size_t)a.replica_partition[r] * a.RF + lane];
      s_sib[w][lane] = s >= 0 ? a.replica_broker[s] : -1;
    }
    const bool row_ok = a.cand_has == nullptr || a.cand_has[c];
    const float wc = a.w_c != nullptr ? a.w_c[c * a.w_stride] : 0.f;
    __syncwarp();
    const long long base = (long long)c * a.K;
    for (int k0 = 4 * lane; k0 < a.K; k0 += 128) {
      const int nk = min(4, a.K - k0);
      int d[4];
      if (a.vec && !a.ids64) {
        const int4 q = *reinterpret_cast<const int4*>(
            static_cast<const int*>(a.dest_ids) + k0);
        d[0] = q.x, d[1] = q.y, d[2] = q.z, d[3] = q.w;
      } else if (a.vec) {
        const longlong2* p = reinterpret_cast<const longlong2*>(
            static_cast<const long long*>(a.dest_ids) + k0);
        const longlong2 q0 = p[0], q1 = p[1];
        d[0] = (int)q0.x, d[1] = (int)q0.y;
        d[2] = (int)q1.x, d[3] = (int)q1.y;
      } else {
        for (int j = 0; j < 4; ++j) d[j] = j < nk ? dest_at(a, k0 + j) : 0;
      }
      uint8_t acc[4] = {1, 1, 1, 1};
      if (a.accept != nullptr) {
        const uint8_t* p = a.accept + c * a.acc_c + (long long)k0 * a.acc_k;
        if (a.acc_vec) {
          const uchar4 q = *reinterpret_cast<const uchar4*>(p);
          acc[0] = q.x, acc[1] = q.y, acc[2] = q.z, acc[3] = q.w;
        } else {
          for (int j = 0; j < nk; ++j) acc[j] = p[j * a.acc_k];
        }
      }
      float val[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bool o = j < nk && row_ok && a.dest_ok[d[j]] && d[j] != own;
        for (int q = 0; q < nsib; ++q) o = o && s_sib[w][q] != d[j];
        if (o && a.w_c != nullptr)
          o = wc <= a.dest_headroom[d[j] * a.hr_stride];
        o = o && acc[j] != 0;
        val[j] = o ? a.dest_pref[d[j] * a.pref_stride] : kNeg;
      }
      float* out = a.out + base + k0;
      if (a.vec) {
        *reinterpret_cast<float4*>(out) =
            make_float4(val[0], val[1], val[2], val[3]);
      } else {
        for (int j = 0; j < nk; ++j) out[j] = val[j];
      }
    }
    __syncwarp();
  }
}

// XLA's total order: -0.0 below +0.0
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 x = __shfl_xor_sync(0xffffffffu, v, o);
    v = x > v ? x : v;
  }
  return v;
}

struct HasArgs {
  int C, RF, B, nt;
  const void* cand_r;  // int32 or int64; null: every replica
  int cand64;
  const float* w_c;
  long long w_stride;
  const uint8_t* dest_ok;
  const float* dest_headroom;
  long long hr_stride;
  const int* replica_broker;
  const int* replica_partition;
  const int* partition_replicas;
  uint8_t* out;
};

__global__ void __launch_bounds__(kThreads) dest_has_kernel(HasArgs a) {
  __shared__ u64 s_cand[kWarps][kMaxTop];
  __shared__ int s_top_b[kMaxTop];
  __shared__ float s_top_h[kMaxTop];
  __shared__ int s_nt;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  // each warp: the top nt keys of the brokers w, w + 8, ... (0: none)
  u64 thr = ~0ull;
  for (int t = 0; t < a.nt; ++t) {
    u64 best = 0ull;
    for (int b = w + kWarps * lane; b < a.B; b += 32 * kWarps) {
      if (!a.dest_ok[b]) continue;
      const u64 key = ((u64)order_key(a.dest_headroom[b * a.hr_stride])
                       << 32) |
                      (uint32_t)(~(uint32_t)b);
      if (key < thr && key > best) best = key;
    }
    best = warp_max(best);
    if (lane == 0) s_cand[w][t] = best;
    thr = best;
  }
  __syncthreads();
  // warp 0: the top nt of the warps' candidates
  if (w == 0) {
    thr = ~0ull;
    int found = 0;
    for (int t = 0; t < a.nt; ++t) {
      u64 best = 0ull;
      for (int i = lane; i < kWarps * a.nt; i += 32) {
        const u64 key = s_cand[i / a.nt][i % a.nt];
        if (key < thr && key > best) best = key;
      }
      best = warp_max(best);
      if (best == 0ull) break;
      if (lane == 0) {
        s_top_b[t] = (int)(~(uint32_t)(best & 0xFFFFFFFFull));
        s_top_h[t] = order_value((uint32_t)(best >> 32));
      }
      thr = best;
      ++found;
    }
    if (lane == 0) s_nt = found;
  }
  __syncthreads();
  const int nt = s_nt;
  for (int c = blockIdx.x * kThreads + threadIdx.x; c < a.C;
       c += gridDim.x * kThreads) {
    const int r = a.cand_r ? cand_at(a.cand_r, a.cand64, c) : c;
    const int row = a.replica_partition[r];
    uint32_t blocked = 0;
    for (int j = 0; j < a.RF; ++j) {
      const int s = a.partition_replicas[(size_t)row * a.RF + j];
      const int sb = s >= 0 ? a.replica_broker[s] : -1;
      for (int t = 0; t < nt; ++t)
        blocked |= (uint32_t)(sb == s_top_b[t]) << t;
    }
    float best = -__int_as_float(0x7f800000);  // -inf
    for (int t = 0; t < nt; ++t)
      if (!((blocked >> t) & 1u)) best = fmaxf(best, s_top_h[t]);
    a.out[c] = best >= a.w_c[c * a.w_stride];
  }
}

int grid_for(long long n, int per_block, int max_blocks) {
  const long long blocks = (n + per_block - 1) / per_block;
  return (int)(blocks < max_blocks ? (blocks > 0 ? blocks : 1) : max_blocks);
}

bool vec_ok(int K, const void* ids, const void* out) {
  return K % 4 == 0 && reinterpret_cast<uintptr_t>(ids) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

bool acc_vec_ok(int K, const uint8_t* accept, long long acc_c,
                long long acc_k) {
  return accept != nullptr && K % 4 == 0 && acc_k == 1 && acc_c % 4 == 0 &&
         reinterpret_cast<uintptr_t>(accept) % 4 == 0;
}

}  // namespace

// partition_replicas may be null (no sibling test; RF is then ignored).
// cand_r and dest_ids: int32, or int64 when cand64 / ids64.  RF <= 16.
// cand_has, w_c (with dest_headroom) and accept may be null; accept is
// read at accept[c * acc_c + k * acc_k], the float vectors with their
// element strides.
extern "C" int cc_dest_pref(int C, int K, int RF, const void* cand_r,
                            int cand64, const void* dest_ids, int ids64,
                            const uint8_t* dest_ok, const int* replica_broker,
                            const int* replica_partition,
                            const int* partition_replicas,
                            const uint8_t* cand_has, const float* w_c,
                            long long w_stride, const float* dest_headroom,
                            long long hr_stride, const uint8_t* accept,
                            long long acc_c, long long acc_k,
                            const float* dest_pref, long long pref_stride,
                            float* out, void* stream) {
  RowArgs a{C, K, RF, cand_r, cand64, dest_ids, ids64, dest_ok,
            replica_broker, replica_partition, partition_replicas,
            cand_has, w_c, w_stride, dest_headroom, hr_stride, accept,
            acc_c, acc_k, dest_pref, pref_stride, out,
            vec_ok(K, dest_ids, out), acc_vec_ok(K, accept, acc_c, acc_k)};
  if (C <= 0 || K <= 0) return 0;
  if (RF > kMaxRF) return (int)cudaErrorInvalidValue;
  dest_pref_kernel<<<grid_for(C, kWarps, kMaxBlocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// cand_r (int32, or int64 when cand64) may be null: the candidates are
// the replicas 0 .. C-1.  The top min(RF + 2, B) brokers by dest_headroom
// among dest_ok are selected in the launch.  w_c and dest_headroom are
// read with their element strides.  RF <= 16.
extern "C" int cc_dest_has(int C, int RF, int B, const void* cand_r,
                           int cand64, const float* w_c, long long w_stride,
                           const uint8_t* dest_ok,
                           const float* dest_headroom, long long hr_stride,
                           const int* replica_broker,
                           const int* replica_partition,
                           const int* partition_replicas, uint8_t* out,
                           void* stream) {
  if (C <= 0) return 0;
  if (RF < 0 || RF > kMaxRF || B <= 0) return (int)cudaErrorInvalidValue;
  const int nt = RF + 2 < B ? RF + 2 : B;
  HasArgs a{C, RF, B, nt, cand_r, cand64, w_c, w_stride, dest_ok,
            dest_headroom, hr_stride, replica_broker, replica_partition,
            partition_replicas, out};
  dest_has_kernel<<<grid_for(C, kThreads, kMaxGuardBlocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
