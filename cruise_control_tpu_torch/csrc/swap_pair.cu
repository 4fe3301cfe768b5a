// K10 swap_pair: the [H, C] pair plane of the swap round.
//
// Replaces the pair-plane block of swap_round
// (cruise_control_tpu/analyzer/kernels.py, from `delta` to the row argmax).
// Hot row h is broker hb = h_ids[h] shedding replica o = max(out_r[hb], 0);
// cold column c is broker cb = c_ids[c] giving replica i = max(in_r[cb],
// 0).  Per pair:
//     delta  = w[o] - w[i]
//     dh     = dev_u[hb], dc = dev_u[cb]
//     imp    = fma(dh, dh, dc*dc) - fma(dh', dh', dc'*dc')
//              with dh' = dh - delta, dc' = dc + delta
//     feasible = out_has[hb] && in_has[cb] && hot[hb] && cold[cb]
//                && delta > 0 && imp > 0
//                && no sibling replica of o's partition on cb
//                && no sibling replica of i's partition on hb
//                && accept[h, c]
//                (&& util[hb] - delta >= lower[hb])   with a lower band
//                (&& util[cb] + delta <= upper[cb])   with an upper band
// Outputs per row the max of (feasible ? imp : NEG) and its first index
// (jnp.argmax's tie rule), so a row with nothing feasible gives NEG at
// slot 0.  Sibling brokers are -1 where partition_replicas is -1.  Each sum
// of squares is one fused multiply-add, as XLA:CPU contracts it inside the
// reference's compiled round (__fmaf_rn); every other product, sum and
// difference is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn), so
// nvcc's own contraction changes no bit.  The acceptance plane composes the prior goals' Python
// callbacks, so the caller computes it with torch ops and passes it in.
//
// Bound: memory, and at H = C = 128 a single launch.  The acceptance plane
// (H*C bytes) is the only plane read; per row and per column a replica id,
// a weight, a deviation and RF sibling brokers are gathered.  A block per
// hot row, a thread per cold column, a warp-shuffle argmax then a
// shared-memory pass over the warps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;

struct Args {
  int H, C, RF;
  const int* h_ids;
  const int* c_ids;
  const int* out_r;
  const int* in_r;
  const uint8_t* out_has;
  const uint8_t* in_has;
  const uint8_t* hot;
  const uint8_t* cold;
  const float* w;
  const float* dev_u;
  const float* util;
  const float* lower;  // null: no lower band
  const float* upper;  // null: no upper band
  const uint8_t* accept;
  const int* replica_partition;
  const int* partition_replicas;
  const int* replica_broker;
  float* sel;
  int* slot;
};

__device__ __forceinline__ bool sibling_on(const Args& a, int replica,
                                           int broker) {
  const int* row =
      a.partition_replicas + (size_t)a.replica_partition[replica] * a.RF;
  bool dup = false;
  for (int j = 0; j < a.RF; ++j) {
    const int s = row[j];
    const int sb = s >= 0 ? a.replica_broker[s] : -1;
    dup |= sb == broker;
  }
  return dup;
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void swap_pair_kernel(Args a) {
  const int h = blockIdx.x;
  const int hb = a.h_ids[h];
  const int o = a.out_r[hb] > 0 ? a.out_r[hb] : 0;
  const bool row_ok = a.out_has[hb] && a.hot[hb];
  const float w_o = a.w[o];
  const float dh = a.dev_u[hb];
  float best = kNeg;
  int best_i = 0x7FFFFFFF;
  for (int c = threadIdx.x; c < a.C; c += blockDim.x) {
    const int cb = a.c_ids[c];
    const int i = a.in_r[cb] > 0 ? a.in_r[cb] : 0;
    const float delta = __fsub_rn(w_o, a.w[i]);
    const float dc = a.dev_u[cb];
    const float before = __fmaf_rn(dh, dh, __fmul_rn(dc, dc));
    const float ah = __fsub_rn(dh, delta);
    const float ac = __fadd_rn(dc, delta);
    const float after = __fmaf_rn(ah, ah, __fmul_rn(ac, ac));
    const float imp = __fsub_rn(before, after);
    bool ok = row_ok && a.in_has[cb] && a.cold[cb] && delta > 0.f &&
              imp > 0.f && a.accept[(size_t)h * a.C + c];
    if (ok && a.lower) ok = __fsub_rn(a.util[hb], delta) >= a.lower[hb];
    if (ok && a.upper) ok = __fadd_rn(a.util[cb], delta) <= a.upper[cb];
    if (ok) ok = !sibling_on(a, o, cb) && !sibling_on(a, i, hb);
    const float v = ok ? imp : kNeg;
    if (better(v, c, best, best_i)) {
      best = v;
      best_i = c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (better(ov, oi, best, best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  __shared__ float s_v[kThreads / 32];
  __shared__ int s_i[kThreads / 32];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_v[warp] = best;
    s_i[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < (int)(blockDim.x >> 5); ++k) {
      if (better(s_v[k], s_i[k], best, best_i)) {
        best = s_v[k];
        best_i = s_i[k];
      }
    }
    // nothing feasible: every value is NEG, slot 0
    a.sel[h] = best;
    a.slot[h] = best_i < a.C ? best_i : 0;
  }
}

}  // namespace

extern "C" int cc_swap_pair(int H, int C, int RF, const int* h_ids,
                            const int* c_ids, const int* out_r,
                            const int* in_r, const uint8_t* out_has,
                            const uint8_t* in_has, const uint8_t* hot,
                            const uint8_t* cold, const float* w,
                            const float* dev_u, const float* util,
                            const float* lower, const float* upper,
                            const uint8_t* accept,
                            const int* replica_partition,
                            const int* partition_replicas,
                            const int* replica_broker, float* sel, int* slot,
                            void* stream) {
  if (H <= 0) return 0;
  Args a{H, C, RF, h_ids, c_ids, out_r, in_r, out_has, in_has, hot, cold,
         w, dev_u, util, lower, upper, accept, replica_partition,
         partition_replicas, replica_broker, sel, slot};
  swap_pair_kernel<<<H, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
