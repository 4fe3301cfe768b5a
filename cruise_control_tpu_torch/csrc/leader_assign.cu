// K4 leader_assign_pass: one pass of the leadership round's follower
// assignment.
//
// Replaces the per-pass body of leadership_round's run_tail with
// _pairwise_jitter (cruise_control_tpu/analyzer/kernels.py): per candidate
// leader row c over its RF follower options j,
//     pass_pref[c, j] = pref[c, j]                          (pass 0)
//                     = fma(amp, jitter(c, j, k), pref[c, j])
//                                               (pass k > 0, finite pref)
// masked to NEG where the option is closed --
//   multi-commit:  taken_cnt[sib_broker[c, j]] >= max_arrivals;
//   single-commit: taken_cnt[sib_broker[c, j]] > 0 or
//                  dep_cnt[src_broker[c]] > 0 --
// and for rows already assigned.  Outputs the first-max slot, its broker
// and replica, and has = cand_has[c] & (max > NEG/2); a row with no open
// option gives slot 0.  The jittered preference is one FMA (__fmaf_rn),
// rounded once, as the reference's compiled program contracts it
// (XLA:CPU; the plain version rounds it so with ops.fma_f32).
//
// Bound: memory.  Per row RF preferences, RF broker and replica ids and RF
// counter gathers (RF = 3: ~40 bytes a row); one thread per row keeps the
// row in registers.  `amp` is read from device memory, so the host never
// syncs for it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kNegHalf = -5e29f;
constexpr int kThreads = 256;

__device__ __forceinline__ float pairwise_jitter(uint32_t c, uint32_t j,
                                                 uint32_t k) {
  uint32_t x = c * 2654435761u + j * 40503u + k * 97919u;
  x ^= x >> 16;
  x *= 2246822519u;
  x ^= x >> 13;
  return __fmul_rn((float)(x & 0xFFFFFFu), 1.0f / 16777216.0f);
}

__global__ void leader_assign_kernel(
    const float* __restrict__ pref, const int* __restrict__ sib_broker,
    const int* __restrict__ sib_replica, const int* __restrict__ src_broker,
    const int* __restrict__ taken_cnt, const int* __restrict__ dep_cnt,
    const uint8_t* __restrict__ assigned, const uint8_t* __restrict__ cand_has,
    int C, int RF, int k, const float* __restrict__ amp_ptr, int multi,
    int max_arrivals, int* __restrict__ slot_out, int* __restrict__ db_out,
    int* __restrict__ dr_out, uint8_t* __restrict__ has_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float amp = *amp_ptr;
  const bool row_closed =
      assigned[c] != 0 || (!multi && dep_cnt[src_broker[c]] > 0);
  const size_t base = (size_t)c * RF;
  float bv = kNeg;
  int bs = 0;
  for (int j = 0; j < RF; ++j) {
    const float v = pref[base + j];
    float pv = v;
    if (k > 0) {
      pv = (v > kNegHalf)
               ? __fmaf_rn(amp, pairwise_jitter(c, j, k), v)
               : kNeg;
    }
    const int taken = taken_cnt[sib_broker[base + j]];
    const bool open = multi ? taken < max_arrivals : taken == 0;
    const float ov = (open && !row_closed) ? pv : kNeg;
    // first max: a later slot wins only when strictly greater
    if (j == 0 || ov > bv) {
      bv = ov;
      bs = j;
    }
  }
  slot_out[c] = bs;
  db_out[c] = sib_broker[base + bs];
  dr_out[c] = sib_replica[base + bs];
  has_out[c] = (cand_has[c] != 0) && (bv > kNegHalf);
}

}  // namespace

extern "C" int cc_leader_assign_pass(
    const float* pref, const int* sib_broker, const int* sib_replica,
    const int* src_broker, const int* taken_cnt, const int* dep_cnt,
    const uint8_t* assigned, const uint8_t* cand_has, int C, int RF, int k,
    const float* amp, int multi, int max_arrivals, int* slot, int* db,
    int* dr, uint8_t* has, void* stream) {
  if (C <= 0) return 0;
  const int blocks = (C + kThreads - 1) / kThreads;
  leader_assign_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      pref, sib_broker, sib_replica, src_broker, taken_cnt, dep_cnt,
      assigned, cand_has, C, RF, k, amp, multi, max_arrivals, slot, db, dr,
      has);
  return (int)cudaGetLastError();
}
