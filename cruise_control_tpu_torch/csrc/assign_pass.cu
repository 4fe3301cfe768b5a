// K2 assign_pass: one pass of the destination assignment.
//
// Replaces the pass body of assign_destinations with _pairwise_jitter
// (cruise_control_tpu/analyzer/kernels.py, the loop over passes): per
// candidate row c, the first-max slot of
//     pass_pref[c, j] = pref[c, j]                         (pass 0)
//                     = pref[c, j] + amp * jitter(c, j, k) (pass k > 0,
//                                                           finite pref)
// over the open destination slots j, masked to NEG for closed slots and
// already-assigned rows; has = cand_has[c] & (max > NEG/2).  The jitter is
// the reference's exact uint32 hash of (row, shortlist slot, pass).
// Rounding matches the reference: the product and the sum are rounded
// separately (__fmul_rn/__fadd_rn keep nvcc from contracting them into
// an FMA).
//
// Bound: memory -- C*K*4 bytes of preferences per pass (2 MB at C=2048,
// K=256), 8 passes per assignment.  Design: one warp per candidate row,
// lanes stride the row (coalesced), the jitter is recomputed in registers
// instead of read from a [C, K] plane, and a shuffle argmax keeps the
// lowest slot on ties.  `amp` is read from device memory so the host
// never syncs for it.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kNegHalf = -5e29f;
constexpr int kThreads = 256;

__device__ __forceinline__ bool better(float v, int s, float u, int t) {
  return v > u || (v == u && s < t);
}

__device__ __forceinline__ float pairwise_jitter(uint32_t c, uint32_t j,
                                                 uint32_t k) {
  uint32_t x = c * 2654435761u + j * 40503u + k * 97919u;
  x ^= x >> 16;
  x *= 2246822519u;
  x ^= x >> 13;
  return __fmul_rn((float)(x & 0xFFFFFFu), 1.0f / 16777216.0f);
}

__global__ void assign_pass_kernel(const float* __restrict__ pref,
                                   const uint8_t* __restrict__ dest_open,
                                   const uint8_t* __restrict__ assigned,
                                   const uint8_t* __restrict__ cand_has,
                                   int C, int K, int k,
                                   const float* __restrict__ amp_ptr,
                                   int* __restrict__ best_slot,
                                   uint8_t* __restrict__ has) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= C) return;  // whole warps exit together
  const float amp = *amp_ptr;
  const bool row_closed = assigned[c] != 0;
  const float* row = pref + (size_t)c * K;
  float bv = -INFINITY;
  int bs = INT_MAX;
  for (int j = lane; j < K; j += 32) {
    const float v = row[j];
    float pv = v;
    if (k > 0) {
      pv = (v > kNegHalf)
               ? __fadd_rn(v, __fmul_rn(amp, pairwise_jitter(c, j, k)))
               : kNeg;
    }
    const float ov = (dest_open[j] && !row_closed) ? pv : kNeg;
    if (better(ov, j, bv, bs)) {
      bv = ov;
      bs = j;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int os = __shfl_down_sync(0xffffffffu, bs, off);
    if (better(ov, os, bv, bs)) {
      bv = ov;
      bs = os;
    }
  }
  if (lane == 0) {
    best_slot[c] = bs;
    has[c] = (cand_has[c] != 0) && (bv > kNegHalf);
  }
}

}  // namespace

extern "C" int cc_assign_pass(const float* pref, const uint8_t* dest_open,
                              const uint8_t* assigned,
                              const uint8_t* cand_has, int C, int K, int k,
                              const float* amp, int* best_slot,
                              uint8_t* has, void* stream) {
  if (C <= 0) return 0;
  const int warps_per_block = kThreads / 32;
  const int blocks = (C + warps_per_block - 1) / warps_per_block;
  assign_pass_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      pref, dest_open, assigned, cand_has, C, K, k, amp, best_slot, has);
  return (int)cudaGetLastError();
}
