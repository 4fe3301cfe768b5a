// K9 segment_argmax: per segment, the lowest index of the max-score valid
// element.
//
// Replaces per_segment_argmax (cruise_control_tpu/analyzer/kernels.py),
// which every move, swap, leadership and pre-balance round calls through
// resolve_dest_conflicts, and which the intra-broker disk round calls
// three times.  For segment s over the elements i with segment[i] == s
// (ids outside [0, S) are dropped, as jax.ops.segment_max drops them):
//     masked[i] = valid[i] ? score[i] : NEG
//     max[s]    = max masked[i]          (-inf for an empty segment)
//     has[s]    = max[s] > NEG / 2
//     arg[s]    = has[s] ? the lowest i with valid[i] and masked[i] ==
//                 max[s] : -1
// The reference's `masked >= seg_max` ties -0.0 with +0.0, so -0.0 is
// canonicalised to +0.0 before packing.  When has[s] holds, the winner is
// valid: invalid elements sit at NEG, below NEG / 2.
//
// Design: one 64-bit key per element, the score's order-preserving uint32
// in the high half and ~i in the low half (so the lowest index wins a
// tie), folded per segment with an integer atomicMax: exact in any thread
// order.  A zero key marks an empty segment (every element's key has a
// non-zero low half below 2**31 elements).  A second launch decodes the S
// keys.
//
// Bound: memory.  Each element's score, id and flag are read once (9
// bytes), each segment's key written by atomics and read once, and the
// three outputs written (9 bytes a segment).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kNegHalf = -5e29f;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t order_key(float f) {
  if (f == 0.f) f = 0.f;  // -0.0 ties +0.0
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__global__ void fold_kernel(const float* __restrict__ score,
                            const int* __restrict__ segment,
                            const uint8_t* __restrict__ valid, int n, int S,
                            unsigned long long* __restrict__ keys) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int s = segment[i];
    if (s < 0 || s >= S) continue;
    const float v = valid[i] ? score[i] : kNeg;
    const unsigned long long key =
        ((unsigned long long)order_key(v) << 32) | (uint32_t)(~(uint32_t)i);
    atomicMax(keys + s, key);
  }
}

__global__ void decode_kernel(const unsigned long long* __restrict__ keys,
                              int S, int* __restrict__ arg,
                              float* __restrict__ max_out,
                              uint8_t* __restrict__ has) {
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < S;
       s += gridDim.x * blockDim.x) {
    const unsigned long long key = keys[s];
    if (key == 0ull) {
      arg[s] = -1;
      max_out[s] = -__int_as_float(0x7f800000);  // -inf
      has[s] = 0;
      continue;
    }
    const float v = order_value((uint32_t)(key >> 32));
    const bool h = v > kNegHalf;
    max_out[s] = v;
    has[s] = h;
    arg[s] = h ? (int)(~(uint32_t)(key & 0xFFFFFFFFull)) : -1;
  }
}

int grid_for(int n) {
  const int blocks = (n + kThreads - 1) / kThreads;
  return blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096;
}

}  // namespace

// keys: scratch of S 64-bit words (zeroed here).
extern "C" int cc_segment_argmax(const float* score, const int* segment,
                                 const uint8_t* valid, int n, int S,
                                 unsigned long long* keys, int* arg,
                                 float* max_out, uint8_t* has,
                                 void* stream) {
  if (S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(keys, 0, sizeof(unsigned long long) * S,
                                    st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0)
    fold_kernel<<<grid_for(n), kThreads, 0, st>>>(score, segment, valid, n,
                                                   S, keys);
  decode_kernel<<<grid_for(S), kThreads, 0, st>>>(keys, S, arg, max_out,
                                                  has);
  return (int)cudaGetLastError();
}
