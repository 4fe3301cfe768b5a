// K11 dest_feasibility: the structural terms of the move rounds'
// candidate x destination plane, and the candidate-level destination
// guard.
//
// Replaces, in cruise_control_tpu/analyzer/kernels.py:
//  * _dest_feasibility's structural terms (entry cc_dest_struct): for
//    candidate replica r = cand_r[c] and destination d = dest_ids[k],
//        out[c, k] = dest_ok[d] && d != replica_broker[r]
//                    && no sibling replica of r's partition on d
//    (the sibling test only when partition_replicas is given; sibling
//    brokers are -1 where partition_replicas is -1).  The caller ANDs the
//    composed acceptance stack, which calls the prior goals' Python
//    callbacks, onto this plane with torch ops.
//  * cand_has_dest's (and feasible_dest_exists') blocked-best reduction
//    (entry cc_dest_has): given the top RF+2 headroom brokers top_b with
//    headrooms top_h (the caller's stable top-k over the brokers),
//        best[c] = max over j of (top_b[j] is the broker of one of r's
//                  partition's replicas ? -inf : top_h[j])
//        out[c]  = best[c] >= w_c[c]
//    with r = cand_r[c], or r = c over every replica when cand_r is null.
//
// Bound: memory.  The plane is C*K output bytes with a broadcast read of
// each candidate's broker and RF sibling brokers and of dest_ok per
// column; a thread per plane entry, grid-stride.  The guard is a thread
// per candidate over RF x (RF + 2) compares in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTop = 32;

__device__ __forceinline__ int sibling_broker(const int* partition_replicas,
                                              const int* replica_broker,
                                              int row, int RF, int j) {
  const int s = partition_replicas[(size_t)row * RF + j];
  return s >= 0 ? replica_broker[s] : -1;
}

__global__ void dest_struct_kernel(int C, int K, int RF,
                                   const int* __restrict__ cand_r,
                                   const int* __restrict__ dest_ids,
                                   const uint8_t* __restrict__ dest_ok,
                                   const int* __restrict__ replica_broker,
                                   const int* __restrict__ replica_partition,
                                   const int* __restrict__ partition_replicas,
                                   uint8_t* __restrict__ out) {
  const long long total = (long long)C * K;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(e / K);
    const int k = (int)(e - (long long)c * K);
    const int d = dest_ids[k];
    const int r = cand_r[c];
    bool ok = dest_ok[d] && d != replica_broker[r];
    if (ok && partition_replicas) {
      const int row = replica_partition[r];
      for (int j = 0; j < RF; ++j)
        ok &= sibling_broker(partition_replicas, replica_broker, row, RF,
                             j) != d;
    }
    out[e] = ok;
  }
}

__global__ void dest_has_kernel(int C, int RF, int nt,
                                const int* __restrict__ cand_r,
                                const float* __restrict__ w_c,
                                const int* __restrict__ top_b,
                                const float* __restrict__ top_h,
                                const int* __restrict__ replica_broker,
                                const int* __restrict__ replica_partition,
                                const int* __restrict__ partition_replicas,
                                uint8_t* __restrict__ out) {
  __shared__ int s_b[kMaxTop];
  __shared__ float s_h[kMaxTop];
  if (threadIdx.x < nt) {
    s_b[threadIdx.x] = top_b[threadIdx.x];
    s_h[threadIdx.x] = top_h[threadIdx.x];
  }
  __syncthreads();
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < C;
       c += gridDim.x * blockDim.x) {
    const int r = cand_r ? cand_r[c] : c;
    const int row = replica_partition[r];
    float best = -__int_as_float(0x7f800000);  // -inf
    uint32_t blocked = 0;
    for (int j = 0; j < RF; ++j) {
      const int sb = sibling_broker(partition_replicas, replica_broker, row,
                                    RF, j);
      for (int t = 0; t < nt; ++t) blocked |= (uint32_t)(sb == s_b[t]) << t;
    }
    for (int t = 0; t < nt; ++t)
      if (!((blocked >> t) & 1u)) best = fmaxf(best, s_h[t]);
    out[c] = best >= w_c[c];
  }
}

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 8192 ? (blocks > 0 ? blocks : 1) : 8192);
}

}  // namespace

// partition_replicas may be null (no sibling test); RF is then ignored.
extern "C" int cc_dest_struct(int C, int K, int RF, const int* cand_r,
                              const int* dest_ids, const uint8_t* dest_ok,
                              const int* replica_broker,
                              const int* replica_partition,
                              const int* partition_replicas, uint8_t* out,
                              void* stream) {
  if (C <= 0 || K <= 0) return 0;
  dest_struct_kernel<<<grid_for((long long)C * K), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      C, K, RF, cand_r, dest_ids, dest_ok, replica_broker, replica_partition,
      partition_replicas, out);
  return (int)cudaGetLastError();
}

// cand_r may be null: the candidates are the replicas 0 .. C-1.  nt <= 32.
extern "C" int cc_dest_has(int C, int RF, int nt, const int* cand_r,
                           const float* w_c, const int* top_b,
                           const float* top_h, const int* replica_broker,
                           const int* replica_partition,
                           const int* partition_replicas, uint8_t* out,
                           void* stream) {
  if (C <= 0) return 0;
  if (nt < 0 || nt > kMaxTop) return (int)cudaErrorInvalidValue;
  dest_has_kernel<<<grid_for(C), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      C, RF, nt, cand_r, w_c, top_b, top_h, replica_broker,
      replica_partition, partition_replicas, out);
  return (int)cudaGetLastError();
}
