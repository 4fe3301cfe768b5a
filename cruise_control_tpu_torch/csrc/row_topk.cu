// K1 row_topk: per-broker top-k of a NEG-masked [B, S] score plane.
//
// Replaces rows_pick_topk / rows_pick_best of
// cruise_control_tpu/analyzer/kernels.py (jax.lax.top_k over the
// resident broker table, then a gather of the winning slots' replica ids)
// and leadership_round's jax.lax.top_k(bonus_rows, 16) and deep_pick's
// top_k(..., 64).
//
// Order: score descending, then slot ascending -- jax.lax.top_k's
// lower-index-first tie rule.  has = score > NEG/2; cand = the table's
// replica id at the slot, or -1; slot = the winning slot.
//
// Bound: memory.  One read of B*S*4 bytes of scores (0.9 MB at B=200,
// S=1152: about 0.3 us at 3.35 TB/s), so at the slice's shapes the launch,
// not the bytes, sets the time.  Two code paths:
//   * k <= 8: one block per broker row; each thread keeps a register-
//     resident sorted top-k of a strided slice of the row (coalesced
//     loads, unrolled through a template), then the block merges the
//     per-thread lists in k rounds of a warp-shuffle + shared-memory
//     argmax.
//   * 8 < k <= 64: one warp per row; each lane keeps a sorted list of its
//     8 best in registers, k rounds of a shuffle argmax pop the winning
//     lane's head, and a lane whose list runs dry rescans its slice for
//     the next 8 strictly after the last one it gave out (the order is
//     total, so nothing is lost or repeated).  No block barriers.
// No allocation, no sync with the host.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;
constexpr float kNegHalf = -5e29f;

__device__ __forceinline__ bool better(float v, int s, float u, int t) {
  return v > u || (v == u && s < t);
}

template <int K>
__global__ void row_topk_kernel(const float* __restrict__ sc,
                                const int* __restrict__ table, int S,
                                int* __restrict__ cand,
                                uint8_t* __restrict__ has,
                                float* __restrict__ top,
                                int* __restrict__ slot) {
  const int b = blockIdx.x;
  const float* row = sc + (size_t)b * S;
  float lv[K];
  int ls[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    lv[i] = -INFINITY;
    ls[i] = INT_MAX;
  }
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    float v = row[j];
    int s = j;
#pragma unroll
    for (int p = 0; p < K; ++p) {
      if (better(v, s, lv[p], ls[p])) {
        float tv = lv[p];
        int ts = ls[p];
        lv[p] = v;
        ls[p] = s;
        v = tv;
        s = ts;
      }
    }
  }

  __shared__ float w_v[kThreads / 32];
  __shared__ int w_s[kThreads / 32];
  __shared__ float win_v;
  __shared__ int win_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = 0; i < K; ++i) {
    float v = lv[0];
    int s = ls[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_down_sync(0xffffffffu, v, off);
      int os = __shfl_down_sync(0xffffffffu, s, off);
      if (better(ov, os, v, s)) {
        v = ov;
        s = os;
      }
    }
    if (lane == 0) {
      w_v[warp] = v;
      w_s[warp] = s;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float bv = w_v[0];
      int bs = w_s[0];
      for (int w = 1; w < kThreads / 32; ++w) {
        if (better(w_v[w], w_s[w], bv, bs)) {
          bv = w_v[w];
          bs = w_s[w];
        }
      }
      win_v = bv;
      win_s = bs;
      const int o = b * K + i;
      const bool h = bv > kNegHalf;
      top[o] = (bs == INT_MAX) ? kNeg : bv;
      has[o] = h;
      cand[o] = (h && bs != INT_MAX) ? table[(size_t)b * S + bs] : -1;
      slot[o] = bs;
    }
    __syncthreads();
    if (ls[0] == win_s) {  // the winner pops its head
#pragma unroll
      for (int p = 0; p + 1 < K; ++p) {
        lv[p] = lv[p + 1];
        ls[p] = ls[p + 1];
      }
      lv[K - 1] = -INFINITY;
      ls[K - 1] = INT_MAX;
    }
    __syncthreads();
  }
}

// Insert (v, s) into a sorted list of L (best first) when it beats the
// list's tail.
template <int L>
__device__ __forceinline__ void insert(float (&lv)[L], int (&ls)[L],
                                       float v, int s) {
  if (!better(v, s, lv[L - 1], ls[L - 1])) return;
#pragma unroll
  for (int p = 0; p < L; ++p) {
    if (better(v, s, lv[p], ls[p])) {
      float tv = lv[p];
      int ts = ls[p];
      lv[p] = v;
      ls[p] = s;
      v = tv;
      s = ts;
    }
  }
}

constexpr int kDeepList = 8;

__global__ void row_topk_deep_kernel(const float* __restrict__ sc,
                                     const int* __restrict__ table, int B,
                                     int S, int k, int* __restrict__ cand,
                                     uint8_t* __restrict__ has,
                                     float* __restrict__ top,
                                     int* __restrict__ slot) {
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= B) return;  // whole warps exit together
  const float* row = sc + (size_t)b * S;
  float lv[kDeepList];
  int ls[kDeepList];
  // the last element this lane gave out; the next refill starts after it
  float last_v = INFINITY;
  int last_s = -1;
  int head = kDeepList;  // forces the first fill
  for (int i = 0; i < k; ++i) {
    if (head == kDeepList) {
#pragma unroll
      for (int p = 0; p < kDeepList; ++p) {
        lv[p] = -INFINITY;
        ls[p] = INT_MAX;
      }
      for (int j = lane; j < S; j += 32) {
        const float v = row[j];
        if (better(last_v, last_s, v, j)) insert<kDeepList>(lv, ls, v, j);
      }
      head = 0;
    }
    // the lane's current head (registers indexed by a loop variable stay
    // in registers through the unrolled select)
    float hv = -INFINITY;
    int hs = INT_MAX;
#pragma unroll
    for (int p = 0; p < kDeepList; ++p) {
      if (p == head) {
        hv = lv[p];
        hs = ls[p];
      }
    }
    float v = hv;
    int s = hs;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int os = __shfl_xor_sync(0xffffffffu, s, off);
      if (better(ov, os, v, s)) {
        v = ov;
        s = os;
      }
    }
    if (lane == 0) {
      const int o = b * k + i;
      const bool h = v > kNegHalf;
      top[o] = (s == INT_MAX) ? kNeg : v;
      has[o] = h;
      cand[o] = (h && s != INT_MAX) ? table[(size_t)b * S + s] : -1;
      slot[o] = s;
    }
    if (hs == s && s != INT_MAX) {  // the winner pops its head
      last_v = hv;
      last_s = hs;
      ++head;
    }
  }
}

template <int K>
void launch(const float* sc, const int* table, int B, int S, int* cand,
            uint8_t* has, float* top, int* slot, cudaStream_t stream) {
  row_topk_kernel<K><<<B, kThreads, 0, stream>>>(sc, table, S, cand, has,
                                                  top, slot);
}

}  // namespace

extern "C" int cc_row_topk(const float* sc, const int* table, int B, int S,
                           int k, int* cand, uint8_t* has, float* top,
                           int* slot, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  switch (k) {
    case 1: launch<1>(sc, table, B, S, cand, has, top, slot, st); break;
    case 2: launch<2>(sc, table, B, S, cand, has, top, slot, st); break;
    case 3: launch<3>(sc, table, B, S, cand, has, top, slot, st); break;
    case 4: launch<4>(sc, table, B, S, cand, has, top, slot, st); break;
    case 5: launch<5>(sc, table, B, S, cand, has, top, slot, st); break;
    case 6: launch<6>(sc, table, B, S, cand, has, top, slot, st); break;
    case 7: launch<7>(sc, table, B, S, cand, has, top, slot, st); break;
    case 8: launch<8>(sc, table, B, S, cand, has, top, slot, st); break;
    default: {
      if (k > 64 || k > S) return (int)cudaErrorInvalidValue;
      const int warps = kThreads / 32;
      row_topk_deep_kernel<<<(B + warps - 1) / warps, kThreads, 0, st>>>(
          sc, table, B, S, k, cand, has, top, slot);
    }
  }
  return (int)cudaGetLastError();
}
