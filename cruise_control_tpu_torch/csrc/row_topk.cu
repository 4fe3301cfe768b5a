// K1 row_topk: per-broker top-k of a NEG-masked [B, S] score plane.
//
// Replaces rows_pick_topk / rows_pick_best of
// cruise_control_tpu/analyzer/kernels.py (jax.lax.top_k over the
// resident broker table, then a gather of the winning slots' replica ids).
//
// Order: score descending, then slot ascending -- jax.lax.top_k's
// lower-index-first tie rule.  has = score > NEG/2; cand = the table's
// replica id at the slot, or -1.
//
// Bound: memory.  One read of B*S*(4+4) bytes (1.8 MB at B=200, S=1152:
// about 0.6 us at 3.35 TB/s), so at the slice's shapes the launch, not
// the bytes, sets the time.  Design: one block per broker row; each
// thread keeps a register-resident sorted top-k of a strided slice of the
// row (coalesced loads, k <= 8 unrolled through a template), then the
// block merges the per-thread lists in k rounds of a warp-shuffle +
// shared-memory argmax.  No allocation, no sync with the host.

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
                                float* __restrict__ top) {
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

template <int K>
void launch(const float* sc, const int* table, int B, int S, int* cand,
            uint8_t* has, float* top, cudaStream_t stream) {
  row_topk_kernel<K><<<B, kThreads, 0, stream>>>(sc, table, S, cand, has,
                                                  top);
}

}  // namespace

extern "C" int cc_row_topk(const float* sc, const int* table, int B, int S,
                           int k, int* cand, uint8_t* has, float* top,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  switch (k) {
    case 1: launch<1>(sc, table, B, S, cand, has, top, st); break;
    case 2: launch<2>(sc, table, B, S, cand, has, top, st); break;
    case 3: launch<3>(sc, table, B, S, cand, has, top, st); break;
    case 4: launch<4>(sc, table, B, S, cand, has, top, st); break;
    case 5: launch<5>(sc, table, B, S, cand, has, top, st); break;
    case 6: launch<6>(sc, table, B, S, cand, has, top, st); break;
    case 7: launch<7>(sc, table, B, S, cand, has, top, st); break;
    case 8: launch<8>(sc, table, B, S, cand, has, top, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
