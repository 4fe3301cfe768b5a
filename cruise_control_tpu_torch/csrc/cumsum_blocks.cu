// K14 cumsum_blocks: the source-side prefix gate of a [B, k] candidate
// table, built on XLA:CPU's inclusive float32 row scan.
//
// Replaces the float `jnp.cumsum(..., axis=1)` prefix gates of the
// reference's round bodies (cruise_control_tpu/analyzer/kernels.py :429,
// :436, :1052, :1058; analyzer/prebalance.py :167-175).  XLA:CPU copies a
// row of one and scans a row of 2 <= n <= 16 sequentially from +0.0 (so a
// leading -0.0 becomes +0.0); every gate row has k <= 16 candidates.  The
// plain version is analyzer/kernels.py prefix_gate_plain (its scan
// ops.cumsum_f32_plain).
//
// One thread per broker row of k <= 16 candidates computes the whole gate
// in registers: wm = has ? w : 0, has &= scan(wm) - wm < excess[b]; then
// for each term t in order tw = has ? w_t[max(cand, 0)] : 0 and has &=
// (j == 0) | (scan(tw) <= hr_t[b]).  The term weights are gathered from the
// candidate ids inside the kernel, eight terms' gathers at a time in flight
// (four at k > 8), a warp a block so that the gathers spread over the SMs,
// and `has` is written once.  Every add is fadd_rn and the subtraction one
// fsub_rn.  Bound: memory (each input read once, each output written
// once); at the main path's [B, k] the launch and one or two dependent
// loads dominate.

#include <cuda_runtime.h>
#include <stdint.h>

// The gate's terms: weights w[t][max(cand, 0) * w_stride[t]] (null: 1.0)
// and headrooms hr[t][b * hr_stride[t]].
constexpr int kMaxTerms = 16;
struct GateTerms {
  const float* w[kMaxTerms];
  long long w_stride[kMaxTerms];
  const float* hr[kMaxTerms];
  long long hr_stride[kMaxTerms];
};

namespace {

constexpr int kGroup = 16;
constexpr int kGateThreads = 32;

template <int KM>
__global__ void prefix_gate_kernel(const uint8_t* __restrict__ has_in,
                                   const float* __restrict__ w,
                                   const float* __restrict__ excess,
                                   long long ex_stride,
                                   const int* __restrict__ cand, int B,
                                   int k, int T, const GateTerms terms,
                                   uint8_t* __restrict__ has_out) {
  // terms gathered at once: every weight of a batch in flight together
  constexpr int kBatch = KM <= 8 ? 8 : 4;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long base = (long long)b * k;
  bool h[KM];
  float v[KM];
  int id[KM];
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j < k) {
      h[j] = has_in[base + j] != 0;
      v[j] = w[base + j];
      id[j] = max(cand[base + j], 0);
    }
  }
  const float ex = excess[b * ex_stride];
  // step 1: the excess still uncovered before each candidate
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j < k) {
      const float wm = h[j] ? v[j] : 0.f;
      s = j == 0 ? (k > 1 ? __fadd_rn(0.f, wm) : wm) : __fadd_rn(s, wm);
      h[j] = h[j] && __fsub_rn(s, wm) < ex;
    }
  }
  // step 2: the terms in order, a batch of terms' gathers issued before
  // the first of them is used
#pragma unroll
  for (int t0 = 0; t0 < kMaxTerms; t0 += kBatch) {
    if (t0 >= T) continue;
    float tw[kBatch][KM];
    float hr[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u;
      if (t < T) {
        hr[u] = terms.hr[t][b * terms.hr_stride[t]];
        const float* wt = terms.w[t];
        const long long ws = terms.w_stride[t];
#pragma unroll
        for (int j = 0; j < KM; ++j) {
          if (j < k) tw[u][j] = wt != nullptr ? wt[id[j] * ws] : 1.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (t0 + u < T) {
        float si = 0.f;
#pragma unroll
        for (int j = 0; j < KM; ++j) {
          if (j < k) {
            const float x = h[j] ? tw[u][j] : 0.f;
            si = j == 0 ? (k > 1 ? __fadd_rn(0.f, x) : x) : __fadd_rn(si, x);
            h[j] = h[j] && (j == 0 || si <= hr[u]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j < k) has_out[base + j] = h[j];
  }
}

}  // namespace

// The gate: has_in, has_out u8[B * k]; w f32[B * k]; cand i32[B * k] (-1:
// none); excess f32 at b * ex_stride; T <= 16 terms; 1 <= k <= 16.
extern "C" int cc_prefix_gate(const uint8_t* has_in, const float* w,
                              const float* excess, long long ex_stride,
                              const int* cand, int B, int k, int T,
                              const GateTerms* terms, uint8_t* has_out,
                              void* stream) {
  if (B <= 0) return 0;
  if (k < 1 || k > kGroup || T < 0 || T > kMaxTerms)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // a warp a block: the rows' scattered weight gathers spread over as
  // many SMs as there are warps of rows
  const int blocks = (B + kGateThreads - 1) / kGateThreads;
  if (k <= 4)
    prefix_gate_kernel<4><<<blocks, kGateThreads, 0, st>>>(
        has_in, w, excess, ex_stride, cand, B, k, T, *terms, has_out);
  else if (k <= 8)
    prefix_gate_kernel<8><<<blocks, kGateThreads, 0, st>>>(
        has_in, w, excess, ex_stride, cand, B, k, T, *terms, has_out);
  else
    prefix_gate_kernel<16><<<blocks, kGateThreads, 0, st>>>(
        has_in, w, excess, ex_stride, cand, B, k, T, *terms, has_out);
  return (int)cudaGetLastError();
}
