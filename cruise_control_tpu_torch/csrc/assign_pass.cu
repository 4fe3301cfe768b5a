// K2 assign_pass: one pass of the destination assignment, with the pass's
// glue.
//
// Replaces the pass body of assign_destinations with _pairwise_jitter
// (cruise_control_tpu/analyzer/kernels.py, the loop over passes, and the
// amplitude `amp` above it).  Per candidate row c:
//   * the previous pass's fold: where keep[c], dest[c] = prev_best[c] and
//     assigned[c] = 1 (both updated in place);
//   * the first-max slot of
//       pass_pref[c, j] = pref[c, j]                         (pass 0)
//                       = fma(amp, jitter(c, j, k), pref[c, j])
//                                                 (pass k > 0, finite pref)
//     over the open slots j -- taken_cnt[dest_ids[j]] < cap[dest_ids[j]],
//     cap 1 without a cap array (one arrival a destination) -- masked to
//     NEG for closed slots and assigned rows; best[c] = dest_ids[slot] (a
//     broker id) and has = cand_has[c] & (max > NEG/2).
// The jitter is the reference's exact uint32 hash of (row, shortlist slot,
// pass).  The pass-0 launch also reduces the plane's finite (> NEG/2) max
// and min, and the last block to finish writes
//   amp = fma(0.35f, isfinite(max - min) ? max - min : 0, 1e-6f)
// into device memory, so the host never syncs for it.  The amplitude and
// the jittered preference are each one FMA (__fmaf_rn), rounded once, as
// the reference's compiled program contracts them (XLA:CPU); the port's
// plain version rounds them so with ops.fma_f32.
//
// Bound: memory -- C*K*4 bytes of preferences per pass (2 MB at C=2048,
// K=256; 42.6 MB at C=4096, K=2600), 8 passes per assignment.  Design:
// each block copies the shortlist's broker ids and builds its open mask
// once in shared memory; one warp per candidate row reads the row with
// float4 loads (K % 4 == 0; a scalar walk otherwise), four in flight a
// lane; the amplitude, the row's flags and the first chunk of a warp's
// first row are loaded before the mask is built, so the mask's two
// dependent loads overlap them; a row already assigned (outside pass 0)
// writes its fixed answer -- slot 0's broker, has false -- without reading
// the plane; pass 0 and the jittered passes are separate instantiations;
// a shuffle argmax keeps the lowest slot on ties; the amplitude's max and
// min are order-free, so they go through atomics on a per-stream counter
// slot that the last block resets.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kNegHalf = -5e29f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1056;
constexpr int kChunk = 4;  // float4 loads in flight a lane
constexpr int kSlots = 72;
constexpr int kMaxK = 46000;

// per stream slot: the ordered max, the complemented ordered min, the
// finished-block count; zero between launches
__device__ unsigned int g_amp_state[kSlots][4];

struct PassArgs {
  const float* pref;
  int C;
  int K;
  const int* dest_ids;
  const int* taken;
  const int* cap;  // null: 1
  const uint8_t* cand_has;
  int k;
  float* amp;
  uint8_t* assigned;
  int* dest;
  const uint8_t* keep;  // null: no fold
  const int* prev_best;
  int* best;
  uint8_t* has;
  int slot;
};

__device__ __forceinline__ bool better(float v, int s, float u, int t) {
  return v > u || (v == u && s < t);
}

// the reference's uint32 hash of (row, slot, pass), `x` = its first line
__device__ __forceinline__ float jitter_of(uint32_t x) {
  x ^= x >> 16;
  x *= 2246822519u;
  x ^= x >> 13;
  return __fmul_rn((float)(x & 0xFFFFFFu), 1.0f / 16777216.0f);
}

// float -> uint32 whose unsigned order is the float order (NaN excluded)
__device__ __forceinline__ unsigned int ordered(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned int e) {
  return __uint_as_float((e & 0x80000000u) ? (e & 0x7FFFFFFFu) : ~e);
}

// A row's flags, loaded before they are needed.
struct Row {
  bool live;     // not assigned and not kept by the pass before
  bool cand;     // cand_has
  bool folded;   // kept by the pass before: dest = prev_best
  int prev;
};

__device__ __forceinline__ Row load_row(const PassArgs& a, int c) {
  Row r;
  const bool kept = a.keep != nullptr && a.keep[c] != 0;
  r.folded = kept;
  r.prev = kept ? a.prev_best[c] : 0;
  r.live = !kept && a.assigned[c] == 0;
  r.cand = a.cand_has[c] != 0;
  return r;
}

// One slot: the row's argmax so far (lanes visit their slots in
// ascending order, so a strictly greater value wins) and, in pass 0, the
// finite max and min.
template <bool kFirst>
__device__ __forceinline__ void take(float v, int j, bool open, bool live,
                                     uint32_t hash0, float amp, float& bv,
                                     int& bs, float& lmax, float& lmin) {
  float ov;
  if (kFirst) {
    if (v > kNegHalf) {
      lmax = fmaxf(lmax, v);
      lmin = fminf(lmin, v);
    }
    ov = v;
  } else {
    ov = (v > kNegHalf)
             ? __fmaf_rn(amp, jitter_of(hash0 + j * 40503u), v)
             : kNeg;
  }
  ov = (open && live) ? ov : kNeg;
  if (ov > bv) {
    bv = ov;
    bs = j;
  }
}

template <bool kVec, bool kFirst>
__global__ void __launch_bounds__(kThreads)
    assign_pass_kernel(PassArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int K = a.K;
  int* ids_s = reinterpret_cast<int*>(smem);
  uint8_t* open_s = smem + 4 * (size_t)((K + 3) & ~3);
  __shared__ float red_max[kWarps];
  __shared__ float red_min[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  const int K4 = K >> 2;

  // first what does not wait for the mask: the amplitude, the first
  // row's flags and its first chunk (read whether or not the row is
  // still open)
  const float amp = kFirst ? 0.f : *a.amp;
  int c = blockIdx.x * kWarps + warp;
  Row row{};
  float4 t[kChunk];
  if (c < a.C) {
    row = load_row(a, c);
    if (kVec) {
      const float4* row4 =
          reinterpret_cast<const float4*>(a.pref + (size_t)c * K);
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int q = lane + 32 * u;
        if (q < K4) t[u] = row4[q];
      }
    }
  }
  for (int j = threadIdx.x; j < K; j += kThreads) {
    const int d = a.dest_ids[j];
    ids_s[j] = d;
    open_s[j] = a.taken[d] < (a.cap != nullptr ? a.cap[d] : 1);
  }
  __syncthreads();

  float lmax = -INFINITY;
  float lmin = INFINITY;
  while (c < a.C) {
    if (row.folded && lane == 0) {
      a.dest[c] = row.prev;
      a.assigned[c] = 1;
    }
    float bv = -INFINITY;
    int bs = INT_MAX;
    if (row.live || kFirst) {
      const uint32_t hash0 =
          (uint32_t)c * 2654435761u + (uint32_t)a.k * 97919u;
      if (kVec) {
        const float4* row4 =
            reinterpret_cast<const float4*>(a.pref + (size_t)c * K);
        if (lane < K4) bs = 4 * lane;
        for (int q0 = 0; q0 < K4; q0 += 32 * kChunk) {
          if (q0 > 0) {
#pragma unroll
            for (int u = 0; u < kChunk; ++u) {
              const int q = q0 + lane + 32 * u;
              if (q < K4) t[u] = row4[q];
            }
          }
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            const int q = q0 + lane + 32 * u;
            if (q < K4) {
              const uchar4 o = reinterpret_cast<const uchar4*>(open_s)[q];
              const int j = 4 * q;
              take<kFirst>(t[u].x, j, o.x, row.live, hash0, amp, bv, bs,
                           lmax, lmin);
              take<kFirst>(t[u].y, j + 1, o.y, row.live, hash0, amp, bv, bs,
                           lmax, lmin);
              take<kFirst>(t[u].z, j + 2, o.z, row.live, hash0, amp, bv, bs,
                           lmax, lmin);
              take<kFirst>(t[u].w, j + 3, o.w, row.live, hash0, amp, bv, bs,
                           lmax, lmin);
            }
          }
        }
      } else {
        const float* rp = a.pref + (size_t)c * K;
        if (lane < K) bs = lane;
        for (int j = lane; j < K; j += 32) {
          take<kFirst>(rp[j], j, open_s[j], row.live, hash0, amp, bv, bs,
                       lmax, lmin);
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
    }
    if (lane == 0) {
      // a row closed before the pass: slot 0's broker, has false
      const bool scanned = row.live || kFirst;
      a.best[c] = ids_s[scanned ? bs : 0];
      a.has[c] = row.cand && row.live && bv > kNegHalf;
    }
    c += stride;
    if (c < a.C) {
      row = load_row(a, c);
      if (kVec && (row.live || kFirst)) {
        const float4* row4 =
            reinterpret_cast<const float4*>(a.pref + (size_t)c * K);
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int q = lane + 32 * u;
          if (q < K4) t[u] = row4[q];
        }
      }
    }
  }

  if (!kFirst) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, off));
    lmin = fminf(lmin, __shfl_xor_sync(0xffffffffu, lmin, off));
  }
  if (lane == 0) {
    red_max[warp] = lmax;
    red_min[warp] = lmin;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bmax = red_max[0];
    float bmin = red_min[0];
    for (int w = 1; w < kWarps; ++w) {
      bmax = fmaxf(bmax, red_max[w]);
      bmin = fminf(bmin, red_min[w]);
    }
    unsigned int* st = g_amp_state[a.slot];
    atomicMax(&st[0], ordered(bmax));
    atomicMax(&st[1], ~ordered(bmin));
    __threadfence();
    if (atomicAdd(&st[2], 1u) == gridDim.x - 1) {
      __threadfence();
      const float pmax = unordered(atomicExch(&st[0], 0u));
      const float pmin = unordered(~atomicExch(&st[1], 0u));
      atomicExch(&st[2], 0u);
      const float d = __fsub_rn(pmax, pmin);
      const float spread = isfinite(d) ? d : 0.f;
      *a.amp = __fmaf_rn(0.35f, spread, 1e-6f);
    }
  }
}

}  // namespace

// pref f32[C, K]; dest_ids i32[K]; taken_cnt (and cap, or null) i32[B];
// cand_has, assigned u8[C]; dest, prev_best i32[C] (keep null: no fold);
// best i32[C], has u8[C] out; amp f32 (written when k == 0, read after);
// slot: the stream's counter slot (< 72).  1 <= K <= 46,000 (the ids and
// the mask in shared memory).
extern "C" int cc_assign_pass(const float* pref, int C, int K,
                              const int* dest_ids, const int* taken_cnt,
                              const int* cap, const uint8_t* cand_has, int k,
                              float* amp, uint8_t* assigned, int* dest,
                              const uint8_t* keep, const int* prev_best,
                              int* best, uint8_t* has, int slot,
                              void* stream) {
  if (C <= 0 || K <= 0 || K > kMaxK || slot < 0 || slot >= kSlots)
    return (int)cudaErrorInvalidValue;
  PassArgs a{pref,     C,    K,   dest_ids, taken_cnt, cap,
             cand_has, k,    amp, assigned, dest,      keep,
             prev_best, best, has, slot};
  int blocks = (C + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  // the shortlist's broker ids, then its open mask
  const size_t smem = 4 * (size_t)((K + 3) & ~3) + (size_t)K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(pref) % 16 == 0;
  void (*kernel)(PassArgs) =
      vec ? (k == 0 ? assign_pass_kernel<true, true>
                    : assign_pass_kernel<true, false>)
          : (k == 0 ? assign_pass_kernel<false, true>
                    : assign_pass_kernel<false, false>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}
