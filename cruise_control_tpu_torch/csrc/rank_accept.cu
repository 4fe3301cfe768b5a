// K8 rank_accept: gain-ranked prefix acceptance per destination broker.
//
// Replaces rank_accept and the segment_rank it calls
// (cruise_control_tpu/analyzer/kernels.py) after the lexsort, which stays
// a torch sort: `order` lists the candidates by destination segment
// (invalid ones, segment B, last), gain descending, index ascending.  In
// sorted position i, with o = order[i]:
//
//   seg_s[i]  = has[o] ? dest[o] : B;   segc = min(seg_s[i], B - 1)
//   start[i]  = the first sorted position of seg_s[i]'s segment (the
//               segments are contiguous, so a binary search over seg_s)
//   pos       = i - start[i]
//   ok        = seg_s < B && pos + taken[segc] < cap[segc]
//   first_free= pos == 0 && taken[segc] == 0
//   fits      = AND over the T terms of
//                 (cum[t][segc] + within_before) + w_s <= hr[t][segc],
//               w_s = seg_s < B ? d_w[t][o] : 0 over the whole sorted row,
//               cs = inclusive cumsum of w_s in XLA:CPU's order (ops.
//               cumsum_f32: sequential within blocks of 16, the zero-padded
//               block totals scanned by the same rule recursively, each
//               block's exclusive carry added to its sums), excl = cs - w_s,
//               within_before = excl - excl[start]
//   ok       &= first_free || fits
//   ok       &= no position of the segment before i failed (the prefix cut:
//               the first failing position is an integer atomicMin, exact
//               in any thread order)
//   out[o]    = ok && has[o]
//
// Every float operation is a single rounding (__fadd_rn / __fsub_rn), so
// nvcc can neither reassociate nor contract them, and the scan runs over
// the whole C-long row, invalid tail included: the block boundaries set
// the rounding.
//
// Design.  C <= 4096: one launch, one block of 1024 threads, the sorted
// segment ids, starts, weights, sums and level totals in shared memory
// (about 70 KB at C = 4096), one term at a time.  Larger C (the capacity
// goals' full-width fallback, the rack goal's table branch at 2,600
// brokers: C = 4 B): the same steps as separate launches over global
// scratch -- a gather, one launch per scan level up and down, a fits pass
// with the atomicMin, and the output pass.
//
// Bound: bytes.  Per candidate the order, destination, flag and T weights
// in and the flag out, per broker the counts and 2 T floats: about 28 KB
// at C = 2048, T = 3, B = 200 -- far below one launch.  The kernel's value
// is taking the plain version's dozens of launches per call off the host.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kSmallMax = 4096;
constexpr int kMaxLevels = 8;

constexpr uint8_t kCapOk = 1;     // valid segment, arrival under cap
constexpr uint8_t kFirstFree = 2;
constexpr uint8_t kFits = 4;

__device__ __forceinline__ int ceil16(int n) { return (n + 15) >> 4; }

// lower_bound of seg_s[i] in seg_s[0, i]
__device__ __forceinline__ int segment_start(const int* seg_s, int i) {
  const int s = seg_s[i];
  int lo = 0, hi = i;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg_s[mid] < s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One 16-block of a scan level: sequential sums of in[16 b ..] into
// out[16 b ..] (in place allowed), zero padding past n, and the block's
// total (pads included) into tot[b] when tot is given.
__device__ __forceinline__ void scan_block16(const float* in, float* out,
                                             float* tot, int n, int b) {
  const int base = b << 4;
  float acc = in[base];
  out[base] = acc;
  for (int j = 1; j < 16; ++j) {
    const int idx = base + j;
    if (idx < n) {
      acc = __fadd_rn(acc, in[idx]);
      out[idx] = acc;
    } else {
      acc = __fadd_rn(acc, 0.0f);
    }
  }
  if (tot != nullptr) tot[b] = acc;
}

// The top level (n <= 16): plainly sequential, in place.
__device__ __forceinline__ void scan_top(float* y, int n) {
  for (int j = 1; j < n; ++j) y[j] = __fadd_rn(y[j - 1], y[j]);
}

// ---------------------------------------------------------------------------
// C <= 4096: one block
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
rank_accept_small(int C, int B, int T, const int64_t* __restrict__ order,
                  const int* __restrict__ dest,
                  const uint8_t* __restrict__ has,
                  const int* __restrict__ taken,
                  const int* __restrict__ cap,
                  const float* __restrict__ cum,
                  const float* __restrict__ dw,
                  const float* __restrict__ hr,
                  uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* seg_s = reinterpret_cast<int*>(smem);
  int* start = seg_s + C;
  float* ws = reinterpret_cast<float*>(start + C);
  float* cs = ws + C;                 // level 0's sums, then the levels'
  uint8_t* flag = reinterpret_cast<uint8_t*>(cs + C + C / 8 + 64);
  const int tid = threadIdx.x;

  for (int i = tid; i < C; i += kThreads) {
    const int o = (int)order[i];
    seg_s[i] = has[o] ? dest[o] : B;
  }
  __syncthreads();
  for (int i = tid; i < C; i += kThreads) {
    const int s0 = segment_start(seg_s, i);
    start[i] = s0;
    const int seg = seg_s[i];
    const int segc = min(seg, B - 1);
    const int pos = i - s0;
    const int tk = taken[segc];
    uint8_t f = kFits;
    if (seg < B && pos + tk < cap[segc]) f |= kCapOk;
    if (pos == 0 && tk == 0) f |= kFirstFree;
    flag[i] = f;
  }

  // level sizes and offsets inside cs: level 0 is cs[0, C)
  int n_lv[kMaxLevels];
  int off[kMaxLevels];
  int levels = 1;
  n_lv[0] = C;
  off[0] = 0;
  while (n_lv[levels - 1] > 16) {
    n_lv[levels] = ceil16(n_lv[levels - 1]);
    off[levels] = off[levels - 1] + n_lv[levels - 1];
    ++levels;
  }

  for (int t = 0; t < T; ++t) {
    __syncthreads();  // the previous term is done with ws / cs
    for (int i = tid; i < C; i += kThreads) {
      ws[i] = seg_s[i] < B ? dw[(size_t)t * C + order[i]] : 0.0f;
    }
    __syncthreads();
    if (levels == 1) {
      if (tid == 0) {
        for (int j = 0; j < C; ++j) cs[j] = ws[j];
        scan_top(cs, C);
      }
    } else {
      // up: level l's blocks, totals into level l + 1
      for (int l = 0; l + 1 < levels; ++l) {
        const float* in = l == 0 ? ws : cs + off[l];
        for (int b = tid; b < n_lv[l + 1]; b += kThreads) {
          scan_block16(in, cs + off[l], cs + off[l + 1], n_lv[l], b);
        }
        __syncthreads();
      }
      if (tid == 0) scan_top(cs + off[levels - 1], n_lv[levels - 1]);
      __syncthreads();
      // down: each block of level l adds level l + 1's exclusive carry
      for (int l = levels - 2; l >= 0; --l) {
        float* y = cs + off[l];
        const float* up = cs + off[l + 1];
        for (int i = tid; i < n_lv[l]; i += kThreads) {
          const int blk = i >> 4;
          y[i] = __fadd_rn(y[i], blk ? up[blk - 1] : 0.0f);
        }
        __syncthreads();
      }
    }
    __syncthreads();
    for (int i = tid; i < C; i += kThreads) {
      const int s0 = start[i];
      const int segc = min(seg_s[i], B - 1);
      const float excl = __fsub_rn(cs[i], ws[i]);
      const float base = __fsub_rn(cs[s0], ws[s0]);
      const float before = __fsub_rn(excl, base);
      const float lhs =
          __fadd_rn(__fadd_rn(cum[(size_t)t * B + segc], before), ws[i]);
      if (!(lhs <= hr[(size_t)t * B + segc])) flag[i] &= (uint8_t)~kFits;
    }
  }
  __syncthreads();

  // the prefix cut: first failing position per segment, by its start
  int* first_bad = reinterpret_cast<int*>(cs);
  for (int i = tid; i < C; i += kThreads) first_bad[i] = INT_MAX;
  __syncthreads();
  for (int i = tid; i < C; i += kThreads) {
    const uint8_t f = flag[i];
    const bool ok = (f & kCapOk) && (f & (kFirstFree | kFits));
    if (seg_s[i] < B && !ok) atomicMin(&first_bad[start[i]], i);
  }
  __syncthreads();
  for (int i = tid; i < C; i += kThreads) {
    const uint8_t f = flag[i];
    const bool ok = (f & kCapOk) && (f & (kFirstFree | kFits)) &&
                    i < first_bad[start[i]];
    const int o = (int)order[i];
    out[o] = (ok && has[o]) ? 1 : 0;
  }
}

size_t small_smem_bytes(int C) {
  // seg_s, start, ws (C each), cs with its levels (< C + C / 8 + 64),
  // the flags (C bytes)
  return (size_t)C * 4 * 3 + ((size_t)C + C / 8 + 64) * 4 + (size_t)C;
}

// ---------------------------------------------------------------------------
// C > 4096: the same steps over global scratch
// ---------------------------------------------------------------------------

__global__ void gather_kernel(int C, int B, int T,
                              const int64_t* __restrict__ order,
                              const int* __restrict__ dest,
                              const uint8_t* __restrict__ has,
                              const float* __restrict__ dw,
                              int* __restrict__ seg_s,
                              int* __restrict__ first_bad,
                              float* __restrict__ ws) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int o = (int)order[i];
  const int seg = has[o] ? dest[o] : B;
  seg_s[i] = seg;
  first_bad[i] = INT_MAX;
  for (int t = 0; t < T; ++t) {
    ws[(size_t)t * C + i] = seg < B ? dw[(size_t)t * C + o] : 0.0f;
  }
}

// one scan level up: per term, the 16-blocks of `in` (stride in_stride)
// into `out` (stride L) and their totals into `tot` (stride L)
__global__ void scan_up_kernel(int T, int n, const float* __restrict__ in,
                               size_t in_stride, float* out, float* tot,
                               size_t L) {
  const int m = ceil16(n);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= T * m) return;
  const int t = g / m;
  const int b = g - t * m;
  scan_block16(in + t * in_stride, out + t * L, tot + t * L, n, b);
}

__global__ void scan_top_kernel(int T, float* y, size_t L, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < T) scan_top(y + t * L, n);
}

__global__ void scan_down_kernel(int T, int n, float* y, const float* up,
                                 size_t L) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= T * n) return;
  const int t = g / n;
  const int i = g - t * n;
  const int blk = i >> 4;
  float* yt = y + t * L;
  yt[i] = __fadd_rn(yt[i], blk ? up[t * L + blk - 1] : 0.0f);
}

__global__ void fits_kernel(int C, int B, int T, const int* __restrict__ seg_s,
                            const int* __restrict__ taken,
                            const int* __restrict__ cap,
                            const float* __restrict__ cum,
                            const float* __restrict__ hr,
                            const float* __restrict__ ws,
                            const float* __restrict__ cs, size_t L,
                            int* __restrict__ start_out,
                            int* __restrict__ first_bad,
                            uint8_t* __restrict__ ok_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int s0 = segment_start(seg_s, i);
  start_out[i] = s0;
  const int seg = seg_s[i];
  const int segc = min(seg, B - 1);
  const int pos = i - s0;
  const int tk = taken[segc];
  const bool cap_ok = seg < B && pos + tk < cap[segc];
  const bool first_free = pos == 0 && tk == 0;
  bool fits = true;
  for (int t = 0; t < T; ++t) {
    const float* w = ws + (size_t)t * C;
    const float* c = cs + (size_t)t * L;
    const float excl = __fsub_rn(c[i], w[i]);
    const float base = __fsub_rn(c[s0], w[s0]);
    const float before = __fsub_rn(excl, base);
    const float lhs =
        __fadd_rn(__fadd_rn(cum[(size_t)t * B + segc], before), w[i]);
    fits = fits && (lhs <= hr[(size_t)t * B + segc]);
  }
  const bool ok = cap_ok && (first_free || fits);
  ok_out[i] = ok ? 1 : 0;
  if (seg < B && !ok) atomicMin(&first_bad[s0], i);
}

__global__ void output_kernel(int C, const int64_t* __restrict__ order,
                              const uint8_t* __restrict__ has,
                              const int* __restrict__ start,
                              const int* __restrict__ first_bad,
                              const uint8_t* __restrict__ ok,
                              uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int o = (int)order[i];
  out[o] = (ok[i] && i < first_bad[start[i]] && has[o]) ? 1 : 0;
}

inline int grid(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

}  // namespace

// Scratch floats the large path needs per term: the level-0 sums and every
// level's totals.
extern "C" long long cc_rank_accept_level_floats(int C) {
  long long total = C;
  long long n = C;
  while (n > 16) {
    n = (n + 15) / 16;
    total += n;
  }
  return total;
}

// order i64[C], dest i32[C], has u8[C], taken / cap i32[B], cum / hr
// f32[T, B], dw f32[T, C] in candidate order; out u8[C].  The large path
// (C > 4096) needs scratch: ints i32[3 C] (sorted segments, starts, first
// failing positions), ok u8[C], ws f32[T C], cs f32[T L] with
// L = cc_rank_accept_level_floats(C); the small path ignores it.
extern "C" int cc_rank_accept(int C, int B, int T, const int64_t* order,
                              const int* dest, const uint8_t* has,
                              const int* taken, const int* cap,
                              const float* cum, const float* dw,
                              const float* hr, int* scratch_i,
                              uint8_t* scratch_ok, float* scratch_ws,
                              float* scratch_cs, uint8_t* out,
                              void* stream) {
  if (C <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= kSmallMax) {
    const size_t bytes = small_smem_bytes(C);
    if (bytes > 48 * 1024) {
      // above the default 48 KB a launch must opt in (per device)
      const cudaError_t e = cudaFuncSetAttribute(
          rank_accept_small, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)small_smem_bytes(kSmallMax));
      if (e != cudaSuccess) return (int)e;
    }
    rank_accept_small<<<1, kThreads, bytes, st>>>(C, B, T, order, dest, has,
                                                  taken, cap, cum, dw, hr,
                                                  out);
    return (int)cudaGetLastError();
  }
  const int threads = 256;
  const size_t L = (size_t)cc_rank_accept_level_floats(C);
  int* seg_s = scratch_i;
  int* start = scratch_i + C;
  int* first_bad = scratch_i + 2 * (size_t)C;
  gather_kernel<<<grid(C, threads), threads, 0, st>>>(
      C, B, T, order, dest, has, dw, seg_s, first_bad, scratch_ws);
  if (T > 0) {
    int n_lv[kMaxLevels];
    size_t off[kMaxLevels];
    int levels = 1;
    n_lv[0] = C;
    off[0] = 0;
    while (n_lv[levels - 1] > 16) {
      if (levels == kMaxLevels) return (int)cudaErrorInvalidValue;
      n_lv[levels] = (n_lv[levels - 1] + 15) / 16;
      off[levels] = off[levels - 1] + n_lv[levels - 1];
      ++levels;
    }
    for (int l = 0; l + 1 < levels; ++l) {
      const float* in = l == 0 ? scratch_ws : scratch_cs + off[l];
      const size_t in_stride = l == 0 ? (size_t)C : L;
      scan_up_kernel<<<grid((long long)T * n_lv[l + 1], threads), threads, 0,
                       st>>>(T, n_lv[l], in, in_stride, scratch_cs + off[l],
                             scratch_cs + off[l + 1], L);
    }
    scan_top_kernel<<<grid(T, 32), 32, 0, st>>>(T, scratch_cs + off[levels - 1], L,
                                      n_lv[levels - 1]);
    for (int l = levels - 2; l >= 0; --l) {
      scan_down_kernel<<<grid((long long)T * n_lv[l], threads), threads, 0,
                         st>>>(T, n_lv[l], scratch_cs + off[l],
                               scratch_cs + off[l + 1], L);
    }
  }
  fits_kernel<<<grid(C, threads), threads, 0, st>>>(
      C, B, T, seg_s, taken, cap, cum, hr, scratch_ws, scratch_cs, L, start,
      first_bad, scratch_ok);
  output_kernel<<<grid(C, threads), threads, 0, st>>>(
      C, order, has, start, first_bad, scratch_ok, out);
  return (int)cudaGetLastError();
}
