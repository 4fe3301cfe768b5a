// K4 leader_assign_pass: one pass of the leadership round's follower
// assignment, with the glue around it.
//
// Replaces the pass loop of leadership_round's run_tail
// (cruise_control_tpu/analyzer/kernels.py): options_feasible's option
// tests, the preference plane and the jitter amplitude above the loop,
// the pass body with _pairwise_jitter, and the fold of each pass into the
// round's state.  Per candidate leader row c over its RF follower
// options j:
//   pass 0 (the plane): with row = rows[c], s = sib[c, j] (the partition's
//     replica, -1 for none), ss = max(s, 0), b = replica_broker[ss],
//       ok   = cand_has[c] && s >= 0 && s != row && leader_ok[b]
//              && !replica_offline[ss] && bonus_w[row] <= headroom[b]
//              && accept[c, j]
//       pref[c, j] = ok ? dest_pref[b] : NEG;  sib_broker[c, j] = b;
//       sib_replica[c, j] = ss;  src[c] = replica_broker[row];
//       gain[c] = bonus_w[row];
//     the counters, `assigned` and `dest_replica` start at zero, and
//       amp = fma(0.35, isfinite(max - min) ? max - min : 0, 1e-6)
//     over the finite (> NEG/2) preferences, one rounding;
//   pass k > 0 first folds pass k - 1: where keep[c], dest_replica[c] =
//     prev_dr[c] and assigned[c] = 1, and (single-commit) taken_cnt
//     [prev_db[c]] and dep_cnt[src[c]] gain one (integer atomics, exact in
//     any order);
//   then every pass picks the first-max option of
//       pass_pref = pref (pass 0), fma(amp, jitter(c, j, k), pref) (pass
//                   k > 0, finite pref; __fmaf_rn, one rounding, as the
//                   reference's compiled program contracts it)
//   masked to NEG where the option is closed -- multi-commit:
//   taken_cnt[b] >= max_arrivals; single-commit: taken_cnt[b] > 0 or
//   dep_cnt[src[c]] > 0 -- and for assigned rows: db = its broker, dr =
//   its replica, has = cand_has[c] && max > NEG/2 (a row with no open
//   option: option 0), and (multi-commit) K8's weights d_w[t, c] =
//   t_ws[t, dr].
// The plain version is leader_assign_pass_plain (analyzer/kernels.py).
//
// Bound: memory.  Pass 0 reads the rows, the sibling rows and acceptance
// plane and gathers 10 + 17 RF bytes a row, and writes the three [C, RF]
// planes; a later pass reads the planes and the counters of the options'
// brokers (about 13 RF + 20 bytes a row).  C = 2048, RF = 3: about 0.1 MB,
// 0.03 us -- the launch sets the time.
//
// Design: a thread a row, grid-stride, a row's options in registers.
// Pass 0 and a single-commit pass are one cooperative launch: pass 0
// reduces the amplitude through per-block partials (min and max are
// order-free) read by block 0 after a grid barrier, and its own pick,
// unjittered, does not wait for them; a single-commit pass folds, then a
// grid barrier, then picks.  A multi-commit pass folds only its own row
// (K8 commits the counters), so it is one plain launch with no barrier.
// No same-address atomics: the counters' atomics spread over brokers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mutex>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e30f;
constexpr float kNegHalf = -5e29f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRF = 16;

struct Args {
  int C, RF, R, B, T, k, multi, max_arrivals;
  const void* rows;
  int rows64;
  const int* sib;
  const uint8_t* accept;
  long long acc_c, acc_j;
  const uint8_t* cand_has;
  const int* replica_broker;
  const uint8_t* leader_ok;
  const uint8_t* offline;
  const float* bonus_w;
  long long bonus_stride;
  const float* headroom;
  long long headroom_stride;
  const float* dest_pref;
  long long dest_pref_stride;
  float* pref;
  int* sib_broker;
  int* sib_replica;
  int* src;
  float* gain;
  float* amp;
  int* taken;
  int* dep;
  uint8_t* assigned;
  int* dest_replica;
  const uint8_t* keep;
  const int* prev_db;
  const int* prev_dr;
  const float* t_ws;
  float* d_w;
  int* db;
  int* dr;
  uint8_t* has;
  float* partials;  // [2 * gridDim.x]: pass 0's block max, block min
};

__device__ __forceinline__ float pairwise_jitter(uint32_t c, uint32_t j,
                                                 uint32_t k) {
  uint32_t x = c * 2654435761u + j * 40503u + k * 97919u;
  x ^= x >> 16;
  x *= 2246822519u;
  x ^= x >> 13;
  return __fmul_rn((float)(x & 0xFFFFFFu), 1.0f / 16777216.0f);
}

__device__ __forceinline__ void grid_barrier() {
  if (gridDim.x == 1) {
    __syncthreads();
  } else {
    cg::this_grid().sync();
  }
}

// The pick's outputs for row c: option bs's broker and replica, has, and
// (multi-commit) K8's weights of the promoted replica.
template <int kR>
__device__ __forceinline__ void put(const Args& a, int c, int bs,
                                    const int (&sb)[kR], const int (&sr)[kR],
                                    bool h) {
  int b = sb[0], r = sr[0];
#pragma unroll
  for (int j = 1; j < kR; ++j) {
    if (j == bs) {
      b = sb[j];
      r = sr[j];
    }
  }
  a.db[c] = b;
  a.dr[c] = r;
  a.has[c] = h;
  if (a.multi) {
    for (int t = 0; t < a.T; ++t) {
      a.d_w[(size_t)t * a.C + c] = a.t_ws[(size_t)t * a.R + r];
    }
  }
}

template <int kR>
__device__ void first_pass(const Args& a) {
  const int stride = gridDim.x * kThreads;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  for (int i = tid; i < a.B; i += stride) {
    a.taken[i] = 0;
    a.dep[i] = 0;
  }
  float lmax = -INFINITY;
  float lmin = INFINITY;
  for (int c = tid; c < a.C; c += stride) {
    // every load first, by dependence depth
    const long long row =
        a.rows64 ? static_cast<const long long*>(a.rows)[c]
                 : (long long)static_cast<const int*>(a.rows)[c];
    const bool ch = a.cand_has[c] != 0;
    const size_t base = (size_t)c * a.RF;
    int s[kR], sb[kR], sr[kR];
    bool acc[kR], on[kR], lok[kR];
    float hr[kR], dp[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      if (j < a.RF) {
        s[j] = a.sib[base + j];
        acc[j] = a.accept[c * a.acc_c + j * a.acc_j] != 0;
      }
    }
    const int src = a.replica_broker[row];
    const float bw = a.bonus_w[row * a.bonus_stride];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      if (j < a.RF) {
        sr[j] = s[j] > 0 ? s[j] : 0;
        sb[j] = a.replica_broker[sr[j]];
        on[j] = a.offline[sr[j]] == 0;
      }
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      if (j < a.RF) {
        lok[j] = a.leader_ok[sb[j]] != 0;
        hr[j] = a.headroom[(long long)sb[j] * a.headroom_stride];
        dp[j] = a.dest_pref[(long long)sb[j] * a.dest_pref_stride];
      }
    }
    a.src[c] = src;
    a.gain[c] = bw;
    a.assigned[c] = 0;
    a.dest_replica[c] = 0;
    float bv = kNeg;
    int bs = 0;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      if (j < a.RF) {
        const bool ok = ch && s[j] >= 0 && (long long)s[j] != row &&
                        lok[j] && on[j] && bw <= hr[j] && acc[j];
        const float p = ok ? dp[j] : kNeg;
        a.pref[base + j] = p;
        a.sib_broker[base + j] = sb[j];
        a.sib_replica[base + j] = sr[j];
        if (p > kNegHalf) {
          lmax = fmaxf(lmax, p);
          lmin = fminf(lmin, p);
        }
        // first max: a later option wins only when strictly greater
        if (j == 0 || p > bv) {
          bv = p;
          bs = j;
        }
      }
    }
    put(a, c, bs, sb, sr, ch && bv > kNegHalf);
  }
  // the amplitude: block partials, a grid barrier, block 0 reduces them
  __shared__ float red_max[kWarps];
  __shared__ float red_min[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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
    a.partials[2 * blockIdx.x] = bmax;
    a.partials[2 * blockIdx.x + 1] = bmin;
  }
  grid_barrier();
  if (blockIdx.x != 0 || warp != 0) return;
  float pmax = -INFINITY;
  float pmin = INFINITY;
  for (int i = lane; i < (int)gridDim.x; i += 32) {
    pmax = fmaxf(pmax, a.partials[2 * i]);
    pmin = fminf(pmin, a.partials[2 * i + 1]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
    pmin = fminf(pmin, __shfl_xor_sync(0xffffffffu, pmin, off));
  }
  if (lane == 0) {
    const float d = __fsub_rn(pmax, pmin);
    *a.amp = __fmaf_rn(0.35f, isfinite(d) ? d : 0.f, 1e-6f);
  }
}

// Row c's pick in a pass k > 0; `closed`: the row is assigned (or kept by
// the pass before).
template <int kR>
__device__ __forceinline__ void later_pick(const Args& a, int c, bool closed,
                                           float amp) {
  const size_t base = (size_t)c * a.RF;
  const bool ch = a.cand_has[c] != 0;
  float v[kR];
  int sb[kR], sr[kR], taken[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    if (j < a.RF) {
      v[j] = a.pref[base + j];
      sb[j] = a.sib_broker[base + j];
      sr[j] = a.sib_replica[base + j];
    }
  }
  if (!a.multi) closed = closed || a.dep[a.src[c]] > 0;
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    if (j < a.RF) taken[j] = a.taken[sb[j]];
  }
  float bv = kNeg;
  int bs = 0;
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    if (j < a.RF) {
      const float pv =
          (v[j] > kNegHalf)
              ? __fmaf_rn(amp, pairwise_jitter(c, j, a.k), v[j])
              : kNeg;
      const bool open =
          a.multi ? taken[j] < a.max_arrivals : taken[j] <= 0;
      const float ov = (open && !closed) ? pv : kNeg;
      if (j == 0 || ov > bv) {
        bv = ov;
        bs = j;
      }
    }
  }
  put(a, c, bs, sb, sr, ch && bv > kNegHalf);
}

template <int kR>
__device__ void later_pass(const Args& a) {
  const int stride = gridDim.x * kThreads;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const float amp = *a.amp;
  if (a.multi) {
    // K8 commits the counters: the fold is the row's own, no barrier
    for (int c = tid; c < a.C; c += stride) {
      const bool kept = a.keep[c] != 0;
      const int pdr = a.prev_dr[c];
      const bool asg = a.assigned[c] != 0;
      if (kept) {
        a.dest_replica[c] = pdr;
        a.assigned[c] = 1;
      }
      later_pick<kR>(a, c, asg || kept, amp);
    }
    return;
  }
  // the fold of the pass before, its counts, then a grid barrier
  for (int c = tid; c < a.C; c += stride) {
    const bool kept = a.keep[c] != 0;
    const int pdr = a.prev_dr[c];
    const int pdb = a.prev_db[c];
    const int src = a.src[c];
    if (kept) {
      a.dest_replica[c] = pdr;
      a.assigned[c] = 1;
      atomicAdd(&a.taken[pdb], 1);
      atomicAdd(&a.dep[src], 1);
    }
  }
  grid_barrier();
  for (int c = tid; c < a.C; c += stride) {
    later_pick<kR>(a, c, a.assigned[c] != 0, amp);
  }
}

template <bool kFirst, int kR>
__global__ void __launch_bounds__(kThreads) leader_pass_kernel(Args a) {
  if (kFirst) {
    first_pass<kR>(a);
  } else {
    later_pass<kR>(a);
  }
}

typedef void (*PassKernel)(Args);

// the instantiation for pass 0 or a later pass and RF (a row's options in
// registers, up to 4 or 16)
PassKernel pass_kernel(bool first, int rf) {
  if (rf <= 4) {
    return first ? leader_pass_kernel<true, 4> : leader_pass_kernel<false, 4>;
  }
  return first ? leader_pass_kernel<true, kMaxRF>
               : leader_pass_kernel<false, kMaxRF>;
}

struct Occ {
  int sms = 0;
  int coop = 0;
  int per_sm[4] = {0, 0, 0, 0};
};
Occ g_occ[16];
std::mutex g_lock;

// The most co-resident blocks of a cooperative launch (1 where the device
// takes none).
int coop_blocks(bool first, int rf, int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 16) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(g_lock);
  Occ& o = g_occ[dev];
  if (o.sms == 0) {
    e = cudaDeviceGetAttribute(&o.coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      o.sms = 0;
      return (int)e;
    }
  }
  int& per = o.per_sm[(first ? 0 : 1) + (rf <= 4 ? 0 : 2)];
  if (per == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, (const void*)pass_kernel(first, rf), kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per < 1) return (int)cudaErrorInvalidConfiguration;
  }
  *blocks = o.coop ? o.sms * per : 1;
  return 0;
}

}  // namespace

// rows i32 or i64[C] (rows64), sib i32[C, RF], accept u8 read at
// c * acc_c + j * acc_j, cand_has u8[C], replica_broker i32[R],
// leader_ok u8[B], offline u8[R], bonus_w f32[R], headroom and dest_pref
// f32[B] (each at its stride); planes pref f32[C, RF], sib_broker and
// sib_replica i32[C, RF], src i32[C], gain f32[C], amp f32 (written by
// pass 0, read after); taken and dep i32[B], assigned u8[C], dest_replica
// i32[C] (zeroed by pass 0, updated in place after); keep u8[C], prev_db
// and prev_dr i32[C] (the pass before; k > 0); t_ws f32[T, R] and d_w
// f32[T, C] (multi-commit); out db, dr i32[C], has u8[C]; partials
// f32[n_partials] (pass 0: two a block).  RF <= 16.
extern "C" int cc_leader_assign_pass(
    int C, int RF, int R, int B, int T, int k, int multi, int max_arrivals,
    const void* rows, int rows64, const int* sib, const uint8_t* accept,
    long long acc_c, long long acc_j, const uint8_t* cand_has,
    const int* replica_broker, const uint8_t* leader_ok,
    const uint8_t* offline, const float* bonus_w, long long bonus_stride,
    const float* headroom, long long headroom_stride, const float* dest_pref,
    long long dest_pref_stride, float* pref, int* sib_broker,
    int* sib_replica, int* src, float* gain, float* amp, int* taken,
    int* dep, uint8_t* assigned, int* dest_replica, const uint8_t* keep,
    const int* prev_db, const int* prev_dr, const float* t_ws, float* d_w,
    int* db, int* dr, uint8_t* has, float* partials, int n_partials,
    void* stream) {
  if (C < 0 || B < 0 || RF < 1 || RF > kMaxRF || (multi && T > 0 && !d_w) ||
      (k > 0 && (!keep || !prev_db || !prev_dr)) ||
      (k == 0 && n_partials < 2)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{C,         RF,       R,          B,           multi ? T : 0,
         k,         multi,    max_arrivals, rows,      rows64,
         sib,       accept,   acc_c,      acc_j,       cand_has,
         replica_broker,      leader_ok,  offline,     bonus_w,
         bonus_stride,        headroom,   headroom_stride,
         dest_pref, dest_pref_stride,     pref,        sib_broker,
         sib_replica,         src,        gain,        amp,
         taken,     dep,      assigned,   dest_replica, keep,
         prev_db,   prev_dr,  t_ws,       d_w,         db,
         dr,        has,      partials};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool first = k == 0;
  const int work = (first && B > C) ? B : C;
  long long want = ((long long)work + kThreads - 1) / kThreads;
  if (want < 1) want = 1;
  const PassKernel kernel = pass_kernel(first, RF);
  if (!first && multi) {
    // no barrier: one plain launch
    if (C == 0) return 0;
    kernel<<<(int)want, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  int cap = 0;
  int err = coop_blocks(first, RF, &cap);
  if (err != 0) return err;
  if (want > cap) want = cap;
  if (first && want > n_partials / 2) want = n_partials / 2;
  const int blocks = (int)want;
  if (blocks == 1) {
    kernel<<<1, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                          dim3(kThreads), params, 0, st);
}
