// K6 sweep_pick: one round's window of the global leadership sweep, from
// the source terms to the chosen transfer, with the fold of the round
// before it.
//
// Replaces, in global_leadership_sweep's round body
// (cruise_control_tpu/analyzer/leadership.py), everything from the line
// after bounds() through dst_b, and the previous round's fold of `cur`
// and `failed` at the end of the body.  With the previous round's window
// (p_sel, p_cur_safe, p_dst_r, p_live_w) and its acceptance p_valid:
//   fold:   cur[replica_partition[p_cur_safe[w]]] = p_dst_r[w] where
//           p_valid[w]; failed[p_sel[w]] = p_valid ? 0 : (p_live_w ? 1 :
//           failed), in place (a rejected round ends the sweep, so a
//           launch only ever folds a kept round; the last round needs no
//           fold);
//   source: cs = max(cur[p], 0), sb = replica_broker[cs], v = value[cs],
//           live = cur[p] >= 0 && static_ok[cs] && W[sb] > shed_to[sb]
//                  && v > 0 (&& v < 2 (W[sb] - shed_to[sb]) in mean mode);
//   window: spread0 = hi - lo of the live gains (1 when hi <= lo), amp =
//           spread0 * select_jitter, gain_sel = fma(amp, jitter(p), v)
//           - failed[p] * (spread0 + amp), jitter the reference's uint32
//           hash salted by salt_i; when P > kWindow the window is
//           jax.lax.top_k(live ? gain_sel : -inf, kWindow) (XLA's total
//           order, -0.0 below +0.0, ties and the -inf tail to the lower
//           index), else every partition in index order;
//   pick:   the window's [W, RF] sibling plane as before this kernel took
//           the window in (sweep_pick_plain): for row w (partition p,
//           leader cs) and option j (replica r = rows[p, j], broker cb):
//             ok = r >= 0 && r != cs && static_ok[r] && alive[cb]
//                  && leader_ok[cb] && W[cb] + value[r] <= hard_cap[cb]
//                  (&& value[r] < 2 deficit in mean mode);
//             deficit = fill_to[cb] - W[cb];
//             score = fma(0.1 spread, (jit[p, j] + salt) mod 1, deficit)
//                     (then fma(0.5 spread, tb_norm[cb], score) with a
//                     tiebreak, tb_norm = (tb - min tb) / max(max tb -
//                     min tb, 1e-9), __fdiv_rn);
//             spread = max(max |deficit| over the WHOLE [W, RF] plane,
//                      1e-6);
//           dst_r = max(rows[p, j*], 0) for the first-max feasible option
//           j* (option 0 when none), has = live && any(ok), dst_b =
//           replica_broker[dst_r].
// Outputs per window row: sel, has, live_w (has before the pick),
// cur_safe, src_b, value_leave (= the gain), dst_r, dst_b.  Each FMA above
// is one __fmaf_rn, as XLA:CPU contracts it in the reference's compiled
// sweep; every other product and sum is rounded on its own.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel), at most
// two blocks of 512 threads an SM, no host sync, phases separated by grid
// barriers:
//   A. the fold (from the second round), a thread per previous window row;
//   B. the source terms, a thread per partition; each block's min and max
//      of the live gains, of tb and (no compaction) of |deficit| into
//      per-block partials (no same-address float atomics); without a
//      compaction the window rows are written here;
//   C. (compaction) every block reduces the gain partials itself, then a
//      thread per partition scores gain_sel and appends the listed keys
//      (topk_select.cuh, shared with K7);
//   D. (compaction, more than kWindow live) the radix select and the
//      compaction of the selected keys;
//   E. (compaction) the order: each selected key's window row written at
//      its rank, then every block its stretch of the tail; the rows'
//      |deficit| maxima into partials;
//   F. every block reduces the partials, then a thread per window row
//      scores its options.
// Without a compaction the launch is A, B, F: two barriers, one on the
// first round.
//
// Bound: bytes.  Per partition its leader id, flags, gain and failure
// mark (about 30 bytes with the gathers), per window option its replica,
// broker, flags, loads and jitter (about 24 bytes): about 0.6 MB at P =
// 20,000 and 6 MB at 200,000.  The grid barriers set the time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace cg = cooperative_groups;

namespace {

using tks::u64;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = tks::kMaxK;
constexpr int kMaxBlocks = 1024;
// per-block partials, each kMaxBlocks floats
constexpr int kGainLo = 0, kGainHi = 1, kTbLo = 2, kTbHi = 3, kDefMax = 4;
constexpr int kPartials = 5;

struct Args {
  int P, RF, B, Wn, compact, fold, improve_gate, salt_i;
  float salt, select_jitter;
  int* cur;
  float* failed;
  const long long* p_sel;
  const long long* p_cur_safe;
  const long long* p_dst_r;
  const uint8_t* p_valid;
  const uint8_t* p_live_w;
  const int* rows;
  const float* jit;
  const int* replica_broker;
  const int* replica_partition;
  const float* value;
  const uint8_t* static_ok;
  const uint8_t* alive;
  const uint8_t* leader_ok;
  const float* W;
  long long W_s;
  const float* shed_to;
  long long shed_s;
  const float* fill_to;
  long long fill_s;
  const float* hard_cap;
  long long cap_s;
  const float* tb;  // null without a tiebreak
  long long tb_s;
  float* partials;  // kPartials * kMaxBlocks
  float* g0;        // f32[P]: the live gain, -inf elsewhere (compaction)
  uint8_t* listed;  // u8[P] (compaction)
  u64* list;        // u64[P]
  int* hist;        // tks::kHistWords
  u64* sel_keys;    // u64[kWindow]
  long long* sel;
  uint8_t* has;
  uint8_t* live_w;
  long long* cur_safe;
  int* src_b;
  float* value_leave;
  long long* dst_r;
  int* dst_b;
};

__device__ __forceinline__ float load_w(const Args& a, int b) {
  return a.W[b * a.W_s];
}

// salted_jitter: the reference's uint32 hash of the index and salt
__device__ __forceinline__ float jitter(uint32_t i, int salt_i) {
  uint32_t x = i * 2654435761u + ((uint32_t)salt_i + 1u) * 97919u;
  x ^= x >> 16;
  x *= 2246822519u;
  x ^= x >> 13;
  return __fmul_rn((float)(x & 0xFFFFFFu), 1.0f / 16777216.0f);
}

// block-wide min / max of each thread's value; the result in every thread
__device__ float block_reduce(float v, bool is_max, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? fmaxf(v, o) : fminf(v, o);
  }
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int k = 1; k < kWarps; ++k) {
    v = is_max ? fmaxf(v, red[k]) : fminf(v, red[k]);
  }
  return v;
}

// every block's reduction of one slot of per-block partials
__device__ float reduce_partials(const Args& a, int slot, bool is_max,
                                 float* red) {
  float v = is_max ? -INFINITY : INFINITY;
  const float* p = a.partials + slot * kMaxBlocks;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x) {
    const float o = __ldcg(p + i);
    v = is_max ? fmaxf(v, o) : fminf(v, o);
  }
  return block_reduce(v, is_max, red);
}

__device__ void write_partial(const Args& a, int slot, float v) {
  if (threadIdx.x == 0) a.partials[slot * kMaxBlocks + blockIdx.x] = v;
}

struct Source {
  int cs, sb;
  float v;
  bool live;
};

__device__ __forceinline__ Source source_terms(const Args& a, int p) {
  Source s;
  const int c = __ldcg(a.cur + p);
  s.cs = c > 0 ? c : 0;
  s.sb = a.replica_broker[s.cs];
  s.v = a.value[s.cs];
  const float wb = load_w(a, s.sb);
  const float sh = a.shed_to[s.sb * a.shed_s];
  s.live = c >= 0 && a.static_ok[s.cs] && wb > sh && s.v > 0.0f;
  if (a.improve_gate) {
    s.live = s.live && s.v < __fmul_rn(2.0f, __fsub_rn(wb, sh));
  }
  return s;
}

__device__ __forceinline__ float deficit_of(const Args& a, int cb) {
  return __fsub_rn(a.fill_to[cb * a.fill_s], load_w(a, cb));
}

// max |deficit| over partition p's options
__device__ __forceinline__ float row_deficit_max(const Args& a, int p) {
  float m = 0.0f;
  for (int j = 0; j < a.RF; ++j) {
    const int r = a.rows[(size_t)p * a.RF + j];
    m = fmaxf(m, fabsf(deficit_of(a, a.replica_broker[r > 0 ? r : 0])));
  }
  return m;
}

__device__ void phase_fold(const Args& a) {
  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < a.Wn;
       w += gridDim.x * blockDim.x) {
    const bool valid = a.p_valid[w] != 0;
    if (valid) {
      a.cur[a.replica_partition[a.p_cur_safe[w]]] = (int)a.p_dst_r[w];
    }
    const long long p = a.p_sel[w];
    if (valid) {
      a.failed[p] = 0.0f;
    } else if (a.p_live_w[w]) {
      a.failed[p] = 1.0f;
    }
  }
}

// the window row at `pos` for partition p (compaction path; its
// liveness is phase B's)
__device__ void write_row(const Args& a, int pos, int p, unsigned* dmax) {
  const int c = __ldcg(a.cur + p);
  const int cs = c > 0 ? c : 0;
  const bool live = __ldcg(a.g0 + p) != -INFINITY;
  a.sel[pos] = p;
  a.has[pos] = live;
  a.live_w[pos] = live;
  a.cur_safe[pos] = cs;
  a.src_b[pos] = a.replica_broker[cs];
  a.value_leave[pos] = a.value[cs];
  atomicMax(dmax, __float_as_uint(row_deficit_max(a, p)));
}

__device__ void phase_sources(const Args& a, float* red) {
  float lo = INFINITY, hi = -INFINITY, dm = 0.0f;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < a.P;
       p += gridDim.x * blockDim.x) {
    const Source s = source_terms(a, p);
    if (s.live) {
      lo = fminf(lo, s.v);
      hi = fmaxf(hi, s.v);
    }
    if (a.compact) {
      a.g0[p] = s.live ? s.v : -INFINITY;
    } else {
      a.sel[p] = p;
      a.has[p] = s.live;
      a.live_w[p] = s.live;
      a.cur_safe[p] = s.cs;
      a.src_b[p] = s.sb;
      a.value_leave[p] = s.v;
      dm = fmaxf(dm, row_deficit_max(a, p));
    }
  }
  float tlo = INFINITY, thi = -INFINITY;
  if (a.tb != nullptr) {
    for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < a.B;
         b += gridDim.x * blockDim.x) {
      const float t = a.tb[b * a.tb_s];
      tlo = fminf(tlo, t);
      thi = fmaxf(thi, t);
    }
  }
  write_partial(a, kGainLo, block_reduce(lo, false, red));
  write_partial(a, kGainHi, block_reduce(hi, true, red));
  if (a.tb != nullptr) {
    write_partial(a, kTbLo, block_reduce(tlo, false, red));
    write_partial(a, kTbHi, block_reduce(thi, true, red));
  }
  if (!a.compact) write_partial(a, kDefMax, block_reduce(dm, true, red));
}

__device__ void phase_window(const Args& a, float* red, int* sh) {
  const float lo = reduce_partials(a, kGainLo, false, red);
  const float hi = reduce_partials(a, kGainHi, true, red);
  const float spread0 = hi > lo ? __fsub_rn(hi, lo) : 1.0f;
  const float amp = __fmul_rn(spread0, a.select_jitter);
  const float pen = __fadd_rn(spread0, amp);
  for (int t = threadIdx.x; t < 256; t += blockDim.x) sh[t] = 0;
  __syncthreads();
  for (int p0 = blockIdx.x * blockDim.x; p0 < a.P;
       p0 += gridDim.x * blockDim.x) {
    const int p = p0 + threadIdx.x;
    bool ok = false;
    float gs = -INFINITY;
    if (p < a.P) {
      const float g = __ldcg(a.g0 + p);
      if (g != -INFINITY) {
        gs = __fsub_rn(__fmaf_rn(amp, jitter((uint32_t)p, a.salt_i), g),
                       __fmul_rn(__ldcg(a.failed + p), pen));
      }
      ok = !(gs == -INFINITY);
      a.listed[p] = ok;
    }
    tks::select_append(ok, tks::select_key(gs, p), a.list, a.hist, sh);
  }
  tks::select_flush(sh, a.hist);
}

struct EmitRow {
  const Args& a;
  unsigned* dmax;
  __device__ void operator()(int rank, u64 key) const {
    write_row(a, rank, tks::select_index(key), dmax);
  }
};

struct Listed {
  const Args& a;
  __device__ bool operator()(int i) const {
    return __ldcg(a.listed + i) != 0;
  }
};

struct EmitTail {
  const Args& a;
  unsigned* dmax;
  __device__ void operator()(int pos, int i) const {
    write_row(a, pos, i, dmax);
  }
};

__device__ void phase_pick(const Args& a, float* red) {
  const float spread =
      fmaxf(reduce_partials(a, kDefMax, true, red), 1e-6f);
  const float jit_amp = __fmul_rn(0.1f, spread);
  const float tb_amp = __fmul_rn(0.5f, spread);
  float tb_lo = 0.0f, tb_den = 1.0f;
  if (a.tb != nullptr) {
    tb_lo = reduce_partials(a, kTbLo, false, red);
    const float tb_hi = reduce_partials(a, kTbHi, true, red);
    tb_den = fmaxf(__fsub_rn(tb_hi, tb_lo), 1e-9f);
  }
  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < a.Wn;
       w += gridDim.x * blockDim.x) {
    const long long p = __ldcg(a.sel + w);
    const int cur = (int)__ldcg(a.cur_safe + w);
    const size_t row0 = (size_t)p * a.RF;
    float best = -INFINITY;
    int bj = 0;
    bool any = false;
    for (int j = 0; j < a.RF; ++j) {
      const int r = a.rows[row0 + j];
      const int rs = r > 0 ? r : 0;
      const int cb = a.replica_broker[rs];
      const float va = a.value[rs];
      const float wb = load_w(a, cb);
      const float deficit = deficit_of(a, cb);
      bool ok = r >= 0 && r != cur && a.static_ok[rs] && a.alive[cb] &&
                a.leader_ok[cb] &&
                __fadd_rn(wb, va) <= a.hard_cap[cb * a.cap_s];
      if (a.improve_gate) ok = ok && va < __fmul_rn(2.0f, deficit);
      // (jit + salt) mod 1: the truncated remainder, shifted to be >= 0
      float frac = fmodf(__fadd_rn(a.jit[row0 + j], a.salt), 1.0f);
      if (frac != 0.f && frac < 0.f) frac = __fadd_rn(frac, 1.0f);
      // each product and the sum after it are one FMA, as the reference's
      // compiled sweep rounds them
      float sc = __fmaf_rn(jit_amp, frac, deficit);
      if (a.tb != nullptr) {
        const float tbn =
            __fdiv_rn(__fsub_rn(a.tb[cb * a.tb_s], tb_lo), tb_den);
        sc = __fmaf_rn(tb_amp, tbn, sc);
      }
      sc = ok ? sc : -INFINITY;
      if (j == 0 || sc > best) {
        best = sc;
        bj = j;
      }
      any = any || ok;
    }
    const int r = a.rows[row0 + bj];
    const int d = r > 0 ? r : 0;
    a.dst_r[w] = d;
    a.dst_b[w] = a.replica_broker[d];
    a.has[w] = __ldcg(a.live_w + w) && any;
  }
}

__global__ void __launch_bounds__(kThreads, 2) sweep_window_kernel(Args a) {
  __shared__ u64 keys[kWindow];
  __shared__ int sh[256];
  __shared__ int tmp[33];
  __shared__ float red[kWarps];
  __shared__ unsigned dmax;
  __shared__ tks::Select st;
  cg::grid_group grid = cg::this_grid();
  if (threadIdx.x == 0) {
    tks::select_init(st, kWindow);
    dmax = 0u;
  }
  __syncthreads();
  if (a.fold) {
    phase_fold(a);
    grid.sync();
  }
  if (a.compact) tks::select_zero(a.hist);
  phase_sources(a, red);
  grid.sync();
  if (a.compact) {
    phase_window(a, red, sh);
    grid.sync();
    for (int q = 1; q < tks::kPasses; ++q) {
      const bool more = tks::select_pass(a.list, a.hist, kWindow, q, st, sh);
      __syncthreads();
      if (!more) break;
      grid.sync();
    }
    const bool compacted =
        tks::select_compact(a.list, a.hist, kWindow, st, a.sel_keys);
    __syncthreads();
    if (compacted) grid.sync();
    EmitRow emit{a, &dmax};
    if (!tks::select_order(a.list, a.hist, a.sel_keys, kWindow, keys,
                           emit)) {
      Listed listed{a};
      EmitTail tail{a, &dmax};
      tks::select_tail(a.hist, kWindow, tmp, listed, tail);
    }
    __syncthreads();
    write_partial(a, kDefMax, __uint_as_float(dmax));
    grid.sync();
  }
  phase_pick(a, red);
}

int g_blocks[16];  // cooperative grid size per device, 0 until queried

int coop_blocks(int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 16 && g_blocks[dev] > 0) {
    *blocks = g_blocks[dev];
    return 0;
  }
  int sms = 0, coop = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sweep_window_kernel, kThreads, 0);
  }
  if (e != cudaSuccess) return (int)e;
  if (!coop || per_sm < 1) return (int)cudaErrorNotSupported;
  *blocks = sms * (per_sm < 2 ? per_sm : 2);
  if (*blocks > kMaxBlocks) *blocks = kMaxBlocks;
  if (dev < 16) g_blocks[dev] = *blocks;
  return 0;
}

}  // namespace

extern "C" int cc_sweep_window_partials() { return kPartials * kMaxBlocks; }
// The window's width (the wrapper checks it against
// analyzer/leadership.py SWEEP_COMPACT) and the shared select's digit
// counts with its two counters (the hist scratch's size).
extern "C" int cc_sweep_window_width() { return kWindow; }
extern "C" int cc_select_hist_words() { return tks::kHistWords; }

// One round's window (see above).  cur i32[P] and failed f32[P] are
// updated in place by the fold (fold != 0: the p_* rows of the previous
// round, Wn of them).  Broker vectors are read through their strides (0
// for a broadcast value).  Scratch: partials f32[cc_sweep_window_
// partials()], and when P > 4096 g0 f32[P], listed u8[P], list u64[P],
// hist i32[tks::kHistWords], sel_keys u64[4096].  Outputs [Wn], Wn =
// min(P, 4096): sel i64, has u8, live_w u8, cur_safe i64, src_b i32,
// value_leave f32, dst_r i64, dst_b i32.
extern "C" int cc_sweep_window(
    int P, int RF, int B, int fold, int improve_gate, int salt_i, float salt,
    float select_jitter, int* cur, float* failed, const long long* p_sel,
    const long long* p_cur_safe, const long long* p_dst_r,
    const uint8_t* p_valid, const uint8_t* p_live_w, const int* rows,
    const float* jit, const int* replica_broker,
    const int* replica_partition, const float* value,
    const uint8_t* static_ok, const uint8_t* alive, const uint8_t* leader_ok,
    const float* W, long long W_s, const float* shed_to, long long shed_s,
    const float* fill_to, long long fill_s, const float* hard_cap,
    long long cap_s, const float* tb, long long tb_s, float* partials,
    float* g0, uint8_t* listed, u64* list, int* hist, u64* sel_keys,
    long long* sel, uint8_t* has, uint8_t* live_w, long long* cur_safe,
    int* src_b, float* value_leave, long long* dst_r, int* dst_b,
    void* stream) {
  if (P <= 0) return 0;
  if (RF <= 0) return (int)cudaErrorInvalidValue;
  const int Wn = P < kWindow ? P : kWindow;
  Args a{P,         RF,          B,         Wn,          P > kWindow,
         fold,      improve_gate, salt_i,   salt,        select_jitter,
         cur,       failed,      p_sel,     p_cur_safe,  p_dst_r,
         p_valid,   p_live_w,    rows,      jit,         replica_broker,
         replica_partition,      value,     static_ok,   alive,
         leader_ok, W,           W_s,       shed_to,     shed_s,
         fill_to,   fill_s,      hard_cap,  cap_s,       tb,
         tb_s,      partials,    g0,        listed,      list,
         hist,      sel_keys,    sel,       has,         live_w,
         cur_safe,  src_b,       value_leave, dst_r,     dst_b};
  int blocks = 0;
  int err = coop_blocks(&blocks);
  if (err != 0) return err;
  // a thread per partition, and (compaction) the order's 64 keys a block
  int want = (P + kThreads - 1) / kThreads;
  const int order_blocks = kWindow / (kThreads / tks::kGroup);
  if (a.compact && want < order_blocks) want = order_blocks;
  if (want < blocks) blocks = want;
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)sweep_window_kernel, dim3(blocks), dim3(kThreads), params,
      0, static_cast<cudaStream_t>(stream));
}
