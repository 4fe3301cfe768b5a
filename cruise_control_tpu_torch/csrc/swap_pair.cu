// K10: the swap round around its acceptance plane, in two launches.
//
// Replaces, in swap_round (cruise_control_tpu/analyzer/kernels.py), every
// line after the picks: the deviations, the two shortlists and their
// gathers (entry cc_swap_shortlist, "K10a"), and after the acceptance
// plane (the prior goals' callbacks, torch ops) the pair plane, its row
// argmax, the three conflict resolutions and the scatter onto the broker
// axis (entry cc_swap_pair, "K10b").
//
// K10a.  dev = dev_u, or util - target when the caller gives none (then
// written out); hot rank = hot[b] && out_has[b] ? dev[b] : -inf, cold rank
// = cold[b] && in_has[b] ? -dev[b] : -inf (-(+0.0) is -0.0, so the ranks
// hold signed zeros).  Each shortlist is jax.lax.top_k(rank, H), H =
// min(SWAP_SHORTLIST, B): XLA's total order (-0.0 below +0.0), ties and
// the -inf tail to the lower broker id.  Outputs h_ids, c_ids (int64[H])
// and out_h = max(out_r[h_ids], 0), in_c = max(in_r[c_ids], 0) (int64[H],
// the acceptance callback's arguments).  Design: one launch of two
// blocks of 1,024 threads, one a side.  A block counts the listed brokers
// (rank above -inf); with H or fewer, each listed key's rank is the count
// of larger listed keys and the tail the lowest-index unlisted brokers by
// a block-wide prefix count; with more, a radix select of the H-th
// largest 64-bit key (the rank's order-preserving bits over the
// complemented broker id: unique keys) over 8-bit digits, each digit's
// bin found by one warp's scan, stopping as soon as the prefix isolates
// exactly the rank left, then the H selected keys ranked by counting.
// The keys are recomputed from global memory on each digit pass (a few
// KB, in L1), so B has no limit.
//
// K10b.  Hot row h is broker hb = h_ids[h] shedding replica o =
// max(out_r[hb], 0); cold column c is broker cb = c_ids[c] giving replica
// i = max(in_r[cb], 0).  Per pair:
//     delta  = w[o] - w[i]
//     dh     = dev_u[hb], dc = dev_u[cb]
//     imp    = fma(dh, dh, dc*dc) - fma(dh', dh', dc'*dc')
//              with dh' = dh - delta, dc' = dc + delta
//     feasible = out_has[hb] && in_has[cb] && hot[hb] && cold[cb]
//                && delta > 0 && imp > 0
//                && no sibling replica of o's partition on cb
//                && no sibling replica of i's partition on hb
//                && accept[h, c]
//                (&& util[hb] - delta >= lower[hb])   with a lower band
//                (&& util[cb] + delta <= upper[cb])   with an upper band
// Per row the max of (feasible ? imp : NEG) and its first column
// (jnp.argmax's tie rule; a row with nothing feasible gives NEG at
// column 0); sel_h = that max, valid_h = sel_h > NEG / 2, cold_h =
// c_ids[column].  Then the three keep resolutions of resolve_dest_
// conflicts in order, by cold_h, by the partition of o, by the partition
// of max(in_r[cold_h], 0): each keeps, among the rows still valid, the
// max sel_h of each segment, ties to the lowest row.  Outputs cold
// (int32[B]) and valid (bool[B]): cold_h and valid_h at h_ids, zeros
// elsewhere.  Each sum of squares is one fused multiply-add, as XLA:CPU
// contracts it inside the reference's compiled round (__fmaf_rn); every
// other product, sum and difference is rounded on its own.  Design: a
// block per hot row, a thread per cold column, a warp-shuffle argmax and
// a shared-memory pass over the warps, then the row's best, its cold
// broker and the partitions of its two replicas into scratch; the last
// block to finish (a counter that it resets) resolves the <= kMaxH rows
// in shared memory (each row against every other, one broadcast load a
// row) and writes both [B] outputs whole.  Vectors and the acceptance
// plane are read through their strides, so a column of a cache plane or
// a broadcast plane is never copied.
//
// Bound: bytes.  K10a reads each broker's flags and deviation once a
// side; K10b the H x H acceptance plane and, per row and per column, a
// replica id, a weight, a deviation and RF sibling brokers, and writes
// the two [B] outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr float kNeg = -1e30f;
constexpr int kPairThreads = 128;
constexpr int kListThreads = 1024;
constexpr int kListWarps = kListThreads / 32;
constexpr int kMaxH = 1024;

__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// ---------------------------------------------------------------------------
// K10a: the shortlists
// ---------------------------------------------------------------------------

struct ListArgs {
  int B, H;
  const uint8_t* hot;
  const uint8_t* cold;
  const uint8_t* out_has;
  const uint8_t* in_has;
  const int* out_r;
  const int* in_r;
  const float* dev_u;  // null: util - target
  long long dev_s;
  const float* util;
  long long util_s;
  const float* target;
  long long target_s;
  float* dev_out;  // written when dev_u is null
  long long* h_ids;
  long long* c_ids;
  long long* out_h;
  long long* in_c;
};

__device__ __forceinline__ float dev_of(const ListArgs& a, int b) {
  if (a.dev_u != nullptr) return a.dev_u[b * a.dev_s];
  return __fsub_rn(a.util[b * a.util_s], a.target[b * a.target_s]);
}

// the side's rank of broker b: hot (side 0) or cold (side 1)
__device__ __forceinline__ float rank_of(const ListArgs& a, int side, int b) {
  const float d = dev_of(a, b);
  if (side == 0) return (a.hot[b] && a.out_has[b]) ? d : -INFINITY;
  return (a.cold[b] && a.in_has[b]) ? -d : -INFINITY;
}

__device__ __forceinline__ u64 key_of(float v, int b) {
  return ((u64)order_bits(v) << 32) | (u64)(~(uint32_t)b);
}

__device__ __forceinline__ bool listed(float v) { return !(v == -INFINITY); }

__device__ __forceinline__ void emit(const ListArgs& a, int side, int pos,
                                     int b) {
  if (side == 0) {
    a.h_ids[pos] = b;
    const int o = a.out_r[b];
    a.out_h[pos] = o > 0 ? o : 0;
  } else {
    a.c_ids[pos] = b;
    const int i = a.in_r[b];
    a.in_c[pos] = i > 0 ? i : 0;
  }
}

// block-wide exclusive prefix count of `flag`; the block's total in *tot
__device__ int block_prefix(bool flag, int* warp_tot, int* tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int below = __popc(ballot & ((1u << lane) - 1u));
  __syncthreads();
  if (lane == 0) warp_tot[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kListWarps ? warp_tot[lane] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane < kListWarps) warp_tot[lane] = incl - v;
    if (lane == 31) *tot = incl;
  }
  __syncthreads();
  return warp_tot[warp] + below;
}

__global__ void __launch_bounds__(kListThreads) swap_shortlist_kernel(
    ListArgs a) {
  __shared__ u64 s_keys[kMaxH];
  __shared__ int s_hist[256];
  __shared__ int s_warp[kListWarps];
  __shared__ int s_tot;
  __shared__ int s_n;
  __shared__ int s_digit, s_above, s_count;
  const int side = blockIdx.x;
  const int t = threadIdx.x;
  if (side == 0 && a.dev_u == nullptr) {
    for (int b = t; b < a.B; b += blockDim.x) a.dev_out[b] = dev_of(a, b);
  }
  // the listed brokers
  int cnt = 0;
  for (int b = t; b < a.B; b += blockDim.x) cnt += listed(rank_of(a, side, b));
  if (t == 0) s_n = 0;
  __syncthreads();
  if (cnt) atomicAdd(&s_n, cnt);
  __syncthreads();
  const int n = s_n;
  const int H = a.H;
  u64 prefix = 0, mask = 0;
  if (n > H) {
    // radix select of the H-th largest listed key
    int k_rem = H;
    for (int d = 0; d < 8; ++d) {
      const int shift = 56 - 8 * d;
      for (int j = t; j < 256; j += blockDim.x) s_hist[j] = 0;
      __syncthreads();
      for (int b = t; b < a.B; b += blockDim.x) {
        const float v = rank_of(a, side, b);
        if (!listed(v)) continue;
        const u64 key = key_of(v, b);
        if ((key & mask) == prefix) {
          atomicAdd(&s_hist[(int)((key >> shift) & 0xFFu)], 1);
        }
      }
      __syncthreads();
      if (t < 32) {
        // lane l holds the bins 255 - 8 l .. 248 - 8 l, highest first
        int local = 0;
        for (int j = 0; j < 8; ++j) local += s_hist[255 - 8 * t - j];
        int incl = local;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int o = __shfl_up_sync(0xffffffffu, incl, off);
          if (t >= off) incl += o;
        }
        int above = incl - local;
        if (above < k_rem && incl >= k_rem) {
          for (int j = 0; j < 8; ++j) {
            const int bin = 255 - 8 * t - j;
            const int c = s_hist[bin];
            if (above + c >= k_rem) {
              s_digit = bin;
              s_above = above;
              s_count = c;
              break;
            }
            above += c;
          }
        }
      }
      __syncthreads();
      prefix |= (u64)s_digit << shift;
      mask |= (u64)0xFFu << shift;
      k_rem -= s_above;
      const bool done = s_count == k_rem;
      __syncthreads();
      if (done) break;
    }
  }
  // the selected listed keys into shared memory: all n, or the H >= prefix
  if (t == 0) s_tot = 0;
  __syncthreads();
  for (int b = t; b < a.B; b += blockDim.x) {
    const float v = rank_of(a, side, b);
    if (!listed(v)) continue;
    const u64 key = key_of(v, b);
    if (n <= H || key >= prefix) s_keys[atomicAdd(&s_tot, 1)] = key;
  }
  __syncthreads();
  const int s = n <= H ? n : H;
  for (int j = t; j < s; j += blockDim.x) {
    const u64 key = s_keys[j];
    int rank = 0;
    for (int i = 0; i < s; ++i) rank += s_keys[i] > key;
    emit(a, side, rank, (int)(~(uint32_t)(key & 0xFFFFFFFFull)));
  }
  // the tail: the H - n lowest-index unlisted brokers, in index order
  const int m = H - s;
  int base = 0;
  for (int b0 = 0; b0 < a.B && base < m; b0 += blockDim.x) {
    const int b = b0 + t;
    const bool un = b < a.B && !listed(rank_of(a, side, b));
    const int pos = base + block_prefix(un, s_warp, &s_tot);
    if (un && pos < m) emit(a, side, s + pos, b);
    base += s_tot;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K10b: the pair plane and the resolutions
// ---------------------------------------------------------------------------

struct PairArgs {
  int H, C, RF, B;
  const long long* h_ids;
  const long long* c_ids;
  const int* out_r;
  const int* in_r;
  const uint8_t* out_has;
  const uint8_t* in_has;
  const uint8_t* hot;
  const uint8_t* cold;
  const float* w;
  long long w_s;
  const float* dev_u;
  long long dev_s;
  const float* util;
  long long util_s;
  const float* lower;  // null: no lower band
  long long lower_s;
  const float* upper;  // null: no upper band
  long long upper_s;
  const uint8_t* accept;
  long long acc_s0, acc_s1;
  const int* replica_partition;
  const int* partition_replicas;
  const int* replica_broker;
  float* sel;          // scratch f32[H]: each row's best improvement
  int* segs;           // scratch i32[3 H]: its cold broker and partitions
  unsigned* done;      // scratch counter, zero between launches
  int* cold_out;       // i32[B]
  uint8_t* valid_out;  // u8[B]
};

__device__ __forceinline__ bool sibling_on(const PairArgs& a, int replica,
                                           int broker) {
  const int* row =
      a.partition_replicas + (size_t)a.replica_partition[replica] * a.RF;
  bool dup = false;
  for (int j = 0; j < a.RF; ++j) {
    const int s = row[j];
    const int sb = s >= 0 ? a.replica_broker[s] : -1;
    dup |= sb == broker;
  }
  return dup;
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// among the rows still valid, keep each segment's max sel (ties to the
// lowest row); every thread of the block calls it.  Each row's segment
// (-1 when not valid) and sel sit side by side in s_key, so a thread
// tests its row against every other with one broadcast load a row and
// no early exit (the loads overlap).
__device__ void keep_max(int H, const float* s_sel, const int* seg,
                         uint8_t* s_valid, int2* s_key) {
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    s_key[h] = make_int2(s_valid[h] ? seg[h] : -1, __float_as_int(s_sel[h]));
  }
  __syncthreads();
  bool keep[kMaxH / kPairThreads];
  int q = 0;
  for (int h = threadIdx.x; h < H; h += blockDim.x, ++q) {
    const int sh = seg[h];
    const float vh = s_sel[h];
    bool beaten = false;
#pragma unroll 8
    for (int g = 0; g < H; ++g) {
      const int2 e = s_key[g];
      const float v = __int_as_float(e.y);
      beaten |= (e.x == sh) & ((v > vh) | ((v == vh) & (g < h)));
    }
    keep[q] = s_valid[h] && !beaten;
  }
  __syncthreads();
  q = 0;
  for (int h = threadIdx.x; h < H; h += blockDim.x, ++q) s_valid[h] = keep[q];
  __syncthreads();
}

__device__ void resolve(const PairArgs& a) {
  __shared__ float s_sel[kMaxH];
  __shared__ int s_cold[kMaxH];
  __shared__ int s_seg[3][kMaxH];
  __shared__ uint8_t s_valid[kMaxH];
  __shared__ int2 s_key[kMaxH];
  const int H = a.H;
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    const float v = __ldcg(a.sel + h);
    s_sel[h] = v;
    s_valid[h] = v > kNeg / 2;
    for (int r = 0; r < 3; ++r) s_seg[r][h] = __ldcg(a.segs + r * H + h);
    s_cold[h] = s_seg[0][h];
  }
  __syncthreads();
  for (int r = 0; r < 3; ++r) keep_max(H, s_sel, s_seg[r], s_valid, s_key);
  for (int b = threadIdx.x; b < a.B; b += blockDim.x) {
    a.cold_out[b] = 0;
    a.valid_out[b] = 0;
  }
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    const long long hb = a.h_ids[h];
    a.cold_out[hb] = s_cold[h];
    a.valid_out[hb] = s_valid[h];
  }
  if (threadIdx.x == 0) *a.done = 0u;
}

__global__ void __launch_bounds__(kPairThreads) swap_pair_kernel(
    PairArgs a) {
  __shared__ float s_v[kPairThreads / 32];
  __shared__ int s_i[kPairThreads / 32];
  __shared__ bool s_last;
  const int h = blockIdx.x;
  const int hb = (int)a.h_ids[h];
  const int o = a.out_r[hb] > 0 ? a.out_r[hb] : 0;
  const bool row_ok = a.out_has[hb] && a.hot[hb];
  const float w_o = a.w[o * a.w_s];
  const float dh = a.dev_u[hb * a.dev_s];
  float best = kNeg;
  int best_i = 0x7FFFFFFF;
  for (int c = threadIdx.x; c < a.C; c += blockDim.x) {
    const int cb = (int)a.c_ids[c];
    const int i = a.in_r[cb] > 0 ? a.in_r[cb] : 0;
    const float delta = __fsub_rn(w_o, a.w[i * a.w_s]);
    const float dc = a.dev_u[cb * a.dev_s];
    const float before = __fmaf_rn(dh, dh, __fmul_rn(dc, dc));
    const float ah = __fsub_rn(dh, delta);
    const float ac = __fadd_rn(dc, delta);
    const float after = __fmaf_rn(ah, ah, __fmul_rn(ac, ac));
    const float imp = __fsub_rn(before, after);
    bool ok = row_ok && a.in_has[cb] && a.cold[cb] && delta > 0.f &&
              imp > 0.f && a.accept[h * a.acc_s0 + c * a.acc_s1];
    if (ok && a.lower) {
      ok = __fsub_rn(a.util[hb * a.util_s], delta) >=
           a.lower[hb * a.lower_s];
    }
    if (ok && a.upper) {
      ok = __fadd_rn(a.util[cb * a.util_s], delta) <=
           a.upper[cb * a.upper_s];
    }
    if (ok) ok = !sibling_on(a, o, cb) && !sibling_on(a, i, hb);
    const float v = ok ? imp : kNeg;
    if (better(v, c, best, best_i)) {
      best = v;
      best_i = c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (better(ov, oi, best, best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_v[warp] = best;
    s_i[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < (int)(blockDim.x >> 5); ++k) {
      if (better(s_v[k], s_i[k], best, best_i)) {
        best = s_v[k];
        best_i = s_i[k];
      }
    }
    // nothing feasible: every value is NEG, column 0; the row's segments
    // of the three resolutions: its cold broker, the partitions of the
    // outgoing and the incoming replica
    const int cb = (int)a.c_ids[best_i < a.C ? best_i : 0];
    const int i = a.in_r[cb];
    a.sel[h] = best;
    a.segs[h] = cb;
    a.segs[a.H + h] = a.replica_partition[o];
    a.segs[2 * a.H + h] = a.replica_partition[i > 0 ? i : 0];
    __threadfence();
    s_last = atomicAdd(a.done, 1u) == (unsigned)(a.H - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  resolve(a);
}

}  // namespace

// The widest shortlist.
extern "C" int cc_swap_max_shortlist() { return kMaxH; }

// K10a.  hot, cold, out_has, in_has u8[B]; out_r, in_r i32[B]; dev_u
// (f32, stride dev_s) or, when null, util and target (f32, strided), and
// then dev_out f32[B] is written.  Out h_ids, c_ids, out_h, in_c i64[H],
// 1 <= H <= min(B, 1024).  One launch of two blocks.
extern "C" int cc_swap_shortlist(
    int B, int H, const uint8_t* hot, const uint8_t* cold,
    const uint8_t* out_has, const uint8_t* in_has, const int* out_r,
    const int* in_r, const float* dev_u, long long dev_s, const float* util,
    long long util_s, const float* target, long long target_s,
    float* dev_out, long long* h_ids, long long* c_ids, long long* out_h,
    long long* in_c, void* stream) {
  if (B <= 0) return 0;
  if (H < 1 || H > B || H > kMaxH) return (int)cudaErrorInvalidValue;
  ListArgs a{B,     H,      hot,    cold,     out_has,  in_has, out_r,
             in_r,  dev_u,  dev_s,  util,     util_s,   target, target_s,
             dev_out, h_ids, c_ids, out_h,    in_c};
  swap_shortlist_kernel<<<2, kListThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// K10b's counter zeroed once, when it is allocated.
extern "C" int cc_swap_pair_reset(unsigned* done, void* stream) {
  return (int)cudaMemsetAsync(done, 0, sizeof(unsigned),
                              static_cast<cudaStream_t>(stream));
}

// K10b.  h_ids i64[H], c_ids i64[C] (C = H), the [B] flags and picks, w
// (f32[R], stride w_s), dev_u / util / lower / upper (f32[B], strided;
// lower, upper null without a band), accept u8 [H, C] through strides;
// scratch sel f32[H], segs i32[3 H], done u32 (zero, and left zero); out
// cold i32[B], valid u8[B].  One launch of H blocks.
extern "C" int cc_swap_pair(
    int H, int C, int RF, int B, const long long* h_ids,
    const long long* c_ids, const int* out_r, const int* in_r,
    const uint8_t* out_has, const uint8_t* in_has, const uint8_t* hot,
    const uint8_t* cold, const float* w, long long w_s, const float* dev_u,
    long long dev_s, const float* util, long long util_s, const float* lower,
    long long lower_s, const float* upper, long long upper_s,
    const uint8_t* accept, long long acc_s0, long long acc_s1,
    const int* replica_partition, const int* partition_replicas,
    const int* replica_broker, float* sel, int* segs, unsigned* done,
    int* cold_out, uint8_t* valid_out, void* stream) {
  if (H <= 0) return 0;
  if (C < 1 || H > kMaxH) return (int)cudaErrorInvalidValue;
  PairArgs a{H,       C,       RF,      B,        h_ids,   c_ids,
             out_r,   in_r,    out_has, in_has,   hot,     cold,
             w,       w_s,     dev_u,   dev_s,    util,    util_s,
             lower,   lower_s, upper,   upper_s,  accept,  acc_s0,
             acc_s1,  replica_partition,          partition_replicas,
             replica_broker,   sel,     segs,     done,    cold_out,
             valid_out};
  swap_pair_kernel<<<H, kPairThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}
