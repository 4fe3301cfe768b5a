// K1 row_topk: per-broker top-k (k <= 64) of a broker table's scores.
//
// Replaces rows_pick_topk / rows_pick_best and table_pick_topk /
// table_pick_best of cruise_control_tpu/analyzer/kernels.py
// (jax.lax.top_k over the [B, S] broker table, then a gather of the
// winning slots' replica ids), leadership_round's jax.lax.top_k(bonus_rows,
// 16) and deep_pick's top_k(..., 64), and move_round's struct_any
// (jnp.any(sc_rows > NEG / 2, 1)).  Two sources of a row's scores:
//   * plane: a NEG-masked f32[B, S] plane;
//   * table: the per-replica score f32[R] (any stride) and valid u8[R],
//     read through the table itself -- slot (b, j) holds
//     valid[id] ? score[id] : NEG for id = table[b, j] in [0, R), and NEG
//     for a pad slot (id R) -- the reference's _table_rows, with no
//     [B, S] plane in device memory.
// Order: score descending in XLA's float total order (-0.0 below +0.0),
// then slot ascending -- jax.lax.top_k's order, which the plain version
// sorts on (ops.topk_total).  Out per row and rank:
// top = the score (its own bits, -0.0 kept), slot, has = top > NEG/2,
// cand = has ? table[b, slot] : -1; per row any = has at rank 0 (a score
// above NEG/2 in the row).
//
// Bound: memory.  One read of the row (4 bytes a slot; the table source
// reads the ids and gathers 5 bytes a slot) and k outputs: 0.9 MB at
// B = 200, S = 1152, about 0.3 us at 3.35 TB/s, so the launch and the
// row's chain of dependent steps, not the bytes, set the time.
//
// Design.  The select, for every k: a row a block of 256 threads, or of
// one warp when the rows are many (2,600 rows fill the card that way in
// one wave).  The row is staged once as the scores' order-preserving
// 32-bit keys, a block's beside the slots' replica ids (in registers when
// they fit, else in shared memory), with the first 8-bit digit's
// histogram.  A radix select finds the k-th largest key one 8-bit digit a
// pass (shared-memory atomics with no return, which do not stall the
// thread, into bins padded so that each lane's scan reads its own bank;
// every warp scans the histogram itself, so a pass is one barrier) and
// stops as soon as the keys that share the chosen prefix are exactly the
// rank still wanted: then the winners are every key at or above the
// prefix.  After the fourth digit the threshold is one score, and its
// tied keys are taken lowest slot first (their ranks from a ballot a warp
// and iteration and one prefix scan of those counts).  The k winners are
// compacted (one shared atomic a warp) as unique 48-bit keys, the score's
// key above 0xFFFF - slot, and each is written at its rank, the count of
// larger winners, with the score read back from its key.  The register
// path, for k <= 8: each thread keeps its top k in registers and a block
// argmax merges them in k rounds (two barriers a round), the winners' ids
// read together at the end.  The wrapper picks the path by k and B from
// phase 2's times (cuda_kernels.ROW_TOPK_*).  No allocation, no sync with
// the host.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 64;
constexpr int kMaxS = 16384;
constexpr float kNeg = -1e30f;
constexpr float kNegHalf = -5e29f;

typedef unsigned long long u64;

struct Args {
  const float* sc;       // plane f32[B, S], or null (table source)
  const float* score;    // table source: f32[R] at `score_stride`
  long long score_stride;
  const uint8_t* valid;  // table source: u8[R]
  int R;
  const int* table;      // i32[B, S] replica ids
  int B, S, k;
  int* cand;
  uint8_t* has;
  float* top;
  int* slot;
  uint8_t* any;          // u8[B] or null
};

// slot (b, j)'s score, its replica id being `id`
template <bool kTable>
__device__ __forceinline__ float value_at(const Args& a, int b, int j,
                                          int id) {
  if (!kTable) return a.sc[(size_t)b * a.S + j];
  return (id >= 0 && id < a.R && a.valid[id] != 0)
             ? a.score[(long long)id * a.score_stride]
             : kNeg;
}

// float -> uint32 whose unsigned order is the float total order
__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the float a key's order bits came from (-0.0 and every other value
// exactly)
__device__ __forceinline__ float order_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// rank `rank` of row b: the score of `key`, slot s, replica id `id`
__device__ __forceinline__ void write_out(const Args& a, int b, int rank,
                                          uint32_t key, int s, int id) {
  const int o = b * a.k + rank;
  const float v = order_value(key);
  const bool h = v > kNegHalf;
  a.top[o] = v;
  a.has[o] = h;
  a.cand[o] = h ? id : -1;
  a.slot[o] = s;
  if (rank == 0 && a.any != nullptr) a.any[b] = h;
}

// A histogram bin's word: one pad word every 8 bins, so a lane reading 8
// consecutive bins hits its own bank
__device__ __forceinline__ int bin(uint32_t d) { return d + (d >> 3); }
constexpr int kBinWords = 256 + 32;

// A thread's keys and (kIds) replica ids: kN of each in registers (slot
// i * kT + threadIdx.x for i < kN), or with kN = 0 in shared memory (the
// row's slots rounded up to whole iterations: keys, then ids).
template <int kT, int kN, bool kIds>
struct Keys {
  uint32_t r[kN > 0 ? kN : 1];
  int ri[kN > 0 ? kN : 1];
  uint32_t* s;
  int S;
  __device__ __forceinline__ int count() const {
    return kN > 0 ? kN : (S + kT - 1) / kT;
  }
  __device__ __forceinline__ uint32_t get(int i) const {
    if constexpr (kN > 0) {
      return r[i];
    } else {
      return s[i * kT + threadIdx.x];
    }
  }
  __device__ __forceinline__ int id(int i) const {
    if constexpr (kN > 0) {
      return ri[i];
    } else {
      return (int)s[count() * kT + i * kT + threadIdx.x];
    }
  }
  __device__ __forceinline__ void set(int i, uint32_t v, int id) {
    if constexpr (kN > 0) {
      r[i] = v;
      if (kIds) ri[i] = id;
    } else {
      s[i * kT + threadIdx.x] = v;
      if (kIds) s[count() * kT + i * kT + threadIdx.x] = (uint32_t)id;
    }
  }
};

// f(i) for each of a thread's keys i: unrolled when they sit in registers
template <int kN, typename F>
__device__ __forceinline__ void for_keys(int n, F&& f) {
  if constexpr (kN > 0) {
#pragma unroll
    for (int i = 0; i < kN; ++i) f(i);
  } else {
    for (int i = 0; i < n; ++i) f(i);
  }
}

// A row a block of kT threads: 256 (a row's slots spread over eight warps)
// or 32 (a warp a row, for many rows); each thread's kN keys in registers
// (S <= kN * kT), or with kN = 0 the row's keys in shared memory.
template <int kT, int kN, bool kTable>
__global__ void __launch_bounds__(kT) row_select_kernel(Args a) {
  // a block stages the slots' ids with the keys, sparing the write its
  // dependent load; a warp a row reads the winners' ids at the end (their
  // registers would cost it occupancy)
  constexpr bool kIds = kT >= 256;
  constexpr int kW = kT / 32;
  constexpr int kParts = kT >= 256 ? 4 : 1;  // threads ranking a winner
  extern __shared__ uint32_t smem_keys[];     // keys and ids (kN = 0)
  __shared__ unsigned int hist[3][kBinWords];
  // tied keys of each (iteration, warp), then their exclusive prefix
  __shared__ unsigned int tied[kMaxS / kT][kW];
  __shared__ u64 win[kMaxK];
  __shared__ int win_id[kMaxK];
  __shared__ int n_win;
  const int b = blockIdx.x;
  const int S = a.S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Keys<kT, kN, kIds> keys;
  keys.s = smem_keys;
  keys.S = S;
  const int n = keys.count();
  for (int i = threadIdx.x; i < 3 * kBinWords; i += kT) {
    (&hist[0][0])[i] = 0;
  }
  if (threadIdx.x == 0) n_win = 0;
  __syncthreads();
  // stage the row's keys and ids, counting the first digit
  for_keys<kN>(n, [&](int i) {
    const int j = i * kT + threadIdx.x;
    uint32_t key = 0;
    int id = -1;
    if (j < S) {
      if (kIds || kTable) id = a.table[(size_t)b * S + j];
      key = order_bits(value_at<kTable>(a, b, j, id));
      atomicAdd(&hist[0][bin(key >> 24)], 1u);
    }
    keys.set(i, key, id);
  });
  __syncthreads();
  // radix select of the k-th largest score key, 8 bits a pass; every warp
  // derives the same digit from the same histogram (one barrier a pass:
  // the histograms rotate through three buffers, so the one being zeroed
  // is neither read nor counted into by any warp)
  uint32_t prefix = 0;
  unsigned int rem = (unsigned int)a.k;
  int shift = 24;
  int cur = 0;
  bool tie = false;  // the threshold is one score, its keys taken by slot
  while (true) {
    unsigned int h[8];
    unsigned int sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      h[i] = hist[cur][bin(255 - 8 * lane - i)];
      sum += h[i];
    }
    unsigned int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    const int src = __ffs(__ballot_sync(0xffffffffu, incl >= rem)) - 1;
    unsigned int run = incl - sum, d = 0, cnt = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (cnt == 0 && run + h[i] >= rem) {
        d = 255 - 8 * lane - i;
        cnt = h[i];
      } else if (cnt == 0) {
        run += h[i];
      }
    }
    d = __shfl_sync(0xffffffffu, d, src);
    cnt = __shfl_sync(0xffffffffu, cnt, src);
    run = __shfl_sync(0xffffffffu, run, src);
    prefix |= d << shift;
    rem -= run;
    if (cnt == rem) break;
    if (shift == 0) {
      tie = true;
      break;
    }
    for (int i = threadIdx.x; i < kBinWords; i += kT) {
      hist[(cur + 2) % 3][i] = 0;
    }
    shift -= 8;
    const uint32_t p = prefix >> (shift + 8);
    const int nxt = (cur + 1) % 3;
    for_keys<kN>(n, [&](int i) {
      const int j = i * kT + threadIdx.x;
      const uint32_t key = keys.get(i);
      if (j < S && (key >> (shift + 8)) == p) {
        atomicAdd(&hist[nxt][bin((key >> shift) & 255u)], 1u);
      }
    });
    cur = nxt;
    __syncthreads();
  }
  // the winners: keys above the threshold and, when it is one tied score,
  // its `rem` lowest slots (a tied slot's rank: the tied keys of the
  // iterations and warps before its own, then of the lanes below it)
  if (tie) {
    for_keys<kN>(n, [&](int i) {
      const int j = i * kT + threadIdx.x;
      const unsigned int m =
          __ballot_sync(0xffffffffu, j < S && keys.get(i) == prefix);
      if (lane == 0) tied[i][warp] = __popc(m);
    });
    __syncthreads();
    if (warp == 0) {
      unsigned int carry = 0;
      for (int e0 = 0; e0 < n * kW; e0 += 32) {
        const int e = e0 + lane;
        const unsigned int v = e < n * kW ? (&tied[0][0])[e] : 0;
        unsigned int sc = v;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned int o = __shfl_up_sync(0xffffffffu, sc, off);
          if (lane >= off) sc += o;
        }
        if (e < n * kW) (&tied[0][0])[e] = carry + sc - v;
        carry += __shfl_sync(0xffffffffu, sc, 31);
      }
    }
    __syncthreads();
  }
  for_keys<kN>(n, [&](int i) {
    const int j = i * kT + threadIdx.x;
    const uint32_t key = keys.get(i);
    bool take = j < S && (tie ? key > prefix : key >= prefix);
    if (tie) {
      const unsigned int m =
          __ballot_sync(0xffffffffu, j < S && key == prefix);
      const unsigned int r = tied[i][warp] + __popc(m & ((1u << lane) - 1u));
      take = take || ((m >> lane) & 1u && r < rem);
    }
    const unsigned int m = __ballot_sync(0xffffffffu, take);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(&n_win, __popc(m));
    base = __shfl_sync(0xffffffffu, base, 0);
    const int at = base + __popc(m & ((1u << lane) - 1u));
    if (take && at < kMaxK) {
      win[at] = ((u64)key << 16) | (u64)(0xFFFFu - (uint32_t)j);
      if (kIds) win_id[at] = keys.id(i);
    }
  });
  __syncthreads();
  // each winner's rank, the count of larger winners (kParts threads a
  // winner)
  for (int w0 = 0; w0 < a.k; w0 += kT / kParts) {
    const int w = w0 + (int)threadIdx.x / kParts;
    const int part = threadIdx.x % kParts;
    const u64 mine = w < a.k ? win[w] : 0;
    int rank = 0;
    for (int i = part; i < a.k; i += kParts) rank += win[i] > mine;
    if (kParts == 4) {
      rank += __shfl_xor_sync(0xffffffffu, rank, 1);
      rank += __shfl_xor_sync(0xffffffffu, rank, 2);
    }
    if (w < a.k && part == 0) {
      const int s = 0xFFFF - (int)(mine & 0xFFFFu);
      write_out(a, b, rank, (uint32_t)(mine >> 16), s,
                kIds ? win_id[w] : a.table[(size_t)b * S + s]);
    }
  }
}

__device__ __forceinline__ bool better(uint32_t v, int s, uint32_t u,
                                       int t) {
  return v > u || (v == u && s < t);
}

// k <= 8: each thread's top K of a strided slice in registers, merged in K
// rounds of a block argmax (two barriers a round).
template <int K, bool kTable>
__global__ void __launch_bounds__(kThreads)
    row_register_kernel(Args a) {
  const int b = blockIdx.x;
  uint32_t lv[K];
  int ls[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    lv[i] = 0;
    ls[i] = INT_MAX;
  }
  for (int j = threadIdx.x; j < a.S; j += kThreads) {
    uint32_t v = order_bits(value_at<kTable>(
        a, b, j, kTable ? a.table[(size_t)b * a.S + j] : 0));
    int s = j;
#pragma unroll
    for (int p = 0; p < K; ++p) {
      if (better(v, s, lv[p], ls[p])) {
        const uint32_t tv = lv[p];
        const int ts = ls[p];
        lv[p] = v;
        ls[p] = s;
        v = tv;
        s = ts;
      }
    }
  }
  __shared__ uint32_t w_v[kWarps];
  __shared__ int w_s[kWarps];
  __shared__ int win_s;
  __shared__ int slots[K];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = 0; i < K; ++i) {
    uint32_t v = lv[0];
    int s = ls[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const uint32_t ov = __shfl_down_sync(0xffffffffu, v, off);
      const int os = __shfl_down_sync(0xffffffffu, s, off);
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
      uint32_t bv = w_v[0];
      int bs = w_s[0];
      for (int w = 1; w < kWarps; ++w) {
        if (better(w_v[w], w_s[w], bv, bs)) {
          bv = w_v[w];
          bs = w_s[w];
        }
      }
      win_s = bs;
      const float v = order_value(bv);
      slots[i] = v > kNegHalf ? bs : -1;
      const int o = b * K + i;
      a.top[o] = v;
      a.has[o] = v > kNegHalf;
      a.slot[o] = bs;
      if (i == 0 && a.any != nullptr) a.any[b] = v > kNegHalf;
    }
    __syncthreads();
    if (ls[0] == win_s) {  // the winner pops its head
#pragma unroll
      for (int p = 0; p + 1 < K; ++p) {
        lv[p] = lv[p + 1];
        ls[p] = ls[p + 1];
      }
      lv[K - 1] = 0;
      ls[K - 1] = INT_MAX;
    }
  }
  __syncthreads();
  // the winners' replica ids, all at once
  if (threadIdx.x < K) {
    const int o = b * K + threadIdx.x;
    const int sl = slots[threadIdx.x];
    a.cand[o] = sl >= 0 ? a.table[(size_t)b * a.S + sl] : -1;
  }
}

template <bool kTable>
int launch_register(const Args& a, cudaStream_t st) {
  switch (a.k) {
#define CC_ROW_CASE(K)                                                   \
  case K:                                                                \
    row_register_kernel<K, kTable><<<a.B, kThreads, 0, st>>>(a);         \
    break;
    CC_ROW_CASE(1)
    CC_ROW_CASE(2)
    CC_ROW_CASE(3)
    CC_ROW_CASE(4)
    CC_ROW_CASE(5)
    CC_ROW_CASE(6)
    CC_ROW_CASE(7)
    CC_ROW_CASE(8)
#undef CC_ROW_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int kT, int kN, bool kTable>
int launch_select(const Args& a, cudaStream_t st) {
  const size_t smem = kN > 0 ? 0
                             : (kT >= 256 ? 2 : 1) *
                                   (size_t)((a.S + kT - 1) / kT) * kT *
                                   sizeof(uint32_t);
  if (smem > 32 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_select_kernel<kT, kN, kTable>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  row_select_kernel<kT, kN, kTable><<<a.B, kT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The select with kT threads a row: the keys in registers when they fit
// (8 a thread of a block, 32 a lane of a warp), else in shared memory.
template <int kT, bool kTable>
int launch_select(const Args& a, cudaStream_t st) {
  constexpr int kN = kT >= 256 ? 8 : 32;
  if (a.S <= kN * kT) return launch_select<kT, kN, kTable>(a, st);
  return launch_select<kT, 0, kTable>(a, st);
}

// path: 0 the select with a block of 256 a row, 1 the register path (k <=
// 8), 2 the select with a warp a row
int launch(const Args& a, int path, cudaStream_t st) {
  if (a.B <= 0) return 0;
  if (a.S < 1 || a.S > kMaxS || a.k < 1 || a.k > kMaxK || a.k > a.S ||
      path < 0 || path > 2 || (path == 1 && a.k > 8)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool table = a.sc == nullptr;
  if (path == 1) {
    return table ? launch_register<true>(a, st)
                 : launch_register<false>(a, st);
  }
  if (path == 2) {
    return table ? launch_select<32, true>(a, st)
                 : launch_select<32, false>(a, st);
  }
  return table ? launch_select<kThreads, true>(a, st)
               : launch_select<kThreads, false>(a, st);
}

}  // namespace

// Plane source: sc f32[B, S], table i32[B, S]; out cand i32[B*k], has
// u8[B*k], top f32[B, k], slot i32[B, k], any u8[B] (or null).  `path`: 0
// the select a block a row, 1 the register path (k <= 8), 2 the select a
// warp a row.  1 <= k <= min(64, S), S <= 16384.
extern "C" int cc_row_topk(const float* sc, const int* table, int B, int S,
                           int k, int* cand, uint8_t* has, float* top,
                           int* slot, uint8_t* any, int path, void* stream) {
  if (sc == nullptr) return (int)cudaErrorInvalidValue;
  Args a{sc, nullptr, 0, nullptr, 0, table, B, S, k, cand, has, top, slot,
         any};
  return launch(a, path, static_cast<cudaStream_t>(stream));
}

// Table source: score f32[R] (stride `score_stride` floats), valid u8[R],
// table i32[B, S] (ids in [0, R]; R is the pad); outputs as above.
extern "C" int cc_table_topk(const float* score, long long score_stride,
                             const uint8_t* valid, int R, const int* table,
                             int B, int S, int k, int* cand, uint8_t* has,
                             float* top, int* slot, uint8_t* any, int path,
                             void* stream) {
  Args a{nullptr, score, score_stride, valid, R, table, B, S, k, cand, has,
         top, slot, any};
  return launch(a, path, static_cast<cudaStream_t>(stream));
}
