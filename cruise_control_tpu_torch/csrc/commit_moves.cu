// K3 commit_moves: apply a committed move batch to the round cache.
//
// Replaces update_cache_for_moves with _update_table_for_moves,
// _row_slot_of and _scatter_pm (cruise_control_tpu/analyzer/context.py),
// and the arrival rank it takes from kernels.segment_rank (`arrival_rank`
// in the port), except the re-pack branch, which stays a torch sort.
//
// Inputs per move i: replica r[i], destination dst[i] and valid[i].  A move
// is dropped unless valid[i], dst[i] lies in [0, B) and dst[i] differs from
// the replica's broker (a no-op).  The outputs are the cache's own planes,
// updated in place:
//   * per broker: load [B,4], util = load / max(cap, 1e-9), replica and
//     leader counts, potential NW_OUT, leader bytes-in;
//   * per partition x rack and broker x topic replica counts;
//   * the broker table: the departure slot found by scanning the source
//     row is punched (id = R, ok = 0); arrival k at destination d (the
//     batch's valid arrivals at d, stable by batch index) lands at
//     fill[d] + k with its id, load, bonus, leader flag and eligibility
//     when that is below S; fill[d] counts every valid arrival.
//
// Table-less mode (S == 0, the self-healing path, which runs before any
// broker table exists): only the aggregates are committed, by the same
// walk, so they equal the table mode's and the plain version's bit for
// bit; no table plane and no fill pointer is read or written (the wrapper
// passes null for them).
//
// The order kept: each float aggregate starts from the cache's value and
// adds, at each broker, the batch's removals in batch order and then its
// arrivals in batch order, each add rounded (__fadd_rn): the order of the
// reference's one fused scatter over [s; d].  util is __fdiv_rn(load,
// fmaxf(cap, 1e-9f)).  Integer counts use atomics (partition x rack,
// broker x topic) or the broker's own walk (replica and leader counts).
//
// Design: ONE launch a call (commit_bucket.cuh): a cooperative grid, a
// plain launch when it is one block.
//   phase 0, a block per tile of moves: a lane per move loads the move,
//     its replica's rows and its partition's and brokers' rows (each level
//     for all of the lane's moves at once), the block buckets the tile's
//     departures and arrivals by broker, stably, and each lane writes its
//     move's row (load[4], potential NW_OUT, leader bytes-in, leader flag,
//     id; for the arrival also bonus[4], eligibility and the move's
//     index) at both of its keys' positions, then commits the two integer
//     count planes with atomics;
//   grid barrier;
//   phase 1, a warp per broker: it walks its departures and then its
//     arrivals, 32 keys at a time: the lanes load 32 rows at once (the
//     next chunk's while this one is walked) into shared memory, then lane
//     q adds component q of each in order.  The warp holds its table row
//     in registers (1,024 slots, loaded at once) and finds the chunk's
//     departing replicas' slots in registers (chunk_slots), then every
//     lane punches its own; an arrival's rank is its position among
//     the broker's arrivals, so it lands at fill[b] + k (the rank the torch
//     path takes from kernels.segment_rank), and the warp writes fill[b]
//     last.  Each broker's row, fill pointer and aggregates have this one
//     writer, which reads them first: so fill is updated in place.
// Bound on this card: latency, not bytes.  A batch of a few thousand moves
// touches a few hundred kilobytes (under a microsecond at the memory's
// rate, PERF.md); the launch waits on three dependent memory levels in
// phase 0, the grid barrier, two in the walk (the bucket metadata, the
// rows) and the busiest broker's chain: its chunks one after another, each
// a round trip, 32 adds and its slot searches.  A tile's shared-memory work
// grows with the brokers (2B counters a ranking warp), so at 2,600 brokers
// phase 0 dominates.
// In place: the wrapper hands in the cache's own planes, and the caller gives
// the cache up (every call site rebinds it; one that keeps the old cache
// commits into a copy of it).
// `rank_out` (a test's probe, may be null) gets each valid arrival's rank
// and -1 for a dropped move.

#include "commit_bucket.cuh"

namespace {

using ccb::kChunks;
using ccb::kStage;
using ccb::kThreads;
using ccb::kWarps;

// a key's row: load[4], potential NW_OUT, leader bytes-in, leader flag, id
// | bonus[4] | eligibility, move index, unused[2] (a departure's row is its
// first 8 floats)
constexpr int kRow = 16;

struct Args {
  int n, num_b, S, num_r, num_racks, num_topics, r_ok_len;
  const int* r;
  const int* dst;
  const uint8_t* valid;
  const int* replica_broker;
  const int* replica_partition;
  const uint8_t* replica_is_leader;
  const float* base_load;
  const float* bonus;
  const int* partition_topic;
  const int* broker_rack;
  const float* capacity;
  const float* replica_load;
  const uint8_t* replica_ok;
  float* broker_load;
  float* broker_util;
  int* replica_count;
  int* leader_count;
  int* prc;
  int* btc;
  float* pot;
  float* lbi;
  int* table;
  int* fill;
  float* t_load;
  float* t_bonus;
  uint8_t* t_leader;
  uint8_t* t_ok;
  int* rank_out;
  ccb::Bucketing bk;
};

// Phase 0 for tile t.  The loads of a lane's moves are issued level by
// level (the move; its replica's rows; its partition's and brokers'
// rows), all before any store, so they overlap.
__device__ void commit_tile(const Args& a, int t, unsigned char* smem) {
  int idx[kChunks], ri[kChunks], di[kChunks];
  bool live[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    idx[c] = ccb::tile_move(a.bk, t, c);
    live[c] = false;
    ri[c] = 0;
    di[c] = -1;
    if (idx[c] >= 0) {
      live[c] = a.valid[idx[c]] != 0;
      ri[c] = a.r[idx[c]];
      di[c] = a.dst[idx[c]];
    }
  }
  int src[kChunks], pi[kChunks];
  bool lead[kChunks];
  float4 ld[kChunks];
  float nw_in[kChunks];
  uint8_t ok[kChunks];
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    live[c] = live[c] && di[c] >= 0 && di[c] < a.num_b;
    src[c] = -1;
    pi[c] = 0;
    lead[c] = false;
    nw_in[c] = 0.f;
    ok[c] = 0;
    ld[c] = zero4;
    if (live[c]) {
      const int r = ri[c];
      src[c] = a.replica_broker[r];
      pi[c] = a.replica_partition[r];
      lead[c] = a.replica_is_leader[r] != 0;
      ld[c] = reinterpret_cast<const float4*>(a.replica_load)[r];
      nw_in[c] = a.base_load[(size_t)r * 4 + 1];
      if (a.S) ok[c] = a.replica_ok[min(r, a.r_ok_len - 1)];
    }
  }
  int kd[kChunks], ka[kChunks], topic[kChunks], rack_s[kChunks],
      rack_d[kChunks];
  float4 bo[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    live[c] = live[c] && src[c] != di[c];
    kd[c] = live[c] ? src[c] : -1;
    ka[c] = live[c] ? a.num_b + di[c] : -1;
    topic[c] = rack_s[c] = rack_d[c] = 0;
    bo[c] = zero4;
    if (live[c]) {
      bo[c] = reinterpret_cast<const float4*>(a.bonus)[pi[c]];
      topic[c] = a.partition_topic[pi[c]];
      rack_s[c] = a.broker_rack[src[c]];
      rack_d[c] = a.broker_rack[di[c]];
    }
  }
  int pd[kChunks], pa[kChunks];
  ccb::bucket_tile(a.bk, t, kd, ka, smem, pd, pa);
  float4* rows = reinterpret_cast<float4*>(a.bk.rows);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (idx[c] >= 0 && !live[c] && a.rank_out) a.rank_out[idx[c]] = -1;
    if (!live[c]) continue;
    // expression order follows the plain version exactly:
    // (replica_load[NW_OUT] + (leader ? 0 : bonus[NW_OUT])) * 1.0 and
    // base_load[NW_IN] * (valid & leader)
    const float pot = __fadd_rn(ld[c].z, lead[c] ? 0.0f : bo[c].z);
    const float lbi = __fmul_rn(nw_in[c], lead[c] ? 1.0f : 0.0f);
    const float4 r1 = make_float4(pot, lbi, lead[c] ? 1.0f : 0.0f,
                                  __int_as_float(ri[c]));
    rows[(size_t)pd[c] * 4] = ld[c];
    rows[(size_t)pd[c] * 4 + 1] = r1;
    rows[(size_t)pa[c] * 4] = ld[c];
    rows[(size_t)pa[c] * 4 + 1] = r1;
    rows[(size_t)pa[c] * 4 + 2] = bo[c];
    rows[(size_t)pa[c] * 4 + 3] = make_float4(
        __int_as_float((int)ok[c]), __int_as_float(idx[c]), 0.f, 0.f);
    const size_t p = (size_t)pi[c] * a.num_racks;
    atomicSub(&a.prc[p + rack_s[c]], 1);
    atomicAdd(&a.prc[p + rack_d[c]], 1);
    atomicSub(&a.btc[(size_t)src[c] * a.num_topics + topic[c]], 1);
    atomicAdd(&a.btc[(size_t)di[c] * a.num_topics + topic[c]], 1);
  }
}

// Phase 1 for broker b, by one warp.
__device__ void commit_broker(const Args& a, int b, int* pre, int* seg,
                              float* stage) {
  const int lane = threadIdx.x & 31;
  int ldep = 0;
  const int L = ccb::broker_segments(a.bk, b, pre, seg, &ldep);
  // lanes 0-3: load[q]; lane 4: potential NW_OUT; lane 5: leader bytes-in
  float acc = 0.f;
  if (lane < 4) acc = a.broker_load[(size_t)b * 4 + lane];
  else if (lane == 4) acc = a.pot[b];
  else if (lane == 5) acc = a.lbi[b];
  int rc = a.replica_count[b];
  int lc = a.leader_count[b];
  const int S = a.S;
  const int fill0 = S ? a.fill[b] : 0;
  const int* row = a.table + (size_t)b * S;
  ccb::RowWindow win;
  if (S && ldep > 0) ccb::row_load(win, row, S);
  const int col = lane & (kStage - 1);
  const float4* rows = reinterpret_cast<const float4*>(a.bk.rows);
  // the rows of the chunk of keys from e0, one key a lane (an arrival's
  // third and fourth float4 only where they are written); each chunk's
  // loads are issued while the one before it is walked
  float4 next[4];
  auto load_chunk = [&](int e0) {
    const int e = e0 + lane;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    next[0] = next[1] = next[2] = next[3] = z;
    if (e < L) {
      const float4* src =
          rows + (size_t)ccb::entry_row(a.bk, pre, seg, e) * 4;
      next[0] = __ldcg(src);
      next[1] = __ldcg(src + 1);
      if (e >= ldep && S) next[2] = __ldcg(src + 2);
      if (e >= ldep && (S || a.rank_out)) next[3] = __ldcg(src + 3);
    }
  };
  load_chunk(0);
  for (int e0 = 0; e0 < L; e0 += 32) {
    const int e = e0 + lane;
    const bool live = e < L;
    const bool arr = e >= ldep;
    const float4 c0 = next[0], c1 = next[1], c2 = next[2], c3 = next[3];
    if (e0 + 32 < L) load_chunk(e0 + 32);
    float* mine = stage + lane * kStage;
    mine[0] = c0.x;
    mine[1] = c0.y;
    mine[2] = c0.z;
    mine[3] = c0.w;
    mine[4] = c1.x;
    mine[5] = c1.y;
    mine[6] = c1.z;
    mine[7] = c1.w;
    __syncwarp();
    // the adds in key order: the loads of eight keys ahead of their adds
    const int cnt = min(32, L - e0);
    int k = 0;
    for (; k + 8 <= cnt; k += 8) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = stage[(k + j) * kStage + col];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc = __fadd_rn(acc, e0 + k + j < ldep ? -x[j] : x[j]);
    }
    for (; k < cnt; ++k) {
      const float x = stage[k * kStage + col];
      acc = __fadd_rn(acc, e0 + k < ldep ? -x : x);
    }
    const bool is_lead = c1.z != 0.f;
    const unsigned int dep_m = __ballot_sync(0xffffffffu, live && !arr);
    const unsigned int arr_m = __ballot_sync(0xffffffffu, live && arr);
    const unsigned int lead_m = __ballot_sync(0xffffffffu, live && is_lead);
    rc += __popc(arr_m) - __popc(dep_m);
    lc += __popc(arr_m & lead_m) - __popc(dep_m & lead_m);
    const int rid = __float_as_int(c1.w);
    if (S) {
      // departures: punch each mover's slot in this row, all at once
      const int slot = ccb::chunk_slots(win, row, S, fill0, dep_m, rid);
      if (slot >= 0) {
        const size_t o = (size_t)b * S + slot;
        a.table[o] = a.num_r;
        a.t_ok[o] = 0;
      }
    }
    if (live && arr) {
      const int rank = e - ldep;
      if (a.rank_out) a.rank_out[__float_as_int(c3.y)] = rank;
      const int slot = fill0 + rank;
      if (S && slot < S) {
        const size_t o = (size_t)b * S + slot;
        a.table[o] = rid;
        reinterpret_cast<float4*>(a.t_load)[o] = c0;
        reinterpret_cast<float4*>(a.t_bonus)[o] = c2;
        a.t_leader[o] = is_lead ? 1 : 0;
        a.t_ok[o] = (uint8_t)__float_as_int(c3.x);
      }
    }
    __syncwarp();  // the next chunk overwrites the stage
  }
  if (lane < 4) {
    a.broker_load[(size_t)b * 4 + lane] = acc;
    a.broker_util[(size_t)b * 4 + lane] =
        __fdiv_rn(acc, fmaxf(a.capacity[(size_t)b * 4 + lane], 1e-9f));
  } else if (lane == 4) {
    a.pot[b] = acc;
  } else if (lane == 5) {
    a.lbi[b] = acc;
  } else if (lane == 6) {
    a.replica_count[b] = rc;
    a.leader_count[b] = lc;
  } else if (lane == 7 && S) {
    a.fill[b] = fill0 + (L - ldep);
  }
}

__global__ void __launch_bounds__(kThreads, 2) commit_moves_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  for (int t = blockIdx.x; t < a.bk.T; t += gridDim.x)
    commit_tile(a, t, dyn);
  ccb::grid_barrier();
  const int warp = threadIdx.x >> 5;
  const int per = 4 * a.bk.T + 2;
  int* pre = reinterpret_cast<int*>(dyn) + warp * per;
  int* seg = pre + 2 * a.bk.T + 1;
  float* stage = reinterpret_cast<float*>(dyn + 4LL * kWarps * per) +
                 warp * 32 * kStage;
  for (int b = warp * gridDim.x + blockIdx.x; b < a.num_b;
       b += gridDim.x * kWarps)
    commit_broker(a, b, pre, seg, stage);
}

ccb::Occupancy g_occ[16];
std::mutex g_occ_lock;

}  // namespace

// Bytes of scratch cc_commit_moves needs for n moves into num_b brokers,
// or -1 when the batch does not fit the kernel.
extern "C" long long cc_commit_moves_scratch(int n, int num_b) {
  ccb::Plan p;
  return ccb::make_plan(n, num_b, kRow, &p) ? p.bytes : -1;
}

// The updated planes are read and written in place; the table planes,
// `fill` and `rank_out` may be null in table-less mode (S == 0).  scratch:
// cc_commit_moves_scratch(n, num_b) bytes, 256-byte aligned.
extern "C" int cc_commit_moves(
    int n, int num_b, int S, int num_r, int num_racks, int num_topics,
    int r_ok_len, const int* r, const int* dst, const uint8_t* valid,
    const int* replica_broker, const int* replica_partition,
    const uint8_t* replica_is_leader, const float* base_load,
    const float* bonus, const int* partition_topic, const int* broker_rack,
    const float* capacity, const float* replica_load,
    const uint8_t* replica_ok, float* broker_load, float* broker_util,
    int* replica_count, int* leader_count, int* prc, int* btc, float* pot,
    float* lbi, int* table, int* fill, float* t_load, float* t_bonus,
    uint8_t* t_leader, uint8_t* t_ok, int* rank_out, void* scratch,
    long long scratch_bytes, void* stream) {
  ccb::Plan p;
  if (!ccb::make_plan(n, num_b, kRow, &p) || scratch_bytes < p.bytes)
    return (int)cudaErrorInvalidValue;
  Args a{n, num_b, S, num_r, num_racks, num_topics, r_ok_len,
         r, dst, valid, replica_broker, replica_partition,
         replica_is_leader, base_load, bonus, partition_topic, broker_rack,
         capacity, replica_load, replica_ok, broker_load, broker_util,
         replica_count, leader_count, prc, btc, pot, lbi, table, fill,
         t_load, t_bonus, t_leader, t_ok, rank_out,
         ccb::bucketing(p, n, num_b, scratch)};
  return ccb::launch((const void*)commit_moves_kernel, g_occ, g_occ_lock, a,
                     p, num_b, static_cast<cudaStream_t>(stream));
}
