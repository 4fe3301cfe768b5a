// K3 commit_moves: apply a committed move batch to the round cache.
//
// Replaces update_cache_for_moves with _update_table_for_moves,
// _row_slot_of and _scatter_pm (cruise_control_tpu/analyzer/context.py),
// except the re-pack branch, which stays a torch sort.
//
// Inputs per move i: replica r[i], destination dst[i], valid[i] (already
// excluding no-op moves) and rank[i], the arrival's rank among the batch's
// valid arrivals at its destination.  The outputs are updated in place
// (the wrapper hands in fresh copies):
//   * per broker: load [B,4], util = load / max(cap, 1e-9), replica and
//     leader counts, potential NW_OUT, leader bytes-in;
//   * per partition x rack and broker x topic replica counts;
//   * the broker table: the departure slot found by scanning the source
//     row is punched (id = R, ok = 0); the arrival lands at fill[dst] +
//     rank with its id, load, bonus, leader flag and eligibility; the
//     fill pointers count every valid arrival.
//
// Float aggregates use no float atomics: each broker walks the batch,
// removals first and then arrivals, each in batch order -- exactly the
// order of the reference's fused scatter over [s; d] -- so the sums are
// deterministic and equal the reference's bit for bit.  Integer counters
// use atomics.
//
// Bound: latency.  The batch is at most a few thousand moves and touches
// O(batch * (S + RES)) bytes, so what costs is chains of dependent loads.
// Three launches keep them short and parallel:
//   1. contrib_kernel, a thread per move, gathers the move's source,
//      destination and float contribution into a scratch row once;
//   2. broker_kernel, a warp per broker, finds the broker's moves 32 at a
//      time with a ballot and adds each contribution in batch order, lane
//      q owning component q (a thread per broker would serialise one
//      gather chain per matching move across its warp);
//   3. move_kernel, a warp per move, scans the source row in coalesced
//      128-byte pieces for the departure slot; lane 0 writes the slots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// scratch row per move: load[4], pot, lbi, lead, unused
constexpr int kContrib = 8;

struct Args {
  int n, num_b, S, num_r, num_racks, num_topics, r_ok_len;
  const int* r;
  const int* dst;
  const uint8_t* valid;
  const int* rank;
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
  const int* fill_in;
  int* fill_out;
  float* t_load;
  float* t_bonus;
  uint8_t* t_leader;
  uint8_t* t_ok;
  float* contrib;  // [n, kContrib] scratch
  int* ends;       // [2, n] scratch: source, destination (-1 if invalid)
};

// One move's contribution to its brokers' float aggregates.  Expression
// order follows the reference exactly.
__global__ void contrib_kernel(Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  if (!a.valid[i]) {
    a.ends[i] = -1;
    a.ends[a.n + i] = -1;
    return;
  }
  const int ri = a.r[i];
  a.ends[i] = a.replica_broker[ri];
  a.ends[a.n + i] = a.dst[i];
  const float* ld = a.replica_load + (size_t)ri * 4;
  float* c = a.contrib + (size_t)i * kContrib;
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] = ld[q];
  const bool lead = a.replica_is_leader[ri] != 0;
  const int pi = a.replica_partition[ri];
  // (replica_load[NW_OUT] + (leader ? 0 : bonus[NW_OUT])) * 1.0
  c[4] = __fadd_rn(ld[2], lead ? 0.0f : a.bonus[(size_t)pi * 4 + 2]);
  // base_load[NW_IN] * (valid & leader)
  c[5] = lead ? a.base_load[(size_t)ri * 4 + 1] : 0.0f;
  c[6] = lead ? 1.0f : 0.0f;
}

__global__ void broker_kernel(Args a) {
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  // b is uniform across the warp, so the whole warp leaves or stays
  if (b >= a.num_b) return;
  // lanes 0-3: load[q]; lane 4: potential NW_OUT; lane 5: leader bytes-in
  float acc = 0.f;
  if (lane < 4) acc = a.broker_load[(size_t)b * 4 + lane];
  else if (lane == 4) acc = a.pot[b];
  else if (lane == 5) acc = a.lbi[b];
  int rc = a.replica_count[b];
  int lc = a.leader_count[b];
  // pass 0: departures (sign -1); pass 1: arrivals (sign +1)
  for (int pass = 0; pass < 2; ++pass) {
    const int* key = a.ends + (size_t)pass * a.n;
    for (int base = 0; base < a.n; base += 32) {
      const int i = base + lane;
      unsigned hit = __ballot_sync(0xffffffffu, i < a.n && key[i] == b);
      while (hit != 0) {
        const int j = base + __ffs(hit) - 1;
        hit &= hit - 1;
        const float* c = a.contrib + (size_t)j * kContrib;
        const int lead = c[6] != 0.f ? 1 : 0;
        if (lane < 6) {
          acc = __fadd_rn(acc, pass == 0 ? -c[lane] : c[lane]);
        }
        rc += pass == 0 ? -1 : 1;
        lc += pass == 0 ? -lead : lead;
      }
    }
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
  }
}

// One warp per move: the lanes scan the source row 32 slots at a time
// (coalesced) for the departure slot; lane 0 does the rest.
__global__ void move_kernel(Args a) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  // i is uniform across the warp, so the whole warp leaves or stays
  if (i >= a.n || !a.valid[i]) return;
  const int ri = a.r[i];
  const int src = a.replica_broker[ri];

  // departure: punch the mover's slot in its source row.  Concurrent
  // writes to the same row touch other replicas' slots (punches) or slots
  // at or past the row's fill pointer (arrivals), never this id.
  const int* row = a.table + (size_t)src * a.S;
  for (int base = 0; base < a.S; base += 32) {
    const int j = base + lane;
    const unsigned hit = __ballot_sync(0xffffffffu, j < a.S && row[j] == ri);
    if (hit != 0) {
      if (lane == 0) {
        const size_t o = (size_t)src * a.S + base + __ffs(hit) - 1;
        a.table[o] = a.num_r;
        a.t_ok[o] = 0;
      }
      break;
    }
  }
  if (lane != 0) return;
  const int d = a.dst[i];
  const int pi = a.replica_partition[ri];
  const int t = a.partition_topic[pi];
  atomicSub(&a.prc[(size_t)pi * a.num_racks + a.broker_rack[src]], 1);
  atomicAdd(&a.prc[(size_t)pi * a.num_racks + a.broker_rack[d]], 1);
  atomicSub(&a.btc[(size_t)src * a.num_topics + t], 1);
  atomicAdd(&a.btc[(size_t)d * a.num_topics + t], 1);

  // arrival: append at fill[dst] + rank when the row has room
  const int as = a.fill_in[d] + a.rank[i];
  if (as < a.S) {
    const size_t o = (size_t)d * a.S + as;
    a.table[o] = ri;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a.t_load[o * 4 + q] = a.replica_load[(size_t)ri * 4 + q];
      a.t_bonus[o * 4 + q] = a.bonus[(size_t)pi * 4 + q];
    }
    a.t_leader[o] = a.replica_is_leader[ri];
    a.t_ok[o] = a.replica_ok[min(ri, a.r_ok_len - 1)];
  }
  atomicAdd(&a.fill_out[d], 1);
}

int blocks_for(long long threads) {
  return (int)((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int cc_commit_moves(
    int n, int num_b, int S, int num_r, int num_racks, int num_topics,
    int r_ok_len, const int* r, const int* dst, const uint8_t* valid,
    const int* rank, const int* replica_broker, const int* replica_partition,
    const uint8_t* replica_is_leader, const float* base_load,
    const float* bonus, const int* partition_topic, const int* broker_rack,
    const float* capacity, const float* replica_load,
    const uint8_t* replica_ok, float* broker_load, float* broker_util,
    int* replica_count, int* leader_count, int* prc, int* btc, float* pot,
    float* lbi, int* table, const int* fill_in, int* fill_out,
    float* t_load, float* t_bonus, uint8_t* t_leader, uint8_t* t_ok,
    float* contrib, int* ends, void* stream) {
  Args a{n, num_b, S, num_r, num_racks, num_topics, r_ok_len,
         r, dst, valid, rank, replica_broker, replica_partition,
         replica_is_leader, base_load, bonus, partition_topic, broker_rack,
         capacity, replica_load, replica_ok, broker_load, broker_util,
         replica_count, leader_count, prc, btc, pot, lbi, table, fill_in,
         fill_out, t_load, t_bonus, t_leader, t_ok, contrib, ends};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    contrib_kernel<<<blocks_for(n), kThreads, 0, st>>>(a);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  broker_kernel<<<blocks_for(32LL * num_b), kThreads, 0, st>>>(a);
  int err = (int)cudaGetLastError();
  if (err != 0 || n <= 0) return err;
  move_kernel<<<blocks_for(32LL * n), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
