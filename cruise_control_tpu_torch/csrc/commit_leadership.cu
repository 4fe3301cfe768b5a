// K5 commit_leadership: apply a committed leadership-transfer batch to the
// round cache.
//
// Replaces update_cache_for_leadership with its _row_slot_of and _scatter_pm
// calls (cruise_control_tpu/analyzer/context.py).  Transfer i hands the
// leadership bonus of partition p = replica_partition[sr[i]] from replica
// sr[i] to replica dr[i] (valid[i] only):
//   * broker_load[B, 4]: -bonus at the source broker, +bonus at the
//     destination broker, util = load / max(cap, 1e-9);
//   * leader_count[B]: -1 at the source, +1 at the destination;
//   * leader_bytes_in[B]: the demoted replica's base NW_IN leaves the
//     source, the promoted replica's base NW_IN arrives at the destination
//     (an asymmetric pair);
//   * replica_load[R, 4]: -bonus on row sr[i], +bonus on row dr[i];
//   * with a broker table: the slot of sr[i] in its broker's row and of
//     dr[i] in its row are found by scanning; the table load plane gets
//     -bonus / +bonus there and the leader flags flip.
// The batch holds at most one transfer per partition, so every replica row
// and table slot is touched at most once: those updates need no ordering.
// The per-broker float sums get none of the card's atomics: each broker
// walks the batch, sources first and then destinations, each in batch
// order -- the order of the reference's fused scatter over [s; d] -- so
// the sums equal the plain version's bit for bit.  The outputs are updated
// in place (the wrapper hands in either copies or the donated cache's own
// planes).
//
// Bound: latency, as K3.  Two launches:
//   1. transfer_kernel, a warp per transfer: lane 0 gathers the transfer's
//      ends and float contribution into a scratch row and updates the two
//      replica rows; with a table the warp scans both rows 32 slots at a
//      time (coalesced) for the two slots and lane 0 updates them;
//   2. broker_kernel, a warp per broker: a ballot finds the broker's
//      transfers 32 at a time and lane q adds component q in batch order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// scratch row per transfer: bonus[4], demoted NW_IN, promoted NW_IN
constexpr int kContrib = 8;

struct Args {
  int n, num_b, S, num_r;
  const int* sr;
  const int* dr;
  const uint8_t* valid;
  const int* replica_broker;
  const int* replica_partition;
  const float* base_load;
  const float* bonus;
  const float* capacity;
  const int* table;
  float* broker_load;
  float* broker_util;
  float* replica_load;
  int* leader_count;
  float* lbi;
  float* t_load;
  uint8_t* t_leader;
  float* contrib;  // [n, kContrib] scratch
  int* ends;       // [2, n] scratch: source, destination broker (-1)
};

// First slot of `r` in row `b` of the table, or -1; called by a whole warp.
__device__ int find_slot(const Args& a, int b, int r, int lane) {
  const int* row = a.table + (size_t)b * a.S;
  for (int base = 0; base < a.S; base += 32) {
    const int j = base + lane;
    const unsigned hit = __ballot_sync(0xffffffffu, j < a.S && row[j] == r);
    if (hit != 0) return base + __ffs(hit) - 1;
  }
  return -1;
}

__global__ void transfer_kernel(Args a) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  // i is uniform across the warp, so the whole warp leaves or stays
  if (i >= a.n) return;
  if (!a.valid[i]) {
    if (lane == 0) {
      a.ends[i] = -1;
      a.ends[a.n + i] = -1;
    }
    return;
  }
  const int s = a.sr[i];
  const int d = a.dr[i];
  const int bs = a.replica_broker[s];
  const int bd = a.replica_broker[d];
  const float* bo = a.bonus + (size_t)a.replica_partition[s] * 4;
  if (lane == 0) {
    a.ends[i] = bs;
    a.ends[a.n + i] = bd;
    float* c = a.contrib + (size_t)i * kContrib;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      c[q] = bo[q];
      a.replica_load[(size_t)s * 4 + q] =
          __fadd_rn(a.replica_load[(size_t)s * 4 + q], -bo[q]);
      a.replica_load[(size_t)d * 4 + q] =
          __fadd_rn(a.replica_load[(size_t)d * 4 + q], bo[q]);
    }
    c[4] = a.base_load[(size_t)s * 4 + 1];
    c[5] = a.base_load[(size_t)d * 4 + 1];
  }
  if (a.S == 0) return;
  const int ss = find_slot(a, bs, s, lane);
  const int ds = find_slot(a, bd, d, lane);
  if (lane != 0) return;
  if (ss >= 0) {
    const size_t o = (size_t)bs * a.S + ss;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a.t_load[o * 4 + q] = __fadd_rn(a.t_load[o * 4 + q], -bo[q]);
    a.t_leader[o] = 0;
  }
  if (ds >= 0) {
    const size_t o = (size_t)bd * a.S + ds;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a.t_load[o * 4 + q] = __fadd_rn(a.t_load[o * 4 + q], bo[q]);
    a.t_leader[o] = 1;
  }
}

__global__ void broker_kernel(Args a) {
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (b >= a.num_b) return;
  // lanes 0-3: load[q]; lane 4: leader bytes-in
  float acc = 0.f;
  if (lane < 4) acc = a.broker_load[(size_t)b * 4 + lane];
  else if (lane == 4) acc = a.lbi[b];
  int lc = a.leader_count[b];
  // pass 0: sources (sign -1); pass 1: destinations (sign +1)
  for (int pass = 0; pass < 2; ++pass) {
    const int* key = a.ends + (size_t)pass * a.n;
    for (int base = 0; base < a.n; base += 32) {
      const int i = base + lane;
      unsigned hit = __ballot_sync(0xffffffffu, i < a.n && key[i] == b);
      while (hit != 0) {
        const int j = base + __ffs(hit) - 1;
        hit &= hit - 1;
        const float* c = a.contrib + (size_t)j * kContrib;
        if (lane < 4) {
          acc = __fadd_rn(acc, pass == 0 ? -c[lane] : c[lane]);
        } else if (lane == 4) {
          acc = __fadd_rn(acc, pass == 0 ? -c[4] : c[5]);
        }
        lc += pass == 0 ? -1 : 1;
      }
    }
  }
  if (lane < 4) {
    a.broker_load[(size_t)b * 4 + lane] = acc;
    a.broker_util[(size_t)b * 4 + lane] =
        __fdiv_rn(acc, fmaxf(a.capacity[(size_t)b * 4 + lane], 1e-9f));
  } else if (lane == 4) {
    a.lbi[b] = acc;
  } else if (lane == 5) {
    a.leader_count[b] = lc;
  }
}

int blocks_for(long long threads) {
  return (int)((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int cc_commit_leadership(
    int n, int num_b, int S, int num_r, const int* sr, const int* dr,
    const uint8_t* valid, const int* replica_broker,
    const int* replica_partition, const float* base_load, const float* bonus,
    const float* capacity, const int* table, float* broker_load,
    float* broker_util, float* replica_load, int* leader_count, float* lbi,
    float* t_load, uint8_t* t_leader, float* contrib, int* ends,
    void* stream) {
  Args a{n,           num_b,        S,           num_r,   sr,
         dr,          valid,        replica_broker,       replica_partition,
         base_load,   bonus,        capacity,    table,   broker_load,
         broker_util, replica_load, leader_count, lbi,    t_load,
         t_leader,    contrib,      ends};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    transfer_kernel<<<blocks_for(32LL * n), kThreads, 0, st>>>(a);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  broker_kernel<<<blocks_for(32LL * num_b), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
