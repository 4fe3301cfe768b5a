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
//
// The order kept: the per-broker float sums get none of the card's
// atomics.  Each starts from the cache's value and adds the batch's
// sources in batch order and then its destinations in batch order, each
// add rounded (__fadd_rn) -- the order of the reference's fused scatter
// over [s; d] -- so the sums equal the plain version's bit for bit.  The
// outputs are updated in place (the wrapper hands in either copies or,
// with `donate`, the cache's own planes).
//
// Design: ONE launch a call (commit_bucket.cuh), as K3's:
//   phase 0, a block per tile of transfers: a lane per transfer loads its
//     two replicas' brokers and rows and its partition's bonus (each level
//     for all of the lane's transfers at once), the block buckets the
//     tile's sources and destinations by broker, stably, and each lane
//     writes the transfer's row (bonus[4], the demoted and promoted
//     NW_IN, the two ids) at both of its positions and updates the two
//     replica rows;
//   grid barrier;
//   phase 1, a warp per broker: it walks its sources and then its
//     destinations, 32 at a time (32 rows loaded at once into shared
//     memory, the next chunk's while this one is walked, then lane q adds
//     component q of each in order); with a table it holds its row in
//     registers (1,024 slots, loaded at once), finds the chunk's
//     replicas' slots in registers (chunk_slots), and then every lane
//     updates its own slot.  Only this warp writes the broker's
//     aggregates and its row's table slots.
// Bound on this card: latency, not bytes, as K3's: three dependent memory
// levels in phase 0 (at 2,600 brokers and 41,600 transfers the tiles'
// scattered loads, on a quarter of the SMs, take most of the time), the
// grid barrier, and the busiest broker's chunks one after another (a
// round trip for the rows and one for the table slots each).
// `donate` (the wrapper's): the planes handed in are the cache's own, which
// the caller gives up; otherwise copies.  The kernel is the same.

#include "commit_bucket.cuh"

namespace {

using ccb::kChunks;
using ccb::kStage;
using ccb::kThreads;
using ccb::kWarps;

// a key's row: bonus[4], demoted NW_IN, promoted NW_IN, the source and
// destination replica ids (the same at both ends)
constexpr int kRow = 8;

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
  const int* fill;
  float* broker_load;
  float* broker_util;
  float* replica_load;
  int* leader_count;
  float* lbi;
  float* t_load;
  uint8_t* t_leader;
  ccb::Bucketing bk;
};

// Phase 0 for tile t, the loads of a lane's transfers level by level, all
// before any store.
__device__ void transfer_tile(const Args& a, int t, unsigned char* smem) {
  int idx[kChunks], si[kChunks], di[kChunks];
  bool live[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    idx[c] = ccb::tile_move(a.bk, t, c);
    live[c] = false;
    si[c] = 0;
    di[c] = 0;
    if (idx[c] >= 0) {
      live[c] = a.valid[idx[c]] != 0;
      si[c] = a.sr[idx[c]];
      di[c] = a.dr[idx[c]];
    }
  }
  int bs[kChunks], bd[kChunks], pi[kChunks];
  float dem[kChunks], pro[kChunks];
  float4 ls[kChunks], ldd[kChunks];
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* rload = reinterpret_cast<const float4*>(a.replica_load);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    bs[c] = bd[c] = -1;
    pi[c] = 0;
    dem[c] = pro[c] = 0.f;
    ls[c] = ldd[c] = zero4;
    if (live[c]) {
      const int s = si[c];
      const int d = di[c];
      bs[c] = a.replica_broker[s];
      bd[c] = a.replica_broker[d];
      pi[c] = a.replica_partition[s];
      dem[c] = a.base_load[(size_t)s * 4 + 1];
      pro[c] = a.base_load[(size_t)d * 4 + 1];
      ls[c] = rload[s];
      ldd[c] = rload[d];
    }
  }
  int kd[kChunks], ka[kChunks];
  float4 bo[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    kd[c] = live[c] ? bs[c] : -1;
    ka[c] = live[c] ? a.num_b + bd[c] : -1;
    bo[c] = live[c] ? reinterpret_cast<const float4*>(a.bonus)[pi[c]]
                    : zero4;
  }
  int pd[kChunks], pa[kChunks];
  ccb::bucket_tile(a.bk, t, kd, ka, smem, pd, pa);
  float4* rows = reinterpret_cast<float4*>(a.bk.rows);
  float4* wload = reinterpret_cast<float4*>(a.replica_load);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (!live[c]) continue;
    const float4 b4 = bo[c];
    wload[si[c]] = make_float4(
        __fadd_rn(ls[c].x, -b4.x), __fadd_rn(ls[c].y, -b4.y),
        __fadd_rn(ls[c].z, -b4.z), __fadd_rn(ls[c].w, -b4.w));
    wload[di[c]] = make_float4(
        __fadd_rn(ldd[c].x, b4.x), __fadd_rn(ldd[c].y, b4.y),
        __fadd_rn(ldd[c].z, b4.z), __fadd_rn(ldd[c].w, b4.w));
    const float4 r1 = make_float4(dem[c], pro[c], __int_as_float(si[c]),
                                  __int_as_float(di[c]));
    rows[(size_t)pd[c] * 2] = b4;
    rows[(size_t)pd[c] * 2 + 1] = r1;
    rows[(size_t)pa[c] * 2] = b4;
    rows[(size_t)pa[c] * 2 + 1] = r1;
  }
}

// Phase 1 for broker b, by one warp.
__device__ void transfer_broker(const Args& a, int b, int* pre, int* seg,
                                float* stage) {
  const int lane = threadIdx.x & 31;
  int ldep = 0;
  const int L = ccb::broker_segments(a.bk, b, pre, seg, &ldep);
  // lanes 0-3: load[q]; lane 4: leader bytes-in
  float acc = 0.f;
  if (lane < 4) acc = a.broker_load[(size_t)b * 4 + lane];
  else if (lane == 4) acc = a.lbi[b];
  const int S = a.S;
  const int fill = S ? a.fill[b] : 0;
  const int* row = a.table + (size_t)b * S;
  ccb::RowWindow win;
  if (S && L > 0) ccb::row_load(win, row, S);
  const float4* rows = reinterpret_cast<const float4*>(a.bk.rows);
  // the rows of the chunk of keys from e0, one key a lane; each chunk's
  // loads are issued while the one before it is walked
  float4 next[2];
  auto load_chunk = [&](int e0) {
    const int e = e0 + lane;
    next[0] = next[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < L) {
      const float4* src =
          rows + (size_t)ccb::entry_row(a.bk, pre, seg, e) * 2;
      next[0] = __ldcg(src);
      next[1] = __ldcg(src + 1);
    }
  };
  load_chunk(0);
  for (int e0 = 0; e0 < L; e0 += 32) {
    const int e = e0 + lane;
    const bool live = e < L;
    const float4 c0 = next[0], c1 = next[1];
    if (e0 + 32 < L) load_chunk(e0 + 32);
    float* mine = stage + lane * kStage;
    mine[0] = c0.x;
    mine[1] = c0.y;
    mine[2] = c0.z;
    mine[3] = c0.w;
    mine[4] = c1.x;
    mine[5] = c1.y;
    __syncwarp();
    // the adds in key order: a source takes -bonus and -demoted NW_IN, a
    // destination +bonus and +promoted NW_IN
    const int cnt = min(32, L - e0);
    int k = 0;
    for (; k + 8 <= cnt; k += 8) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool dep = e0 + k + j < ldep;
        const int col = lane < 4 ? lane : (dep ? 4 : 5);
        x[j] = stage[(k + j) * kStage + col];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc = __fadd_rn(acc, e0 + k + j < ldep ? -x[j] : x[j]);
    }
    for (; k < cnt; ++k) {
      const bool dep = e0 + k < ldep;
      const float x = stage[k * kStage + (lane < 4 ? lane : (dep ? 4 : 5))];
      acc = __fadd_rn(acc, dep ? -x : x);
    }
    if (S) {
      // each transfer's slot in this row, all found first; then each lane
      // updates its own: -bonus and leader flag 0 at a source, +bonus and
      // flag 1 at a destination
      const bool dep = e < ldep;
      const int slot = ccb::chunk_slots(
          win, row, S, fill, __ballot_sync(0xffffffffu, live),
          __float_as_int(dep ? c1.z : c1.w));
      if (slot >= 0) {
        const size_t o = (size_t)b * S + slot;
        float4* tl = reinterpret_cast<float4*>(a.t_load) + o;
        const float4 cur = *tl;
        const float4 d4 =
            dep ? make_float4(-c0.x, -c0.y, -c0.z, -c0.w) : c0;
        *tl = make_float4(__fadd_rn(cur.x, d4.x), __fadd_rn(cur.y, d4.y),
                          __fadd_rn(cur.z, d4.z), __fadd_rn(cur.w, d4.w));
        a.t_leader[o] = dep ? 0 : 1;
      }
    }
    __syncwarp();  // the next chunk overwrites the stage
  }
  if (lane < 4) {
    a.broker_load[(size_t)b * 4 + lane] = acc;
    a.broker_util[(size_t)b * 4 + lane] =
        __fdiv_rn(acc, fmaxf(a.capacity[(size_t)b * 4 + lane], 1e-9f));
  } else if (lane == 4) {
    a.lbi[b] = acc;
  } else if (lane == 5) {
    a.leader_count[b] += L - 2 * ldep;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    commit_leadership_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  for (int t = blockIdx.x; t < a.bk.T; t += gridDim.x)
    transfer_tile(a, t, dyn);
  ccb::grid_barrier();
  const int warp = threadIdx.x >> 5;
  const int per = 4 * a.bk.T + 2;
  int* pre = reinterpret_cast<int*>(dyn) + warp * per;
  int* seg = pre + 2 * a.bk.T + 1;
  float* stage = reinterpret_cast<float*>(dyn + 4LL * kWarps * per) +
                 warp * 32 * kStage;
  for (int b = warp * gridDim.x + blockIdx.x; b < a.num_b;
       b += gridDim.x * kWarps)
    transfer_broker(a, b, pre, seg, stage);
}

ccb::Occupancy g_occ[16];
std::mutex g_occ_lock;

}  // namespace

// Bytes of scratch cc_commit_leadership needs for n transfers into num_b
// brokers, or -1 when the batch does not fit the kernel.
extern "C" long long cc_commit_leadership_scratch(int n, int num_b) {
  ccb::Plan p;
  return ccb::make_plan(n, num_b, kRow, &p) ? p.bytes : -1;
}

// The updated planes are read and written in place; `fill` (the table's
// fill pointers, read), t_load and t_leader may be null without a table
// (S == 0).  scratch:
// cc_commit_leadership_scratch(n, num_b) bytes, 256-byte aligned.
extern "C" int cc_commit_leadership(
    int n, int num_b, int S, int num_r, const int* sr, const int* dr,
    const uint8_t* valid, const int* replica_broker,
    const int* replica_partition, const float* base_load, const float* bonus,
    const float* capacity, const int* table, const int* fill,
    float* broker_load,
    float* broker_util, float* replica_load, int* leader_count, float* lbi,
    float* t_load, uint8_t* t_leader, void* scratch, long long scratch_bytes,
    void* stream) {
  ccb::Plan p;
  if (!ccb::make_plan(n, num_b, kRow, &p) || scratch_bytes < p.bytes)
    return (int)cudaErrorInvalidValue;
  Args a{n,           num_b,        S,           num_r,   sr,
         dr,          valid,        replica_broker,       replica_partition,
         base_load,   bonus,        capacity,    table,   fill,
         broker_load,
         broker_util, replica_load, leader_count, lbi,    t_load,
         t_leader,    ccb::bucketing(p, n, num_b, scratch)};
  return ccb::launch((const void*)commit_leadership_kernel, g_occ,
                     g_occ_lock, a, p, num_b,
                     static_cast<cudaStream_t>(stream));
}
