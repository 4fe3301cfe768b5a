#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (cruise_control_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--phases 1,2,3,4] [--profile] [--requests-only]
                          [--scenarios-only] [--sampled-only]
                          [--scheduled-only]

Phases:
  1. the card's name and power limit (nvidia-smi), then the build of the
     port's fourteen CUDA kernels from csrc/ (one nvcc per source, started
     together, with nvcc's resource report);
  2. each kernel against its plain PyTorch version on the card at the
     slice's shapes and again at the 2,600-broker shapes of phase 4
     (integers and booleans exactly, floats bit for bit): K1 at k = 1, 4,
     8, 16 and 64 from a [B, S] plane and from per-replica scores read
     through the table (pad slots, a strided score), on each of its paths
     (the block and warp selects, the register path at k <= 8) and the
     wrapper's choice, with any_eligible, ties, -0.0 beside +0.0, all-NEG
     rows, k = S and rows too wide for the keys in registers, K2 with
     caps, its fold of the pass before and pass 0's
     amplitude (also at the forced-move round's C = 4096 against K = 256
     and 2600), and through a chain of eight multi-commit passes (K2, then
     K8 with the commit) at the slice's and the 2,600-broker shortlist,
     each pass checked and timed with the rows it still reads, K3 on
     2,048 moves with the broker table (at 2,600
     brokers also on 10,400) and on 4,096 table-less (self-healing's
     commits), in place into a copy of the cache, its in-kernel arrival
     ranks against arrival_rank, K4 in both commit modes pass by pass from
     0 (its plane, zeroed state and amplitude) to 3 (each folding the pass
     before; rows with every option closed, tied and NEG options) at C =
     2048 on 200 and 2,600 brokers and at C = R = 600,000, K5 on a
     4,096-transfer table-less batch and on a phase-a batch of 16 B
     transfers with the table, undonated and donated, K6 (a sweep
     round's window: source terms, window score and top-4096, sibling
     pick, the fold of the round before) at P = 20,000, 200,000 and 3,000
     in both modes, with and without the tiebreak, first round and fold,
     with tied values and signed zeros, few and no live partitions and
     every partition failed, K7 at R = 60,000 and 600,000, k =
     4096, and at k = R on a 24-broker cluster, with 0.5 % forced, equal
     weights, fewer forced than k and every replica forced (and its
     guard-only launch), K8 at C = 1 to 4097 (B = 200 and 2600, T = 0 to
     6 terms) in eight cases and at C = 10,400, 20,800 and 600,000, alone
     and with the pass commit (keep, arrival counts and cumulants), K9's
     dense entry at n = 2048 and 4096, at R = 60,000 into 800 and 600,000
     into 10,400 segments (the grid path also under each fold: global
     keys, shared keys at S/4 to 2 S a block) and at n = 2048 into
     20,000 (int32 and int64 ids), and its keep entry
     (resolve_dest_conflicts) at n = 2048 into 200, 20,000 and 200,000,
     128 into 200, 4096 into 20,000 and 41,600 into 2,600 (ties, -0.0
     against +0.0, empty and all-invalid segments, NEG and -inf scores,
     out-of-range ids; the key scratch zero after every call), K10 (a
     swap round's shortlists, then its pair plane with the three conflict
     resolutions and the scatter) at B = 200, 2,600 and 100 with tied
     improvements, signed-zero ranks (given and as util - target),
     conflicts on a cold broker and a partition, with no band, each band
     and an all-False acceptance plane, K11's preference plane at C = 2048 x
     K = 200, 131 and 256 and C = 4096 x K = 2600 (int64 and int32 ids;
     with and without the sibling test, on sibling rows with -1;
     acceptance planes [C, K], [C, 1], [1, K] and 0-d; with and without
     the fit test) and its guard, which selects its own top brokers, on
     candidates and on every replica (tied headrooms, -0.0, no eligible
     broker), K12 at [60,000, 4] into
     200, [60,000] into 800, [600,000, 4] into 2,600, [600,000] into
     10,400 and [800] into 200 (dropped and negative ids, every id
     dropped, N = 0, n = SEGMENT_MAX, empty segments, signed zeros, one
     segment holding 60,000 and 600,000 entries, segment lengths around
     the walk's stage; with `init` and int32 and int64 ids against the
     ordered scatter), K13 at [200, 4], [2,600, 4], [2,600, 100],
     [60,000, 4], [600,000, 4] and [600,000, 1], the stats' [B, RES + 3 +
     T] planes, 1 to 33 terms and 1,024 to 32,770 rows (the second
     level's window offsets), and both of its paths at the shapes around
     the wrapper's choice, and K14, the prefix gate, at [200, k] and
     [2,600, k] for k = 4, 8, 16 and 0 to 3 terms and at k = 8 with 5
     (bounds hit exactly, a leading -0.0; K12 and K13 bit for bit: int32
     views); then the dirty-region functions, torch ops (apply_delta,
     set_broker_capacities, restrict_context_to_dirty), against the CPU
     byte for byte and timed, at 200 and 2,600 brokers.  Device times
     per call (20 calls captured in a CUDA graph, median of 5 replays timed with CUDA
     events; K3 in place and K5 alone and with `donate`, each on cache
     planes restored before each replay, and each with a copy of the
     cache's planes) beside
     the bound for the bytes the function needs and a one-call PyTorch
     yardstick where one exists; K3, K5, K12 and K13 also with the
     wrapper's host time per call, the device launches per call and
     (K12) the chain bound, and K12 with each of its two walks at the
     main path's shapes; K8 also per call with
     its host work against its lexsort dispatch (the torch lexsort, the
     kernel on that order, the ordered scatters), and its one-block time
     split
     by the sort and the commit; with --parent (a checkout of the parent
     tree), K6's and K10's entries also beside the parent's chain at the
     same shapes: its kernel launches with the torch ops its callers ran
     around them (the sweep window's source terms, score, stable top-k,
     casts and fold; the swap round's shortlists, casts, K9 resolutions
     and scatters) -- the yardstick of the redesign; K7 beside the
     parent's K7 on the same inputs, equal bit for bit, timed in turns
     with it; K6 and K10 also
     beside torch.topk (the compaction's and the shortlist's library
     yardstick);
  3. the slice geometry (200 brokers / 20K partitions / rf 3, 8 racks, 10
     topics, skew 0.2, default options): the disk + network-inbound solve
     of the first slice (seed 4); config 2 whole — Disk, NwIn, NwOut and
     Cpu usage distribution — as the bench builds it (seed 4), where the
     leadership sweeps clear every over-limit broker so the leadership
     table rounds (K4) never start; the same four goals on seed 2, where
     they do; the whole default stack (the 15 goals of DEFAULT_GOAL_ORDER,
     seed 4, 192 rounds) and the add-broker solve of bench config 4 (10
     empty brokers appended) under it; BASELINE config 5 (4 logdirs per
     broker, 4 broken, healed, then Disk capacity + Disk usage
     distribution); the remove-broker drain (brokers 0 and 100 killed)
     under the six hard goals; then the request modes: demote brokers 0
     and 100 (preferred leader election), the kafka-assigner goal order,
     and the intra-broker goals on config 5's geometry without load skew,
     without and with 4 broken logdirs.  One warm-up and one timed solve
     each, the garbage collector's passes inside each timed solve, the
     kernels' launch counts of
     each timed solve (every kernel the path reaches must be > 0; the
     default stack's counts go into the
     kernel JSON, the kafka-assigner solve's for K10 if the stack runs no
     swap round, config 5's for K7), self-healing's rounds and moves, the
     per-goal violated counts, the sanity / no offline replica left /
     proposal-replay (new leaders included) / cache-equals-rebuild /
     no-self-regression gates (and for the intra-broker solves no alive
     logdir above 0.8 of its capacity), and each solve but the first
     again on the port's CPU path: its proposals (logdirs included) and
     final leader flags must equal the card's, and so must its statistics
     (before, after and each goal's) bit for bit; per solve K2's and
     K14's launches; the default stack once
     more with the sorts, ordered sums and host syncs inside its
     multi-commit passes counted (there must be none), every call of a
     plain version of K12-K14 or of arrival_rank on a card tensor (there
     must be none), the host syncs inside the float ordered sums (none),
     the tensors K3's wrapper clones and the planes it returns other
     than the given cache's own (none: it commits in place) and the torch
     ops inside assign_destinations, those between the first K2 and the
     last K8 of a multi-commit call among them (none: a pass is K2 and
     K8), and inside resolve_dest_conflicts, cand_has_dest and
     feasible_dest_exists (none: each call is one K9 or K11 launch) and
     assign_pref (one K11 preference-plane launch a call beside the
     acceptance stack's ops), and inside leadership_round's follower
     assignments those between an assignment's first K4 and its last K8
     or K9 (none: a pass is K4 then K8, or K4 then K9 twice); each
     path's warm-up solve with the torch ops of every sweep round between
     its bounds() and its acceptance callback (none: the window is one K6
     launch) and of every swap round after its picks outside its
     acceptance callback (none: K10's two launches) counted; each timed
     solve's K1 launches by source and k, K4 launches by commit mode, K6
     launches by window and fold and K10 launches by entry; then the
     requests as the facade sends them, each with the gates above, the
     CPU comparison (placement, rounds, converged-at, per-goal counts
     and the host-skipped goals too) and its own gate: the add-broker
     request (10 new brokers the only destinations, from a rack-aware
     placement; every new broker holds replicas, the swaps' reverse legs
     onto old brokers counted), the self-healing request through the
     options generator (two topics excluded by pattern, brokers 0 and
     100 excluded from leadership, 50 and 150 from replica moves: no
     excluded replica moves, no leadership transfer onto 0 or 100, no
     more arrivals on 50 or 150 than departures), the incremental solve
     (a cold solve, one delta applied on the card, the one phase 2
     holds against the CPU, then the warm solve restricted to the dirty
     brokers; no hard goal
     left violated, and an all-dirty solve equal to the full one) and
     fast mode under the fused solver (fusion-group segments, the
     host-side skip, the eager abort);
     Phase 3 ends with requests served through the port's facade, its
     scheduler off so that each solves inline
     (`CruiseControl` over a `SnapshotLoadMonitor`, fed the description
     of a
     generated cluster: `served_inputs`, each topic's partitions
     numbered in turn as a simulated cluster reports them:
     `sim_description`), each on the card and again in
     a facade on the CPU, with the gates above, the store's counters
     (never a quarantine), the resident model and warm seed unchanged by
     every request, the resident model equal to a rebuild after each
     fast-forward, and the times of each request (wall, the rebuild's
     builder loop and move to the card, the fast-forward, the solve):
     `optimizations` cold, its cache hit, `rebalance` with the
     self-healing options and an excluded-topics pattern, a narrow delta
     (a restricted warm solve over at most 25 dirty brokers), a wide
     delta (warm, unrestricted, one counted fallback), the
     kafka-assigner `rebalance`, `demote_brokers` and `remove_brokers`
     of brokers 0 and 100, `add_brokers` of the 10 appended brokers from
     the add-broker request's rack-aware placement, and
     `fix_offline_replicas` on config 5's cluster; then requests
     executed (`run_executed`) through the port's `Executor` on a
     `SimulatedCluster` (virtual clock) built from the same description,
     journaled, with a replication throttle: `rebalance(dryrun=False)`
     (its proposals the served cold request's), the monitor refreshed
     from the cluster and `optimizations()` again (a store miss whose
     rebuilt model holds the executed placement; its stats beside the
     executed solve's), then `remove_brokers([0, 100], dryrun=False)`
     and the recently removed brokers in the next self-healing options;
     each execution with every task completed, the throttle cleared,
     the executor idle, the journal ending in its finish record and the
     cluster in the solve's final placement (replica sets, leaders,
     logdirs), with the solve's seconds, the executor's host wall, the
     virtual seconds, the polls, the admin calls, the tasks by type and
     the launches; then requests served from metric samples
     (`run_sampled`): the facade built as the reference's, from a
     `SimulatedCluster` of the same description with its leader loads, a
     `SimulatedClusterSampler` and a capacity JSON file, its own
     `LoadMonitor` filled by the two sampling rounds the default
     requirements need, then `optimizations()` cold,
     `rebalance(dryrun=False)` of its proposals, two rounds more and
     `optimizations()` again (its model holds the executed placement with
     no refresh by hand), each broker's sampled load within 1e-6 of the
     cluster's, both requests against a CPU facade, the seconds of each
     round and each request split into aggregation, builder loop,
     arrays, move to the card and solve; then the what-if requests
     (`run_scenarios`), and last the requests through the device-time
     scheduler (`run_scheduled`): a facade with its scheduler on, one
     background precompute pass parked at its first goal-segment
     checkpoint until the interactive self-healing `rebalance` queues,
     which then runs first and preempts it; both results equal to their
     inline twins above bit for bit, the resident model and the seed
     unchanged, the preempted trace pinned in the flight recorder, K9's
     scratch zero, no new counter slot; two identical concurrent requests
     coalesced to one solve, two what-if sweeps folded into one batch
     (each lane equal to the what-if batch's), and `state()` with the
     OpenMetrics page;
  4. scale, 2,600 brokers / 200K partitions / 26 racks / 100 topics: the
     whole default stack (bench.py's "north" preset), the four-goal solve,
     config 5 (52 broken logdirs), the six hard goals with brokers 0,
     100, ..., 2500 killed, and the three modes (26 brokers demoted, the
     kafka-assigner order, the intra-broker goals on 4 logdirs per
     broker), the add-broker request (130 new brokers) and the
     incremental solve (its cold and warm times), with the same gates
     (no CPU comparison), and the served requests `optimizations` cold,
     a narrow delta and `remove_brokers` of 26 brokers (card only), and
     the cold `rebalance(dryrun=False)` executed as at the slice with a
     one-minute progress check and no journal, the sampled cold request
     (card only, with its gates and the load check), and `remove_brokers` of
     two candidate sets of 26 brokers (every lane feasible) and the host
     rung's wall with broker 0 dead, and the scheduled precompute
     preempted by `remove_brokers` of 26 brokers on the served facade
     (the served cold model put back as its resident; the precompute
     equal to the served cold request); then
     the widest rank_accept call of the run
     must be one phase 2 checked.  --requests-only runs only the request
     paths and the served, executed, sampled and what-if requests in
     phases 3 and 4, --scenarios-only only the what-if requests,
     --sampled-only only the sampled ones, --scheduled-only only the
     scheduled ones (their inline yardsticks solved on the card first),
     and --profile with
     --requests-only profiles the request paths beside their option-less
     twins.
With --profile, default-stack solves in turns and two more profiled (with
K8, then with K8's lexsort dispatch: the torch lexsort, the kernel on its
order and the ordered scatters after each pass) and one more config-5,
kafka-assigner and intra-broker solve each run under torch.profiler and
the device's busy share and time by kernel are printed; then the
default-stack and intra-broker solves in turns with K12-K14 and with
their plain versions (the column-loop torch ops).

Every phase that fails raises, so the run exits non-zero.  The line
before the last is the kernel JSON; the last line is the device JSON.
Exits non-zero without a result when no card is present or when the
port's package is not beside this script.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published peaks (NVIDIA data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

REPLACES = {
    "row_topk": "cruise_control_tpu/analyzer/kernels.py:91",
    "assign_pass": "cruise_control_tpu/analyzer/kernels.py:788",
    "commit_moves": "cruise_control_tpu/analyzer/context.py:642",
    "leader_assign_pass": "cruise_control_tpu/analyzer/kernels.py:924",
    "commit_leadership": "cruise_control_tpu/analyzer/context.py:732",
    "sweep_pick": "cruise_control_tpu/analyzer/leadership.py:178",
    "forced_select": "cruise_control_tpu/analyzer/kernels.py:1235",
    "rank_accept": "cruise_control_tpu/analyzer/kernels.py:145",
    "segment_argmax": "cruise_control_tpu/analyzer/kernels.py:31",
    "swap_pair": "cruise_control_tpu/analyzer/kernels.py:1367",
    "dest_feasibility": "cruise_control_tpu/analyzer/kernels.py:208",
    "segment_sum": "cruise_control_tpu/model/state.py:140",
    "ordered_sum": "cruise_control_tpu/model/stats.py:67",
    "cumsum_blocks": "cruise_control_tpu/analyzer/kernels.py:429",
}
SOURCES = {
    "row_topk": "cruise_control_tpu_torch/csrc/row_topk.cu",
    "assign_pass": "cruise_control_tpu_torch/csrc/assign_pass.cu",
    "commit_moves": "cruise_control_tpu_torch/csrc/commit_moves.cu",
    "leader_assign_pass": "cruise_control_tpu_torch/csrc/leader_assign.cu",
    "commit_leadership":
        "cruise_control_tpu_torch/csrc/commit_leadership.cu",
    "sweep_pick": "cruise_control_tpu_torch/csrc/sweep_pick.cu",
    "forced_select": "cruise_control_tpu_torch/csrc/forced_select.cu",
    "rank_accept": "cruise_control_tpu_torch/csrc/rank_accept.cu",
    "segment_argmax": "cruise_control_tpu_torch/csrc/segment_argmax.cu",
    "swap_pair": "cruise_control_tpu_torch/csrc/swap_pair.cu",
    "dest_feasibility": "cruise_control_tpu_torch/csrc/dest_feasibility.cu",
    "segment_sum": "cruise_control_tpu_torch/csrc/segment_sum.cu",
    "ordered_sum": "cruise_control_tpu_torch/csrc/ordered_sum.cu",
    "cumsum_blocks": "cruise_control_tpu_torch/csrc/cumsum_blocks.cu",
}
#: the kernels each solve must launch: the leadership table rounds (K4)
#: run only when a sweep leaves an over-limit broker; every path runs
#: multi-commit passes or sweeps, so K8 in all; every move round resolves
#: its conflicts with K9 and builds its destination plane with K11; every
#: solve's stats sum broker loads with K12 and reduce them with K13
SUM_KERNELS = ("segment_sum", "ordered_sum")
MOVE_KERNELS = ("segment_argmax", "dest_feasibility") + SUM_KERNELS
TWO_GOAL_KERNELS = ("row_topk", "assign_pass", "commit_moves",
                    "rank_accept") + MOVE_KERNELS
FOUR_GOAL_KERNELS = ("row_topk", "assign_pass", "commit_moves",
                     "leader_assign_pass", "commit_leadership", "sweep_pick",
                     "rank_accept") + MOVE_KERNELS
SWEEP_ONLY_KERNELS = tuple(k for k in FOUR_GOAL_KERNELS
                           if k != "leader_assign_pass")
#: self-healing selects with K7 and commits with K3 (table-less); the hard
#: goals' rack awareness and capacity rounds pick with K1
CONFIG5_KERNELS = ("forced_select", "commit_moves", "assign_pass",
                   "rank_accept") + MOVE_KERNELS
HARD_KERNELS = ("forced_select", "commit_moves", "assign_pass", "row_topk",
                "rank_accept") + MOVE_KERNELS
#: the whole default stack: the leader-count goal's transfer rounds run K4,
#: the pre-balance and the multi-candidate move rounds' prefix gates K14
STACK_KERNELS = FOUR_GOAL_KERNELS + ("cumsum_blocks",)
#: the kafka-assigner mode: the rack rounds and the count-evening pass
#: (K1, K2, K3, K9, K11), then swap rounds (K10, K3); demote runs none of
#: the hand kernels (preferred leader election is one batched pass of
#: torch ops); the intra-broker goals pick with K9 only, and after broken
#: logdirs self-healing adds K7, K3 and K11
KAFKA_ASSIGNER_KERNELS = ("row_topk", "assign_pass", "commit_moves",
                          "swap_pair") + MOVE_KERNELS
DEMOTE_KERNELS = SUM_KERNELS
INTRA_KERNELS = ("segment_argmax",) + SUM_KERNELS
INTRA_BROKEN_KERNELS = ("segment_argmax", "forced_select", "commit_moves",
                        "dest_feasibility") + SUM_KERNELS
#: the kernels each request path must launch in its timed solve (the
#: incremental path's warm solve included)
REQUEST_KERNELS = {"add_request": STACK_KERNELS + ("swap_pair",),
                   "heal_request": STACK_KERNELS + ("swap_pair",),
                   "incremental": STACK_KERNELS + ("swap_pair",),
                   # fast mode runs no swap round
                   "fast_fused": STACK_KERNELS}
#: the plain versions of K12-K14, which a card solve must never call
PLAIN_SUMS = ("segment_sum_plain", "scatter_add_seq_plain", "sum_f32_plain",
              "cumsum_f32_plain")
#: the widest rank_accept call phase 2 checks (C = R at 2,600 brokers)
RANK_CHECKED_C = 600_000

SLICE_SPEC = dict(num_brokers=200, num_partitions=20_000,
                  replication_factor=3, num_racks=8, num_topics=10, seed=4,
                  skew_fraction=0.2)
#: the same geometry on seed 2: NwOut's and Cpu's sweeps end with
#: over-limit brokers left, so the leadership table rounds (phase a,
#: K4) run; on seed 4 the sweep clears them and phase a never starts
SLICE_MAIN_SPEC = dict(SLICE_SPEC, seed=2)
NORTH_SPEC = dict(num_brokers=2600, num_partitions=200_000,
                  replication_factor=3, num_racks=26, num_topics=100, seed=4,
                  skew_fraction=0.2)

TWO_GOALS = ["DiskUsageDistributionGoal",
             "NetworkInboundUsageDistributionGoal"]
FOUR_GOALS = TWO_GOALS + ["NetworkOutboundUsageDistributionGoal",
                          "CpuUsageDistributionGoal"]
CONFIG5_GOALS = ["DiskCapacityGoal", "DiskUsageDistributionGoal"]
#: the default hard goals (goals/registry.py DEFAULT_HARD_GOALS)
HARD_GOALS = ["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
              "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal",
              "CpuCapacityGoal"]
#: the request modes beside the default stack (goals/registry.py): demote
#: brokers, kafka_assigner=true, and the intra-broker (JBOD) rebalance
DEMOTE_GOALS = ["PreferredLeaderElectionGoal"]
KAFKA_ASSIGNER_GOALS = ["KafkaAssignerEvenRackAwareGoal",
                        "KafkaAssignerDiskUsageDistributionGoal"]
INTRA_GOALS = ["IntraBrokerDiskCapacityGoal",
               "IntraBrokerDiskUsageDistributionGoal"]


def path(spec: dict, goals, max_rounds=None, kill=(), demote=(),
         broken=(), **request) -> dict:
    """A solve: the random cluster `spec` with the brokers `kill` killed
    (set_broker_state(alive=False), the bench's remove-broker drain), the
    brokers `demote` demoted (set_broker_state(demoted=True), the
    demote-broker request) and the logdirs `broken` marked dead
    (mark_disk_dead), optimized by `goals` (registry names; None is the
    whole default order) at `max_rounds`.  A request (see `_solve`) may
    add `options` (OptimizationOptions arguments; "new" names the new
    brokers), `pattern` (the options generator's excluded-topics
    pattern), `prep` (the options of a RackAwareGoal-alone solve whose
    final placement the request starts from), `optimizer` and `call`
    (GoalOptimizer's and optimizations' arguments) and `incremental`
    (a cold solve, one model delta, then the warm, dirty solve)."""
    return dict(spec=spec, goals=None if goals is None else list(goals),
                max_rounds=max_rounds, kill=tuple(kill),
                demote=tuple(demote), broken=tuple(broken), **request)


SLICE_TWO = path(SLICE_SPEC, TWO_GOALS)
SLICE_FOUR = path(SLICE_SPEC, FOUR_GOALS)
SLICE_MAIN = path(SLICE_MAIN_SPEC, FOUR_GOALS)
#: BASELINE config 5 (bench.py _build: 4 logdirs per broker, one broken
#: per 50 brokers) at the slice size, and the remove-broker drain of
#: bench.py's config 4 (brokers 0, 100, ... killed) under the six hard
#: goals
SLICE_CONFIG5 = path(dict(SLICE_SPEC, jbod_disks=4, dead_disks=4),
                     CONFIG5_GOALS, 192)
SLICE_HARD = path(SLICE_SPEC, HARD_GOALS, 192, kill=(0, 100))
NORTH_FOUR = path(NORTH_SPEC, FOUR_GOALS)
NORTH_CONFIG5 = path(dict(NORTH_SPEC, jbod_disks=4, dead_disks=52),
                     CONFIG5_GOALS, 192)
NORTH_HARD = path(NORTH_SPEC, HARD_GOALS, 192, kill=range(0, 2600, 100))
#: the whole default stack (goals/registry.py DEFAULT_GOAL_ORDER, 15
#: goals) as the bench's "north" / "3" presets run it, and the add-broker
#: solve of bench.py's config 4 (max(1, B / 20) empty brokers appended)
SLICE_STACK = path(SLICE_SPEC, None, 192)
SLICE_ADD = path(dict(SLICE_SPEC, new_brokers=10), None, 192)
NORTH_STACK = path(NORTH_SPEC, None, 192)
#: the three request modes: demote brokers 0 and 100 (0, 100, ..., 2500
#: at 2,600 brokers); the kafka-assigner goal order; the intra-broker
#: goals on config 5's JBOD geometry (4 logdirs per broker) without load
#: skew -- a skewed broker above 0.8 of its whole logdir capacity cannot
#: be fixed by moves inside it, and the hard intra-broker capacity goal
#: then aborts the solve, in the reference as in the port -- without and
#: with config 5's max(1, B / 50) = 4 broken logdirs, one per 50 brokers
JBOD_SPEC = dict(SLICE_SPEC, skew_fraction=0.0, jbod_disks=4)
SLICE_DEMOTE = path(SLICE_SPEC, DEMOTE_GOALS, demote=(0, 100))
SLICE_KAFKA_ASSIGNER = path(SLICE_SPEC, KAFKA_ASSIGNER_GOALS)
SLICE_INTRA = path(JBOD_SPEC, INTRA_GOALS)
SLICE_INTRA_BROKEN = path(JBOD_SPEC, INTRA_GOALS,
                          broken=(0, 4 * 50, 4 * 100, 4 * 150))
NORTH_DEMOTE = path(NORTH_SPEC, DEMOTE_GOALS, demote=range(0, 2600, 100))
NORTH_KAFKA_ASSIGNER = path(NORTH_SPEC, KAFKA_ASSIGNER_GOALS)
NORTH_INTRA = path(dict(NORTH_SPEC, skew_fraction=0.0, jbod_disks=4),
                   INTRA_GOALS)
#: the requests as the facade sends them, on the default stack at 192
#: rounds.  Add-broker (facade.add_brokers): move destinations limited to
#: the max(1, B / 20) appended brokers, from a rack-aware placement
#: (RackAwareGoal alone first, the new brokers excluded from its moves so
#: that they stay empty; on the random placement the request leaves rack
#: violations it may not fix, and the solve aborts, in the reference too)
ADD_PREP = dict(excluded_brokers_for_replica_move="new")
ADD_OPTIONS = dict(requested_destination_broker_ids="new")
SLICE_ADD_REQUEST = path(dict(SLICE_SPEC, new_brokers=10), None, 192,
                         options=ADD_OPTIONS, prep=ADD_PREP)
NORTH_ADD_REQUEST = path(dict(NORTH_SPEC, new_brokers=130), None, 192,
                         options=ADD_OPTIONS, prep=ADD_PREP)
#: self-healing for a goal violation (facade._self_healing_options) through
#: the options generator with an excluded-topics pattern
#: (topics.excluded.from.partition.movement) matching two of the ten
#: topics, from a rack-aware placement
HEAL_EXCLUDED_LEADERSHIP = (0, 100)
HEAL_EXCLUDED_MOVES = (50, 150)
SLICE_HEAL_REQUEST = path(
    SLICE_SPEC, None, 192, prep={}, pattern="topic-[03]",
    options=dict(
        excluded_brokers_for_leadership=frozenset(HEAL_EXCLUDED_LEADERSHIP),
        excluded_brokers_for_replica_move=frozenset(HEAL_EXCLUDED_MOVES),
        is_triggered_by_goal_violation=True))
#: the incremental path: a cold solve, one model delta (broker 2's
#: capacity row raised by half and 64 partitions' loads by a quarter, as
#: tests/test_incremental.py's dirty-region solve), applied on the device,
#: then the warm solve seeded by the cold one's final placement and
#: restricted to the delta's dirty brokers
SLICE_INCREMENTAL = path(SLICE_SPEC, None, 192, incremental=True)
NORTH_INCREMENTAL = path(NORTH_SPEC, None, 192, incremental=True)
#: fast mode under the facade's fused solver: fusion-group segments, the
#: host-side skip and the eager hard-goal abort
SLICE_FAST_FUSED = path(SLICE_SPEC, None, 192,
                        options=dict(fast_mode=True),
                        optimizer=dict(fused_segments=True,
                                       host_side_skip=True,
                                       eager_hard_abort=True))


def log(msg: str) -> None:
    print(msg, flush=True)


#: the run's start and the card's nvidia-smi name and power limit (main
#: sets both), for the per-path lines
T_RUN = [time.time()]
CARD = ["not read"]


def cuda_time_ms(fn, reps: int = 20) -> float:
    """Median of `reps` single-launch CUDA-event timings (after a
    warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_time_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Device time per call: `reps` calls captured in one CUDA graph,
    replayed `trials` times between CUDA events; the median replay over
    `reps`.  Keeps the host's per-call overhead out of a kernel's time
    (usable only for code that never synchronises with the host)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # captured on the warm-up's stream, whose per-stream scratch (K9's
    # keys) the warm-up made: the capture allocates none of it
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(nbytes: float, ops: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def equal_exact(a, b) -> bool:
    import torch
    if a.dtype.is_floating_point:
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    or torch.equal(a, b))
    return bool(torch.equal(a, b))


def max_abs_err(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        d = (a.double() - b.double()).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _row_topk_inputs(b: int, s: int, g):
    """K1's inputs on the card: a [B, S] plane of quantised scores (many
    ties), a third NEG, a -0.0 beside a +0.0 in every row, a row of NEG, a
    row of pure ties, a row with fewer eligible slots than 64; a table of
    replica ids with pad slots (id R), per-replica scores read at a stride
    (a column of an [R, 4] plane) and valid flags."""
    import torch
    from cruise_control_tpu_torch.analyzer import kernels as K
    sc = torch.round(torch.rand((b, s), generator=g, device="cuda") * 50.0)
    sc = torch.where(torch.rand((b, s), generator=g, device="cuda") < 0.33,
                     torch.full((), K.NEG, device="cuda"), sc)
    sc[:, 2] = -0.0
    sc[:, 9] = 0.0
    sc[0] = K.NEG                       # a row with nothing eligible
    sc[1, :] = 7.0                      # a row of pure ties
    sc[3, 40:] = K.NEG                  # fewer eligible slots than 64
    num_r = b * s - s // 4 * b // 8
    ids = torch.full((b * s,), num_r, dtype=torch.int32, device="cuda")
    ids[torch.randperm(b * s, generator=g, device="cuda")[:num_r]] = \
        torch.arange(num_r, dtype=torch.int32, device="cuda")
    table = ids.reshape(b, s)
    load = torch.round(torch.rand((num_r, 4), generator=g, device="cuda")
                       * 40.0)
    load[::7, 1] = -0.0
    valid = torch.rand(num_r, generator=g, device="cuda") < 0.6
    return sc, table, load[:, 1], valid


def _row_topk_check(got, want, what: str) -> None:
    import torch
    for x, y, name in zip(got, want, ("cand", "has", "top", "slot",
                                      "any_eligible")):
        if not (x.dtype == y.dtype and torch.equal(x, y)
                and (name != "top" or torch.equal(x.view(torch.int32),
                                                  y.view(torch.int32)))):
            raise AssertionError(f"{what}: {name} differs from the plain "
                                 "version")


#: K1's paths (cuda_kernels.ROW_TOPK_PATH): the select with a block a
#: row, the register path (k <= 8) and the select with a warp a row
ROW_TOPK_PATHS = {0: "block select", 1: "register", 2: "warp select"}


@contextlib.contextmanager
def row_topk_path(path):
    """K1 forced onto `path` (None: the wrapper's choice)."""
    from cruise_control_tpu_torch import cuda_kernels as ck
    saved = ck.ROW_TOPK_PATH
    ck.ROW_TOPK_PATH = path
    try:
        yield
    finally:
        ck.ROW_TOPK_PATH = saved


def _parent_ms(pk, chain):
    """The parent's chain's device time per call, None without a checkout."""
    return None if pk is None else graph_time_ms(chain)


def _ms(t) -> str:
    return "not measured (no --parent checkout)" if t is None else \
        f"{t:.4f} ms"


def check_row_topk(b: int, s: int, seed: int) -> dict:
    """K1 at B x S for k in {1, 4, 8, 16, 64}, the plane and the table
    source, on each path (the block and warp selects, the register path
    at k <= 8) and on the wrapper's choice, each exact against its plain
    version (cand, has, top bit for bit, slot, any_eligible); then k = S
    = 64 on a narrow table.  Device times of each path, of the plain
    versions and of torch.topk on the plane.  {"plane k=..." / "table
    k=...": the record of the wrapper's path}."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels as ck
    from cruise_control_tpu_torch.analyzer import kernels as K
    g = torch.Generator(device="cuda").manual_seed(seed)
    sc, table, score, valid = _row_topk_inputs(b, s, g)
    out = {}
    for k in (1, 4, 8, 16, 64):
        for source in ("plane", "table"):
            if source == "plane":
                def launch(k=k):
                    return ck.row_topk(sc, table, k)

                def plain(k=k):
                    return K.row_topk_plain(sc, table, k)
                lib_ms = graph_time_ms(lambda: torch.topk(sc, k, dim=1))
                # the row once; per output the table id, id, flag, score and
                # slot; the row flag
                nbytes = b * s * 4 + b * k * (4 + 4 + 1 + 4 + 4) + b
            else:
                def launch(k=k):
                    return ck.table_topk(table, score, valid, k)

                def plain(k=k):
                    return K.table_topk_plain(table, score, valid, k)
                lib_ms = None
                # the ids and, per real id, its score and flag; outputs
                n_ids = int((table < score.shape[0]).sum())
                nbytes = b * s * 4 + n_ids * 5 + b * k * 17 + b
            want = plain()
            times = {}
            for path in [p for p in ROW_TOPK_PATHS if p != 1 or k <= 8] + [
                    None]:
                with row_topk_path(path):
                    got = launch()
                    torch.cuda.synchronize()
                    _row_topk_check(got, want, f"row_topk {source} B={b} "
                                    f"S={s} k={k} path {path}")
                    times[path] = graph_time_ms(launch)
            t_plain = graph_time_ms(plain)
            t_b, by = bound(nbytes, b * s)
            chosen = ck._row_topk_path(b, k)
            log(f"  row_topk {source} B={b} S={s} k={k}: exact match on "
                f"every path; device time per call: "
                + ", ".join(f"{ROW_TOPK_PATHS[p]} {times[p]:.4f} ms"
                            for p in ROW_TOPK_PATHS if p in times)
                + f" (the wrapper's: {ROW_TOPK_PATHS[chosen]}), plain "
                f"{t_plain:.4f} ms, torch.topk "
                f"{_ms(lib_ms) if lib_ms is not None else 'none'}; bound "
                f"{t_b:.5f} ms ({nbytes} bytes)")
            out[f"{source} k={k}"] = dict(
                max_abs_err=0.0, ms=times[None], path=ROW_TOPK_PATHS[chosen],
                paths_ms={ROW_TOPK_PATHS[p]: times[p] for p in ROW_TOPK_PATHS
                          if p in times},
                plain_ms=t_plain, bound_ms=t_b,
                bound_by=by, library_ms=lib_ms,
                shape=f"{source} B={b} S={s} k={k}")
    # k = S, the whole row in order; rows too wide for the keys in
    # registers (the selects' shared-memory keys)
    for rows, width in ((b, 64), (40, 3000)):
        sc_n, table_n, score_n, valid_n = _row_topk_inputs(rows, width, g)
        for path in ROW_TOPK_PATHS:
            kk = 8 if path == 1 else 64
            with row_topk_path(path):
                _row_topk_check(ck.row_topk(sc_n, table_n, kk),
                                K.row_topk_plain(sc_n, table_n, kk),
                                f"row_topk plane B={rows} S={width} k={kk}")
                _row_topk_check(
                    ck.table_topk(table_n, score_n, valid_n, kk),
                    K.table_topk_plain(table_n, score_n, valid_n, kk),
                    f"row_topk table B={rows} S={width} k={kk}")
    log(f"  row_topk B={b} S=64 and B=40 S=3000 at k = 64 (= S on the "
        f"narrow rows; 8 on the register path), both sources, every path: "
        f"exact match")
    return out


def _assign_pass_inputs(c: int, kk: int, num_b: int, g) -> dict:
    """K2's inputs on the card: a [C, K] plane (30 % NEG, two tied slots),
    shortlist ids, arrival counts and caps, the rows' flags, and a
    previous pass's keep and broker ids to fold."""
    import torch
    from cruise_control_tpu_torch.analyzer import kernels as K

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    def ints(hi, n):
        return torch.randint(0, hi, (n,), generator=g, device="cuda",
                             dtype=torch.int32)
    pref = -rand(c, kk)
    pref = torch.where(rand(c, kk) < 0.3, torch.full((), K.NEG,
                                                     device="cuda"), pref)
    pref[:, 5 % kk] = pref[:, 3 % kk]          # planted ties between slots
    taken = torch.where(rand(num_b) < 0.5, torch.zeros((), device="cuda",
                                                       dtype=torch.int32),
                        ints(3, num_b))
    assigned = rand(c) < 0.2
    return dict(pref=pref, dest_ids=torch.randperm(
                    num_b, generator=g, device="cuda")[:kk].to(torch.int32),
                taken_cnt=taken, cap=1 + ints(3, num_b),
                cand_has=rand(c) < 0.9, assigned=assigned,
                dest=ints(num_b, c), keep=(rand(c) < 0.3) & ~assigned,
                prev_best=ints(num_b, c))


def _assign_pass_call(fn, x: dict, k: int, amp):
    """One K2 call (or its plain version) on copies of the in-place
    arguments: (best, has, dest, assigned, amp)."""
    dest, assigned = x["dest"].clone(), x["assigned"].clone()
    best, has = fn(x["pref"], x["dest_ids"], x["taken_cnt"], x["cap"],
                   x["cand_has"], k, amp, assigned, dest,
                   x["keep"] if k else None, x["prev_best"] if k else None)
    return best, has, dest, assigned, amp


def assign_pass_bytes(x: dict, k: int) -> int:
    """The bytes one K2 pass must move: the rows it still has to read
    (every row in pass 0), the shortlist's ids, counts and caps, the
    rows' flags, fold inputs and outputs."""
    c, kk = x["pref"].shape
    live = c if k == 0 else int((~(x["assigned"] | x["keep"])).sum())
    fold = int(x["keep"].sum()) if k else 0
    return (live * kk * 4 + kk * 12 + c * (1 + 1 + 4 + 1)
            + fold * (4 + 1) + c * (4 + 1)), live


def check_assign_pass(c: int, widths, seed: int) -> dict:
    """K2 at C x K for each K in `widths` (shortlist ids of max(K, 200)
    brokers, with caps), passes 0 (with the amplitude) and 3 (with the
    previous pass's fold): best broker, has, the folded dest and assigned
    and the amplitude against assign_pass_plain, exactly; the record of
    the first width's pass 3."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import kernels as K
    g = torch.Generator(device="cuda").manual_seed(seed)
    timed = None
    for kk in widths:
        x = _assign_pass_inputs(c, kk, max(kk, 200), g)
        for k in (0, 3):
            amp0 = torch.full((), 0.35 + 1e-6, device="cuda")
            got = _assign_pass_call(cuda_kernels.assign_pass, x, k,
                                    amp0.clone())
            want = _assign_pass_call(K.assign_pass_plain, x, k, amp0.clone())
            torch.cuda.synchronize()
            for a, b, what in zip(got, want, ("best", "has", "dest",
                                              "assigned", "amp")):
                if not equal_exact(a, b):
                    raise AssertionError(
                        f"assign_pass C={c} K={kk} pass {k}: {what} "
                        "differs from the plain version")
            args = (x["pref"], x["dest_ids"], x["taken_cnt"], x["cap"],
                    x["cand_has"], k, amp0, x["assigned"].clone(),
                    x["dest"].clone(), x["keep"] if k else None,
                    x["prev_best"] if k else None)
            t = (graph_time_ms(lambda: cuda_kernels.assign_pass(*args)),
                 graph_time_ms(lambda: K.assign_pass_plain(*args)))
            nbytes, live = assign_pass_bytes(x, k)
            t_b, by = bound(nbytes, live * kk * 2)
            log(f"  assign_pass C={c} K={kk} pass {k}: exact match; device "
                f"time per call: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms; "
                f"{live} rows read; bound {t_b:.5f} ms ({nbytes} bytes)")
            if timed is None and k == 3:
                timed = (kk, t, t_b, by)
    kk, t, t_b, by = timed
    return dict(max_abs_err=0.0, ms=t[0], plain_ms=t[1], bound_ms=t_b,
                bound_by=by, library_ms=None, shape=f"C={c} K={kk} pass 3")


def check_assign_chain(c: int, kk: int, num_b: int, seed: int) -> dict:
    """K2 on the late passes of a real chain: assign_destinations'
    multi-commit loop (K2, then K8 with the commit, T = 3 terms, the
    default cap) on a [C, K] plane, each pass against assign_pass_plain on
    the same state (exactly) and timed, with the rows it still reads."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import kernels as K
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = _assign_pass_inputs(c, kk, num_b, g)
    pref, ids, has_c = x["pref"], x["dest_ids"], x["cand_has"]
    gain = torch.round(torch.rand(c, generator=g, device="cuda") * 8.0)
    d_w = torch.rand((3, c), generator=g, device="cuda")
    hr = torch.rand((3, num_b), generator=g, device="cuda") * 40.0
    cap = torch.full((num_b,), K.MAX_ARRIVALS_PER_ROUND, dtype=torch.int32,
                     device="cuda")
    taken = torch.zeros(num_b, dtype=torch.int32, device="cuda")
    cum = torch.zeros((3, num_b), device="cuda")
    amp = torch.empty((), device="cuda")
    assigned = torch.zeros(c, dtype=torch.bool, device="cuda")
    dest = torch.zeros(c, dtype=torch.int32, device="cuda")
    keep = best = None
    passes = {}
    for k in range(K.MULTI_ASSIGN_PASSES):
        state = dict(x, taken_cnt=taken.clone(), cap=cap, assigned=assigned,
                     dest=dest, keep=keep if k else assigned.clone(),
                     prev_best=best if k else dest.clone())
        got = _assign_pass_call(cuda_kernels.assign_pass, state, k,
                                amp.clone())
        want = _assign_pass_call(K.assign_pass_plain, state, k, amp.clone())
        torch.cuda.synchronize()
        if not all(equal_exact(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"assign_pass chain C={c} K={kk} pass {k}: "
                                 "differs from the plain version")
        args = (pref, ids, state["taken_cnt"], cap, has_c, k, amp.clone(),
                assigned.clone(), dest.clone(), keep, best)
        ms = graph_time_ms(lambda: cuda_kernels.assign_pass(*args))
        nbytes, live = assign_pass_bytes(state, k)
        t_b, by = bound(nbytes, live * kk * 2)
        passes[k] = dict(ms=ms, live_rows=live, bound_ms=t_b, bound_by=by)
        log(f"  assign_pass chain C={c} K={kk} B={num_b} pass {k}: exact "
            f"match; {live} of {c} rows read; kernel {ms:.4f} ms; bound "
            f"{t_b:.5f} ms")
        best, h = cuda_kernels.assign_pass(pref, ids, taken, cap, has_c, k,
                                           amp, assigned, dest, keep, best)
        keep = K.rank_accept_commit(best, gain, h, num_b, taken, cap, cum,
                                    d_w, hr)
    return passes


def commit_bytes(state, cache, r, dst, valid, rank) -> int:
    """Bytes K3's function must move for this batch: the batch once, each
    valid move's replica and partition rows, the prefix of each source row
    up to the last departing slot (the cache keeps no replica-to-slot
    index), the punched and appended table slots, and a read and a write
    of each touched aggregate entry.  No copy of an untouched entry."""
    import torch
    s_w = cache.broker_table.shape[1]
    rv, dv = r[valid].long(), dst[valid].long()
    src = state.replica_broker[rv].long()
    if s_w:
        slot = (cache.broker_table[src] == rv[:, None].int()).int().argmax(1)
        scan = torch.full((state.num_brokers,), -1, dtype=torch.int64,
                          device=src.device).scatter_reduce(
                              0, src, slot.long(), "amax")
        arrive = (cache.table_fill[dv] + rank[valid]) < s_w
        table_bytes = (int((scan + 1).sum()) * 4   # source-row prefixes
                       + rv.numel() * 5            # punched id and flag
                       # appended slots and fill pointers
                       + int(arrive.sum()) * (4 + 16 + 16 + 1 + 1)
                       + torch.unique(dv).numel() * 8)
    else:
        table_bytes = 0                            # table-less mode
    p = state.replica_partition[rv].long()
    t = state.partition_topic[p].long()
    k, nt = state.num_racks, state.num_topics
    prc = torch.unique(torch.cat([p * k + state.broker_rack[src].long(),
                                  p * k + state.broker_rack[dv].long()]))
    btc = torch.unique(torch.cat([src * nt + t, dv * nt + t]))
    brokers = torch.unique(torch.cat([src, dv]))
    n_v = rv.numel()
    return int(r.numel() * (13 if s_w else 9)      # r, dst, valid, rank
               + n_v * (4 + 4 + 1 + 16 + 1 + 16 + 4 + 4)   # replica rows
               + table_bytes
               # per touched broker: load read and written, util written,
               # capacity and rack read, four counters read and written
               + brokers.numel() * (32 + 16 + 16 + 4 + 4 * 8)
               + (prc.numel() + btc.numel()) * 8)  # count planes


def restored_graph_ms(pristine: dict, launch, reps: int = 20,
                      trials: int = 5):
    """Device time per call of `launch(planes)` without the copies a
    commit would make: `reps` calls captured in one CUDA graph, each on
    its own copy of the `pristine` planes, which are restored before each
    timed replay (so every replay commits the same batch into the same
    cache); the median replay over `reps`.  Returns (ms, the first copy
    after the last replay)."""
    import torch
    launch({f: t.clone() for f, t in pristine.items()})
    bufs = [{f: t.clone() for f, t in pristine.items()}
            for _ in range(reps)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for buf in bufs:
            launch(buf)
    times = []
    for _ in range(trials):
        for buf in bufs:
            for f, t in pristine.items():
                buf[f].copy_(t)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), bufs[0]


def _check_equal(got: dict, want: dict, what: str) -> None:
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what} writes {sorted(got)}, the plain "
                             f"version {sorted(want)}")
    for f in sorted(want):
        if not equal_exact(got[f], want[f]):
            raise AssertionError(f"{what}: {f} differs from the plain "
                                 "version")


def _donor(cache, fields):
    """A copy of `cache` whose `fields` an in-place commit may update."""
    return cache.replace(**{f: getattr(cache, f).clone() for f in fields})


def _move_batch(state, n: int, g, hubs: int):
    """n distinct replicas moving to `hubs` random destinations (several
    arrivals each), nine in ten valid; the no-ops among them (a replica
    already on its destination) are left for the commit to drop."""
    import torch
    r = torch.randperm(state.num_replicas, generator=g,
                       device="cuda")[:n].to(torch.int32)
    pool = torch.randperm(state.num_brokers, generator=g,
                          device="cuda")[:hubs]
    dst = pool[torch.randint(0, hubs, (n,), generator=g,
                             device="cuda")].to(torch.int32)
    valid = torch.rand(n, generator=g, device="cuda") < 0.9
    return r, dst, valid


def check_commit_moves(spec: dict, seed: int, shapes) -> dict:
    """K3 on the round cache of the cluster `spec` for each (batch, hubs,
    table) of `shapes`: against its plain version bit for bit, committed
    in place into a copy of the cache (the returned planes must be that
    copy's own), and its in-kernel arrival ranks against `arrival_rank`;
    then the device time per call of the commit in place (on cache planes
    restored before each replay) and of a clone of the cache's planes plus
    the commit (what a caller that keeps its cache would pay), the host
    time per call of each, the plain version's time and the bound.  The
    record of the first shape, with every shape under "cases"."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels as ck
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.testing.random_cluster import (
        RandomClusterSpec, random_cluster)
    state, _ = random_cluster(RandomClusterSpec(**spec))
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    g = torch.Generator(device="cuda").manual_seed(seed)
    rec = None
    for n, hubs, table in shapes:
        cache = C.make_round_cache(state, ctx.table_slots if table else 0,
                                   ctx)
        fields = ck.commit_fields(cache)
        r, dst, valid = _move_batch(state, n, g, hubs)
        counted = valid & (state.replica_broker[r.long()] != dst)
        rank = C.arrival_rank(dst, counted, state.num_brokers)
        t_rank = rank if table else None
        label = (f"commit_moves B={state.num_brokers} batch={n}"
                 + ("" if table else " table-less"))
        want = C.commit_moves_plain(state, cache, r, dst, counted, t_rank)
        ranks = torch.empty_like(r)
        donor = _donor(cache, fields)
        got = ck.commit_moves(state, donor, r, dst, valid, rank_out=ranks)
        torch.cuda.synchronize()
        _check_equal(got, want, label)
        if any(got[f].data_ptr() != getattr(donor, f).data_ptr()
               for f in want):
            raise AssertionError(f"{label}: the committed planes are not "
                                 "the cache's own")
        if not equal_exact(ranks, torch.where(counted, rank, -1)):
            raise AssertionError(f"{label}: in-kernel ranks differ from "
                                 "arrival_rank")
        err = max_abs_err([(got[f], want[f]) for f in want
                           if want[f].dtype.is_floating_point])
        per_dest = int(torch.bincount(dst[counted].long()).max())
        pristine = {f: getattr(cache, f) for f in fields}
        kernel, kept = restored_graph_ms(
            pristine, lambda planes: ck.commit_moves(
                state, cache.replace(**planes), r, dst, valid))
        _check_equal(kept, want, label + " replayed")
        copies = graph_time_ms(lambda: ck.commit_moves(
            state, _donor(cache, fields), r, dst, valid))
        host = host_us(lambda: ck.commit_moves(state, donor, r, dst, valid))
        host_copies = host_us(lambda: ck.commit_moves(
            state, _donor(cache, fields), r, dst, valid))
        # the plain version synchronises with the host (its ordered float
        # scatter counts rounds), so it is timed per call with its host
        # time
        plain = cuda_time_ms(lambda: C.commit_moves_plain(
            state, cache, r, dst, counted, t_rank), reps=5)
        nbytes = commit_bytes(state, cache, r, dst, counted, t_rank)
        t_b, by = bound(nbytes, int(counted.sum()) * 2 * 6)
        log(f"  {label} ({int(counted.sum())} counted, up to {per_dest} "
            f"arrivals per destination): bit-exact, in place, ranks equal "
            f"arrival_rank's; device time per call: in place {kernel:.4f} "
            f"ms, a clone of the {len(fields)} cache planes plus the commit "
            f"{copies:.4f} ms; host time per call {host:.1f} us in place, "
            f"{host_copies:.1f} us with the clone; plain version, one call "
            f"with its host time, {plain:.4f} ms; bound {t_b:.5f} ms "
            f"({nbytes} bytes)")
        case = dict(max_abs_err=err, ms=kernel, copies_ms=copies,
                    host_us=host, host_us_copies=host_copies,
                    plain_ms=plain, bound_ms=t_b, bound_by=by,
                    library_ms=None, shape=label[len("commit_moves "):])
        if rec is None:
            rec = dict(case)
        rec.setdefault("cases", {})[case["shape"]] = case
    return rec


#: K7's launches per call: one cooperative launch; the guard alone is one
#: plain launch
FORCED_SELECT_LAUNCHES = {"select": 1, "guard": 1}


def check_forced_select(spec: dict, seed: int, pk=None) -> dict:
    """K7 at R = the cluster `spec`'s replicas, k = min(4096, R), in four
    cases: about 0.5 % forced (config 5's broken logdirs), many equal
    weights, fewer forced than k (the -inf tail in play), every replica
    forced; each bit for bit against its plain version, and the guard-only
    launch (k = 0).  Times of the kernel, the plain version and torch.topk
    on the same scores; with --parent, the parent's K7 on the same inputs,
    bit for bit against this tree's, timed in turns with it (this tree,
    the parent, this tree, the parent).  The record of the 0.5 % case."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.analyzer import kernels as K
    from cruise_control_tpu_torch.testing.random_cluster import (
        RandomClusterSpec, random_cluster)
    state, _ = random_cluster(RandomClusterSpec(**spec))
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    g = torch.Generator(device="cuda").manual_seed(seed)
    num_r, num_b = state.num_replicas, state.num_brokers
    pr = ctx.partition_replicas
    rf = pr.shape[1]
    k = min(4096, num_r)
    w0 = state.replica_base_load[:, 3].contiguous()
    inf = torch.full((), float("inf"), device="cuda")
    dest_ok = state.broker_alive & (torch.rand(num_b, generator=g,
                                               device="cuda") < 0.9)
    top_b, top_h = K.top_headroom(dest_ok, inf.expand(num_b), rf)
    top_b = top_b.to(torch.int32).contiguous()
    top_h = top_h.contiguous()
    cases = (("0.5% forced", 0.005, w0),
             ("equal weights", 0.3, torch.round(w0 / w0.max() * 3.0)),
             ("fewer forced than k", min(1.0, 0.5 * k / num_r), w0),
             ("every replica forced", 1.0, w0))
    rec = None
    for label, share, w in cases:
        forced = torch.rand(num_r, generator=g, device="cuda") < share
        args = (forced, w, state.replica_partition, state.replica_broker,
                pr, top_b, top_h)
        for kk in (k, 0):
            got = cuda_kernels.forced_select(*args, kk)
            want = K.forced_select_plain(*args, kk)
            torch.cuda.synchronize()
            for x, y, what in zip(got, want, ("cand_r", "cand_has",
                                              "forced_ok")):
                if (x is None) != (y is None) or (
                        x is not None and not equal_exact(x, y)):
                    raise AssertionError(
                        f"forced_select R={num_r} k={kk} {label}: {what} "
                        "differs from the plain version")
        n_forced, n_ok = int(forced.sum()), int(want[2].sum())
        if label.startswith("fewer") and not 0 < n_ok < k:
            raise AssertionError(f"forced_select {label}: {n_ok} guarded "
                                 f"replicas, not between 0 and k={k}")
        score = torch.where(want[2], w + 1.0, -inf)
        t = (graph_time_ms(lambda: cuda_kernels.forced_select(*args, k)),
             graph_time_ms(lambda: K.forced_select_plain(*args, k)),
             graph_time_ms(lambda: torch.topk(score, k)),
             graph_time_ms(lambda: cuda_kernels.forced_select(*args, 0)))
        # the flags in and out for every replica; weight, partition,
        # sibling row and sibling brokers for each forced one; k ids and
        # flags out
        nbytes = num_r * 2 + n_forced * (4 + 4 + 8 * rf) + k * 5
        t_b, by = bound(nbytes, n_forced * rf * (rf + 2) + num_r)
        path = "select" if n_ok > k else "no select (<= k guarded)"
        log(f"  forced_select R={num_r} k={k} {label} ({n_forced} forced, "
            f"{n_ok} with a destination, {path}): exact match, guard-only "
            f"too; device time per call: kernel {t[0]:.4f} ms (1 "
            f"cooperative launch; guard only {t[3]:.4f} ms), plain "
            f"{t[1]:.4f} ms, torch.topk {t[2]:.4f} ms; bound {t_b:.5f} ms "
            f"({nbytes} bytes)")
        turns = None
        if pk is not None:
            mine = cuda_kernels.forced_select(*args, k)
            theirs = pk.forced_select(*args, k)
            torch.cuda.synchronize()
            if not all(equal_exact(x, y) for x, y in zip(mine, theirs)):
                raise AssertionError(f"forced_select R={num_r} k={k} "
                                     f"{label}: differs from the parent's")
            turns = [graph_time_ms(lambda: kc.forced_select(*args, k))
                     for kc in (cuda_kernels, pk, cuda_kernels, pk)]
            log(f"  forced_select R={num_r} k={k} {label}: equal to the "
                "parent's bit for bit; in turns this tree / the parent / "
                "this tree / the parent " + " / ".join(
                    f"{x:.4f}" for x in turns) + " ms")
        case = dict(ms=t[0], parent_ms=turns, path=path)
        if rec is None:
            rec = dict(max_abs_err=0.0, ms=t[0], plain_ms=t[1], bound_ms=t_b,
                       bound_by=by, library_ms=t[2], guard_ms=t[3],
                       launches_per_call=FORCED_SELECT_LAUNCHES,
                       shape=f"R={num_r} k={k} {label}", cases={})
        rec["cases"][label] = case
    return rec


def _leader_inputs(c: int, num_b: int, num_r: int, g, multi: bool):
    """K4's pass-0 inputs on the card (analyzer/kernels.py leader_tail):
    candidate rows (int64, as the compaction gives them), sibling rows (the
    row itself among them, a tenth -1), an acceptance plane, per-replica
    brokers, offline flags and bonuses, per-broker flags, headrooms and
    preferences (planted ties, a NEG broker), three weight rows
    (multi-commit); rows 0-3 with every option closed (no candidate, no
    acceptance, NEG brokers only, no headroom)."""
    import types
    import torch
    from cruise_control_tpu_torch.analyzer import kernels as K

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    def ints(hi, shape, dtype=torch.int32):
        return torch.randint(0, hi, shape, generator=g, device="cuda",
                             dtype=dtype)
    rf = 3
    rows = ints(num_r, (c,), torch.int64)
    sib = ints(num_r, (c, rf))
    sib[:, 0] = rows.to(torch.int32)
    sib = torch.where(rand(c, rf) < 0.1, -1, sib)
    rb = ints(num_b, (num_r,))
    pref = -torch.round(rand(num_b) * 8.0)
    pref[3] = K.NEG
    pref[5] = pref[6]
    accept = rand(c, rf) < 0.85
    cand_has = rand(c) < 0.9
    cand_has[0] = False
    accept[1] = False
    sib[2] = torch.where(rb[sib[2].clamp_min(0).long()] == 3, sib[2], -1)
    bonus = torch.round(rand(num_r) * 4.0)
    bonus[rows[3]] = 1e9
    state = types.SimpleNamespace(replica_broker=rb,
                                  replica_offline=rand(num_r) < 0.05)
    x = dict(state=state, rows=rows, sib=sib, accept=accept,
             cand_has=cand_has, leader_ok=rand(num_b) < 0.9, bonus_w=bonus,
             dest_headroom=rand(num_b) * 5.0, dest_pref=pref,
             t_ws=rand(3, num_r) if multi else None)
    return x


def _leader_tail(x: dict):
    from cruise_control_tpu_torch.analyzer import kernels as K
    return K.leader_tail(x["state"], x["rows"], x["sib"], x["accept"],
                         x["cand_has"], x["leader_ok"], x["bonus_w"],
                         x["dest_headroom"], x["dest_pref"], x["t_ws"])


def leader_pass_bytes(t, k: int, multi: bool, keep) -> int:
    """The bytes one K4 pass must move.  Pass 0: the rows, sibling rows,
    acceptance plane and flags, per row its broker and bonus, per option
    its broker, flags, headroom and preference; the three option planes,
    the sources, gains, zeroed state and picks out.  Pass k: the keep
    flags and each kept row's fold, the preferences, option brokers and
    their counters, the winner's replica, the flags and the picks; with
    K8's weights (read and written) in multi-commit mode."""
    c, rf = t.sib.shape
    num_b = t.taken_cnt.shape[0]
    n_t = 0 if t.t_ws is None or not multi else t.t_ws.shape[0]
    if k == 0:
        n = (c * (t.rows.element_size() + 5 * rf + 1 + 8 + 14 * rf
                  + 12 * rf + 8 + 5 + 9) + 8 * num_b)
    else:
        kept = int(keep.sum())
        n = (c + kept * (4 + 5 + (4 + 8 if not multi else 0))
             + c * (8 * rf + 4 * rf + 4 + 1 + 9 + 1)
             + (0 if multi else 8 * c))
    return n + 8 * n_t * c


def check_leader_assign(c: int, num_b: int, num_r: int,
                        seed: int) -> dict:
    """K4 at C rows of RF = 3 options over num_r replicas, both commit
    modes: passes 0 (the plane, the sources, gains, zeroed state and the
    amplitude bit for bit) to 3, each folding the pass before (a random
    third of the rows with an option kept), every output and buffer exact
    against leader_assign_pass_plain; passes 0 and 3 timed beside the
    plain version.  {"multi" / "single": {"pass 0" / "pass 3":
    record}}."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels as ck
    from cruise_control_tpu_torch.analyzer import kernels as K
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for multi in (True, False):
        mode = "multi" if multi else "single"
        x = _leader_inputs(c, num_b, num_r, g, multi)
        tk, tp = _leader_tail(x), _leader_tail(x)
        keep = db = dr = None
        rec = out[mode] = {}
        for k in range(4):
            args = (keep, db, dr)
            got = ck.leader_assign_pass(tk, k, multi, *args)
            want = K.leader_assign_pass_plain(tp, k, multi, *args)
            torch.cuda.synchronize()
            for a, b, what in zip(got, want, ("db", "dr", "has")):
                if not equal_exact(a, b):
                    raise AssertionError(f"leader_assign_pass C={c} "
                                         f"B={num_b} {mode} pass {k}: {what} "
                                         "differs from the plain version")
            for f in ("pref", "sib_broker", "sib_replica", "src", "gain",
                      "amp", "taken_cnt", "dep_cnt", "assigned",
                      "dest_replica", "d_w"):
                a, b = getattr(tk, f), getattr(tp, f)
                if a is not None and not (a.dtype == b.dtype
                                          and torch.equal(a, b)
                                          and (not a.is_floating_point()
                                               or torch.equal(
                                                   a.view(torch.int32),
                                                   b.view(torch.int32)))):
                    raise AssertionError(f"leader_assign_pass C={c} "
                                         f"B={num_b} {mode} pass {k}: {f} "
                                         "differs from the plain version")
            if k == 0 and bool(want[2][:4].any()):
                raise AssertionError("leader_assign_pass: a row with every "
                                     "option closed has an option")
            if k in (0, 3):
                launch_args = (tk, k, multi) + args
                ms = graph_time_ms(lambda: ck.leader_assign_pass(
                    *launch_args))
                t_plain = graph_time_ms(lambda: K.leader_assign_pass_plain(
                    tp, k, multi, *args))
                nbytes = leader_pass_bytes(tk, k, multi, keep)
                t_b, by = bound(nbytes, c * 3 * 4)
                log(f"  leader_assign_pass C={c} B={num_b} {mode} pass {k}: "
                    f"exact match ({int(want[2].sum())} rows with an "
                    f"option{', amp ' + repr(float(tk.amp)) if k == 0 else ''}"
                    f"); device time per call: kernel {ms:.4f} ms (1 "
                    f"launch), plain {t_plain:.4f} ms; bound {t_b:.6f} ms "
                    f"({nbytes} bytes)")
                rec[f"pass {k}"] = dict(
                    max_abs_err=0.0, ms=ms, plain_ms=t_plain, bound_ms=t_b,
                    bound_by=by, library_ms=None,
                    shape=f"C={c} B={num_b} RF=3 {mode} pass {k}")
            db, dr = want[0], want[1]
            keep = want[2] & (torch.rand(c, generator=g, device="cuda")
                              < 0.3)
            if multi:
                # K8's commit between passes: destinations filling up to
                # the arrival ceiling and past it
                bump = torch.randint(0, 40, (num_b,), generator=g,
                                     device="cuda", dtype=torch.int32)
                tk.taken_cnt += bump
                tp.taken_cnt += bump
    return out


def _leadership_batch(state, n: int, g, valid_share: float):
    """n transfers (current leader -> another replica of the partition)
    on distinct partitions; about `valid_share` of them valid."""
    import torch
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.model import state as S
    rows = torch.from_numpy(C.partition_replica_index(state)).cuda()
    cur = S.partition_leader_replica(state)
    parts = torch.randperm(state.num_partitions, generator=g,
                           device="cuda")[:n]
    opts = rows[parts]
    sr = cur[parts]
    pick = torch.randint(1, opts.shape[1], (n,), generator=g, device="cuda")
    # the first option that is not the leader, rotated by `pick`
    order = (torch.arange(opts.shape[1], device="cuda")[None, :]
             + pick[:, None]) % opts.shape[1]
    cand = torch.gather(opts, 1, order)
    ok = (cand >= 0) & (cand != sr[:, None])
    dr = torch.clamp_min(torch.gather(
        cand, 1, torch.argmax(ok.to(torch.int8), 1)[:, None]), 0)
    valid = (torch.rand(n, generator=g, device="cuda") < valid_share) & (
        sr >= 0) & torch.any(ok, 1)
    return (torch.clamp_min(sr, 0).to(torch.int32).contiguous(),
            dr[:, 0].to(torch.int32).contiguous(), valid)


def leadership_bytes(state, cache, sr, dr, valid) -> int:
    """Bytes K5's function must move for this batch: the batch once, each
    valid transfer's replica and partition rows, a read and a write of its
    two replica-load rows, with a table each row's prefix up to the slot
    it searches for and a read and a write of the two slots, and a read
    and a write of each touched broker entry."""
    import torch
    sv, dv = sr[valid].long(), dr[valid].long()
    n_v = sv.numel()
    nbytes = sr.numel() * 9 + n_v * (4 + 4 + 4 + 16 + 4 + 4 + 2 * 2 * 16)
    sw = cache.broker_table.shape[1]
    if sw:
        for ids in (sv, dv):
            rows = cache.broker_table[state.replica_broker[ids].long()]
            slot = (rows == ids[:, None].int()).int().argmax(1)
            nbytes += int((slot + 1).sum()) * 4 + ids.numel() * (2 * 16 + 1)
    brokers = torch.unique(torch.cat([state.replica_broker[sv],
                                      state.replica_broker[dv]]))
    return int(nbytes + brokers.numel() * (32 + 16 + 16 + 8 + 8))


def check_commit_leadership(spec: dict, seed: int) -> dict:
    """K5 on a 4,096-transfer table-less batch (the sweep's commit) and on
    a B*16-row batch with the broker table (phase a's): against its plain
    version bit for bit, undonated and donated (into the cache's own
    planes), then the device time per call of the kernel alone, of the
    wrapper with `donate` and of the wrapper with copies of the planes it
    writes, the wrapper's host time per call with and without `donate`,
    the plain version's time and the bound.  The record of the
    table-less batch, with both under "cases"."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels as ck
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.testing.random_cluster import (
        RandomClusterSpec, random_cluster)
    state, _ = random_cluster(RandomClusterSpec(**spec))
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    g = torch.Generator(device="cuda").manual_seed(seed)
    rec = None
    for kind, slots, n, share in (
            ("table-less", 0, 4096, 0.9),
            ("with table", ctx.table_slots, state.num_brokers * 16, 0.5)):
        cache = C.make_round_cache(state, slots, ctx)
        sr, dr, valid = _leadership_batch(state, n, g, share)
        label = f"commit_leadership B={state.num_brokers} {kind} batch={n}"
        want = C.commit_leadership_plain(state, cache, sr, dr, valid)
        got = ck.commit_leadership(state, cache, sr, dr, valid)
        donor = _donor(cache, want)
        donated = ck.commit_leadership(state, donor, sr, dr, valid,
                                       donate=True)
        torch.cuda.synchronize()
        _check_equal(got, want, label)
        _check_equal(donated, want, label + " donated")
        if any(donated[f].data_ptr() != getattr(donor, f).data_ptr()
               for f in want):
            raise AssertionError(f"{label}: donated planes are copies")
        err = max_abs_err([(got[f], want[f]) for f in want
                           if want[f].dtype.is_floating_point])
        pristine = {f: getattr(cache, f) for f in want}
        kernel, kept = restored_graph_ms(
            pristine, lambda out: ck.commit_leadership_into(
                out, state, cache, sr, dr, valid))
        _check_equal(kept, want, label + " replayed")
        donate_ms, kept = restored_graph_ms(
            pristine, lambda planes: ck.commit_leadership(
                state, cache.replace(**planes), sr, dr, valid, donate=True))
        _check_equal(kept, want, label + " donated, replayed")
        wrapper = graph_time_ms(lambda: ck.commit_leadership(
            state, cache, sr, dr, valid))
        host_copy = host_us(lambda: ck.commit_leadership(state, cache, sr,
                                                         dr, valid))
        host_donate = host_us(lambda: ck.commit_leadership(
            state, donor, sr, dr, valid, donate=True))
        plain = cuda_time_ms(lambda: C.commit_leadership_plain(
            state, cache, sr, dr, valid), reps=5)
        nbytes = leadership_bytes(state, cache, sr, dr, valid)
        t_b, by = bound(nbytes, int(valid.sum()) * 2 * 5)
        log(f"  {label} ({int(valid.sum())} valid): bit-exact, donated "
            f"too; device time per call: kernel {kernel:.4f} ms, wrapper "
            f"with donate {donate_ms:.4f} ms, wrapper with copies of the "
            f"planes it writes {wrapper:.4f} ms; host time per call "
            f"{host_donate:.1f} us with donate, {host_copy:.1f} us with "
            f"copies; plain version, one call with its host time, "
            f"{plain:.4f} ms; bound {t_b:.5f} ms ({nbytes} bytes)")
        case = dict(max_abs_err=err, ms=kernel, donate_ms=donate_ms,
                    wrapper_ms=wrapper, host_us_donate=host_donate,
                    host_us_copies=host_copy, plain_ms=plain, bound_ms=t_b,
                    bound_by=by, library_ms=None,
                    shape=label[len("commit_leadership "):])
        if rec is None:
            rec = dict(case)
        rec.setdefault("cases", {})[case["shape"]] = case
    return rec


#: K6's input cases (see _sweep_case)
SWEEP_CASES = ("random", "ties and signed zeros", "few live partitions",
               "no live partition", "all failed")


def _sweep_case(state, ctx, cache, g, improve: bool, tiebreak: bool,
                case: str) -> dict:
    """K6's inputs on the card from the cluster `state`: the goals' value
    (a resource's leader bonus), their bounds (limit mode: the balance
    upper limit, the band's middle; mean mode: the alive-broker average
    read through stride 0), a column of the cache's broker loads (a
    strided vector), the carried leader index and failure marks, and
    `case`: quantized values with -0.0 and +0.0 among them (tied gains),
    no live partition (every source bound +inf), or every partition
    marked failed, or few live partitions (the brokers above the 97th
    percentile shed: fewer than the window)."""
    import numpy as np
    import torch
    from cruise_control_tpu_torch import ops
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.analyzer import kernels as K
    from cruise_control_tpu_torch.model import state as S
    res = 2
    rows = ctx.partition_replicas
    num_p, rf = rows.shape
    num_b = state.num_brokers
    value = (state.partition_leader_bonus[state.replica_partition.long(),
                                          res] * state.replica_valid)
    if case == "ties and signed zeros":
        value = torch.round(value * 4.0) / 4.0
        r = torch.rand(value.shape[0], generator=g, device="cuda")
        value = torch.where(r < 0.05, torch.full_like(value, -0.0), value)
        value = torch.where((r >= 0.05) & (r < 0.1),
                            torch.zeros_like(value), value)
    cap = state.broker_capacity[:, res]
    W = cache.broker_load[:, res]
    if improve:
        alive = state.broker_alive
        avg = ops.sum_f32(W * alive) / torch.clamp_min(torch.sum(alive), 1)
        up = (ctx.balance_upper_pct[res] * cap).contiguous()
        shed_to = avg.reshape(1).expand(num_b)
        fill_to = torch.minimum(shed_to, up)
        hard_cap = up
    else:
        shed_to = hard_cap = (ctx.balance_upper_pct[res] * cap).contiguous()
        fill_to = ((hard_cap + ctx.balance_lower_pct[res] * cap) / 2.0
                   ).contiguous()
        # sheds from the upper third of the brokers
        shed_to = torch.minimum(shed_to, torch.quantile(W, 0.6).expand(
            num_b)).contiguous()
    if case == "few live partitions":
        shed_to = torch.quantile(W, 0.97).expand(num_b)
    if case == "no live partition":
        shed_to = torch.full((num_b,), float("inf"), device="cuda")
    failed = (torch.ones(num_p, device="cuda") if case == "all failed"
              else (torch.rand(num_p, generator=g, device="cuda")
                    < 0.1).float())
    tb = None
    if tiebreak:
        tb = -cache.leader_bytes_in.clone()
        tb[::9] = 0.0
    return dict(
        cur=S.partition_leader_replica(state), failed=failed, rows=rows,
        jit_plane=K._pairwise_jitter(num_p, rf, salt=0, device="cuda"),
        replica_broker=state.replica_broker,
        replica_partition=state.replica_partition, value_r=value.contiguous(),
        static_ok=C.replica_static_ok(state, ctx), alive=state.broker_alive,
        leader_ok=ctx.broker_leader_ok, W=W, shed_to=shed_to,
        fill_to=fill_to, hard_cap=hard_cap, tb=tb,
        salt=float(np.float32(3) * np.float32(0.37)), improve_gate=improve,
        select_jitter=1.0 if improve else 0.35)


def _sweep_args(x: dict, cur, failed, prev) -> tuple:
    return (cur, failed, prev, x["rows"], x["jit_plane"],
            x["replica_broker"], x["replica_partition"], x["value_r"],
            x["static_ok"], x["alive"], x["leader_ok"], x["W"],
            x["shed_to"], x["fill_to"], x["hard_cap"], x["tb"], x["salt"],
            x["improve_gate"], x["select_jitter"])


def _sweep_equal(got, want, what: str) -> None:
    from cruise_control_tpu_torch.analyzer import leadership as L
    for x, y, name in zip(got, want, L.SweepWindow._fields):
        if not (x.dtype == y.dtype and equal_exact(x, y)):
            raise AssertionError(f"sweep_pick {what}: {name} differs from "
                                 "the plain version")


def parent_sweep_chain(pk, x: dict, prev, valid):
    """The parent's sweep window at these inputs: its torch ops from
    cur_safe0 to dst_b around its K6 launch (the old cuda_kernels
    sweep_pick), then its fold of `valid` into copies of cur and
    failed."""
    import torch
    from cruise_control_tpu_torch import ops
    from cruise_control_tpu_torch.analyzer import leadership as L
    cur, failed = x["cur"], x["failed"]
    rb, value, W = x["replica_broker"], x["value_r"], x["W"]
    shed_to = x["shed_to"]
    num_p = cur.shape[0]
    cur_safe0 = torch.clamp_min(cur, 0).long()
    src_b0 = rb[cur_safe0]
    sb = src_b0.long()
    value_leave0 = value[cur_safe0]
    live = ((cur >= 0) & x["static_ok"][cur_safe0] & (W[sb] > shed_to[sb])
            & (value_leave0 > 0.0))
    if x["improve_gate"]:
        live &= value_leave0 < 2.0 * (W[sb] - shed_to[sb])
    gain_sel = L.sweep_window_gain(value_leave0, live, failed, x["salt"],
                                   x["select_jitter"])
    if num_p > L.SWEEP_COMPACT:
        inf = torch.full((), float("inf"), device="cuda")
        _, sel = ops.topk_stable(torch.where(live, gain_sel, -inf),
                                 L.SWEEP_COMPACT)
        has, cur_safe, src_b = live[sel], cur_safe0[sel], src_b0[sel]
        _, _ = value_leave0[sel], value_leave0[sel]
    else:
        sel = torch.arange(num_p, dtype=torch.int64, device="cuda")
        has, cur_safe, src_b = live, cur_safe0, src_b0
    tb_norm = None
    if x["tb"] is not None:
        tb = x["tb"]
        tb_lo = torch.min(tb)
        tb_norm = (tb - tb_lo) / torch.clamp_min(torch.max(tb) - tb_lo, 1e-9)
    dst_r, has = pk.sweep_pick(
        sel.to(torch.int32).contiguous(), has.contiguous(),
        cur_safe.to(torch.int32).contiguous(), x["rows"], x["jit_plane"], rb,
        value, x["static_ok"], x["alive"], x["leader_ok"], W.contiguous(),
        x["fill_to"].contiguous(), x["hard_cap"].contiguous(), tb_norm,
        x["salt"], x["improve_gate"])
    dst_b = rb[dst_r.long()]
    p_w = x["replica_partition"][cur_safe].long()
    ops.scatter_set(cur, torch.where(valid, p_w, torch.full_like(p_w, num_p)),
                    dst_r)
    failed = failed.clone()
    failed[sel] = torch.where(
        valid, torch.zeros((), device="cuda"),
        torch.where(has & ~valid, torch.ones((), device="cuda"),
                    failed[sel]))
    return dst_b


def sweep_bytes(x: dict, wn: int) -> int:
    """The bytes a sweep round's window with the fold must move: per
    partition its leader id and failure mark and the leader's value,
    broker and static flag; per window option its replica id, jitter,
    value, broker and static flag; each [B] vector once; per window row
    the outputs, the fold's reads of the round before and its writes of
    cur and failed.  The kernel's own scratch (the compaction's gains,
    flags and keys) is not the function's and is not counted."""
    num_p, rf = x["rows"].shape
    num_b = x["alive"].shape[0]
    per_p = 4 + 4 + 4 + 4 + 1
    per_opt = 4 + 4 + 4 + 4 + 1
    per_b = 4 * 4 + 1 + 1 + (4 if x["tb"] is not None else 0)
    per_row = (8 + 1 + 1 + 8 + 4 + 4 + 8 + 4) + (8 + 8 + 8 + 1 + 1) + 8
    return num_p * per_p + wn * rf * per_opt + num_b * per_b + wn * per_row


def check_sweep_window(spec: dict, seed: int, pk=None) -> dict:
    """K6 against sweep_window_plain on the cluster `spec`, exactly (every
    output and the folded cur and failed): both modes, with and without
    the tiebreak, first round and fold, in each of SWEEP_CASES; then
    device times of the first round and of a fold in limit mode (the
    goals'), beside the plain version, the bound, torch.topk of the
    window's [P] score (the compaction's library yardstick) and, with
    --parent, the parent's chain."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.analyzer import leadership as L
    from cruise_control_tpu_torch.testing.random_cluster import (
        RandomClusterSpec, random_cluster)
    state, _ = random_cluster(RandomClusterSpec(**spec))
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    cache = C.make_round_cache(state, 0, ctx)
    g = torch.Generator(device="cuda").manual_seed(seed)
    num_p = ctx.partition_replicas.shape[0]
    wn = min(L.SWEEP_COMPACT, num_p)
    n_cases = 0
    for improve in (False, True):
        for tiebreak in (False, True):
            for case in SWEEP_CASES:
                x = _sweep_case(state, ctx, cache, g, improve, tiebreak,
                                case)
                what = (f"P={num_p} improve_gate={improve} "
                        f"tiebreak={tiebreak} {case}")
                kc, kf = x["cur"].clone(), x["failed"].clone()
                pc, pf = x["cur"].clone(), x["failed"].clone()
                got = L.SweepWindow(*cuda_kernels.sweep_window(
                    *_sweep_args(x, kc, kf, None)))
                want = L.sweep_window_plain(*_sweep_args(x, pc, pf, None))
                _sweep_equal(got, want, f"{what}, first round")
                live = int(want.live_w.sum())
                if (live == 0) != (case == "no live partition"):
                    raise AssertionError(f"sweep_pick {what}: {live} live")
                valid = want.has & (torch.rand(wn, generator=g,
                                               device="cuda") < 0.6)
                got2 = L.SweepWindow(*cuda_kernels.sweep_window(
                    *_sweep_args(x, kc, kf, (got, valid))))
                want2 = L.sweep_window_plain(*_sweep_args(
                    x, pc, pf, (want, valid)))
                _sweep_equal(got2, want2, f"{what}, fold")
                if not (equal_exact(kc, pc) and equal_exact(kf, pf)):
                    raise AssertionError(f"sweep_pick {what}: the folded "
                                         "cur or failed differs")
                n_cases += 1
    log(f"  sweep_pick P={num_p} W={wn}: exact match in {n_cases} cases x "
        "(first round, fold)")
    x = _sweep_case(state, ctx, cache, g, False, False, "random")
    kc, kf = x["cur"].clone(), x["failed"].clone()
    first = L.SweepWindow(*cuda_kernels.sweep_window(
        *_sweep_args(x, kc, kf, None)))
    valid = first.has & (torch.rand(wn, generator=g, device="cuda") < 0.6)
    prev = (first, valid)
    t_first = graph_time_ms(lambda: cuda_kernels.sweep_window(
        *_sweep_args(x, kc, kf, None)))
    t_fold = graph_time_ms(lambda: cuda_kernels.sweep_window(
        *_sweep_args(x, kc, kf, prev)))
    pc, pf = x["cur"].clone(), x["failed"].clone()
    t_plain = graph_time_ms(lambda: L.sweep_window_plain(
        *_sweep_args(x, pc, pf, prev)))
    lib = None
    if num_p > wn:
        gain = torch.rand(num_p, generator=g, device="cuda")
        lib = graph_time_ms(lambda: torch.topk(gain, wn))
    t_parent = _parent_ms(pk, lambda: parent_sweep_chain(pk, x, prev,
                                                         valid))
    nbytes = sweep_bytes(x, wn)
    t_b, by = bound(nbytes, num_p * 12 + wn * x["rows"].shape[1] * 8)
    log(f"  sweep_pick P={num_p} W={wn} (limit mode): device time per "
        f"call: kernel first round {t_first:.4f} ms, with the fold "
        f"{t_fold:.4f} ms, plain {t_plain:.4f} ms, the parent's chain "
        f"{_ms(t_parent)}; bound {t_b:.5f} ms ({by}, {nbytes} bytes); "
        "library yardstick of the compaction alone: torch.topk of the "
        "[P] score " + (f"{lib:.4f} ms" if lib is not None
                        else "none (no compaction)"))
    return dict(max_abs_err=0.0, ms=t_fold, plain_ms=t_plain, bound_ms=t_b,
                bound_by=by, library_ms=lib, first_ms=t_first,
                parent_ms=t_parent, shape=f"P={num_p} W={wn} RF=3 fold")


#: K8's cases (see _rank_inputs for what each plants)
RANK_CASES = ("random", "all invalid", "one segment", "equal gains",
              "signed zeros", "taken at cap", "mid-segment failure",
              "order-sensitive weights")


def _rank_inputs(c: int, b: int, t: int, case: str, g):
    """rank_accept's inputs at C candidates, B brokers and T terms for one
    of RANK_CASES: (dest, gain, has, taken, cap, cum f32[T, B], d_w
    f32[T, C], hr f32[T, B])."""
    import torch
    dev = "cuda"

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=torch.int32)
    # few destinations, so segments are long; quantized gains plant ties
    dest = ints(0, min(b, max(1, c // 8) + 1), c)
    gain = torch.round(rand(c) * 8.0) / 4.0
    has = rand(c) < 0.85
    taken = torch.where(rand(b) < 0.7, torch.zeros((), device=dev,
                                                   dtype=torch.int32),
                        ints(1, 4, b))
    cap = ints(24, 65, b)
    d_w = torch.round(rand(t, c) * 64.0) / 16.0
    cum = torch.round(rand(t, b) * 16.0) / 4.0
    hr = cum + rand(t, b) * 60.0
    if case == "all invalid":
        has = torch.zeros(c, dtype=torch.bool, device=dev)
    elif case == "one segment":
        dest = torch.full((c,), b // 2, dtype=torch.int32, device=dev)
        cap = torch.full((b,), 1 << 30, dtype=torch.int32, device=dev)
        hr = cum + 0.4 * c
    elif case == "equal gains":
        gain = torch.ones(c, device=dev)
    elif case == "signed zeros":
        gain = torch.where(rand(c) < 0.5, torch.zeros((), device=dev),
                           torch.full((), -0.0, device=dev))
    elif case == "taken at cap":
        taken = torch.where(rand(b) < 0.5, cap, taken)
    elif case == "mid-segment failure":
        # one term crosses its headroom halfway down each segment
        d_w = torch.ones((t, c), device=dev)
        cum = torch.zeros((t, b), device=dev)
        hr = torch.full((t, b), max(1.0, c / (2.0 * max(1, c // 8 + 1))),
                        device=dev)
        cap = torch.full((b,), 1 << 30, dtype=torch.int32, device=dev)
    elif case == "order-sensitive weights":
        # magnitudes 2**24 apart with ties: the committed sums change with
        # the order of the adds; headrooms that let most candidates in
        scale = torch.tensor([1.0, 0.1, 3.0, 1.5e7], device=dev)[
            torch.randint(0, 4, (t, c), generator=g, device=dev)]
        d_w = scale * (torch.round(rand(t, c) * 3.0) + 1.0) / 3.0
        cum = cum * 1e3
        hr = torch.full((t, b), 3e9, device=dev)
    return dest, gain, has, taken, cap, cum, d_w, hr


def lexsort_rank_accept(dest, gain, has, num_b, taken_cnt, cap, cum_d, d_w,
                    hr_d):
    """K8's lexsort dispatch, for comparison: the torch lexsort (two
    stable sorts), then the kernel on that order."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import kernels as K
    seg = torch.where(has, dest.long(), torch.full_like(dest, num_b).long())
    return cuda_kernels.rank_accept(
        dest.to(torch.int32).contiguous(), gain.contiguous(),
        has.contiguous(), num_b, taken_cnt.to(torch.int32).contiguous(),
        cap.to(torch.int32).contiguous(), cum_d, d_w, hr_d,
        order=K._lexsort_dest_gain(seg, gain))


def lexsort_rank_accept_commit(dest, gain, has, num_b, taken_cnt, cap, cum,
                           d_w, hr):
    """The multi-commit pass after the assignment with K8's lexsort
    dispatch, for comparison: then the integer count and the ordered
    scatter of the cumulants (one host sync for the scatter's width, a
    launch per rank column)."""
    import torch
    from cruise_control_tpu_torch import ops
    keep = lexsort_rank_accept(dest, gain, has, num_b, taken_cnt, cap, cum,
                               d_w, hr)
    kept_d = torch.where(keep, dest, torch.full_like(dest, num_b))
    taken_cnt += ops.segment_sum(torch.ones_like(kept_d), kept_d, num_b)
    if cum.shape[0]:
        cum.T.copy_(ops.scatter_add_seq_plain(
            cum.T, kept_d, torch.where(keep[:, None], d_w.T,
                                       torch.zeros((), device=cum.device))))
    return keep


def lexsort_k8():
    """Inside the block the port runs K8's lexsort dispatch in place of the
    one-launch K8 (the leadership sweep's acceptance and the multi-commit
    passes)."""
    from cruise_control_tpu_torch.analyzer import kernels as K

    def to_lexsort(fn, name):
        return (lexsort_rank_accept if name == "rank_accept"
                else lexsort_rank_accept_commit)
    return _wrapped([(K, "rank_accept"), (K, "rank_accept_commit")],
                    to_lexsort)


def plain_sums():
    """Inside the block the card runs the plain versions of K12-K14 (the
    column-loop torch ops of the earlier dispatch, and the prefix gate's
    torch ops) in place of the kernels."""
    from cruise_control_tpu_torch import ops
    from cruise_control_tpu_torch.analyzer import kernels as K
    plain = {"segment_sum": ops.segment_sum_plain,
             "scatter_add_seq": ops.scatter_add_seq_plain,
             "sum_f32": ops.sum_f32_plain, "prefix_gate": K.prefix_gate_plain}
    return _wrapped([(K if name == "prefix_gate" else ops, name)
                     for name in plain],
                    lambda fn, name: lambda *a, **kw: plain[name](*a, **kw))


def dispatch_turns(solve: dict, other, labels=("kernel", "other")) -> dict:
    """A warm-up solve of `solve`, then unprofiled solves in turns: the
    dispatch `other()` (a context manager), the port's own, its own, the
    other; the wall times by label."""
    _, _, _, warm = _solve(solve, "cuda")
    log(f"  warm-up solve {warm:.3f} s")
    times = {label: [] for label in labels}
    for label in (labels[1], labels[0], labels[0], labels[1]):
        with (other() if label == labels[1] else contextlib.nullcontext()):
            _, _, result, secs = _solve(solve, "cuda")
        times[label].append(secs)
        log(f"  {label}: solve {secs:.3f} s, {len(result.proposals)} "
            "proposals")
    return times


def check_rank_accept(seed: int) -> dict:
    """K8 against its plain versions on the card, exactly: the acceptance
    alone (rank_accept, the leadership sweep's form) and with the pass
    commit (rank_accept_commit: keep, taken_cnt and the cumulants bit for
    bit), at C = 1, 16, 17, 256, 257, 2048, 4096 and 4097 (B = 200 and
    2600), T = 0, 1, 3 and 6, in every case of RANK_CASES; then at the
    paths' widest calls (C = 4 B = 10,400, the rack goal's table branch
    and the capacity goals' fallback at 2,600 brokers, with its follow-on
    commit; 20,800; and C = R = 600,000) with T = 3.  Times per pass
    commit at C = 2048 and 4096 (B = 200, T = 3; the record is C = 2048)
    and at 10,400 (B = 2600): the new kernel alone (graph replay), and
    per call with its host work (CUDA events around one call): the new
    dispatch, the lexsort dispatch (torch lexsort, the kernel on that
    order, the two ordered scatters) and the plain version."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import kernels as K
    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = [(c, b, t) for c in (1, 16, 17, 256, 257, 2048, 4096, 4097)
              for b in (200, 2600) for t in (0, 1, 3, 6)]
    shapes += [(10_400, 2600, 3), (20_800, 2600, 3), (600_000, 2600, 3)]
    n_checked = 0
    accepted = 0
    for c, b, t in shapes:
        for case in RANK_CASES:
            dest, gain, has, taken, cap, cum, d_w, hr = _rank_inputs(
                c, b, t, case, g)
            got = K.rank_accept(dest, gain, has, b, taken, cap, list(cum),
                                list(d_w), list(hr))
            want = K.rank_accept_plain(dest, gain, has, b, taken, cap,
                                       list(cum), list(d_w), list(hr))
            taken_k, cum_k = taken.clone(), cum.clone()
            keep_k = K.rank_accept_commit(dest, gain, has, b, taken_k, cap,
                                          cum_k, d_w, hr)
            taken_p, cum_p = taken.clone(), cum.clone()
            keep_p = K.rank_accept_commit_plain(dest, gain, has, b, taken_p,
                                                cap, cum_p, d_w, hr)
            torch.cuda.synchronize()
            for what, x, y in (("acceptance", got, want),
                               ("keep", keep_k, keep_p),
                               ("taken_cnt", taken_k, taken_p),
                               ("cumulants", cum_k, cum_p)):
                if not equal_exact(x, y):
                    bad = int((x != y).sum())
                    raise AssertionError(
                        f"rank_accept C={c} B={b} T={t} case {case!r}: "
                        f"{what}: {bad} entries differ from the plain "
                        "version")
            if not equal_exact(keep_k, want):
                raise AssertionError(f"rank_accept C={c} B={b} T={t} case "
                                     f"{case!r}: the commit's keep differs "
                                     "from the acceptance alone")
            n_checked += 1
            accepted += int(got.sum())
    log(f"  rank_accept: exact match in all {n_checked} checks ({accepted} "
        "acceptances), acceptance alone and with the commit (keep, counts "
        "and cumulants bit for bit), C up to 600,000")
    rec = None
    for c, b, t in ((2048, 200, 3), (4096, 200, 3), (10_400, 2600, 3)):
        dest, gain, has, taken, cap, cum, d_w, hr = _rank_inputs(
            c, b, t, "random", g)
        tk, cm = taken.clone(), cum.clone()
        args = (dest, gain, has, b, tk, cap, cm, d_w, hr)
        order = (None if c <= cuda_kernels.RANK_ONE_BLOCK_MAX
                 else K._lexsort_dest_gain(
                     torch.where(has, dest.long(),
                                 torch.full_like(dest, b).long()), gain))

        def reset():
            tk.copy_(taken)
            cm.copy_(cum)

        def kernel():
            reset()
            cuda_kernels.rank_accept(dest, gain, has, b, tk, cap, cm, d_w,
                                     hr, order=order, commit=True)

        def timed(fn):
            def call():
                reset()
                fn(*args)
            return cuda_time_ms(call)
        # graph replay: the kernel with the two resets, less the resets
        t_kernel = graph_time_ms(kernel) - graph_time_ms(reset)
        t_reset = cuda_time_ms(reset)
        times = (t_kernel, timed(K.rank_accept_commit) - t_reset,
                 timed(lexsort_rank_accept_commit) - t_reset,
                 timed(K.rank_accept_commit_plain) - t_reset)
        launches = 1 if c <= cuda_kernels.RANK_ONE_BLOCK_MAX else None
        # destinations, gains, flags and the T weight rows in, the flags
        # out; per broker the caps, the counts in and out, the T
        # headrooms in and the T cumulants in and out
        nbytes = c * (4 + 4 + 1 + 4 * t + 1) + b * (4 + 8 + 12 * t)
        t_b, by = bound(nbytes, c * t * 4)
        log(f"  rank_accept with the commit C={c} B={b} T={t}: kernel "
            f"{times[0]:.4f} ms per call (graph replay"
            f"{', one launch' if launches else ''}); per call with its host "
            f"work (CUDA events): new dispatch {times[1]:.4f} ms, lexsort "
            f"dispatch {times[2]:.4f} ms, plain {times[3]:.4f} ms; bound "
            f"{t_b:.6f} ms ({by}, {nbytes} bytes)")
        if rec is None:
            rec = dict(max_abs_err=0.0, ms=times[0], plain_ms=times[3],
                       dispatch_ms=times[1], lexsort_dispatch_ms=times[2],
                       bound_ms=t_b, bound_by=by, library_ms=None,
                       shape=f"C={c} B={b} T={t}, with the commit")
        else:
            rec.setdefault("wider", []).append(dict(
                c=c, b=b, t=t, ms=times[0], dispatch_ms=times[1],
                lexsort_dispatch_ms=times[2], plain_ms=times[3], bound_ms=t_b))
    return rec


def rank_accept_breakdown(seed: int) -> list:
    """Where K8's time goes: device time per call (graph replay, less the
    resets of the counts and cumulants) of the kernel given the lexsort
    order or sorting itself, without and with the commit; at C = 2048 and
    4096, T = 3, B = 200 and 2600 (one block), and at C = 10,400, B = 2600
    (the multi-launch path, given the order: its commit is one more
    launch)."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import kernels as K
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for c, b in ((2048, 200), (4096, 200), (2048, 2600), (4096, 2600),
                 (10_400, 2600)):
        dest, gain, has, taken, cap, cum, d_w, hr = _rank_inputs(
            c, b, 3, "random", g)
        seg = torch.where(has, dest.long(), torch.full_like(dest, b).long())
        order = K._lexsort_dest_gain(seg, gain)
        tk, cm = taken.clone(), cum.clone()

        def reset():
            tk.copy_(taken)
            cm.copy_(cum)

        t_reset = graph_time_ms(reset)
        row = dict(c=c, b=b)
        for label, kw in (("order, no commit", dict(order=order)),
                          ("sort, no commit", {}),
                          ("order, commit", dict(order=order, commit=True)),
                          ("sort, commit", dict(commit=True))):
            if "order" not in kw and c > cuda_kernels.RANK_ONE_BLOCK_MAX:
                continue
            def call(kw=kw):
                reset()
                cuda_kernels.rank_accept(dest, gain, has, b, tk, cap, cm,
                                         d_w, hr, **kw)
            row[label] = graph_time_ms(call) - t_reset
        rows.append(row)
        log(f"  rank_accept C={c} B={b} T=3, device ms per call: "
            + ", ".join(f"{k} {v:.4f}" for k, v in row.items()
                        if k not in ("c", "b")))
    return rows


def _argmax_inputs(n: int, s: int, g):
    """K9's inputs at n elements into s segments: quantized scores (many
    ties) with -0.0 against +0.0, NEG and -inf scores, a run of
    out-of-range and negative ids, an all-invalid segment (1) and empty
    segments (ids drawn from the lower nine tenths)."""
    import torch
    from cruise_control_tpu_torch.analyzer import kernels as K
    dev = "cuda"

    def rand(m):
        return torch.rand(m, generator=g, device=dev)
    score = torch.round(rand(n) * 6.0) / 2.0 - 1.0
    score = torch.where(rand(n) < 0.1, torch.full((), -0.0, device=dev),
                        score)
    score = torch.where(rand(n) < 0.05, torch.full((), K.NEG, device=dev),
                        score)
    score[: min(n, 3)] = torch.tensor([-float("inf"), K.NEG / 2, K.NEG / 4],
                                      device=dev)[: min(n, 3)]
    hi = max(1, (s * 9) // 10)
    seg = torch.randint(0, hi, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    seg[: min(n, 16)] = torch.arange(-8, 8, device=dev,
                                     dtype=torch.int32)[: min(n, 16)] * s
    valid = (rand(n) < 0.8) & (seg != 1)
    return score, seg, valid


def parent_kernels(root):
    """The parent tree's cuda_kernels module, loaded from the checkout
    `root` under a name of its own (it builds the parent's csrc/ into that
    checkout's build directory), for the yardstick chains; None without a
    checkout."""
    if not root:
        return None
    import importlib.util
    path = os.path.join(root, "cruise_control_tpu_torch", "cuda_kernels.py")
    spec = importlib.util.spec_from_file_location("parent_cuda_kernels",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build()
    log(f"[2] the parent's kernels ({root}) built in "
        f"{mod.BUILD_INFO['seconds']:.1f} s")
    return mod


def scratch_is_zero() -> bool:
    """K9's key scratch of the current stream is all zero (as it must be
    between launches)."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    torch.cuda.synchronize()
    buf = cuda_kernels.argmax_scratch(torch.cuda.current_device(),
                                      torch.cuda.current_stream().cuda_stream)
    return not bool(torch.count_nonzero(buf))


#: K9's grid-path folds phase 2 times at each grid shape: straight into
#: the global scratch, and into shared keys at shares of 1/4 to 2 S
ARGMAX_FOLDS = (("global", 0), ("shared S/4", 0.25), ("shared S/2", 0.5),
                ("shared 1 S", 1.0), ("shared 2 S", 2.0))


@contextlib.contextmanager
def argmax_fold(per_key: float):
    """K9's grid path with shares of `per_key` S elements a block folded
    into shared keys, whatever n (0: straight into the global scratch)."""
    from cruise_control_tpu_torch import cuda_kernels as ck
    saved = ck.ARGMAX_SHARE_PER_KEY, ck.ARGMAX_SHARED_MIN_AVG
    ck.ARGMAX_SHARE_PER_KEY, ck.ARGMAX_SHARED_MIN_AVG = per_key, 0
    try:
        yield
    finally:
        ck.ARGMAX_SHARE_PER_KEY, ck.ARGMAX_SHARED_MIN_AVG = saved


def _fold_times(launch, check, entry: str, n: int, s: int) -> dict:
    """A grid-path K9 call (n elements into s segments) under each fold of
    ARGMAX_FOLDS: exact (`check`) and the scratch zero after it, then
    timed.  {fold: ms}."""
    from cruise_control_tpu_torch import cuda_kernels
    out = {}
    for name, per_key in ARGMAX_FOLDS:
        with argmax_fold(per_key):
            check(launch())
            if not scratch_is_zero():
                raise AssertionError(f"{entry} n={n} S={s} ({name}): the key "
                                     "scratch is not zero after the call")
            out[name] = graph_time_ms(launch)
    log(f"    {entry} n={n} S={s} by fold: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in out.items())
        + f"; the wrapper's share here: {cuda_kernels.argmax_share(n, s)}")
    return out


def check_segment_argmax(seed: int) -> dict:
    """K9's dense entry against per_segment_argmax_plain on the card,
    exactly (max with ==, so -0.0 equals +0.0), at the conflict-resolution
    widths (n = 2048 and 4096 into 200 and 4096 segments; one block), at
    R = 60,000 into 800 and at R = 600,000 into 10,400 (the intra-broker
    candidate pick at 200 and 2,600 brokers x 4 logdirs; the grid path,
    each fold of ARGMAX_FOLDS timed), and at n = 2048 into 20,000 (the
    grid path's global keys) with int64 ids; the key scratch zero after
    every call.  {shape: times}."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import kernels as K
    g = torch.Generator(device="cuda").manual_seed(seed)
    cases = {}
    for n, s, ids in ((2048, 200, torch.int32), (4096, 4096, torch.int32),
                      (60_000, 800, torch.int64),
                      (600_000, 10_400, torch.int32),
                      (2048, 20_000, torch.int64)):
        score, seg, valid = _argmax_inputs(n, s, g)
        seg = seg.to(ids)
        want = K.per_segment_argmax_plain(score, seg, s, valid)

        def check(got, n=n, s=s, want=want):
            torch.cuda.synchronize()
            if not (equal_exact(got[0], want[0])
                    and equal_exact(got[2], want[2])
                    and bool(torch.equal(got[1], want[1]))):
                raise AssertionError(f"segment_argmax n={n} S={s}: differs "
                                     "from the plain version")
        got = cuda_kernels.segment_argmax(score, seg, valid, s)
        check(got)
        if not scratch_is_zero():
            raise AssertionError(f"segment_argmax n={n} S={s}: the key "
                                 "scratch is not zero after the call")
        n_has = int(got[2].sum())
        if not 0 < n_has < s:
            raise AssertionError(f"segment_argmax n={n} S={s}: {n_has} "
                                 "segments with a winner, not between 0 "
                                 "and S")
        t = (graph_time_ms(lambda: cuda_kernels.segment_argmax(
                 score, seg, valid, s)),
             graph_time_ms(lambda: K.per_segment_argmax_plain(
                 score, seg, s, valid)))
        if not scratch_is_zero():
            raise AssertionError("segment_argmax: the key scratch is not "
                                 "zero after the timed replays")
        # each element's score, id and flag in; each segment's id, max and
        # flag out
        nbytes = n * (5 + seg.element_size()) + s * 9
        t_b, _ = bound(nbytes, n)
        log(f"  segment_argmax n={n} S={s} ({str(ids)[6:]} ids): exact match "
            f"({n_has} segments with a winner), scratch zero; device time "
            f"per call: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms; "
            f"bound {t_b:.6f} ms ({nbytes} bytes); library call: none")
        cases[f"n={n} S={s}"] = case = dict(ms=t[0], plain_ms=t[1],
                                            bound_ms=t_b)
        if n > cuda_kernels.ARGMAX_ONE_BLOCK_N:
            case["folds"] = _fold_times(
                lambda: cuda_kernels.segment_argmax(score, seg, valid, s),
                check, "segment_argmax", n, s)
    return cases


def check_segment_keep(seed: int) -> dict:
    """K9's keep entry (resolve_dest_conflicts on the card) against
    resolve_dest_conflicts_plain, exactly: n = 2048 candidates into 200
    brokers and into 20,000 and 200,000 partitions (the partition-keyed
    resolves of the slice and of 2,600 brokers: one block on global keys),
    128 into 200 (the swap shortlist), 4096 into 20,000 (the forced
    round's width) and 41,600 into 2,600 (a
    full-width fallback; the grid path, each fold of ARGMAX_FOLDS timed),
    with ties, -0.0, NEG scores and invalid rows; the key scratch zero
    after every call.  The record of n = 2048 into 20,000 (the
    slice's partition-keyed resolves), every shape under "cases"."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import kernels as K
    g = torch.Generator(device="cuda").manual_seed(seed)
    cases = {}
    for n, s in ((2048, 200), (2048, 20_000), (2048, 200_000), (128, 200),
                 (4096, 20_000), (41_600, 2600)):
        score, seg, valid = _argmax_inputs(n, s, g)
        dest = torch.clamp(seg, 0, s - 1).long()
        want = K.resolve_dest_conflicts_plain(dest, score, valid, s)

        def check(got, n=n, s=s, want=want):
            torch.cuda.synchronize()
            if not equal_exact(got, want) or not 0 < int(got.sum()) < n:
                raise AssertionError(f"segment_keep n={n} S={s}: differs "
                                     "from the plain version or keeps all "
                                     "or none")
        got = cuda_kernels.segment_keep(score, dest, valid, s)
        check(got)
        if not scratch_is_zero():
            raise AssertionError(f"segment_keep n={n} S={s}: the key "
                                 "scratch is not zero after the call")
        t = (graph_time_ms(lambda: cuda_kernels.segment_keep(
                 score, dest, valid, s)),
             graph_time_ms(lambda: K.resolve_dest_conflicts_plain(
                 dest, score, valid, s)))
        # each element's score, int64 id and flag in, its keep flag out
        nbytes = n * (4 + 8 + 1 + 1)
        t_b, by = bound(nbytes, n)
        log(f"  segment_keep n={n} S={s}: exact match ({int(got.sum())} "
            f"kept), scratch zero; device time per call: kernel "
            f"{t[0]:.4f} ms, plain {t[1]:.4f} ms; bound "
            f"{t_b:.6f} ms ({nbytes} bytes); library call: none")
        cases[f"n={n} S={s}"] = case = dict(
            max_abs_err=0.0, ms=t[0], plain_ms=t[1], bound_ms=t_b,
            bound_by=by, library_ms=None, shape=f"keep n={n} S={s}")
        if n > cuda_kernels.ARGMAX_ONE_BLOCK_N:
            case["folds"] = _fold_times(
                lambda: cuda_kernels.segment_keep(score, dest, valid, s),
                check, "segment_keep", n, s)
    return dict(cases["n=2048 S=20000"], cases=cases)


#: K10's pair cases
SWAP_CASES = ("no band", "band", "lower band", "upper band", "refuse all")


def _swap_case(state, pr, g, case: str, from_util: bool) -> dict:
    """K10's inputs on the card: picks on every broker (some missing), a
    quarter of the in-picks pairwise replicas of one partition and a few
    out-picks replicas of the in-picks' partitions (conflicts on a
    partition), quantized weights and deviations (tied improvements,
    conflicts on a cold broker) with -0.0 and +0.0 among the deviations,
    given or as util - target with util -0.0 or +0.0 against a target of
    0; the band or the acceptance plane of `case` (refuse all: all
    False)."""
    import torch
    nb, num_r = state.num_brokers, state.num_replicas

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")
    out_r = torch.randint(0, num_r, (nb,), generator=g, device="cuda",
                          dtype=torch.int32)
    in_r = torch.randint(0, num_r, (nb,), generator=g, device="cuda",
                         dtype=torch.int32)
    sib = pr[torch.randint(0, pr.shape[0], (nb // 8 + 1,), generator=g,
                           device="cuda")]
    for j in range(nb // 8):
        in_r[8 * j] = sib[j, 0]
        in_r[8 * j + 4] = sib[j, 1]
        out_r[8 * j + 2] = sib[j, 2]
    out_r[rand(nb) < 0.05] = -1
    in_r[rand(nb) < 0.05] = -1
    w = torch.round(rand(num_r) * 8.0)
    dev = torch.round(rand(nb) * 16.0) - 8.0
    zero = dev == 0
    dev = torch.where(zero & (rand(nb) < 0.5), torch.full_like(dev, -0.0),
                      dev)
    util = rand(nb) * 50.0
    target = None
    if from_util:
        util = torch.where(zero, dev, util)
        target = torch.where(zero, torch.zeros_like(util), util - dev)
    out_has, in_has = out_r >= 0, in_r >= 0
    hot, cold = rand(nb) < 0.6, rand(nb) < 0.6
    band = case in ("band", "lower band", "upper band")
    return dict(hot=hot, cold=cold, out_r=out_r, in_r=in_r,
                out_has=out_has, in_has=in_has,
                dev_u=None if from_util else dev, util=util, target=target,
                w=w, lower=(util - 20.0) if case in ("band", "lower band")
                else None,
                upper=(util + 20.0) if case in ("band", "upper band")
                else None, refuse=case == "refuse all", band=band)


def _shortlist_args(x: dict, h: int) -> tuple:
    return (x["hot"], x["cold"], x["out_r"], x["in_r"], x["out_has"],
            x["in_has"], x["dev_u"], x["util"], x["target"], h)


def _pair_args(x: dict, state, pr, lists, accept) -> tuple:
    h_ids, c_ids, _, _, dev = lists
    return (h_ids, c_ids, x["out_r"], x["in_r"], x["out_has"], x["in_has"],
            x["hot"], x["cold"], x["w"], dev, x["util"], x["lower"],
            x["upper"], accept, state.replica_partition, pr,
            state.replica_broker)


def parent_swap_chain(pk, x: dict, state, pr, accept, h: int):
    """The parent's swap round after its picks at these inputs: the
    deviations, the two stable top-k shortlists and their gathers and
    casts, its K10 launch (the old pair plane), the three K9 keep
    launches with their gathers and the two [B] scatters (the acceptance
    plane given, as the acceptance ops are outside both)."""
    import torch
    from cruise_control_tpu_torch import ops
    from cruise_control_tpu_torch.analyzer import kernels as K
    nb = state.num_brokers
    inf = torch.full((), float("inf"), device="cuda")
    out_r, in_r = x["out_r"], x["in_r"]
    dev_u = x["dev_u"] if x["dev_u"] is not None else x["util"] - x["target"]
    out_safe = torch.clamp_min(out_r, 0).long()
    in_safe = torch.clamp_min(in_r, 0).long()
    hot_rank = torch.where(x["hot"] & x["out_has"], dev_u, -inf)
    cold_rank = torch.where(x["cold"] & x["in_has"], -dev_u, -inf)
    _, h_ids = ops.topk_stable(hot_rank, h)
    _, c_ids = ops.topk_stable(cold_rank, h)
    out_h = out_safe[h_ids]
    _ = in_safe[c_ids]

    def f32(t):
        return None if t is None else t.to(torch.float32).contiguous()
    sel_h, cold_slot = pk.swap_pair(
        h_ids.to(torch.int32).contiguous(), c_ids.to(torch.int32).contiguous(),
        out_r.contiguous(), in_r.contiguous(), x["out_has"], x["in_has"],
        x["hot"], x["cold"], f32(x["w"]), f32(dev_u), f32(x["util"]),
        f32(x["lower"]), f32(x["upper"]), accept.contiguous(),
        state.replica_partition, pr, state.replica_broker)
    valid_h = sel_h > K.NEG / 2
    cold_h = c_ids[cold_slot.long()]

    def keep(dest, valid, n):
        return pk.segment_keep(sel_h.contiguous(), K._int_ids(dest),
                               valid.contiguous(), n)
    valid_h = keep(cold_h, valid_h, nb)
    p_out = state.replica_partition[out_h]
    p_in = state.replica_partition[torch.clamp_min(in_r[cold_h], 0).long()]
    valid_h = keep(p_out, valid_h, state.num_partitions)
    valid_h = keep(p_in, valid_h, state.num_partitions)
    cold = torch.zeros((nb,), dtype=torch.int32, device="cuda")
    cold[h_ids] = cold_h.to(torch.int32)
    valid = torch.zeros((nb,), dtype=torch.bool, device="cuda")
    valid[h_ids] = valid_h
    return cold, valid


def check_swap(spec: dict, seed: int, pk=None) -> dict:
    """K10's two entries against their plain versions on the cluster
    `spec`, exactly: the shortlists with the deviations given and as util
    - target (signed zeros in both), the pair entry in each of SWAP_CASES
    (tied improvements, conflicts on a cold broker and on a partition);
    then device times of a round's two launches beside the plain
    versions, the bound, torch.topk of the hot ranks (the shortlist's
    library yardstick) and, with --parent, the parent's chain."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.analyzer import kernels as K
    from cruise_control_tpu_torch.testing.random_cluster import (
        RandomClusterSpec, random_cluster)
    state, _ = random_cluster(RandomClusterSpec(**spec))
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb = state.num_brokers
    pr = ctx.partition_replicas
    h = min(K.SWAP_SHORTLIST, nb)
    n_valid = {}
    for from_util in (False, True):
        for case in SWAP_CASES:
            x = _swap_case(state, pr, g, case, from_util)
            what = (f"B={nb} H={h} {case} "
                    f"{'util - target' if from_util else 'dev_u given'}")
            got = cuda_kernels.swap_shortlist(*_shortlist_args(x, h))
            want = K.swap_shortlist_plain(*_shortlist_args(x, h))
            for a, b, name in zip(got, want, ("h_ids", "c_ids", "out_h",
                                             "in_c", "dev")):
                if not (a.dtype == b.dtype and equal_exact(a, b)):
                    raise AssertionError(f"swap_pair shortlist {what}: "
                                         f"{name} differs")
            accept = torch.rand((h, h), generator=g, device="cuda") < (
                0.0 if x["refuse"] else 0.8)
            got2 = cuda_kernels.swap_pair(*_pair_args(x, state, pr, want,
                                                      accept))
            want2 = K.swap_pair_plain(*_pair_args(x, state, pr, want,
                                                  accept))
            for a, b, name in zip(got2, want2, ("cold", "valid")):
                if not (a.dtype == b.dtype and equal_exact(a, b)):
                    raise AssertionError(f"swap_pair {what}: {name} "
                                         "differs")
            nv = int(want2[1].sum())
            if (nv == 0) != x["refuse"]:
                raise AssertionError(f"swap_pair {what}: {nv} swaps")
            n_valid[what] = nv
    log(f"  swap_pair B={nb} H={h}: exact match, both entries; swaps kept "
        f"{n_valid}")
    x = _swap_case(state, pr, g, "no band", False)
    lists = cuda_kernels.swap_shortlist(*_shortlist_args(x, h))
    accept = torch.rand((h, h), generator=g, device="cuda") < 0.8
    pargs = _pair_args(x, state, pr, lists, accept)
    t_a = graph_time_ms(lambda: cuda_kernels.swap_shortlist(
        *_shortlist_args(x, h)))
    t_b = graph_time_ms(lambda: cuda_kernels.swap_pair(*pargs))
    p_a = graph_time_ms(lambda: K.swap_shortlist_plain(
        *_shortlist_args(x, h)))
    p_b = graph_time_ms(lambda: K.swap_pair_plain(*pargs))
    inf = torch.full((), float("inf"), device="cuda")
    hot_rank = torch.where(x["hot"] & x["out_has"], x["dev_u"], -inf)
    lib = graph_time_ms(lambda: torch.topk(hot_rank, h))
    t_parent = _parent_ms(pk, lambda: parent_swap_chain(pk, x, state, pr,
                                                        accept, h))
    rf = pr.shape[1]
    # K10a: per broker its four flags and its deviation, the two picks at
    # the shortlisted brokers, four [H] outputs; K10b (no band): the
    # acceptance plane, per row and column a broker id, its pick, two
    # flags, the pick's weight, the deviation and utilization, the
    # replica's partition and its RF sibling ids and brokers, and the two
    # [B] outputs (the resolutions' scratch is the kernel's own)
    bytes_a = nb * (4 + 4) + 2 * h * 4 + 4 * h * 8
    bytes_b = (h * h + 2 * h * (8 + 4 + 2 + 4 + 4 + 4 + 4 + 8 * rf)
               + nb * 5)
    tb_a, _ = bound(bytes_a, 0)
    tb_b, by = bound(bytes_b, h * h * 16)
    log(f"  swap_pair B={nb} H={h} (no band): device time per call: "
        f"shortlist {t_a:.4f} ms (plain {p_a:.4f}), pair {t_b:.4f} ms "
        f"(plain {p_b:.4f}), a round's two {t_a + t_b:.4f} ms; the "
        f"parent's chain {_ms(t_parent)}; bound {tb_a:.6f} + {tb_b:.6f} ms "
        f"(bytes); library yardstick of the shortlist alone: torch.topk of "
        f"the hot ranks {lib:.4f} ms")
    return dict(max_abs_err=0.0, ms=t_a + t_b, plain_ms=p_a + p_b,
                bound_ms=tb_a + tb_b, bound_by=by, library_ms=lib,
                shortlist_ms=t_a, pair_ms=t_b, parent_ms=t_parent,
                shape=f"B={nb} H=C={h}, a round's two launches")


def check_dest_feasibility(spec: dict, widths, seed: int) -> dict:
    """K11 against its plain versions on the card, exactly.  For each (C,
    K) in `widths` (a shortlist of K brokers, or every broker): the
    preference entry (dest_pref) against dest_pref_plain with candidate
    and destination ids int64 (as the move rounds pass them) and int32,
    with and without the sibling test (on partitions whose sibling rows
    carry -1: rf below the widest), with the fit test and the candidates'
    flags and without, on an acceptance plane [C, K], [C, 1], [1, K] or
    0-d (broadcast, never materialised).  The guard entry (which selects
    its top brokers itself) against dest_has_plain on C candidates and on
    every replica, with tied headrooms, -0.0 and ineligible brokers.  The
    record of the first preference plane, the other widths under "pref"
    and the guard under "guard"."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.analyzer import kernels as K
    from cruise_control_tpu_torch.testing.random_cluster import (
        RandomClusterSpec, random_cluster)
    state, _ = random_cluster(RandomClusterSpec(**spec))
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb, num_r = state.num_brokers, state.num_replicas
    # every third partition loses its last replica: -1 in its sibling row
    pr = ctx.partition_replicas.clone()
    pr[::3, -1] = -1
    rf = pr.shape[1]
    dest_ok = torch.rand(nb, generator=g, device="cuda") < 0.85
    rb, rp = state.replica_broker, state.replica_partition
    w = state.replica_base_load[:, 3].contiguous()
    # quantized headroom: ties, a -0.0
    room = torch.round(torch.rand(nb, generator=g, device="cuda") * 8.0) \
        * float(torch.median(w)) / 4.0
    room[0] = -0.0
    dest_pref_b = torch.round(torch.rand(nb, generator=g, device="cuda")
                              * 16.0) - 8.0
    rec = None
    for c, k in widths:
        cand = torch.randperm(num_r, generator=g, device="cuda")[:c]
        dest_ids = (torch.randperm(nb, generator=g, device="cuda")[:k]
                    if k < nb else torch.arange(nb, device="cuda"))
        ch = torch.rand(c, generator=g, device="cuda") < 0.9
        w_c = w[cand]
        full = torch.rand((c, k), generator=g, device="cuda") < 0.9
        planes = {"[C, K]": full, "[C, 1]": full[:, :1], "[1, K]": full[:1],
                  "0-d": torch.ones((), dtype=torch.bool, device="cuda")}
        for ids in (torch.int64, torch.int32):
            cand_t, dest_t = cand.to(ids), dest_ids.to(ids)
            for rows in (pr, None):
                for label, acc in planes.items():
                    for fit in (True, False):
                        kw = dict(cand_has=ch, w_c=w_c,
                                  dest_headroom=room) if fit else {}
                        got = cuda_kernels.dest_pref(
                            cand_t, dest_t, dest_ok, rb, rp, rows,
                            kw.get("cand_has"), kw.get("w_c"),
                            kw.get("dest_headroom"), acc, dest_pref_b)
                        want = K.dest_pref_plain(
                            state, cand_t, dest_t, dest_ok, dest_pref_b,
                            acc, rows, **kw)
                        torch.cuda.synchronize()
                        if not equal_exact(got, want) or not bool(
                                (want > K.NEG / 2).any()):
                            raise AssertionError(
                                f"dest_pref C={c} K={k} {str(ids)[6:]} ids "
                                f"siblings={rows is not None} accept "
                                f"{label} fit={fit}: differs from the plain "
                                "version or is all NEG")
        pargs = (cand, dest_ids, dest_ok, rb, rp, pr, ch, w_c, room, full,
                 dest_pref_b)
        t = (graph_time_ms(lambda: cuda_kernels.dest_pref(*pargs)),
             graph_time_ms(lambda: K.dest_pref_plain(
                 state, cand, dest_ids, dest_ok, dest_pref_b, full, pr, ch,
                 w_c, room)))
        # the f32 plane out and the acceptance plane in; per candidate its
        # id, broker, partition, RF sibling ids and brokers, flag and
        # weight; per destination its id, flag, headroom and preference
        nbytes = 4 * c * k + c * k + c * (8 + 4 + 4 + 8 * rf + 1 + 4) \
            + k * 17
        t_b, by = bound(nbytes, c * k * (rf + 4))
        log(f"  dest_pref C={c} K={k}: exact match (int64 and int32 ids; "
            f"with and without the sibling test; accept [C, K], [C, 1], "
            f"[1, K], 0-d; with and without the fit test); device time per "
            f"call: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms; "
            f"bound {t_b:.6f} ms ({by}); library call: none")
        case = dict(max_abs_err=0.0, ms=t[0], plain_ms=t[1], bound_ms=t_b,
                    bound_by=by, library_ms=None, shape=f"pref C={c} K={k}")
        if rec is None:
            rec = dict(case)
        rec.setdefault("pref", {})[f"C={c} K={k}"] = case
    for c in (widths[0][0], None):
        cand = (None if c is None else
                torch.randperm(num_r, generator=g, device="cuda")[:c])
        w_c = w if cand is None else w[cand].contiguous()
        n = w_c.shape[0]
        # with no eligible broker every candidate has no destination
        for ok in (torch.zeros_like(dest_ok), dest_ok):
            args = (cand, w_c, ok, room, rb, rp, pr)
            got = cuda_kernels.dest_has(*args)
            want = K.dest_has_plain(*args)
            torch.cuda.synchronize()
            if not equal_exact(got, want):
                raise AssertionError(f"dest_feasibility guard C={n}: "
                                     "differs from the plain version")
        if not 0 < int(got.sum()) < n:
            raise AssertionError(f"dest_feasibility guard C={n}: uniform")
        t = (graph_time_ms(lambda: cuda_kernels.dest_has(*args)),
             graph_time_ms(lambda: K.dest_has_plain(*args)))
        nt = min(rf + 2, nb)
        nbytes = n * (8 + 4 + 4 + 8 * rf + 1) + nb * 5
        t_b, _ = bound(nbytes, n * rf * nt)
        log(f"  dest_feasibility guard C={n} (top {nt} of {nb} brokers "
            f"selected in the launch): exact match ({int(got.sum())} with a "
            f"destination; also with no eligible broker); device time per "
            f"call: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms; "
            f"bound {t_b:.6f} ms")
        rec.setdefault("guard", {})[n] = dict(ms=t[0], plain_ms=t[1],
                                              bound_ms=t_b)
    return rec


def bits_equal(a, b) -> bool:
    """Bit for bit: floats compared through their int32 views (so -0.0
    differs from +0.0)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
    return bool(torch.equal(a, b))


def _signed_values(shape, g):
    """Magnitudes spread over many binades, both signs, with +0.0 and
    -0.0 sprinkled in (so the order of the adds shows in the rounding)."""
    import torch
    dev = "cuda"
    x = torch.exp(torch.randn(shape, generator=g, device=dev) * 3.0)
    x = torch.where(torch.rand(shape, generator=g, device=dev) < 0.3, -x, x)
    x = torch.where(torch.rand(shape, generator=g, device=dev) < 0.02,
                    torch.full((), 0.0, device=dev), x)
    return torch.where(torch.rand(shape, generator=g, device=dev) < 0.02,
                       torch.full((), -0.0, device=dev), x)


#: K12's phase-2 cases: (label, rows, row width (None: 1-d), segments,
#: id pattern); the first is the record
SEGMENT_SUM_CASES = (
    ("broker_load", 60_000, 4, 200, "random"),
    ("disk_load", 60_000, None, 800, "random"),
    ("broker_load north", 600_000, 4, 2600, "random"),
    ("disk_load north", 600_000, None, 10_400, "random"),
    ("logdirs into brokers", 800, None, 200, "random"),
    ("dropped ids", 60_000, 4, 200, "dropped"),
    ("signed zeros", 60_000, 4, 200, "zeros"),
    ("one segment of 60,000", 60_000, 4, 8, "one"),
    ("one segment of 600,000", 600_000, None, 8, "one"),
    ("stage lengths", 58_980, 4, 140, "stages"),
    ("stage lengths, 1-d", 58_980, None, 140, "stages"),
    ("n = SEGMENT_MAX", 60_000, 4, 57_344, "random"),
    ("all ids dropped", 60_000, 4, 200, "all dropped"),
    ("N = 0", 0, 4, 200, "random"),
)
#: segment lengths of the "stages" pattern, in turn: one below, at and one
#: above K12's walk stage (128 rows of 4 floats, 512 of one) and several
#: stages; 140 segments take 20 turns, 58,980 entries
STAGE_LENGTHS = (127, 128, 129, 511, 512, 513, 1029)
#: dependent float32 adds: cycles from one to the next on the card's SMs
FADD_LATENCY_CYCLES = 4
#: K12's two walks, forced by the wrapper's threshold (average entries a
#: segment): a thread per (segment, column) or a warp per segment
SEGMENT_WALKS = {"lane": 2 ** 31, "warp": 0}
#: the main path's K12 shapes (label, N, width, n) and four between them:
#: average segment lengths from 4 to 300
SEGMENT_WALK_SHAPES = (
    ("broker_load", 60_000, 4, 200), ("disk_load", 60_000, None, 800),
    ("broker_load north", 600_000, 4, 2600),
    ("disk_load north", 600_000, None, 10_400),
    ("logdirs into brokers", 800, None, 200),
    ("[60,000] into 2,600", 60_000, None, 2600),
    ("[60,000] into 5,000", 60_000, None, 5000),
    ("[60,000] into 7,500", 60_000, None, 7500),
    ("[60,000, 4] into 2,600", 60_000, 4, 2600))


def _segment_case(num, width, n, pattern, g):
    import torch
    dev = "cuda"
    shape = (num,) if width is None else (num, width)
    x = _signed_values(shape, g)
    # the last tenth of the segments stays empty
    ids = torch.randint(0, max(1, n - n // 10), (num,), generator=g,
                        device=dev, dtype=torch.int32)
    bad = torch.tensor([-1, -7, n, n + 3, 2 ** 30], device=dev,
                       dtype=torch.int32)
    if pattern == "dropped":
        pick = torch.rand(num, generator=g, device=dev) < 0.05
        ids = torch.where(pick, bad[torch.randint(0, 5, (num,), generator=g,
                                                  device=dev)], ids)
    elif pattern == "all dropped":
        ids = bad[torch.randint(0, 5, (num,), generator=g, device=dev)]
    elif pattern == "zeros":
        x = torch.where(torch.rand(shape, generator=g, device=dev) < 0.5,
                        torch.full((), -0.0, device=dev), x)
    elif pattern == "one":
        ids = torch.full((num,), n // 2, device=dev, dtype=torch.int32)
    elif pattern == "stages":
        lengths = torch.tensor([STAGE_LENGTHS[s % len(STAGE_LENGTHS)]
                                for s in range(n)], device=dev)
        assert int(lengths.sum()) == num, "stage lengths must sum to N"
        runs = torch.repeat_interleave(
            torch.arange(n, device=dev, dtype=torch.int32), lengths)
        ids = runs[torch.randperm(num, generator=g, device=dev)]
    return x, ids


def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0]) * 1e6


def host_us(fn, calls: int = 200) -> float:
    """Host time per call (µs): `calls` calls of a wrapper (its checks, its
    allocations and the launch) in a loop that ends in one synchronize;
    where the device takes longer than the host, its time."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def launches_per_call(fn, names, calls: int = 10) -> float:
    """Device kernels per call of `fn` whose names hold one of `names`,
    by torch.profiler.  A first kernel and a pause open the trace, so that
    the profiler's start-up does not drop the calls' own records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and any(k in e.key for k in names)) / calls


#: the launch counts of phase 2's K12 and K13 cases, taken after all of its
#: timings: a torch.profiler session slows the small kernels timed after it
_DEFERRED_COUNTS: list = []


def defer_launch_count(case: dict, label: str, fn, names, calls: int = 10):
    """Count `fn`'s launches into case["launches_per_call"] later, by
    take_launch_counts."""
    _DEFERRED_COUNTS.append((case, label, fn, names, calls))


def take_launch_counts() -> None:
    """The launch counts that phase 2's checks deferred."""
    for case, label, fn, names, calls in _DEFERRED_COUNTS:
        case["launches_per_call"] = launches_per_call(fn, names, calls)
        log(f"  {label}: {case['launches_per_call']:g} kernel launches a "
            "call")
    _DEFERRED_COUNTS.clear()


def check_segment_sum(seed: int) -> dict:
    """K12 against ops.segment_sum_plain on the card, bit for bit, at the
    slice's and the 2,600-broker shapes (broker_load's [R, 4] into B,
    disk_load's [R] into D, the logdirs' [D] into B), with dropped and
    negative ids, signed zeros, empty segments, one segment holding every
    entry, segment lengths around the walk's stage size, n = SEGMENT_MAX,
    every id dropped and N = 0; with `init` (int32 and int64 ids) against
    ops.scatter_add_seq_plain.  Device time per call beside the plain
    version (host-synced: it reads its width), `index_add_` (atomics, no
    fixed order), the bytes bound, the chain bound (the longest segment's
    dependent adds at the card's highest SM clock), the wrapper's host time
    per call and the device launches per call; then both walks at
    SEGMENT_WALK_SHAPES (bit for bit too).  The record of broker_load at
    200 brokers."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels, ops
    g = torch.Generator(device="cuda").manual_seed(seed)
    clock = sm_clock_hz()
    log(f"  SM clock (clocks.max.sm): {clock / 1e6:.0f} MHz; chain bound = "
        f"longest segment x {FADD_LATENCY_CYCLES} cycles")
    rec = None
    for label, num, width, n, pattern in SEGMENT_SUM_CASES:
        x, ids = _segment_case(num, width, n, pattern, g)
        got = cuda_kernels.segment_sum(x, ids, n)
        want = ops.segment_sum_plain(x, ids, n)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            raise AssertionError(f"segment_sum {label}: differs from the "
                                 "plain version")
        # with init (scatter_add_seq), int32 and int64 ids, but for the one
        # segment of 600,000 (the plain version makes a launch per entry)
        with_init = not (pattern == "one" and num > 60_000)
        if with_init:
            init = _signed_values(tuple(want.shape), g)
            spill = torch.where(ids < 0, torch.full_like(ids, n), ids)
            want_i = ops.scatter_add_seq_plain(init, spill, x)
            for idx in (spill, spill.long()):
                got_i = cuda_kernels.segment_sum(x, idx, n, init=init)
                torch.cuda.synchronize()
                if not bits_equal(got_i, want_i):
                    raise AssertionError(
                        f"segment_sum {label} with init ({idx.dtype} ids): "
                        "differs from scatter_add_seq_plain")
        t_k = graph_time_ms(lambda: cuda_kernels.segment_sum(x, ids, n))
        t_p = (cuda_time_ms(lambda: ops.segment_sum_plain(x, ids, n), reps=5)
               if pattern != "one" else None)
        safe = ops._spill_ids(ids, n)
        lib_out = torch.zeros((n + 1,) + tuple(x.shape[1:]), device="cuda")
        t_l = graph_time_ms(lambda: lib_out.index_add_(0, safe, x))
        h_us = host_us(lambda: cuda_kernels.segment_sum(x, ids, n),
                       calls=20 if pattern == "one" else 200)
        # x and its ids in, the sums out
        nbytes = x.numel() * 4 + num * 4 + want.numel() * 4
        t_b, by = bound(nbytes, x.numel())
        longest = int(torch.bincount(safe, minlength=n + 1)[:n].max())
        t_chain = longest * FADD_LATENCY_CYCLES / clock * 1e3
        plain = f"{t_p:.4f} ms" if t_p is not None else "not measured"
        log(f"  segment_sum {label} ([{num}{', ' + str(width) if width else ''}]"
            f" into {n}): bit for bit{', with init too' if with_init else ''};"
            f" device time per call: kernel {t_k:.4f} ms, plain {plain}; bounds: bytes {t_b:.6f} ms ({nbytes} bytes), chain "
            f"{t_chain:.6f} ms (longest segment {longest}); index_add_ "
            f"{t_l:.4f} ms; host {h_us:.1f} us a call")
        case = dict(ms=t_k, plain_ms=t_p, bound_ms=t_b, chain_bound_ms=t_chain,
                    library_ms=t_l, host_us=h_us)
        defer_launch_count(
            case, f"segment_sum {label}",
            lambda x=x, ids=ids, n=n: cuda_kernels.segment_sum(x, ids, n),
            ("segment_sum_kernel",), calls=2 if pattern == "one" else 10)
        if rec is None:
            rec = dict(max_abs_err=0.0, ms=t_k, plain_ms=t_p, bound_ms=t_b,
                       bound_by=by, library_ms=t_l,
                       shape=f"[{num}, {width}] into {n}")
        rec.setdefault("cases", {})[label] = case
    # the wrapper's choice of walk: each walk at the main path's shapes,
    # bit for bit and timed
    walks = {}
    default = cuda_kernels.SEGMENT_WARP_WALK_AVG
    try:
        for label, num, width, n in SEGMENT_WALK_SHAPES:
            x, ids = _segment_case(num, width, n, "random", g)
            want = ops.segment_sum_plain(x, ids, n)
            row = {}
            for name, avg in SEGMENT_WALKS.items():
                cuda_kernels.SEGMENT_WARP_WALK_AVG = avg
                got = cuda_kernels.segment_sum(x, ids, n)
                torch.cuda.synchronize()
                if not bits_equal(got, want):
                    raise AssertionError(f"segment_sum {label}, {name} walk: "
                                         "differs from the plain version")
                row[name] = graph_time_ms(
                    lambda: cuda_kernels.segment_sum(x, ids, n))
            walks[label] = row
            log(f"  segment_sum {label} by walk (bit for bit; {num / n:.1f} "
                f"entries a segment): lane {row['lane']:.4f} ms, warp "
                f"{row['warp']:.4f} ms")
    finally:
        cuda_kernels.SEGMENT_WARP_WALK_AVG = default
    rec["walks"] = walks
    return rec


#: K13's phase-2 shapes: the stats' planes at 200 and 2,600 brokers,
#: cluster_load's [R, 4] at the slice (60,000) and at 2,600 brokers, the
#: window offsets of the second level (1,024 to 32,770 rows) and 1 to 33
#: terms
ORDERED_SUM_SHAPES = ((200, 4), (2600, 4), (2600, 100), (600_000, 4),
                      (200, 17), (2600, 107), (1, 4), (31, 3), (32, 3),
                      (33, 3), (60_000, 4), (1024, 4), (1025, 4),
                      (32_768, 4), (32_769, 4), (32_770, 4), (600_000, 1))


#: K13's two paths, forced by the wrapper's spread threshold (rows)
ORDERED_PATHS = {"column": 2 ** 31, "spread": 1024}
#: the shapes around the wrapper's choice of K13's path
ORDERED_PATH_SHAPES = ((1025, 4), (2600, 4), (2600, 100), (4096, 4),
                       (8192, 4), (16_384, 4), (60_000, 4))


def _ordered_input(n, m, g):
    """Signed values with a -0.0 in the first row, at the start of a
    first-level window and at the start of a second-level window."""
    x = _signed_values((n, m), g)
    x[0] = -0.0
    if n > 32:
        w0 = -(-n // 32)
        lo0 = (w0 * 32 - n) // 2
        x[32 - lo0] = -0.0
        if w0 > 32:
            w1 = -(-w0 // 32)
            lo1 = (w1 * 32 - w0) // 2
            x[(32 - lo1) * 32 - lo0] = -0.0
    return x


def check_ordered_sum(seed: int) -> dict:
    """K13 against ops.sum_f32_plain on the card, bit for bit, at
    ORDERED_SUM_SHAPES.  Device time per call beside the plain version,
    `torch.sum` and the bytes bound, the wrapper's host time per call and the device launches per call; then both of K13's paths at
    the shapes around the wrapper's choice (bit for bit too).  The record
    of [200, 4]."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels, ops
    g = torch.Generator(device="cuda").manual_seed(seed)
    rec = None
    for n, m in ORDERED_SUM_SHAPES:
        x = _ordered_input(n, m, g)
        got = cuda_kernels.ordered_sum(x)
        want = ops.sum_f32_plain(x)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            raise AssertionError(f"ordered_sum [{n}, {m}]: differs from the "
                                 "plain version")
        t = (graph_time_ms(lambda: cuda_kernels.ordered_sum(x)),
             graph_time_ms(lambda: ops.sum_f32_plain(x)),
             graph_time_ms(lambda: torch.sum(x, 0)))
        h_us = host_us(lambda: cuda_kernels.ordered_sum(x))
        nbytes = x.numel() * 4 + m * 4
        t_b, by = bound(nbytes, x.numel())
        key = f"[{n}, {m}]"
        log(f"  ordered_sum {key}: bit for bit; device time per call: "
            f"kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms; bound {t_b:.6f} ms ({nbytes} bytes); torch.sum "
            f"{t[2]:.4f} ms; host {h_us:.1f} us a call")
        if rec is None:
            rec = dict(max_abs_err=0.0, ms=t[0], plain_ms=t[1], bound_ms=t_b,
                       bound_by=by, library_ms=t[2], shape=key)
        case = rec.setdefault("cases", {})[key] = dict(
            ms=t[0], plain_ms=t[1], bound_ms=t_b, library_ms=t[2],
            host_us=h_us)
        defer_launch_count(case, f"ordered_sum {key}",
                           lambda x=x: cuda_kernels.ordered_sum(x),
                           ("column_kernel", "spread_kernel"))
    # the wrapper's choice of path: each path that takes the shape, bit for
    # bit and timed
    paths = {}
    default = cuda_kernels.ORDERED_SPREAD_ROWS
    try:
        for n, m in ORDERED_PATH_SHAPES:
            x = _ordered_input(n, m, g)
            want = ops.sum_f32_plain(x)
            row = {}
            for name, rows in ORDERED_PATHS.items():
                cuda_kernels.ORDERED_SPREAD_ROWS = rows
                got = cuda_kernels.ordered_sum(x)
                torch.cuda.synchronize()
                if not bits_equal(got, want):
                    raise AssertionError(f"ordered_sum [{n}, {m}], {name} "
                                         "path: differs from the plain version")
                row[name] = graph_time_ms(lambda: cuda_kernels.ordered_sum(x))
            paths[f"[{n}, {m}]"] = row
            log(f"  ordered_sum [{n}, {m}] by path (bit for bit): column "
                f"{row['column']:.4f} ms, spread {row['spread']:.4f} ms")
    finally:
        cuda_kernels.ORDERED_SPREAD_ROWS = default
    rec["paths"] = paths
    return rec


def _gate_case(num_b: int, k: int, n_terms: int, g):
    """A [B, k] candidate table on quarter steps (sums exact, bounds hit)
    over R = 300 B replicas, with a leading -0.0, its excess and up to
    five terms in the round bodies' forms: columns of the [R, 4] load
    plane against columns of a [B, 4] plane, the count term (weights
    1.0), a plain [R] vector."""
    import torch
    dev = "cuda"
    num_r = 300 * num_b
    n = num_b * k

    def quarters(hi, *shape):
        return torch.randint(0, hi, shape, generator=g,
                             device=dev).float() * 0.25
    has = torch.rand(n, generator=g, device=dev) < 0.85
    w = quarters(9, n)
    w[::k] = -0.0
    cand = torch.randint(0, num_r, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    cand = torch.where(torch.rand(n, generator=g, device=dev) < 0.1,
                       torch.full_like(cand, -1), cand)
    excess = quarters(4 * k + 2, num_b)
    excess[0] = torch.sum(w[:k - 1])            # before == excess
    loads, room = quarters(9, num_r, 4), quarters(3 * k + 2, num_b, 4)
    vec, hr = quarters(5, num_r), quarters(3 * k + 2, num_b)
    terms = [(loads[:, 1], room[:, 2]), (None, hr), (vec, room[:, 0]),
             (loads[:, 3], room[:, 1]), (loads[:, 0], room[:, 3])]
    return (has, w, excess, cand), terms[:n_terms]


def gate_bytes(num_b: int, k: int, n_terms: int) -> int:
    """The bytes one gate must move: the table's flags, weights and ids,
    the excess, each term's k gathered weights a row and its headroom,
    the flags written."""
    return num_b * (k * (1 + 4 + 4) + 4 + n_terms * (k * 4 + 4) + k)


def check_prefix_gate(seed: int) -> dict:
    """K14, the prefix gate, against prefix_gate_plain on the card,
    exactly, at [200, k] and [2,600, k] for k = 4, 8, 16 and T = 0 to 3
    terms, and the pre-balance's k = 8 with T = 5; device
    time per call beside the plain version and one `torch.cumsum` launch
    on the same [B, k] table (the scan alone: no PyTorch call computes the
    gate).  The record of [200, 8] with T = 3."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import kernels as K
    g = torch.Generator(device="cuda").manual_seed(seed)
    rec = None
    for num_b in (200, 2600):
        for k in (8, 4, 16):
            for n_terms in (3, 0, 1, 2) + ((5,) if k == 8 else ()):
                args, terms = _gate_case(num_b, k, n_terms, g)
                got = cuda_kernels.prefix_gate(*args, terms, k)
                want = K.prefix_gate_plain(*args, terms, k)
                torch.cuda.synchronize()
                label = f"[{num_b}, {k}] T={n_terms}"
                if not equal_exact(got, want):
                    raise AssertionError(f"prefix_gate {label}: differs from "
                                         "the plain version")
                table = args[1].reshape(num_b, k)
                t = (graph_time_ms(
                         lambda: cuda_kernels.prefix_gate(*args, terms, k)),
                     graph_time_ms(
                         lambda: K.prefix_gate_plain(*args, terms, k)),
                     graph_time_ms(lambda: torch.cumsum(table, 1)))
                nbytes = gate_bytes(num_b, k, n_terms)
                t_b, by = bound(nbytes, 2 * num_b * k * (1 + n_terms))
                log(f"  prefix_gate {label}: exact match, {int(got.sum())} "
                    f"of {got.numel()} kept; device time per call: kernel "
                    f"{t[0]:.4f} ms, plain {t[1]:.4f} ms; bound {t_b:.6f} ms "
                    f"({nbytes} bytes); one torch.cumsum {t[2]:.4f} ms")
                case = dict(ms=t[0], plain_ms=t[1], bound_ms=t_b,
                            cumsum_ms=t[2])
                if rec is None:
                    rec = dict(max_abs_err=0.0, ms=t[0], plain_ms=t[1],
                               bound_ms=t_b, bound_by=by, library_ms=None,
                               shape=f"gate {label}")
                rec.setdefault("cases", {})[label] = case
    return rec


def check_dirty_ops(spec: dict) -> dict:
    """The dirty-region functions, torch ops on the card (no hand
    kernel): `apply_delta` (the incremental path's delta), then
    `set_broker_capacities` (the delta's capacity row) and
    `restrict_context_to_dirty` (its dirty mask), each against the same
    call on the CPU (every output byte for byte) and timed on the card
    (CUDA events around one call, median of 20)."""
    import torch
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.model import state as S
    from cruise_control_tpu_torch.model import store as ST
    from cruise_control_tpu_torch.testing.random_cluster import (
        RandomClusterSpec, random_cluster)
    runs = {}
    for dev in ("cuda", "cpu"):
        st, topo = random_cluster(RandomClusterSpec(**spec), device=dev)
        plan = delta_plan(st, dev)
        new, dirty = ST.apply_delta(st, plan)
        capped = S.set_broker_capacities(st, plan.cap_rows, plan.cap_mask,
                                         plan.cap_values)
        ctx = C.make_context(new, C.BalancingConstraint(),
                             C.OptimizationOptions(), topo)
        rctx = C.restrict_context_to_dirty(new, ctx, dirty)
        runs[dev] = dict(st=st, plan=plan, new=new, dirty=dirty,
                         capped=capped, ctx=ctx, rctx=rctx)
    card, cpu = runs["cuda"], runs["cpu"]
    diff = [f for f in S.STATE_FIELDS
            if not torch.equal(getattr(card["new"], f).cpu(),
                               getattr(cpu["new"], f))]
    diff += [] if torch.equal(card["dirty"].cpu(), cpu["dirty"]) else ["dirty"]
    diff += [] if torch.equal(card["capped"].broker_capacity.cpu(),
                              cpu["capped"].broker_capacity) else ["capacity"]
    diff += [f for f in ("replica_movable", "broker_dest_ok")
             if not torch.equal(getattr(card["rctx"], f).cpu(),
                                getattr(cpu["rctx"], f))]
    if diff:
        raise AssertionError(f"dirty-region ops on the card differ from the "
                             f"CPU: {diff}")
    st, plan = card["st"], card["plan"]

    def nbytes(obj, fields):
        return sum(getattr(obj, f).numel() * getattr(obj, f).element_size()
                   for f in fields)
    # each function's inputs read once and outputs written once
    delta_written = ("broker_new", "broker_demoted", "broker_alive",
                     "replica_offline", "replica_original_offline",
                     "partition_leader_bonus", "replica_base_load",
                     "broker_capacity")
    delta_bytes = (nbytes(st, delta_written + (
        "replica_broker", "replica_valid", "replica_partition",
        "replica_is_leader")) + nbytes(plan, ST.PLAN_FIELDS)
        + nbytes(card["new"], delta_written) + st.num_brokers)
    caps_bytes = (2 * nbytes(st, ("broker_capacity",)) + nbytes(
        plan, ("cap_rows", "cap_mask", "cap_values")))
    ctx_written = ("replica_movable", "broker_dest_ok")
    restrict_bytes = (nbytes(card["new"], (
        "replica_base_load", "replica_is_leader", "replica_partition",
        "partition_leader_bonus", "replica_valid", "replica_broker",
        "broker_capacity", "broker_alive")) + st.num_brokers
        + nbytes(card["ctx"], ctx_written + ("balance_upper_pct",))
        + nbytes(card["rctx"], ctx_written))
    out = {"brokers": st.num_brokers, "replicas": st.num_replicas,
           "dirty brokers": int(cpu["dirty"].sum()),
           "bound ms (bytes)": {
               "apply_delta": bound(delta_bytes, 0)[0],
               "set_broker_capacities": bound(caps_bytes, 0)[0],
               "restrict_context_to_dirty": bound(restrict_bytes, 0)[0]},
           "apply_delta ms": cuda_time_ms(lambda: ST.apply_delta(st, plan)),
           "set_broker_capacities ms": cuda_time_ms(
               lambda: S.set_broker_capacities(st, plan.cap_rows,
                                               plan.cap_mask,
                                               plan.cap_values)),
           "restrict_context_to_dirty ms": cuda_time_ms(
               lambda: C.restrict_context_to_dirty(card["new"], card["ctx"],
                                                   card["dirty"]))}
    log(f"    dirty-region ops, equal to the CPU's: {out}")
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: the solve
# ---------------------------------------------------------------------------

def _request_options(solve: dict, kw, state, topo):
    """The OptimizationOptions of `kw` ("new" standing for the state's new
    brokers), through the options generator when `solve` names a
    pattern."""
    from cruise_control_tpu_torch.analyzer.context import \
        OptimizationOptions
    from cruise_control_tpu_torch.analyzer.options_generator import \
        DefaultOptimizationOptionsGenerator
    kw = dict(kw or {})
    new = frozenset(topo.broker_ids[i] for i in
                    state.broker_new.nonzero().flatten().tolist())
    kw = {k: (new if v == "new" else v) for k, v in kw.items()}
    options = OptimizationOptions(**kw)
    if solve.get("pattern"):
        options = DefaultOptimizationOptionsGenerator(
            solve["pattern"]).generate(options, topo)
    return options


def delta_plan(state, device: str):
    """The incremental path's model delta as a DeltaPlan on `device`:
    broker 2's capacity row raised by half, and 64 partitions (every
    P / 64-th) with their leader's and followers' base loads and their
    leadership bonus raised by a quarter.  Built on the host from the
    state's numbers, so both devices get the same plan."""
    import numpy as np
    from cruise_control_tpu_torch.model import store as ST
    cap = state.broker_capacity.cpu().numpy()
    base = state.replica_base_load.cpu().numpy()
    bonus = state.partition_leader_bonus.cpu().numpy()
    part = state.replica_partition.cpu().numpy()
    lead = state.replica_is_leader.cpu().numpy()
    valid = state.replica_valid.cpu().numpy()
    f = np.float32(1.25)
    loads = {}
    for p in range(0, state.num_partitions, state.num_partitions // 64)[:64]:
        rows = np.nonzero((part == p) & valid)[0]
        lrow = rows[lead[rows]][0] if lead[rows].any() else rows[0]
        frow = next((r for r in rows if not lead[r]), lrow)
        loads[p] = (base[lrow] * f, base[frow] * f, bonus[p] * f)
    arrays = ST.plan_arrays(
        state.num_brokers, state.num_partitions,
        capacities={2: {r: cap[2, r] * np.float32(1.5)
                        for r in range(cap.shape[1])}},
        loads=loads)
    return ST.plan_from_numpy(arrays, device)


#: (device, what) -> a request's preparation, computed once a run: the
#: rack-aware placement of a spec, and the cold default-stack result of a
#: spec (the incremental path's seed; a plain default-stack solve of the
#: same spec fills it, so the seed is the very solve the stack path ran)
_PREPARED: dict = {}


def _spec_key(solve: dict, *extra) -> tuple:
    return (tuple(sorted(solve["spec"].items())), solve["max_rounds"]) + extra


def _solve(solve: dict, device: str, before=None):
    """Build the cluster of `solve` (see `path`) on `device` and run its
    goals through GoalOptimizer.optimizations: (initial state, topology,
    result, solve seconds).  A request's preparation (the rack-aware
    solve, or the incremental path's cold solve and delta) runs first and
    is not timed; `before()` is called just before the timed solve.  The
    result carries the request's options and dirty mask (for the
    gates) and, on the incremental path, the cold solve's result, time
    and the delta's dirty mask."""
    import torch
    from cruise_control_tpu_torch.analyzer.goals.registry import \
        default_goals
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.model import state as S
    from cruise_control_tpu_torch.model import store as ST
    from cruise_control_tpu_torch.testing.random_cluster import (
        RandomClusterSpec, random_cluster)
    state, topo = random_cluster(RandomClusterSpec(**solve["spec"]),
                                 device=device)
    for b in solve["kill"]:
        state = S.set_broker_state(state, b, alive=False)
    for b in solve["demote"]:
        state = S.set_broker_state(state, b, demoted=True)
    for d in solve["broken"]:
        state = S.mark_disk_dead(state, d)
    goals = default_goals(solve["max_rounds"], solve["goals"])
    call = dict(solve.get("call") or {})
    cold = None
    if solve.get("prep") is not None:
        key = (device, "rack-aware") + _spec_key(
            solve, tuple(sorted(solve["prep"].items())))
        card = _PREPARED.get(("cuda",) + key[1:])
        if key not in _PREPARED and card is not None:
            # the CPU comparison solves the request from the card's
            # rack-aware placement: the same input on both devices
            _PREPARED[key] = card.to(device)
        if key not in _PREPARED:
            _PREPARED[key] = GoalOptimizer(default_goals(
                solve["max_rounds"], ["RackAwareGoal"])).optimizations(
                state, topo, _request_options({}, solve["prep"], state, topo),
                device=device).final_state
        state = _PREPARED[key]
    cold_key = (device, "cold") + _spec_key(solve)
    if solve.get("incremental"):
        if cold_key not in _PREPARED:
            t0 = time.time()
            cold = GoalOptimizer(goals).optimizations(state, topo,
                                                      device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            _PREPARED[cold_key] = (cold, time.time() - t0)
        cold, cold_s = _PREPARED[cold_key]
        state, dirty = ST.apply_delta(state, delta_plan(state, device))
        call.update(warm_start=cold.final_state, dirty_brokers=dirty)
    options = _request_options(solve, solve.get("options"), state, topo)
    opt = GoalOptimizer(goals, **(solve.get("optimizer") or {}))
    if before is not None:
        before()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    result = opt.optimizations(state, topo, options, device=device, **call)
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.time() - t0
    if (solve["goals"] is None and set(solve) == set(path({}, None))
            and not (solve["kill"] or solve["demote"] or solve["broken"])):
        # a plain default-stack solve: the incremental path's cold seed
        _PREPARED.setdefault(cold_key, (result, secs))
    result.request = dict(options=options, dirty=call.get("dirty_brokers"))
    if cold is not None:
        result.request.update(cold=cold, cold_s=cold_s)
    return state, topo, result, secs


@contextlib.contextmanager
def _wrapped(targets, wrap):
    """Replace each module function (module, name) by `wrap(fn, name)` for
    the block, and restore it afterwards.  The port's callers reach these
    functions through the module attribute, so the wrappers see every
    call."""
    saved = []
    for mod, name in targets:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))
        setattr(mod, name, functools.wraps(fn)(wrap(fn, name)))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _arg(fn, name: str, a, kw):
    """The argument `name` of the call fn(*a, **kw), bound by name."""
    import inspect
    bound = inspect.signature(fn).bind(*a, **kw)
    bound.apply_defaults()
    return bound.arguments[name]


#: torch ops that launch no device work: views and allocations
NO_LAUNCH_OPS = ("empty", "empty_strided", "empty_like", "lift_fresh",
                 "detach", "alias")


def torch_op_counter(on_op):
    """A torch dispatch mode that calls on_op(name) for every torch op
    inside it that touches a card tensor, views and allocations
    excepted (the hand kernels' ctypes launches are not torch ops)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if not (func.is_view or name in NO_LAUNCH_OPS):
                flat, _ = tree_flatten((args, kwargs or {}, out))
                if any(isinstance(t, torch.Tensor) and t.is_cuda
                       for t in flat):
                    on_op(name)
            return out
    return Counter()


def assign_torch_ops(fn_solve):
    """(fn_solve(), counts): the torch ops inside assign_destinations --
    its calls, the multi-commit ones among them, the torch ops inside all
    of them, and inside the multi-commit ones those between the first K2
    launch and the last K8 launch of a call (the passes, which should
    launch K2 and K8 alone) and after the last (the final fold)."""
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import kernels as K
    counts = {"calls": 0, "multi-commit calls": 0, "torch ops": 0,
              "torch ops in multi-commit passes": 0,
              "torch ops after the last pass": 0}
    # per call: multi-commit, K2 seen, ops since the last K8
    call = {"multi": False, "started": False, "pending": 0}

    def on_op(name):
        counts["torch ops"] += 1
        call["pending"] += call["multi"] and call["started"]

    def assign(fn, name):
        def run(*a, **kw):
            multi = _arg(fn, "dest_terms", a, kw) is not None
            counts["calls"] += 1
            counts["multi-commit calls"] += multi
            call.update(multi=multi, started=False, pending=0)
            try:
                with torch_op_counter(on_op):
                    return fn(*a, **kw)
            finally:
                counts["torch ops after the last pass"] += call["pending"]
                call.update(multi=False, started=False, pending=0)
        return run

    def k2(fn, name):
        def run(*a, **kw):
            call["started"] = True
            return fn(*a, **kw)
        return run

    def k8(fn, name):
        def run(*a, **kw):
            out = fn(*a, **kw)
            counts["torch ops in multi-commit passes"] += call["pending"]
            call["pending"] = 0
            return out
        return run
    with _wrapped([(K, "assign_destinations")], assign), \
            _wrapped([(cuda_kernels, "assign_pass")], k2), \
            _wrapped([(cuda_kernels, "rank_accept")], k8):
        return fn_solve(), counts


def leadership_torch_ops(fn_solve):
    """(fn_solve(), counts): leadership_round's follower assignments (each
    from its leader_tail to the next or to the round's end) -- their
    number, the K4 launches and the K8 and K9 launches inside them, the
    torch ops between an assignment's first K4 and its last K8 or K9 (the
    pass loop, which should launch K4, K8 and K9 alone) and after it up to
    the next assignment or the round's end (the final fold and the round's
    own ops), and the torch ops inside leadership_round in all."""
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import kernels as K
    counts = {"assignments": 0, "K4 launches": 0, "K8 launches": 0,
              "K9 launches": 0, "torch ops in leadership_round": 0,
              "torch ops in the passes": 0,
              "torch ops after the last pass": 0}
    st = {"on": False, "pending": 0, "depth": 0}

    def on_op(name):
        counts["torch ops in leadership_round"] += 1
        st["pending"] += st["on"]

    def close():
        if st["on"]:
            counts["torch ops after the last pass"] += st["pending"]
        st.update(on=False, pending=0)

    def round_(fn, name):
        def run(*a, **kw):
            st["depth"] += 1
            try:
                with torch_op_counter(on_op):
                    return fn(*a, **kw)
            finally:
                close()
                st["depth"] -= 1
        return run

    def tail(fn, name):
        def run(*a, **kw):
            close()
            counts["assignments"] += 1
            return fn(*a, **kw)
        return run

    def launch(key):
        def wrap(fn, name):
            def run(*a, **kw):
                if st["depth"]:
                    if key == "K4 launches" and not st["on"]:
                        st.update(on=True, pending=0)
                    if st["on"]:
                        counts[key] += 1
                        counts["torch ops in the passes"] += st["pending"]
                        st["pending"] = 0
                return fn(*a, **kw)
            return run
        return wrap
    with _wrapped([(K, "leadership_round")], round_), \
            _wrapped([(K, "leader_tail")], tail), \
            _wrapped([(cuda_kernels, "leader_assign_pass")],
                     launch("K4 launches")), \
            _wrapped([(cuda_kernels, "rank_accept")], launch("K8 launches")), \
            _wrapped([(cuda_kernels, "segment_keep")],
                     launch("K9 launches")):
        return fn_solve(), counts


def check_leadership_counts(counts: dict) -> None:
    """Raise unless the leadership passes ran: K4 launches, and each
    assignment's first K4 through its last K8 / K9 with no torch op
    between."""
    if not counts["K4 launches"] or counts["torch ops in the passes"]:
        raise AssertionError(f"the leadership passes are not K4 with K8 or "
                             f"K9 alone: {counts}")


#: the functions around K9's and K11's launches whose torch ops phase 3
#: counts
K9_K11_CALLERS = ("resolve_dest_conflicts", "cand_has_dest",
                  "feasible_dest_exists", "assign_pref")


def k9_k11_counts(fn_solve):
    """(fn_solve(), counts): for resolve_dest_conflicts, cand_has_dest,
    feasible_dest_exists and assign_pref, their calls, the torch ops
    inside them (the acceptance stack's own ops inside assign_pref among
    them) and K9's, K11's and K11's preference-entry launches inside
    them."""
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import kernels as K
    launched = {"K9 launches": "segment_argmax",
                "K11 launches": "dest_feasibility",
                "dest_pref launches": "dest_pref"}
    counts = {n: dict({"calls": 0, "torch ops": 0},
                      **{k: 0 for k in launched}) for n in K9_K11_CALLERS}

    def wrap(fn, name):
        c = counts[name]

        def on_op(op):
            c["torch ops"] += 1

        def call(*a, **kw):
            c["calls"] += 1
            before = {k: cuda_kernels.LAUNCHES[v] for k, v in launched.items()}
            try:
                with torch_op_counter(on_op):
                    return fn(*a, **kw)
            finally:
                for k, v in launched.items():
                    c[k] += cuda_kernels.LAUNCHES[v] - before[k]
        return call
    with _wrapped([(K, n) for n in K9_K11_CALLERS], wrap):
        return fn_solve(), counts


def sweep_swap_torch_ops(fn_solve):
    """(fn_solve(), counts): each sweep round from the return of its
    bounds() to the call of its acceptance callback, and each swap round
    from its last pick (a K1 or K9 launch) to its return outside its
    acceptance callback: the rounds, the torch ops there, and the K6 and
    K10 launches there."""
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import kernels as K
    from cruise_control_tpu_torch.analyzer import leadership as L
    from cruise_control_tpu_torch.analyzer.goals import base as GB
    counts = {"sweep rounds": 0, "K6 launches": 0,
              "torch ops between bounds and the acceptance": 0,
              "swap rounds": 0, "K10 shortlist launches": 0,
              "K10 pair launches": 0, "torch ops after the picks": 0,
              "acceptance ops": 0}
    st = {"armed": False, "pending": 0, "k6": 0, "swap": 0,
          "accepting": False}

    def on_op(name):
        if st["armed"]:
            st["pending"] += 1
        if st["swap"]:
            if st["accepting"]:
                counts["acceptance ops"] += 1
            else:
                st["pending"] += 1

    def sweep(fn, name):
        def call(*a, **kw):
            bounds = kw["bounds"]

            def wrapped_bounds(*ba, **bkw):
                st["armed"] = False
                out = bounds(*ba, **bkw)
                st.update(armed=True, pending=0,
                          k6=cuda_kernels.LAUNCHES["sweep_pick"])
                return out
            kw["bounds"] = wrapped_bounds
            try:
                with torch_op_counter(on_op):
                    return fn(*a, **kw)
            finally:
                st["armed"] = False
        return call

    def compose(fn, name):
        def call(*a, **kw):
            accept = fn(*a, **kw)

            def wrapped(*aa, **akw):
                if st["armed"]:
                    counts["sweep rounds"] += 1
                    counts["torch ops between bounds and the acceptance"] += \
                        st["pending"]
                    counts["K6 launches"] += (
                        cuda_kernels.LAUNCHES["sweep_pick"] - st["k6"])
                    st["armed"] = False
                return accept(*aa, **akw)
            return wrapped
        return call

    def swap(fn, name):
        def call(*a, **kw):
            a = list(a)
            accept = a[7] if len(a) > 7 else kw["accept_pair_fn"]

            def wrapped(*aa, **akw):
                st["accepting"] = True
                try:
                    return accept(*aa, **akw)
                finally:
                    st["accepting"] = False
            if len(a) > 7:
                a[7] = wrapped
            else:
                kw["accept_pair_fn"] = wrapped
            counts["swap rounds"] += 1
            st.update(swap=1, pending=0)
            try:
                with torch_op_counter(on_op):
                    return fn(*a, **kw)
            finally:
                counts["torch ops after the picks"] += st["pending"]
                st.update(swap=0, pending=0)
        return call

    def pick(fn, name):
        def call(*a, **kw):
            try:
                return fn(*a, **kw)
            finally:
                if st["swap"]:
                    st["pending"] = 0
        return call

    def k10(key):
        def wrap(fn, name):
            def call(*a, **kw):
                if st["swap"]:
                    counts[key] += 1
                return fn(*a, **kw)
            return call
        return wrap
    with _wrapped([(L, "global_leadership_sweep")], sweep), \
            _wrapped([(GB, "compose_leadership_acceptance")], compose), \
            _wrapped([(K, "swap_round")], swap), \
            _wrapped([(cuda_kernels, "row_topk"),
                      (cuda_kernels, "table_topk"),
                      (cuda_kernels, "segment_argmax")], pick), \
            _wrapped([(cuda_kernels, "swap_shortlist")],
                     k10("K10 shortlist launches")), \
            _wrapped([(cuda_kernels, "swap_pair")],
                     k10("K10 pair launches")):
        return fn_solve(), counts


def check_sweep_swap_counts(counts: dict, label: str) -> None:
    """Raise unless every sweep round's window was one K6 launch with no
    torch op between bounds() and the acceptance callback, and every swap
    round after its picks launched K10's two entries and no torch op
    outside its acceptance callback."""
    bad = (counts["torch ops between bounds and the acceptance"]
           or counts["K6 launches"] != counts["sweep rounds"]
           or counts["torch ops after the picks"]
           or counts["K10 shortlist launches"] != counts["swap rounds"]
           or counts["K10 pair launches"] != counts["swap rounds"])
    log(f"    sweep and swap rounds ({label}, the warm-up solve): {counts}")
    if bad:
        raise AssertionError(f"{label}: a sweep round's window is not one "
                             f"K6 launch, or a swap round after its picks "
                             f"not K10's two launches and its acceptance "
                             f"ops: {counts}")


def check_k9_k11_counts(counts: dict) -> None:
    """Raise unless every resolve_dest_conflicts call was one K9 launch
    and every cand_has_dest / feasible_dest_exists call one K11 launch,
    none with a torch op, and every assign_pref call built its plane in
    one preference-entry launch (beside the acceptance stack's ops)."""
    bad = []
    for name, kernel in (("resolve_dest_conflicts", "K9 launches"),
                         ("cand_has_dest", "K11 launches"),
                         ("feasible_dest_exists", "K11 launches")):
        c = counts[name]
        if c["torch ops"] or c[kernel] != c["calls"]:
            bad.append(name)
    c = counts["assign_pref"]
    if c["dest_pref launches"] != c["calls"] or c["K11 launches"] != c[
            "calls"]:
        bad.append("assign_pref")
    if bad or not counts["resolve_dest_conflicts"]["calls"]:
        raise AssertionError(f"K9 / K11 callers not one launch each: {bad} "
                             f"({counts})")


def _commit_log(solve: dict, device: str) -> list:
    """Run `solve` once and return every cached commit's sorted
    (kind, replica, destination) triples, one list per commit (a host
    copy per commit): destination brokers for moves and swaps, promoted
    replicas for leadership transfers."""
    import torch
    from cruise_control_tpu_torch.analyzer import kernels as K
    commits = []

    def record(kind, replicas, dests, ok):
        pairs = torch.stack([replicas[ok].long(), dests[ok].long()], 1)
        commits.append(sorted((kind, a, b) for a, b in pairs.cpu().tolist()))

    def wrap(fn, name):
        def logged(state, cache, *batch, **kw):
            if name == "commit_moves_cached":
                cand_r, cand_dest, cand_valid = batch
                record("move", cand_r, cand_dest, cand_valid & (cand_r >= 0))
            elif name == "commit_leadership_cached":
                cand_r, cand_dest, cand_valid = batch
                record("lead", cand_r, cand_dest, cand_valid & (cand_r >= 0))
            else:
                record("move", *K._swap_moves(state, *batch))
            return fn(state, cache, *batch, **kw)
        return logged

    from cruise_control_tpu_torch.analyzer import leadership as L

    def wrap_sweep(fn, name):
        def logged(st, cache, sr, dr, valid, **kw):
            record("sweep", sr, dr, valid)
            return fn(st, cache, sr, dr, valid, **kw)
        return logged

    with _wrapped([(K, "commit_moves_cached"), (K, "commit_swaps_cached"),
                   (K, "commit_leadership_cached")], wrap), \
            _wrapped([(L, "update_cache_for_leadership")], wrap_sweep):
        _solve(solve, device)
    return commits


def _sweep_rounds(fn_solve):
    """Run `fn_solve()` and return (its result, the sweep rounds of each
    leadership sweep in call order)."""
    from cruise_control_tpu_torch.analyzer import leadership as L
    counts = []

    def wrap(fn, name):
        def counted(*a, **kw):
            out = fn(*a, **kw)
            counts.append(int(out[1]))
            return out
        return counted

    with _wrapped([(L, "run_sweep_threaded")], wrap):
        return fn_solve(), counts


def pass_region_counts(solve: dict) -> dict:
    """One card solve of `solve` with every torch.sort, ops.scatter_add_seq
    and ops.segment_sum call and every host sync (torch's sync debug
    warnings) counted inside the multi-commit passes -- assign_destinations
    with destination terms, and run_tail from a multi-commit K4 pass to the
    end of its rank_accept_commit -- and elsewhere; every call of a plain
    version of K12-K14 or of arrival_rank (K3 ranks its arrivals itself)
    on a card tensor; the host syncs made inside a float ops.segment_sum,
    scatter_add_seq or sum_f32 call; K3's wrapper calls, the
    tensors cloned (torch clone or empty_like) inside them and the planes
    they return that are not the given cache's own; K14's calls by entry
    (a prefix gate's k and terms); and the torch ops
    inside assign_destinations (`assign_torch_ops`) and around K9 and K11
    (`k9_k11_counts`).  The wrappers bind their arguments by name.
    Raises if a pass sorts, scatters, sums or syncs, if a multi-commit
    pass launches a torch op between its first K2 and its last K8, if a
    plain ordered sum or arrival_rank runs on the card or an ordered sum
    syncs, if K3 never ran, cloned a tensor or
    returned a plane other than the cache's own, if a K9 or K11 caller
    is not one launch (`check_k9_k11_counts`), or if the
    rank_accept_commit calls seen inside the passes are not every K8
    launch with the commit (so that the passes were found)."""
    import torch
    import warnings
    from cruise_control_tpu_torch import cuda_kernels, ops
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.analyzer import kernels as K
    region = {"assign": 0, "tail": False}
    counts = {f"{n} {w}": 0 for n in ("sort", "scatter_add_seq",
                                      "segment_sum", "sync",
                                      "rank_accept_commit")
              for w in ("in passes", "elsewhere")}
    counts["K8 launches with the commit"] = 0
    for name in PLAIN_SUMS + ("arrival_rank",):
        counts[f"{name} on the card"] = 0
    counts["K3 calls"] = 0
    counts["K3 cache-plane copies"] = 0
    counts["K3 planes not the cache's own"] = 0
    in_k3 = [False]
    k14 = counts.setdefault("K14 gates by k and terms", {})
    counts["float ordered sums"] = 0
    counts["syncs inside float ordered sums"] = 0
    in_sum = [0]

    def where():
        return ("in passes" if region["assign"] or region["tail"]
                else "elsewhere")


    def counted(fn, name):
        def call(*a, **kw):
            counts[f"{name} {where()}"] += 1
            return fn(*a, **kw)
        return call

    def ordered(fn, name):
        def call(x, *a, **kw):
            if f"{name} in passes" in counts:
                counts[f"{name} {where()}"] += 1
            floats = x.dtype.is_floating_point
            counts["float ordered sums"] += floats
            in_sum[0] += floats
            try:
                return fn(x, *a, **kw)
            finally:
                in_sum[0] -= floats
        return call

    def plain(fn, name):
        def call(x, *a, **kw):
            counts[f"{name} on the card"] += bool(x.is_cuda)
            return fn(x, *a, **kw)
        return call

    def assign(fn, name):
        def call(*a, **kw):
            multi = _arg(fn, "dest_terms", a, kw) is not None
            region["assign"] += multi
            try:
                return fn(*a, **kw)
            finally:
                region["assign"] -= multi
        return call

    def tail_open(fn, name):
        def call(*a, **kw):
            if _arg(fn, "multi", a, kw):
                region["tail"] = True
            return fn(*a, **kw)
        return call

    def tail_close(fn, name):
        def call(*a, **kw):
            counts[f"rank_accept_commit {where()}"] += 1
            try:
                return fn(*a, **kw)
            finally:
                region["tail"] = False
        return call

    def k8(fn, name):
        def call(*a, **kw):
            counts["K8 launches with the commit"] += bool(
                _arg(fn, "commit", a, kw))
            return fn(*a, **kw)
        return call

    def k3(fn, name):
        def call(*a, **kw):
            counts["K3 calls"] += 1
            cache = _arg(fn, "cache", a, kw)
            own = {f: getattr(cache, f).data_ptr()
                   for f in cuda_kernels.commit_fields(cache)}
            in_k3[0] = True
            try:
                out = fn(*a, **kw)
            finally:
                in_k3[0] = False
            counts["K3 planes not the cache's own"] += sum(
                out[f].data_ptr() != p for f, p in own.items())
            return out
        return call

    def k3_copy(fn, name):
        def call(*a, **kw):
            counts["K3 cache-plane copies"] += in_k3[0]
            return fn(*a, **kw)
        return call

    def k14_gate(fn, name):
        def call(*a, **kw):
            k = (f"gate k={_arg(fn, 'k', a, kw)} "
                 f"T={len(_arg(fn, 'terms', a, kw))}")
            k14[k] = k14.get(k, 0) + 1
            return fn(*a, **kw)
        return call

    def on_warning(message, *a, **kw):
        if "synchroniz" in str(message):
            counts[f"sync {where()}"] += 1
            counts["syncs inside float ordered sums"] += bool(in_sum[0])
    with _wrapped([(torch, "sort")], counted), \
            _wrapped([(ops, "scatter_add_seq"), (ops, "segment_sum"),
                      (ops, "sum_f32")], ordered), \
            _wrapped([(ops, name) for name in PLAIN_SUMS]
                     + [(C, "arrival_rank")], plain), \
            _wrapped([(cuda_kernels, "commit_moves")], k3), \
            _wrapped([(torch.Tensor, "clone"), (torch, "clone"),
                      (torch, "empty_like")], k3_copy), \
            _wrapped([(cuda_kernels, "prefix_gate")], k14_gate), \
            _wrapped([(K, "assign_destinations")], assign), \
            _wrapped([(K, "leader_assign_pass")], tail_open), \
            _wrapped([(K, "rank_accept_commit")], tail_close), \
            _wrapped([(cuda_kernels, "rank_accept")], k8), \
            warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ((_, k9_k11), lead), torch_ops = assign_torch_ops(
                lambda: leadership_torch_ops(
                    lambda: k9_k11_counts(lambda: _solve(solve, "cuda"))))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counts["torch ops in assign_destinations"] = torch_ops
    counts["K9 and K11 callers"] = k9_k11
    counts["leadership assignments"] = lead
    log(f"    calls inside and outside the multi-commit passes: {counts}")
    check_k9_k11_counts(k9_k11)
    check_leadership_counts(lead)
    if torch_ops["torch ops in multi-commit passes"]:
        raise AssertionError(f"the multi-commit passes launch torch ops "
                             f"between K2 and K8: {torch_ops}")
    bad = {k: v for k, v in counts.items() if k.endswith("in passes")
           and v and not k.startswith("rank_accept_commit")}
    if bad:
        raise AssertionError(f"the multi-commit passes still sort, scatter "
                             f"or sync: {bad}")
    plain_calls = {k: v for k, v in counts.items()
                   if k.endswith("on the card") and v}
    if plain_calls or counts["syncs inside float ordered sums"]:
        raise AssertionError(
            f"the card solve ran a plain ordered sum or arrival_rank "
            f"({plain_calls}) or synced inside an ordered sum "
            f"({counts['syncs inside float ordered sums']} syncs)")
    foreign = counts["K3 planes not the cache's own"]
    if (not counts["K3 calls"] or counts["K3 cache-plane copies"]
            or foreign):
        raise AssertionError(
            f"K3's wrapper ran {counts['K3 calls']} times, cloned "
            f"{counts['K3 cache-plane copies']} tensors and returned "
            f"{foreign} planes other than the cache's own: it must commit "
            "in place")
    if not counts["float ordered sums"]:
        raise AssertionError("the counted solve saw no float ordered sum")
    seen = counts["rank_accept_commit in passes"]
    if not seen or seen != counts["K8 launches with the commit"] or counts[
            "rank_accept_commit elsewhere"]:
        raise AssertionError(
            f"the passes were not all found: {seen} rank_accept_commit "
            f"calls inside them, {counts['rank_accept_commit elsewhere']} "
            f"outside, {counts['K8 launches with the commit']} K8 "
            "launches with the commit")
    return counts


def _report(label: str, result, seconds: float, sweeps=None) -> None:
    log(f"  {label}: solve {seconds:.3f} s")
    log(f"    self-healing: {result.heal_rounds} rounds, "
        f"{result.heal_moves} replicas moved")
    log(f"    rounds {result.rounds_by_goal}")
    if sweeps is not None:
        lead_goals = [g for g in result.rounds_by_goal
                      if g.startswith(("NetworkOutbound", "Cpu"))]
        for g, n in zip(lead_goals, sweeps):
            log(f"    {g}: sweep rounds {n}, table rounds "
                f"{result.rounds_by_goal[g] - n}")
    log(f"    converged_at {result.converged_at_by_goal}")
    for g, (b, o, a) in result.violated_broker_counts.items():
        e = result.entry_broker_counts[g]
        log(f"    violated {g}: before {b} -> entry {e} -> own {o} "
            f"-> after {a}")
    log(f"    proposals {len(result.proposals)}, replica moves "
        f"{result.num_replica_movements}, leadership moves "
        f"{result.num_leadership_movements}, balancedness "
        f"{result.balancedness_score():.3f}")


def _gates(state, topo, result) -> None:
    """Sanity, proposal replay (new leaders included), cache equals a
    rebuild (under the request's own context), no goal above its own
    entry violated count."""
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.model.sanity import sanity_check
    from cruise_control_tpu_torch.testing import checks
    sanity_check(result.final_state)
    # includes: no replica on a dead broker or broken disk, no offline
    # replica left
    checks.verify_result(state, result, topo)
    request = getattr(result, "request", {})
    ctx = C.make_context(state, C.BalancingConstraint(),
                         request.get("options") or C.OptimizationOptions(),
                         topo)
    if request.get("dirty") is not None:
        ctx = C.restrict_context_to_dirty(state, ctx, request["dirty"])
    bad = checks.cache_mismatches(result.final_state, ctx,
                                  result.final_cache)
    if bad:
        raise AssertionError(f"final cache differs from a rebuild: {bad}")
    log("    sanity, no offline replica left, proposal replay (leaders "
        "included) and cache-equals-rebuild: ok")
    for g, (_, own, _) in result.violated_broker_counts.items():
        if own > result.entry_broker_counts[g]:
            raise AssertionError(f"{g} regressed itself: own {own} > entry "
                                 f"{result.entry_broker_counts[g]}")
    log("    no goal self-regression: ok")


@contextlib.contextmanager
def collector_passes():
    """Python's garbage-collector passes inside the block, which pause the
    host: a list of (seconds, generation), one entry as each pass ends."""
    passes, start = [], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            passes.append((time.perf_counter() - start[0],
                           info["generation"]))

    gc.callbacks.append(on_gc)
    try:
        yield passes
    finally:
        gc.callbacks.remove(on_gc)


def _timed_path(solve: dict, kernels, label: str, warm: bool = True):
    """One warm-up (unless `warm` is False) and one timed card solve; the
    launches of the timed solve (counts set to 0 just before it, read just
    after), each of `kernels` > 0, and the garbage-collector passes inside
    it."""
    from cruise_control_tpu_torch import cuda_kernels
    log(f"[t] {label}: starts at {time.time() - T_RUN[0]:.1f} s")
    if warm:
        (_, _, _, warm_s), counts = sweep_swap_torch_ops(
            lambda: _solve(solve, "cuda"))
        log(f"  {label}: warm-up solve {warm_s:.3f} s (its sweep and swap "
            "rounds' torch ops counted)")
        check_sweep_swap_counts(counts, label)
    cuda_kernels.reset_launches()
    with collector_passes() as gc_passes:
        def before():
            # a request's untimed preparation ends here
            cuda_kernels.reset_launches()
            gc_passes.clear()
        (state, topo, result, secs), sweeps = _sweep_rounds(
            lambda: _solve(solve, "cuda", before))
    launches = dict(cuda_kernels.LAUNCHES)
    launches["splits"] = dict(sorted(cuda_kernels.LAUNCH_SPLITS.items()))
    four = solve["goals"] == FOUR_GOALS
    _report(f"{label} on the card", result, secs, sweeps if four else None)
    log(f"    garbage collector in the timed solve: {len(gc_passes)} passes, "
        f"{sum(t for t, _ in gc_passes) * 1e3:.1f} ms; generation 2: "
        f"{sum(1 for _, g in gc_passes if g == 2)} passes, "
        f"{sum(t for t, g in gc_passes if g == 2) * 1e3:.1f} ms")
    log(f"    kernel launches in the timed solve {launches}")
    log(f"    K2 launches {launches['assign_pass']}; K14 launches (prefix "
        f"gates) {launches['cumsum_blocks']}")
    log(f"    K1 launches by source and k, K4 launches by commit mode and "
        f"pass: {launches['splits']}")
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"{label} solve")
    _gates(state, topo, result)
    return state, topo, result, secs, launches


def _stats_differences(a, b) -> list:
    """(stats, field) of every statistic two results do not share bit for
    bit: stats_before, stats_after and each goal's stats."""
    import dataclasses
    if set(a.stats_by_goal) != set(b.stats_by_goal):
        return [("goals", sorted(a.stats_by_goal), sorted(b.stats_by_goal))]
    pairs = [("before", a.stats_before, b.stats_before),
             ("after", a.stats_after, b.stats_after)]
    pairs += [(g, a.stats_by_goal[g], b.stats_by_goal[g])
              for g in a.stats_by_goal]
    return [(which, f.name, getattr(x, f.name).tolist(),
             getattr(y, f.name).tolist())
            for which, x, y in pairs for f in dataclasses.fields(x)
            if not bits_equal(getattr(x, f.name).cpu(),
                              getattr(y, f.name).cpu())]


def _card_equals_cpu(solve: dict, result, label: str) -> None:
    """The same solve on the port's CPU path: its proposals, final leader
    flags, proposals' new leaders and statistics (before, after and each
    goal's, bit for bit) must equal the card's; on a difference in the
    proposals or leaders, both solves rerun with every commit logged and
    the first differing commit is named."""
    import torch
    from cruise_control_tpu_torch.analyzer.optimizer import proposal_set
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    _, _, cpu_result, cpu_s = _solve(solve, "cpu")
    _report(f"{label}, port on the CPU", cpu_result, cpu_s)
    same = (proposal_set(cpu_result) == proposal_set(result)
            and _logdir_moves(cpu_result) == _logdir_moves(result))
    same_leaders = bool(torch.equal(
        cpu_result.final_state.replica_is_leader,
        result.final_state.replica_is_leader.cpu()))
    same_new_leaders = ({(p.partition, p.new_leader)
                         for p in cpu_result.proposals}
                        == {(p.partition, p.new_leader)
                            for p in result.proposals})
    stats_diff = _stats_differences(result, cpu_result)
    log(f"    card and CPU: proposals identical {same}, final leader flags "
        f"identical {same_leaders}, proposals' new leaders identical "
        f"{same_new_leaders}, stats identical bit for bit "
        f"{not stats_diff} ({2 + len(result.stats_by_goal)} sets)")
    if not (same and same_leaders and same_new_leaders):
        card_log = _commit_log(solve, "cuda")
        cpu_log = _commit_log(solve, "cpu")
        first = next((i for i, (a, b) in enumerate(zip(card_log, cpu_log))
                      if a != b), min(len(card_log), len(cpu_log)))
        log(f"    first differing commit: {first} (card {len(card_log)} "
            f"commits, CPU {len(cpu_log)})")
        raise AssertionError(f"the card's {label} solve differs from the "
                             "port's CPU path")
    if stats_diff:
        raise AssertionError(f"the card's {label} stats differ from the "
                             f"port's CPU path (card, CPU): {stats_diff[:8]}")
    return cpu_result


def _logdir_moves(result) -> set:
    """{(partition, old (broker, logdir)s, new (broker, logdir)s)} of a
    result's proposals."""
    return {(p.partition,
             tuple((r.broker_id, r.logdir) for r in p.old_replicas),
             tuple((r.broker_id, r.logdir) for r in p.new_replicas))
            for p in result.proposals}


def _logdir_gate(result, threshold: float = 0.8) -> None:
    """No alive logdir above `threshold` of its capacity, tested as the
    intra-broker capacity goal tests it (load > capacity * threshold)."""
    import torch
    from cruise_control_tpu_torch.model import state as S
    st = result.final_state
    load = S.disk_load(st)
    over = st.disk_alive & (load > st.disk_capacity * threshold)
    fill = load / torch.clamp_min(st.disk_capacity, 1e-9)
    worst = float(torch.max(torch.where(st.disk_alive, fill,
                                        torch.zeros_like(fill))))
    if bool(torch.any(over)):
        raise AssertionError(f"{int(over.sum())} alive logdirs end above "
                             f"{threshold} of their capacity (worst "
                             f"{worst:.6f})")
    log(f"    no alive logdir above {threshold} of its capacity (worst "
        f"{worst:.4f}): ok")


def run_modes(results: dict, north: bool) -> None:
    """The three request modes beside the default stack: demote brokers,
    the kafka-assigner goal order and the intra-broker rebalance (at 200
    brokers twice, without and with broken logdirs).  At 200 brokers a
    warm-up, a timed solve and the CPU comparison each; at 2,600 one
    timed solve each."""
    tag = "north_" if north else ""
    where = "2,600 brokers" if north else "slice"
    cases = ((NORTH_DEMOTE, DEMOTE_KERNELS, "demote", "demote 26 brokers"),
             (NORTH_KAFKA_ASSIGNER, KAFKA_ASSIGNER_KERNELS, "kafka_assigner",
              "kafka-assigner"),
             (NORTH_INTRA, INTRA_KERNELS, "intra", "intra-broker")) if north \
        else ((SLICE_DEMOTE, DEMOTE_KERNELS, "demote",
               "demote brokers 0 and 100"),
              (SLICE_KAFKA_ASSIGNER, KAFKA_ASSIGNER_KERNELS,
               "kafka_assigner", "kafka-assigner"),
              (SLICE_INTRA, INTRA_KERNELS, "intra", "intra-broker"),
              (SLICE_INTRA_BROKEN, INTRA_BROKEN_KERNELS, "intra_broken",
               "intra-broker, 4 broken logdirs"))
    for solve, kernels, key, label in cases:
        log(f"  -- {label} ({where})")
        _, _, result, secs, launches = _timed_path(
            solve, kernels, f"{label} {where}", warm=not north)
        if solve["goals"] == INTRA_GOALS:
            _logdir_gate(result)
        results[f"_{tag}{key}_s"] = secs
        results[f"_launches_{tag}{key}"] = launches
        if not north:
            _card_equals_cpu(solve, result, f"{label} {where}")


def run_slice(results: dict) -> None:
    log("  -- the first slice's path: disk + network-inbound, seed 4")
    *_, secs2, _ = _timed_path(SLICE_TWO, TWO_GOAL_KERNELS, "two-goal slice")
    results["_slice2_s"] = secs2
    log("  -- config 2 as the bench builds it: four goals, seed 4")
    _, _, result, secs, _ = _timed_path(SLICE_FOUR, SWEEP_ONLY_KERNELS,
                                        "config 2 (seed 4)")
    results["_config2_s"] = secs
    _card_equals_cpu(SLICE_FOUR, result, "config 2 (seed 4)")
    log("  -- the second slice's main path: four goals, seed 2 (the sweeps "
        "leave work for the leadership table rounds)")
    _, _, result, secs, launches = _timed_path(
        SLICE_MAIN, FOUR_GOAL_KERNELS, "four-goal main path")
    results["_launches_four"] = launches
    results["_slice_s"] = secs
    _card_equals_cpu(SLICE_MAIN, result, "four-goal main path")
    log("  -- this slice's main path: the whole default stack (15 goals), "
        "seed 4")
    _, _, result, secs, launches = _timed_path(
        SLICE_STACK, STACK_KERNELS, "default stack slice")
    stack_result = result
    for name in STACK_KERNELS + ("swap_pair",):
        results.setdefault(name, {})["launches"] = launches[name]
    results["_launches_stack"] = launches
    results["_stack_s"] = secs
    _card_equals_cpu(SLICE_STACK, result, "default stack slice")
    log("  -- the same solve once more, counting sorts, ordered sums and "
        "host syncs inside the multi-commit passes")
    results["_pass_counts"] = pass_region_counts(SLICE_STACK)
    log("  -- add-broker (bench config 4): 10 empty brokers appended, the "
        "default stack")
    _, _, result, secs, launches = _timed_path(
        SLICE_ADD, STACK_KERNELS, "add-broker slice")
    results["_launches_add"] = launches
    results["_add_s"] = secs
    _card_equals_cpu(SLICE_ADD, result, "add-broker slice")
    log("  -- this slice's main path: config 5 (JBOD, 4 broken logdirs) "
        "healed, then Disk capacity + Disk usage distribution")
    _, _, result, secs, launches = _timed_path(
        SLICE_CONFIG5, CONFIG5_KERNELS, "config 5 slice")
    results["forced_select"] = dict(results.get("forced_select", {}),
                                    launches=launches["forced_select"])
    results["_launches_config5"] = launches
    results["_config5_s"] = secs
    _card_equals_cpu(SLICE_CONFIG5, result, "config 5 slice")
    log("  -- remove-broker: brokers 0 and 100 killed, the six hard goals")
    _, _, result, secs, launches = _timed_path(
        SLICE_HARD, HARD_KERNELS, "six hard goals slice")
    results["_launches_hard"] = launches
    results["_hard_s"] = secs
    _card_equals_cpu(SLICE_HARD, result, "six hard goals slice")
    run_modes(results, north=False)
    run_requests(results, north=False, stack_result=stack_result)
    run_served(results, north=False)
    run_executed(results, north=False)
    run_sampled(results, north=False)
    run_scenarios(results, north=False)
    run_scheduled(results, north=False)
    results["_identical"] = True


def _moves(state, result):
    """(moved bool[R], brokers before, brokers after) as numpy arrays."""
    before = state.replica_broker.cpu().numpy()
    after = result.final_state.replica_broker.cpu().numpy()
    return ((before != after) & state.replica_valid.cpu().numpy(), before,
            after)


def add_request_gate(state, result) -> int:
    """Every new broker holds replicas after the add-broker request;
    returns (and prints) the replicas that end on an old broker other
    than their own (a swap's reverse leg: a swap round holds only its
    cold side to the requested destinations, in the reference too)."""
    import numpy as np
    moved, _, after = _moves(state, result)
    new = state.broker_new.cpu().numpy()
    held = np.bincount(after[state.replica_valid.cpu().numpy()],
                       minlength=new.size)
    if not (held[new] > 0).all():
        raise AssertionError(f"new brokers left empty: "
                             f"{np.nonzero(new & (held == 0))[0].tolist()}")
    old_to_old = int((moved & ~new[after]).sum())
    log(f"    add-broker request: {int(new.sum())} new brokers hold "
        f"{int(held[new].sum())} replicas (fewest {int(held[new].min())}); "
        f"{int(moved.sum())} replicas moved, {old_to_old} of them onto an "
        "old broker (swap reverse legs): ok")
    return old_to_old


def heal_request_gate(state, topo, result) -> dict:
    """The self-healing request's exclusions held: no replica of an
    excluded topic moved, no leadership transfer onto a broker excluded
    from leadership, and a broker excluded from replica moves took no
    more replicas than it gave away (a swap's reverse leg is not held to
    the destination mask, in the reference too)."""
    import numpy as np
    options = result.request["options"]
    moved, before, after = _moves(state, result)
    topic_of_r = (state.partition_topic.cpu().numpy()
                  [state.replica_partition.cpu().numpy()])
    excluded = np.isin(topic_of_r, [topo.topics.index(t)
                                    for t in options.excluded_topics])
    lead0 = state.replica_is_leader.cpu().numpy()
    lead1 = result.final_state.replica_is_leader.cpu().numpy()
    no_lead = list(HEAL_EXCLUDED_LEADERSHIP)
    no_move = list(HEAL_EXCLUDED_MOVES)
    transfers = lead1 & ~lead0 & ~moved & np.isin(after, no_lead)
    arrivals = np.bincount(after[moved], minlength=state.num_brokers)
    departures = np.bincount(before[moved], minlength=state.num_brokers)
    counts = {
        "excluded topics": sorted(options.excluded_topics),
        "excluded replicas moved": int(moved[excluded].sum()),
        "leadership transfers onto 0 / 100": int(transfers.sum()),
        "leader replicas moved onto 0 / 100":
            int((moved & lead1 & np.isin(after, no_lead)).sum()),
        "arrivals on 50 / 150": arrivals[no_move].tolist(),
        "departures from 50 / 150": departures[no_move].tolist()}
    log(f"    self-healing request: {counts}")
    if (counts["excluded replicas moved"] or transfers.any()
            or (arrivals[no_move] > departures[no_move]).any()
            or len(options.excluded_topics) != 2):
        raise AssertionError(f"the self-healing request's exclusions did "
                             f"not hold: {counts}")
    return counts


def _request_equals_cpu(solve: dict, result, label: str):
    """`_card_equals_cpu`, then the rest of the result: placement (logdirs
    included), rounds, converged-at rounds, per-goal counts and the
    host-skipped goals must equal the CPU path's."""
    import torch
    cpu = _card_equals_cpu(solve, result, label)
    same = {
        "placement": all(torch.equal(getattr(result.final_state, f).cpu(),
                                     getattr(cpu.final_state, f))
                         for f in ("replica_broker", "replica_disk")),
        "rounds": result.rounds_by_goal == cpu.rounds_by_goal,
        "converged-at": (result.converged_at_by_goal
                         == cpu.converged_at_by_goal),
        "violated counts": (result.violated_broker_counts
                            == cpu.violated_broker_counts),
        "entry counts": result.entry_broker_counts == cpu.entry_broker_counts,
        "skipped goals": result.skipped_goals == cpu.skipped_goals}
    log(f"    card and CPU, the rest of the result identical: {same}")
    if not all(same.values()):
        raise AssertionError(f"the card's {label} result differs from the "
                             f"port's CPU path: {same}")
    return cpu


def incremental_gate(result, label: str, secs: float) -> None:
    """No hard goal left violated by the warm, dirty solve; its time
    beside the cold solve's."""
    hard = set(result.hard_goal_names) & set(result.violated_goals_after)
    req = result.request
    log(f"    {label}: cold solve {req['cold_s']:.3f} s "
        f"({len(req['cold'].proposals)} proposals), warm dirty solve "
        f"{secs:.3f} s ({len(result.proposals)} proposals, "
        f"{int(req['dirty'].sum())} dirty brokers, rounds "
        f"{sum(v for k, v in result.rounds_by_goal.items())} against "
        f"{sum(v for k, v in req['cold'].rounds_by_goal.items())} cold)")
    if hard:
        raise AssertionError(f"{label}: hard goals left violated {hard}")


def all_dirty_gate(stack_result) -> None:
    """The reference's pin (tests/test_incremental.py): an all-dirty mask
    solves exactly as the full solve, on the card."""
    import torch
    solve = dict(SLICE_STACK, call=dict(dirty_brokers=torch.ones(
        SLICE_SPEC["num_brokers"], dtype=torch.bool, device="cuda")))
    _, _, result, secs = _solve(solve, "cuda")
    same = all(torch.equal(getattr(result.final_state, f),
                           getattr(stack_result.final_state, f))
               for f in ("replica_broker", "replica_is_leader",
                         "replica_disk"))
    log(f"    all-dirty default-stack solve {secs:.3f} s: placement and "
        f"leaders equal the full solve's {same}")
    if not same:
        raise AssertionError("the all-dirty solve differs from the full "
                             "solve")


def run_requests(results: dict, north: bool, stack_result=None) -> None:
    """The requests as the facade sends them: add-broker, self-healing
    through the options generator, the incremental (warm, dirty) solve and
    fast mode under the fused solver.  At 200 brokers a warm-up, a timed
    solve, the CPU comparison and each request's gate; at 2,600 the
    add-broker and incremental requests, one timed solve each, gates
    only."""
    tag = "north_" if north else ""
    where = "2,600 brokers" if north else "slice"
    cases = ((NORTH_ADD_REQUEST, "add_request",
              "add-broker request (130 new brokers)"),
             (NORTH_INCREMENTAL, "incremental",
              "incremental (warm, dirty) solve")) if north else (
        (SLICE_ADD_REQUEST, "add_request",
         "add-broker request (10 new brokers)"),
        (SLICE_HEAL_REQUEST, "heal_request",
         "self-healing request (options generator)"),
        (SLICE_INCREMENTAL, "incremental", "incremental (warm, dirty) solve"),
        (SLICE_FAST_FUSED, "fast_fused", "fast mode, fused solver"))
    for solve, key, label in cases:
        log(f"  -- {label} ({where})")
        state, topo, result, secs, launches = _timed_path(
            solve, REQUEST_KERNELS[key], f"{label} {where}", warm=not north)
        results[f"_{tag}{key}_s"] = secs
        results[f"_{tag}{key}_proposals"] = len(result.proposals)
        results[f"_launches_{tag}{key}"] = launches
        log(f"    {label} {where}: solve {secs:.3f} s, "
            f"{len(result.proposals)} proposals, skipped goals "
            f"{result.skipped_goals}, data to move {result.data_to_move:.1f} "
            f"({CARD[0]})")
        if key == "add_request":
            results[f"_{tag}add_old_to_old"] = add_request_gate(state, result)
        elif key == "heal_request":
            results["_heal_counts"] = heal_request_gate(state, topo, result)
        elif key == "incremental":
            incremental_gate(result, f"{label} {where}", secs)
            results[f"_{tag}incremental_cold_s"] = result.request["cold_s"]
        if not north:
            _request_equals_cpu(solve, result, f"{label} {where}")
    if not north:
        if stack_result is None:
            stack_result = _solve(SLICE_STACK, "cuda")[2]
        all_dirty_gate(stack_result)


# ---------------------------------------------------------------------------
# served requests: the port's CruiseControl over its LoadMonitor
# ---------------------------------------------------------------------------

#: the kernels every move-solving default-stack request launches (the
#: pre-balance and the move rounds); a heal adds K7
SERVED_STACK_KERNELS = ("row_topk", "assign_pass", "commit_moves",
                        "rank_accept", "cumsum_blocks") + MOVE_KERNELS
SERVED_HEAL_KERNELS = SERVED_STACK_KERNELS + ("forced_select",)


def served_sums(result) -> tuple:
    """The kernels of a solve that may find little to do: the stats'
    ordered sums, and K3 once it moves a replica."""
    return SUM_KERNELS + (("commit_moves",) if result.num_replica_movements
                          else ())
#: partitions the narrow delta reloads (8 x rf 3 brokers plus broker 2:
#: at most 25 dirty), and the wide one (PR 14's 64, about 124 of 200)
SERVED_NARROW_PARTITIONS = 8
SERVED_WIDE_PARTITIONS = 64
SERVED_PATTERN = "topic-[03]"
#: the store's counters after each request of the 200-broker sequence
#: (hits, misses, fallbacks, delta applies): a cold miss, the cache (no
#: consult), a resident hit, two fast-forwards (the second's dirty region
#: too large: a fallback, counted as a miss), then a resident hit a
#: request
SERVED_STORE = {"cold": (0, 1, 0, 0), "cache hit": (0, 1, 0, 0),
                "self-healing options": (1, 1, 0, 0),
                "narrow delta": (2, 1, 0, 1), "wide delta": (3, 2, 1, 2),
                "kafka assigner": (4, 2, 1, 2), "demote": (5, 2, 1, 2),
                "remove": (6, 2, 1, 2)}


@contextlib.contextmanager
def served_meter():
    """Per served request: each optimizer solve (its inputs, result and
    seconds to a synchronized end), each store fast-forward and each
    monitor rebuild (seconds, and the rebuild's split: the builder's
    description loop, its arrays, the move to the device)."""
    import torch
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.model.store import DeviceModelStore
    from cruise_control_tpu_torch.monitor.load_monitor import (
        LoadMonitor, SnapshotLoadMonitor)
    rec = {"solves": [], "advance_s": [], "builds": []}
    real = (GoalOptimizer.optimizations, DeviceModelStore.advance,
            SnapshotLoadMonitor.cluster_model, LoadMonitor.cluster_model)

    def sync(dev):
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def solve(self, state, topology, options=None, **kw):
        t0 = time.perf_counter()
        result = real[0](self, state, topology, options, **kw)
        sync(result.final_state.device)
        rec["solves"].append(dict(
            state=state, topo=topology, options=options,
            dirty=kw.get("dirty_brokers"),
            warm=kw.get("warm_start") is not None, result=result,
            seconds=time.perf_counter() - t0))
        return result

    def advance(self, records, to_generation):
        t0 = time.perf_counter()
        out = real[1](self, records, to_generation)
        if self._state is not None:
            sync(self._state.device)
        rec["advance_s"].append(time.perf_counter() - t0)
        return out

    def builder(fn):
        def build(self, *a, **kw):
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            rec["builds"].append(dict(self.last_build_seconds,
                                      total=time.perf_counter() - t0))
            return out
        return build

    GoalOptimizer.optimizations = solve
    DeviceModelStore.advance = advance
    SnapshotLoadMonitor.cluster_model = builder(real[2])
    LoadMonitor.cluster_model = builder(real[3])
    try:
        yield rec
    finally:
        (GoalOptimizer.optimizations, DeviceModelStore.advance,
         SnapshotLoadMonitor.cluster_model, LoadMonitor.cluster_model) = real


def served_facade(inputs, device: str, **settings):
    """(monitor, facade) on `device` over a cluster's description
    (`served_inputs`: snapshot, leader loads, capacities) in a
    `SnapshotLoadMonitor`: the default stack at 192 rounds, its scheduler
    disabled (each request solves inline on the calling thread), every
    other setting the reference's default unless `settings` names it."""
    from cruise_control_tpu_torch.facade import CruiseControl
    from cruise_control_tpu_torch.monitor.load_monitor import \
        SnapshotLoadMonitor
    monitor = SnapshotLoadMonitor(*inputs, device=device)
    settings.setdefault("scheduler_enabled", False)
    return monitor, CruiseControl(load_monitor=monitor, device=device,
                                  max_optimization_rounds=192, **settings)


def served_delta(inputs, partitions: int, capacity: bool):
    """A model delta on a cluster's description: every (P / n)-th
    partition's leader load x 1.25 (n = `partitions`) and, with
    `capacity`, broker 2's capacity row x 1.5."""
    import numpy as np
    from cruise_control_tpu_torch.monitor.deltas import (ModelDelta,
                                                         PartitionLoadUpdate)
    from cruise_control_tpu_torch.scenario.spec import RESOURCE_NAMES
    snap, loads, capacities = inputs
    parts = snap.partitions[::len(snap.partitions) // partitions][:partitions]
    updates = tuple(PartitionLoadUpdate(
        p.tp.topic, p.tp.partition,
        tuple(float(x) for x in loads[(p.tp.topic, p.tp.partition)]
              * np.float64(1.25))) for p in parts)
    caps = {}
    if capacity:
        row = capacities[2].capacity
        caps = {2: {n: float(row[i]) * 1.5
                    for i, n in enumerate(RESOURCE_NAMES)}}
    return ModelDelta(capacity_overrides=caps, load_updates=updates)


def _frozen(state):
    from cruise_control_tpu_torch.model.state import STATE_FIELDS
    return None if state is None else {
        f: getattr(state, f).clone() for f in STATE_FIELDS}


def _kept(frozen, state) -> bool:
    import torch
    return frozen is None or all(torch.equal(t, getattr(state, f))
                                 for f, t in frozen.items())


def serve(label: str, call, cc, monitor, kernels=(), expect_store=None,
          rebuild_check: bool = False, gates: bool = True) -> dict:
    """One request through the facade: its wall time, the solve's inputs
    and result, its launches (counts set to 0 just before, read just
    after; each of `kernels`, or of `kernels(result)`, > 0), the store's
    counters (against
    `expect_store`: hits, misses, fallbacks, delta applies; never a
    quarantine), the store's resident model and the warm seed unchanged
    by the request, and with `rebuild_check` the resident model equal to
    a rebuild of its generation, bit for bit; then, with `gates`, the
    phase-3 gates on the solve."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    store = cc.model_store
    old_state = store._state
    old_seed = None if cc._warm_seed is None else cc._warm_seed[0]
    frozen, frozen_seed = _frozen(old_state), _frozen(old_seed)
    on_card = cc.device.type == "cuda"
    cuda_kernels.reset_launches()
    with served_meter() as rec:
        t0 = time.perf_counter()
        answer = call()
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    result = getattr(answer, "optimizer_result", answer)
    counts = store.to_json()
    kept = _kept(frozen, old_state) and _kept(frozen_seed, old_seed)
    solve = rec["solves"][-1] if rec["solves"] else None
    dirty = (None if solve is None or solve["dirty"] is None
             else int(solve["dirty"].sum()))
    build = rec["builds"][0] if rec["builds"] else {}
    out = dict(label=label, result=result, solve=solve, wall=wall,
               launches=launches, store=counts, dirty=dirty,
               build=build, advance_s=sum(rec["advance_s"]),
               solve_s=sum(s["seconds"] for s in rec["solves"]),
               solves=len(rec["solves"]), facade=cc,
               resident=(store._state, store._topology))
    where = "card" if on_card else "CPU"
    log(f"    served {label} ({where}): wall {wall:.3f} s; rebuild "
        + (f"{build['total']:.3f} s (builder loop {build['describe']:.3f}, "
           f"arrays {build['arrays']:.3f}, to the device "
           f"{build['to_device']:.4f}, capacity overlay "
           f"{build['overlay']:.4f})" if build else "none")
        + f"; fast-forward {out['advance_s']:.4f} s; solve "
        f"{out['solve_s']:.3f} s ({out['solves']} solves); rounds "
        f"{sum(result.rounds_by_goal.values())}; proposals "
        f"{len(result.proposals)}; dirty brokers "
        f"{'none (full sweep)' if dirty is None else dirty} of "
        f"{result.final_state.num_brokers}; store {counts['hits']} hits, "
        f"{counts['misses']} misses, {counts['fallbacks']} fallbacks, "
        f"{counts['deltaApplies']} deltas applied, last dirty "
        f"{counts['lastDirtyBrokers']}, last fallback "
        f"{counts['lastFallbackReason']!r}")
    if on_card:
        log(f"      launches {launches}")
    if counts["quarantines"]:
        raise AssertionError(f"served {label}: the store quarantined "
                             f"({counts['lastFallbackReason']})")
    got = (counts["hits"], counts["misses"], counts["fallbacks"],
           counts["deltaApplies"])
    if expect_store is not None and got != tuple(expect_store):
        raise AssertionError(f"served {label}: store counters (hits, "
                             f"misses, fallbacks, delta applies) {got}, "
                             f"expected {tuple(expect_store)}")
    if not kept:
        raise AssertionError(f"served {label}: the request changed the "
                             "store's resident model or the warm seed")
    if on_card:
        if callable(kernels):
            kernels = kernels(result)
        missing = [k for k in kernels if launches[k] <= 0]
        if missing:
            raise AssertionError(f"served {label}: kernels {missing} were "
                                 "not launched")
    if rebuild_check:
        t0 = time.perf_counter()
        rebuilt, _ = monitor.cluster_model()
        if not _kept(_frozen(rebuilt), store._state):
            raise AssertionError(f"served {label}: the fast-forwarded "
                                 "resident model differs from a rebuild")
        log(f"      resident model equal to a rebuild bit for bit "
            f"(rebuilt in {time.perf_counter() - t0:.3f} s): ok")
    if gates and solve is not None:
        result.request = dict(options=solve["options"], dirty=solve["dirty"])
        _gates(solve["state"], solve["topo"], result)
    return out


def served_equal(card: dict, cpu: dict) -> None:
    """The card's served request equals the CPU facade's: proposals
    (logdirs included), placement, leader flags, rounds, the store's
    counters and the stats (before, after and by goal) bit for bit."""
    import torch
    from cruise_control_tpu_torch.analyzer.optimizer import proposal_set
    a, b = card["result"], cpu["result"]
    same = {
        "proposals": (proposal_set(a) == proposal_set(b)
                      and _logdir_moves(a) == _logdir_moves(b)),
        "placement and leaders": all(
            torch.equal(getattr(a.final_state, f).cpu(),
                        getattr(b.final_state, f).cpu())
            for f in ("replica_broker", "replica_disk",
                      "replica_is_leader")),
        "rounds": a.rounds_by_goal == b.rounds_by_goal,
        "store": card["store"] == cpu["store"],
        "dirty brokers": card["dirty"] == cpu["dirty"],
        "stats": not _stats_differences(a, b)}
    log(f"    served {card['label']}: card and CPU identical {same}")
    if not all(same.values()):
        raise AssertionError(f"served {card['label']}: the card differs "
                             f"from the CPU facade: {same}")


class HealingPatternGenerator:
    """The options generator of the served facades' self-healing
    request: the deployment's excluded-topics pattern (`SERVED_PATTERN`)
    merged into a request triggered by a goal violation, any other
    request's options as they are."""

    def __init__(self) -> None:
        from cruise_control_tpu_torch.analyzer.options_generator import \
            DefaultOptimizationOptionsGenerator
        self._pattern = DefaultOptimizationOptionsGenerator(SERVED_PATTERN)
        self._plain = DefaultOptimizationOptionsGenerator()

    def generate(self, options, topology=None):
        gen = (self._pattern if options.is_triggered_by_goal_violation
               else self._plain)
        return gen.generate(options, topology)


def healing_options(cc):
    """The self-healing request's options: brokers 0 and 100 take no
    leadership, 50 and 150 no replicas."""
    return cc._self_healing_options(
        recently_demoted=HEAL_EXCLUDED_LEADERSHIP,
        recently_removed=HEAL_EXCLUDED_MOVES)


def _served_sequence(device: str, inputs, north: bool, add_start=None,
                     jbod=None) -> list:
    """The requests of the served path on `device`, in order (see
    `run_served`); `inputs` describe the cluster, `add_start` (the
    description and the new broker ids) and `jbod` the add-broker and
    config-5 clusters."""
    from cruise_control_tpu_torch.analyzer.goals.registry import \
        KAFKA_ASSIGNER_GOAL_ORDER
    assert KAFKA_ASSIGNER_GOAL_ORDER == KAFKA_ASSIGNER_GOALS
    monitor, cc = served_facade(inputs, device)
    card = device == "cuda"
    num_b = len(inputs[0].brokers)
    removed = list(range(0, num_b, 100))
    out = [serve("cold", cc.optimizations, cc, monitor,
                 SERVED_STACK_KERNELS, SERVED_STORE["cold"])]
    hit = serve("cache hit", cc.optimizations, cc, monitor, (),
                SERVED_STORE["cache hit"], gates=False)
    if hit["result"] is not out[0]["result"] or hit["solves"] \
            or (card and any(hit["launches"].values())):
        raise AssertionError("the cache hit solved, launched or answered "
                             "another result")
    out.append(hit)
    if not north:
        # the deployment's excluded-topics pattern, for this request
        cc._options_generator = HealingPatternGenerator()
        out.append(serve("self-healing options",
                         lambda: cc.rebalance(options=healing_options(cc)),
                         cc, monitor, SERVED_STACK_KERNELS,
                         SERVED_STORE["self-healing options"]))
    monitor.apply_model_delta(served_delta(
        inputs, SERVED_NARROW_PARTITIONS, capacity=True))
    # at 2,600 brokers no self-healing request came before: one hit less
    narrow = serve("narrow delta", cc.optimizations, cc, monitor,
                   served_sums, (1, 1, 0, 1) if north
                   else SERVED_STORE["narrow delta"], rebuild_check=True)
    if narrow["dirty"] is None or not 0 < narrow["dirty"] <= min(
            25, num_b // 2) or not narrow["solve"]["warm"]:
        raise AssertionError(f"the narrow delta's solve was not warm and "
                             f"restricted to at most 25 brokers "
                             f"(dirty {narrow['dirty']})")
    out.append(narrow)
    if north:
        out.append(serve(f"remove brokers {removed[0]}, {removed[1]}, ..., "
                         f"{removed[-1]}", lambda: cc.remove_brokers(removed),
                         cc, monitor, SERVED_HEAL_KERNELS,
                         (2, 1, 0, 1)))
        return out
    monitor.apply_model_delta(served_delta(
        inputs, SERVED_WIDE_PARTITIONS, capacity=False))
    wide = serve("wide delta", cc.optimizations, cc, monitor,
                 SERVED_STACK_KERNELS, SERVED_STORE["wide delta"],
                 rebuild_check=True)
    if wide["dirty"] is not None or not wide["solve"]["warm"] or \
            not wide["store"]["lastFallbackReason"].startswith(
                "dirty region too large"):
        raise AssertionError("the wide delta's solve was not warm, "
                             "unrestricted and counted as a fallback")
    out.append(wide)
    out.append(serve("kafka assigner",
                     lambda: cc.rebalance(kafka_assigner=True), cc, monitor,
                     served_sums,
                     SERVED_STORE["kafka assigner"]))
    out.append(serve("demote", lambda: cc.demote_brokers([0, 100]), cc,
                     monitor, DEMOTE_KERNELS, SERVED_STORE["demote"]))
    out.append(serve("remove", lambda: cc.remove_brokers([0, 100]), cc,
                     monitor, SERVED_HEAL_KERNELS, SERVED_STORE["remove"]))
    add_inputs, new_ids = add_start
    monitor, cc = served_facade(add_inputs, device)
    out.append(serve(f"add brokers {new_ids[0]}-{new_ids[-1]}",
                     lambda: cc.add_brokers(new_ids), cc, monitor,
                     SERVED_STACK_KERNELS + ("swap_pair",), (0, 1, 0, 0)))
    monitor, cc = served_facade(jbod, device)
    out.append(serve("fix offline replicas (config 5, 4 broken logdirs)",
                     cc.fix_offline_replicas, cc, monitor,
                     SERVED_HEAL_KERNELS, (0, 1, 0, 0)))
    return out


def rack_aware_start(solve: dict, device: str = "cuda"):
    """(state, topology): the cluster of `solve` after its rack-aware
    preparation (RackAwareGoal alone under `solve["prep"]`), the one
    `_solve` computes for the request paths (shared through
    `_PREPARED`)."""
    from cruise_control_tpu_torch.analyzer.goals.registry import \
        default_goals
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.testing.random_cluster import (
        RandomClusterSpec, random_cluster)
    state, topo = random_cluster(RandomClusterSpec(**solve["spec"]),
                                 device=device)
    key = (device, "rack-aware") + _spec_key(
        solve, tuple(sorted(solve["prep"].items())))
    if key not in _PREPARED:
        _PREPARED[key] = GoalOptimizer(default_goals(
            solve["max_rounds"], ["RackAwareGoal"])).optimizations(
            state, topo, _request_options({}, solve["prep"], state, topo),
            device=device).final_state
    return _PREPARED[key], topo


def sim_description(inputs):
    """The description (snapshot, leader loads, capacities) as a
    `SimulatedCluster` built from it reports it: brokers by id, each
    topic's partitions together (topics in order of first appearance)
    and numbered 0, 1, ... in their order, each partition's leader first
    in its replica list (the others in their order).  The same cluster;
    a model built from it is the model of what the simulated cluster
    reports."""
    from cruise_control_tpu_torch.cluster.types import (ClusterSnapshot,
                                                        PartitionInfo,
                                                        TopicPartition)
    snap, loads, capacities = inputs
    by_topic: dict = {}
    for p in snap.partitions:
        by_topic.setdefault(p.tp.topic, []).append(p)
    parts, new_loads = [], {}
    for topic, members in by_topic.items():
        for k, p in enumerate(members):
            tp = TopicPartition(topic, k)
            parts.append(PartitionInfo(
                tp, p.leader, tuple(sorted(p.replicas,
                                           key=lambda b, p=p: b != p.leader)),
                p.in_sync, p.offline_replicas, dict(p.logdir_by_broker)))
            new_loads[(topic, k)] = loads[(p.tp.topic, p.tp.partition)]
    brokers = tuple(sorted(snap.brokers, key=lambda b: b.broker_id))
    return (ClusterSnapshot(snap.generation, brokers, tuple(parts),
                            snap.controller_id), new_loads, capacities)


def describe(cluster_spec):
    """The description (`served_inputs`) of a generated cluster."""
    from cruise_control_tpu_torch.testing.random_cluster import (
        RandomClusterSpec, random_cluster, served_inputs)
    t0 = time.perf_counter()
    out = served_inputs(*random_cluster(RandomClusterSpec(**cluster_spec),
                                        device="cuda"))
    log(f"    described {len(out[0].brokers)} brokers, "
        f"{len(out[0].partitions)} partitions in "
        f"{time.perf_counter() - t0:.3f} s")
    return out


def served_description(north: bool):
    """The served requests' cluster, as a simulated cluster reports it:
    at 200 brokers the self-healing request's rack-aware placement of the
    slice (on the random one an excluded topic's rack violations cannot
    be fixed and that request aborts, in the reference too), at 2,600
    the random placement."""
    from cruise_control_tpu_torch.testing.random_cluster import \
        served_inputs
    if north:
        return sim_description(describe(NORTH_SPEC))
    return sim_description(served_inputs(
        *rack_aware_start(SLICE_HEAL_REQUEST)))


def run_served(results: dict, north: bool) -> None:
    """Requests served through the port's CruiseControl over a
    SnapshotLoadMonitor, fed the description (snapshot, leader loads,
    capacities) of a generated cluster.  At 200 brokers, in one facade over the
    self-healing request's rack-aware placement: `optimizations` cold (a
    store miss, the rebuild, `install`), its cache hit (the same
    result, no solve, no launch), a narrow delta (broker 2's capacity x
    1.5 and 8 partitions' loads x 1.25: a fast-forward and the warm solve
    restricted to at most 25 dirty brokers), a wide one (64 partitions:
    a fast-forward, the warm solve unrestricted, one counted fallback),
    `rebalance` with the self-healing options and the excluded-topics
    pattern, `rebalance(kafka_assigner=True)`, `demote_brokers([0, 100])`
    and `remove_brokers([0, 100])`; then `add_brokers` of the 10 appended
    brokers on the add-broker request's rack-aware placement and
    `fix_offline_replicas()` on config 5's JBOD cluster (4 broken
    logdirs), each in a facade of its own.  Every request against the
    same sequence on the CPU.  At 2,600 brokers: cold, a narrow delta and
    `remove_brokers(0, 100, ..., 2500)`, the card only."""
    import torch
    from cruise_control_tpu_torch.testing.random_cluster import \
        served_inputs
    where = "2,600 brokers" if north else "slice"
    log(f"  -- served requests ({where}): the port's CruiseControl over a "
        "SnapshotLoadMonitor")
    add_start = jbod = None
    inputs = served_description(north)
    if not north:
        prep, topo = rack_aware_start(SLICE_ADD_REQUEST)
        new_ids = [topo.broker_ids[i] for i in
                   prep.broker_new.nonzero().flatten().tolist()]
        add_start = (served_inputs(prep, topo), new_ids)
        jbod = describe(SLICE_CONFIG5["spec"])
    card = _served_sequence("cuda", inputs, north, add_start, jbod)
    key = "north" if north else "slice"
    # the cold request's inputs and result, for run_executed and
    # run_scheduled; the resident model it built (later requests leave
    # that state object as it is), and the self-healing request's answer
    results[f"_served_cold_{key}"] = (inputs, card[0]["result"])
    results[f"_served_resident_{key}"] = card[0]["resident"]
    if not north:
        results["_served_heal_slice"] = (card[2]["result"], card[2]["wall"])
    results[f"_served_{'north' if north else 'slice'}"] = [
        {k: r[k] for k in ("label", "wall", "advance_s", "solve_s", "dirty")}
        | {"rebuild_s": r["build"].get("total"),
           "builder_loop_s": r["build"].get("describe"),
           "to_device_s": r["build"].get("to_device"),
           "rounds": sum(r["result"].rounds_by_goal.values()),
           "proposals": len(r["result"].proposals)} for r in card]
    if north:
        # the facade, its model resident, for the what-if requests
        results["_served_facade_north"] = card[-1]["facade"]
        return
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cpu = _served_sequence("cpu", inputs, north, add_start, jbod)
    for a, b in zip(card, cpu):
        served_equal(a, b)


#: the executor's progress check interval (Cruise Control's
#: execution.progress.check.interval.ms): its default at the slice, a
#: minute at 2,600 brokers (fewer polls for the same work)
EXECUTED_CHECK_INTERVAL_S = {False: 10.0, True: 60.0}
#: the replication throttle each execution sets and clears
EXECUTED_THROTTLE = 50e6
#: the admin calls counted in each execution
EXECUTED_OPS = ("describe_cluster", "list_partition_reassignments",
                "alter_partition_reassignments", "elect_preferred_leaders",
                "alter_replica_log_dirs", "set_replication_throttle",
                "clear_replication_throttle")


def executed_cluster(inputs):
    """(SimulatedCluster on a virtual clock, its snapshot) for a
    description from `sim_description`: each broker with its rack and
    host, each topic one `create_topic` with its replica lists in order,
    each partition's size its leader's disk load (as the JAX package's
    loadgen rig sizes a simulated cluster).  The snapshot must report the
    description's placement."""
    from cruise_control_tpu_torch.cluster.metadata import MetadataClient
    from cruise_control_tpu_torch.cluster.simulated import SimulatedCluster
    from cruise_control_tpu_torch.common.resources import Resource
    snap, loads, _capacities = inputs
    sim = SimulatedCluster()
    for b in snap.brokers:
        sim.add_broker(b.broker_id, rack=b.rack, host=b.host,
                       logdirs=tuple(d.path for d in b.logdirs)
                       or ("/data/d0",))
    by_topic: dict = {}
    for p in snap.partitions:
        by_topic.setdefault(p.tp.topic, []).append(p)
    for topic, members in by_topic.items():
        sim.create_topic(topic, [list(p.replicas) for p in members])
        for p in members:
            sim.set_partition_load(p.tp, size_bytes=float(
                loads[(topic, p.tp.partition)][Resource.DISK]))
    described = MetadataClient(sim).refresh_metadata()
    if [(p.tp, p.leader, p.replicas) for p in described.partitions] != \
            [(p.tp, p.leader, p.replicas) for p in snap.partitions]:
        raise AssertionError("the simulated cluster does not report the "
                             "description's placement")
    return sim, described


def state_placement(state, topo, first_logdir) -> dict:
    """{(topic, partition): (broker set, leader, {broker: logdir})} of a
    state; a replica without a logdir is on its broker's first logdir
    (`first_logdir`), where a simulated cluster puts it."""
    h = {f: getattr(state, f).cpu().numpy().tolist() for f in (
        "replica_valid", "replica_partition", "replica_broker",
        "replica_is_leader", "replica_disk")}
    ids, disks = topo.broker_ids, [n for _, n in topo.disk_names]
    out: dict = {}
    for ok, p, b, lead, d in zip(h["replica_valid"], h["replica_partition"],
                                 h["replica_broker"], h["replica_is_leader"],
                                 h["replica_disk"]):
        if not ok:
            continue
        bid = ids[b]
        brokers, leader, logdirs = out.setdefault(p, (set(), [None], {}))
        brokers.add(bid)
        if lead:
            leader[0] = bid
        logdirs[bid] = disks[d] if d >= 0 else first_logdir[bid]
    parts = topo.partitions
    return {(parts[p].topic, parts[p].partition): (frozenset(b), lead[0], ld)
            for p, (b, lead, ld) in out.items()}


def snapshot_placement(snapshot) -> dict:
    return {(p.tp.topic, p.tp.partition): (frozenset(p.replicas), p.leader,
                                           dict(p.logdir_by_broker))
            for p in snapshot.partitions}


def placement_gate(want: dict, snapshot, label: str,
                   logdirs: bool = True) -> None:
    """Every partition of `want` as the cluster reports it: its replica
    set and leader, and with `logdirs` each replica's logdir."""
    have = snapshot_placement(snapshot)
    cut = (lambda v: v) if logdirs else (lambda v: v[:2])
    bad = [tp for tp in want
           if tp not in have or cut(have[tp]) != cut(want[tp])]
    if bad or len(have) != len(want):
        raise AssertionError(
            f"{label}: {len(bad)} of {len(want)} partitions differ from the "
            f"cluster ({len(have)} there), first "
            f"{[(tp, want[tp], have.get(tp)) for tp in bad[:3]]}")
    log(f"    {label}: every partition's replica set, leader"
        f"{' and logdirs' if logdirs else ''} as the cluster reports it "
        f"({len(want)} partitions): ok")


def _stats_relative(a, b) -> tuple:
    """(largest relative difference, field) between two stats."""
    import dataclasses
    import torch
    worst = (0.0, None)
    for f in dataclasses.fields(a):
        x = getattr(a, f.name).cpu().double()
        y = getattr(b, f.name).cpu().double()
        rel = torch.max(torch.abs(x - y)
                        / torch.clamp(torch.abs(y), min=1e-30)).item()
        if rel > worst[0]:
            worst = (rel, f.name)
    return worst


def run_executed(results: dict, north: bool, device: str = "cuda") -> None:
    """Requests executed through the port's Executor on a
    SimulatedCluster (virtual clock) built from the served cold request's
    description, with a journal and a replication throttle: at 200
    brokers `rebalance(dryrun=False)` (its proposals those of
    `run_served`'s cold request on the card), the monitor refreshed from
    the cluster and `optimizations()` again (a store miss whose rebuilt
    model holds the executed placement), then `remove_brokers([0, 100],
    dryrun=False)` and the recent-broker history in the next
    self-healing options; at 2,600 brokers the cold `rebalance
    (dryrun=False)` with a one-minute progress check and no journal.
    Each execution must complete every task, clear its throttle, settle
    the executor (and end its journal in a `finish` record), and leave
    the cluster in the solve's final placement."""
    import collections
    import dataclasses
    import tempfile
    from cruise_control_tpu_torch.analyzer.optimizer import proposal_set
    from cruise_control_tpu_torch.cluster.metadata import MetadataClient
    from cruise_control_tpu_torch.executor import (ExecutorNotifier,
                                                   ExecutorPhase, TaskType)
    from cruise_control_tpu_torch.facade import CruiseControl
    from cruise_control_tpu_torch.monitor.load_monitor import \
        SnapshotLoadMonitor
    from cruise_control_tpu_torch.utils import persist
    key = "north" if north else "slice"
    inputs, cold = results[f"_served_cold_{key}"]
    log(f"  -- executed requests ({'2,600 brokers' if north else 'slice'}):"
        f" the port's Executor on a SimulatedCluster"
        f"{'' if north else ', journaled'}")
    t0 = time.perf_counter()
    sim, described = executed_cluster(inputs)
    log(f"    simulated cluster of {len(described.brokers)} brokers, "
        f"{len(described.partitions)} partitions built in "
        f"{time.perf_counter() - t0:.3f} s")
    first_logdir = {b.broker_id: b.logdirs[0].path
                    for b in described.brokers}
    monitor = SnapshotLoadMonitor(described, inputs[1], inputs[2],
                                  device=device)
    calls: collections.Counter = collections.Counter()
    for op in EXECUTED_OPS:
        def counted(*a, _real=getattr(sim, op), _op=op, **kw):
            calls[_op] += 1
            return _real(*a, **kw)
        setattr(sim, op, counted)

    def sleep(seconds):
        calls["sleeps"] += 1
        sim.advance(seconds)
    finished: dict = {}

    class Finished(ExecutorNotifier):
        def on_execution_finished(self, uuid, succeeded, message):
            finished[uuid] = (succeeded, message, time.perf_counter())

    summary = []
    with tempfile.TemporaryDirectory(prefix="executor-journal-") as jdir:
        cc = CruiseControl(
            admin=sim, load_monitor=monitor, device=device,
            max_optimization_rounds=192,
            time_fn=lambda: sim.now_ms() / 1000.0, sleep_fn=sleep,
            executor_notifier=Finished(),
            # at 2,600 brokers a journal would fsync each of some 215,000
            # task records: the slice's run carries the journal checks
            executor_journal_dir=None if north else jdir,
            executor_kwargs=dict(
                progress_check_interval_s=EXECUTED_CHECK_INTERVAL_S[north],
                replication_throttle_bytes_per_s=EXECUTED_THROTTLE))

        def execute(label, call, kernels):
            """serve() the request (gates after the execution), await
            the execution, check it and the cluster's placement."""
            box = {}

            def started():
                calls.clear()
                box["answer"] = call()
                box["started"] = time.perf_counter()
                box["virtual"] = sim.now_ms() / 1000.0
                return box["answer"]
            out = serve(f"{label}, dryrun=False", started, cc, monitor,
                        kernels, gates=False)
            answer = box["answer"]
            uuid = answer.execution_uuid
            if uuid is None or not answer.proposals:
                raise AssertionError(f"executed {label}: no execution "
                                     "started")
            if not cc.executor.await_completion(timeout=900.0):
                raise AssertionError(f"executed {label}: the execution "
                                     "did not finish in 900 s")
            ok, message, ended = finished[uuid]
            exec_wall = ended - box["started"]
            virtual = sim.now_ms() / 1000.0 - box["virtual"]
            counted = dict(calls)
            mgr = cc.executor._manager
            tasks = {t.value: dataclasses.asdict(mgr.counts(t))
                     for t in TaskType}
            log(f"    executed {label} on {CARD[0]}: solve "
                f"{out['solve_s']:.3f} s (request wall {out['wall']:.3f} "
                f"s, rebuild "
                f"{out['build'].get('total', 0.0):.3f} s); executor host "
                f"wall {exec_wall:.3f} s for {virtual:.0f} virtual s; "
                f"{counted.get('sleeps', 0)} polls, "
                f"{counted.get('describe_cluster', 0)} describe_cluster "
                f"calls, admin calls "
                f"{dict((k, v) for k, v in counted.items() if k != 'sleeps')}"
                f"; tasks by type {tasks}; {message}")
            done = all(c["completed"] == c["total"] for c in tasks.values())
            if not ok or not done:
                raise AssertionError(f"executed {label}: not every task "
                                     f"completed ({message}; {tasks})")
            if any(b.throttle is not None for b in sim._brokers.values()):
                raise AssertionError(f"executed {label}: a throttle was "
                                     "left on")
            if cc.executor.state.phase != ExecutorPhase.NO_TASK_IN_PROGRESS:
                raise AssertionError(f"executed {label}: the executor is "
                                     f"{cc.executor.state.phase}")
            journaled = ""
            if cc.executor_journal is not None:
                replay = cc.executor_journal.replay()
                segment = sorted(p for p in os.listdir(jdir)
                                 if p.startswith("journal-"))[-1]
                records, torn = persist.read_crc_json(
                    os.path.join(jdir, segment))
                if (not replay.finished or replay.start["uuid"] != uuid
                        or torn or records[-1]["t"] != "finish"
                        or not records[-1]["succeeded"]):
                    raise AssertionError(f"executed {label}: the journal "
                                         f"does not end in its finish "
                                         f"record")
                journaled = (f", journal ended in its finish record "
                             f"({replay.records} records)")
            log(f"    executed {label}: every task completed, throttle "
                f"cleared, executor idle{journaled}: ok")
            result = out["result"]
            placement_gate(state_placement(result.final_state,
                                           out["solve"]["topo"],
                                           first_logdir),
                           sim.describe_cluster(),
                           f"executed {label}")
            result.request = dict(options=out["solve"]["options"],
                                  dirty=out["solve"]["dirty"])
            _gates(out["solve"]["state"], out["solve"]["topo"], result)
            summary.append(dict(
                label=label, solve_s=out["solve_s"], wall=out["wall"],
                rebuild_s=out["build"].get("total"),
                executor_wall_s=exec_wall, virtual_s=virtual,
                polls=counted.get("sleeps", 0),
                describe_cluster=counted.get("describe_cluster", 0),
                admin_calls=counted, tasks=tasks,
                proposals=len(result.proposals),
                launches=out["launches"]))
            return out

        try:
            first = execute("rebalance", lambda: cc.rebalance(dryrun=False),
                            SERVED_STACK_KERNELS)
            same = (proposal_set(first["result"]) == proposal_set(cold)
                    and _logdir_moves(first["result"]) == _logdir_moves(cold))
            log(f"    executed rebalance: proposals equal to the served cold "
                f"request's ({len(cold.proposals)}): {same}")
            if not same:
                raise AssertionError("the executed rebalance's proposals "
                                     "differ from the served cold request's")
            if not north:
                monitor.update_cluster(MetadataClient(sim).refresh_metadata())
                store = cc.model_store
                hits, misses = store.hits, store.misses
                after = serve("after the execution", cc.optimizations, cc,
                              monitor, served_sums)
                if store.misses != misses + 1 or store.hits != hits:
                    raise AssertionError("the request after the execution "
                                         "was not a store miss")
                placement_gate(state_placement(after["solve"]["state"],
                                               after["solve"]["topo"],
                                               first_logdir),
                               sim.describe_cluster(),
                               "the rebuilt model", logdirs=False)
                rel, field = _stats_relative(after["result"].stats_before,
                                             first["result"].stats_after)
                log("    the rebuilt model's stats beside the executed "
                    "solve's stats_after: " + json.dumps({
                        f.name: [getattr(after["result"].stats_before,
                                         f.name).tolist(),
                                 getattr(first["result"].stats_after,
                                         f.name).tolist()]
                        for f in dataclasses.fields(
                            first["result"].stats_after)}))
                log(f"    largest relative difference {rel:.3e} "
                    f"({field})")
                results["_executed_stats_rel"] = (rel, field)
                execute("remove brokers 0, 100",
                        lambda: cc.remove_brokers([0, 100], dryrun=False),
                        SERVED_HEAL_KERNELS)
                removed = cc.executor.recently_removed_brokers()
                options = cc._self_healing_options()
                if removed != {0, 100} or options is None or \
                        options.excluded_brokers_for_replica_move != \
                        frozenset({0, 100}):
                    raise AssertionError(
                        f"recently removed {removed}, next self-healing "
                        f"options {options}")
                log("    recently removed brokers {0, 100}, excluded from "
                    "the next self-healing options' replica moves: ok")
        finally:
            cc.shutdown()
    results[f"_executed_{key}"] = summary


# ---------------------------------------------------------------------------
# sampled requests: the facade built as the reference's is, its own
# LoadMonitor sampling a SimulatedCluster
# ---------------------------------------------------------------------------

#: the sampled monitor's windows: a minute each, one sample a window, one
#: stable window kept; a round a minute, so the default requirements (one
#: valid window) are met by two rounds, the fewest
SAMPLED_MONITOR = dict(num_windows=1, window_ms=60_000,
                       min_samples_per_window=1,
                       sampling_interval_ms=60_000)
SAMPLED_ROUNDS = 2
#: the largest relative difference allowed between a sampled model's
#: broker loads and the simulated cluster's (the windows keep float32)
SAMPLED_LOAD_RTOL = 1e-6


def capacity_file(capacities, path: str) -> None:
    """A description's capacities as a capacity JSON file for
    `BrokerCapacityConfigFileResolver`: one entry a broker (a JBOD
    broker's DISK by logdir), the default entry (broker -1) the first
    broker's."""
    from cruise_control_tpu_torch.common.resources import Resource

    def entry(bid, cap):
        c = cap.capacity
        disk = (dict(cap.disk_capacity_by_logdir)
                if cap.disk_capacity_by_logdir else c[Resource.DISK])
        return {"brokerId": str(bid), "capacity": {
            "DISK": disk, "CPU": c[Resource.CPU], "NW_IN": c[Resource.NW_IN],
            "NW_OUT": c[Resource.NW_OUT]}}
    ids = sorted(capacities)
    with open(path, "w") as f:
        json.dump({"brokerCapacities": [entry(-1, capacities[ids[0]])] + [
            entry(b, capacities[b]) for b in ids]}, f)


def sampled_facade(inputs, device: str, cap_path: str, north: bool):
    """(simulated cluster, facade): a `SimulatedCluster` on a virtual
    clock built from the description (`executed_cluster`), each
    partition's leader load its description's, and the facade built as
    the reference's is: `CruiseControl(sim, SimulatedClusterSampler(sim),
    BrokerCapacityConfigFileResolver(cap_path), monitor_kwargs=...)`,
    started without a sampling thread."""
    from cruise_control_tpu_torch.config.capacity import \
        BrokerCapacityConfigFileResolver
    from cruise_control_tpu_torch.facade import CruiseControl
    from cruise_control_tpu_torch.monitor.sampling.sampler import \
        SimulatedClusterSampler
    t0 = time.perf_counter()
    sim, described = executed_cluster(inputs)
    loads = inputs[1]
    for p in described.partitions:
        cpu, nw_in, nw_out, disk = (
            float(x) for x in loads[(p.tp.topic, p.tp.partition)])
        sim.set_partition_load(p.tp, leader_cpu=cpu, nw_in=nw_in,
                               nw_out=nw_out, size_bytes=disk)
    resolver = BrokerCapacityConfigFileResolver(cap_path)
    for b in described.brokers:
        got = resolver.capacity_for_broker(b.rack, b.host, b.broker_id,
                                           False)
        want = inputs[2][b.broker_id]
        if (got.capacity != want.capacity or got.disk_capacity_by_logdir
                != want.disk_capacity_by_logdir):
            raise AssertionError(f"the capacity file gives broker "
                                 f"{b.broker_id} {got}, not {want}")
    cc = CruiseControl(
        sim, SimulatedClusterSampler(sim), resolver,
        monitor_kwargs=dict(SAMPLED_MONITOR), device=device,
        max_optimization_rounds=192,
        time_fn=lambda: sim.now_ms() / 1000.0, sleep_fn=sim.advance,
        executor_kwargs=dict(
            progress_check_interval_s=EXECUTED_CHECK_INTERVAL_S[north],
            replication_throttle_bytes_per_s=EXECUTED_THROTTLE))
    cc.start_up(do_sampling=False)
    log(f"    simulated cluster of {len(described.brokers)} brokers with "
        f"its loads and the sampled facade ({device}) built in "
        f"{time.perf_counter() - t0:.3f} s")
    return sim, cc


def sampling_rounds(cc, sim, rounds: int) -> list:
    """`rounds` sampling rounds a window apart on the virtual clock; the
    host seconds of each."""
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        cc.load_monitor.task_runner.sample_once()
        out.append(time.perf_counter() - t0)
        sim.advance(SAMPLED_MONITOR["window_ms"] / 1000.0)
    return out


def sampled_loads_gate(state, topo, inputs, snapshot, follower_cpu,
                       label: str) -> float:
    """The model's load of each broker (its replicas' loads summed in
    float64) against the simulated cluster's: each partition's leader
    load (the description's) on its leader, and on every other replica
    its follower load (`follower_cpu` of the leader's, NW_OUT 0), per
    `snapshot`'s placement; to `SAMPLED_LOAD_RTOL` relative.  Returns
    the largest relative difference."""
    import numpy as np
    from cruise_control_tpu_torch.common.resources import (NUM_RESOURCES,
                                                           Resource)
    h = {f: getattr(state, f).cpu().numpy() for f in (
        "replica_valid", "replica_partition", "replica_broker",
        "replica_is_leader", "replica_base_load", "partition_leader_bonus")}
    v = h["replica_valid"]
    bonus = h["partition_leader_bonus"].astype(np.float64)
    load = h["replica_base_load"].astype(np.float64)
    lead = v & h["replica_is_leader"]
    load[lead] += bonus[h["replica_partition"][lead]]
    num_b = len(topo.broker_ids)
    model = np.zeros((num_b, NUM_RESOURCES))
    np.add.at(model, h["replica_broker"][v], load[v])
    want = np.zeros((num_b, NUM_RESOURCES))
    idx = topo.broker_index
    for p in snapshot.partitions:
        x = np.asarray(inputs[1][(p.tp.topic, p.tp.partition)], np.float64)
        f = x.copy()
        f[Resource.NW_OUT] = 0.0
        f[Resource.CPU] = follower_cpu(x[Resource.CPU], x[Resource.NW_IN],
                                       x[Resource.NW_OUT])
        for b in p.replicas:
            want[idx[b]] += x if b == p.leader else f
    rel = np.abs(model - want) / np.maximum(np.abs(want), 1e-30)
    worst = float(rel.max())
    log(f"    {label}: each broker's sampled load against the simulated "
        f"cluster's, largest relative difference {worst:.3e} (limit "
        f"{SAMPLED_LOAD_RTOL:g})")
    if not worst <= SAMPLED_LOAD_RTOL:
        b, r = np.unravel_index(int(rel.argmax()), rel.shape)
        raise AssertionError(f"{label}: broker {topo.broker_ids[b]}'s "
                             f"resource {r} is {model[b, r]!r} in the model, "
                             f"{want[b, r]!r} in the cluster")
    return worst


def _sampled_sequence(device: str, inputs, north: bool,
                      cap_path: str) -> dict:
    """The sampled requests on `device` (see `run_sampled`)."""
    import dataclasses
    from cruise_control_tpu_torch.executor import ExecutorPhase, TaskType
    sim, cc = sampled_facade(inputs, device, cap_path, north)
    monitor = cc.load_monitor
    where = "card" if device == "cuda" else "CPU"
    out = {}
    try:
        out["rounds_s"] = sampling_rounds(cc, sim, SAMPLED_ROUNDS)
        log(f"    {SAMPLED_ROUNDS} sampling rounds ({where}): "
            f"{', '.join(f'{x:.3f}' for x in out['rounds_s'])} s; "
            f"{monitor.partition_aggregator.num_samples()} partition "
            f"samples held, {monitor.num_quarantined_samples} quarantined")
        cold = out["cold"] = serve("sampled cold", cc.optimizations, cc,
                                   monitor, SERVED_STACK_KERNELS,
                                   (0, 1, 0, 0))
        build = cold["build"]
        log(f"      the sampled build: aggregation "
            f"{build['aggregate']:.3f} s of {build['total']:.3f}")
        snapshot = monitor.metadata.refresh_metadata()
        out["load_rel"] = sampled_loads_gate(
            cold["solve"]["state"], cold["solve"]["topo"], inputs, snapshot,
            monitor.follower_cpu_estimator(), f"sampled cold ({where})")
        if north:
            return out
        first_logdir = {b.broker_id: b.logdirs[0].path
                        for b in snapshot.brokers}
        t0 = time.perf_counter()
        op = cc.rebalance(dryrun=False)
        if op.execution_uuid is None or op.optimizer_result is not \
                cold["result"]:
            raise AssertionError("the sampled rebalance did not execute the "
                                 "cached cold proposals")
        if not cc.executor.await_completion(timeout=900.0):
            raise AssertionError("the sampled rebalance did not finish in "
                                 "900 s")
        out["executor_s"] = time.perf_counter() - t0
        mgr = cc.executor._manager
        tasks = {t.value: dataclasses.asdict(mgr.counts(t))
                 for t in TaskType}
        if not all(c["completed"] == c["total"] for c in tasks.values()) \
                or cc.executor.state.phase != \
                ExecutorPhase.NO_TASK_IN_PROGRESS:
            raise AssertionError(f"the sampled rebalance left tasks or the "
                                 f"executor busy: {tasks}")
        placement_gate(state_placement(cold["result"].final_state,
                                       cold["solve"]["topo"], first_logdir),
                       sim.describe_cluster(),
                       f"executed sampled rebalance ({where})")
        log(f"    executed the sampled cold proposals ({where}): "
            f"{len(op.proposals)} proposals, tasks {tasks}, executor "
            f"{out['executor_s']:.3f} s")
        out["rounds_after_s"] = sampling_rounds(cc, sim, SAMPLED_ROUNDS)
        misses = cc.model_store.misses
        after = out["after"] = serve("sampled after the execution",
                                     cc.optimizations, cc, monitor,
                                     served_sums)
        if cc.model_store.misses != misses + 1 or after["solve"] is None:
            raise AssertionError("the sampled request after the execution "
                                 "was not a store miss and a solve")
        placement_gate(state_placement(after["solve"]["state"],
                                       after["solve"]["topo"], first_logdir),
                       sim.describe_cluster(),
                       f"the sampled model after the execution ({where})",
                       logdirs=False)
        out["load_rel_after"] = sampled_loads_gate(
            after["solve"]["state"], after["solve"]["topo"], inputs,
            monitor.metadata.refresh_metadata(),
            monitor.follower_cpu_estimator(),
            f"sampled after the execution ({where})")
    finally:
        cc.shutdown()
    return out


def run_sampled(results: dict, north: bool) -> None:
    """Requests served from metric samples: the facade built as the
    reference's is (`sampled_facade`), over a `SimulatedCluster` of the
    served requests' description with each partition's leader load, its
    capacities read from a capacity JSON file, the fewest sampling rounds
    the default requirements need (two, a window apart) on the virtual
    clock, then `optimizations()` cold: a store miss, the model built
    from the aggregated windows, the default stack at 192 rounds; its
    broker loads equal to the simulated cluster's to 1e-6 relative.  At
    200 brokers then `rebalance(dryrun=False)` (the cached proposals,
    executed), two rounds more and `optimizations()` again, whose model
    holds the executed placement with no refresh by hand; both requests
    equal to the same sequence on a CPU facade (proposals, leader flags,
    rounds, store counters and stats bit for bit).  At 2,600 brokers the
    cold request alone, on the card, with the phase-3 gates."""
    import tempfile
    key = "north" if north else "slice"
    log(f"  -- sampled requests ({'2,600 brokers' if north else 'slice'}): "
        "the facade's own LoadMonitor sampling a SimulatedCluster")
    cold = results.get(f"_served_cold_{key}")
    inputs = cold[0] if cold is not None else served_description(north)
    with tempfile.TemporaryDirectory(prefix="capacity-") as tmp:
        cap_path = os.path.join(tmp, "capacity.json")
        capacity_file(inputs[2], cap_path)
        card = _sampled_sequence("cuda", inputs, north, cap_path)
        cpu = None
        if not north:
            cpu = _sampled_sequence("cpu", inputs, north, cap_path)
    steps = ("cold",) if north else ("cold", "after")
    if cpu is not None:
        for step in steps:
            served_equal(card[step], cpu[step])
    summary = {k: card[k] for k in ("rounds_s", "rounds_after_s",
                                    "executor_s", "load_rel",
                                    "load_rel_after") if k in card}
    for step in steps:
        r = card[step]
        summary[step] = {k: r[k] for k in ("wall", "solve_s")} | {
            "aggregate_s": r["build"].get("aggregate"),
            "rebuild_s": r["build"].get("total"),
            "builder_loop_s": r["build"].get("describe"),
            "arrays_s": r["build"].get("arrays"),
            "to_device_s": r["build"].get("to_device"),
            "rounds": sum(r["result"].rounds_by_goal.values()),
            "proposals": len(r["result"].proposals),
            "launches": r["launches"]}
    if cpu is not None:
        summary["cpu_solve_s"] = {s: cpu[s]["solve_s"] for s in steps}
    results[f"_sampled_{key}"] = summary


#: the scenario phase's what-ifs at the slice, after the base lane: 10
#: hypothetical brokers (ids no broker has) the only destinations, brokers
#: 0 and 100 removed, every disk load x 1.2
SCENARIO_FIRST_NEW_ID = 10_000
SCENARIO_ADDED = 10
#: the ladder's settings in the scenario phase: the breaker probes as
#: soon as it opens, and a retry does not wait
SCENARIO_LADDER = dict(solver_breaker_cooldown_s=0.0,
                       sleep_fn=lambda seconds: None)


def scenario_specs():
    from cruise_control_tpu_torch.scenario.spec import (BrokerAdd,
                                                        ScenarioSpec)
    return [ScenarioSpec(
                name=f"add {SCENARIO_ADDED} brokers",
                add_brokers=tuple(BrokerAdd(SCENARIO_FIRST_NEW_ID + i)
                                  for i in range(SCENARIO_ADDED)),
                only_move_to_added=True),
            ScenarioSpec(name="remove 0, 100", remove_brokers=(0, 100)),
            ScenarioSpec(name="disk x 1.2", load_scale={"disk": 1.2})]


@contextlib.contextmanager
def scenario_meter():
    """Per scenario batch the engine's result, and per lane its goal
    pipeline's seconds (to a synchronized end) and kernel launches, and
    the K13 launches of its movement metrics."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.scenario import engine as E
    rec = {"batches": [], "lanes": []}
    real = (GoalOptimizer._pipeline, E._movement_metrics,
            E.ScenarioEngine.evaluate)

    def pipeline(self, initial, *args, **kwargs):
        before = dict(cuda_kernels.LAUNCHES)
        t0 = time.perf_counter()
        run = real[0](self, initial, *args, **kwargs)
        if initial.device.type == "cuda":
            torch.cuda.synchronize()
        rec["lanes"].append(dict(
            seconds=time.perf_counter() - t0,
            launches={k: cuda_kernels.LAUNCHES[k] - before[k]
                      for k in SOURCES}))
        return run

    def movement(initial, final):
        before = cuda_kernels.LAUNCHES["ordered_sum"]
        out = real[1](initial, final)
        if rec["lanes"]:
            rec["lanes"][-1]["movement_k13"] = (
                cuda_kernels.LAUNCHES["ordered_sum"] - before)
        return out

    def evaluate(self, *args, **kwargs):
        result = real[2](self, *args, **kwargs)
        rec["batches"].append(result)
        return result

    GoalOptimizer._pipeline = pipeline
    E._movement_metrics = movement
    E.ScenarioEngine.evaluate = evaluate
    try:
        yield rec
    finally:
        (GoalOptimizer._pipeline, E._movement_metrics,
         E.ScenarioEngine.evaluate) = real


def scenario_request(label: str, call, cc, kernels=(), rung: str = "FUSED",
                     degraded: bool = False) -> dict:
    """One what-if request through the facade: its wall, the engine's
    batches and each lane's seconds and launches (counts set to 0 just
    before, read just after; each of `kernels` > 0 on the card), each
    outcome served at `rung`, the engine's descents and the request's
    trace (`degraded` or not) as expected."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    on_card = cc.device.type == "cuda"
    descents = cc.scenario_engine.total_descents
    cuda_kernels.reset_launches()
    with scenario_meter() as rec:
        t0 = time.perf_counter()
        answer = call()
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: cuda_kernels.LAUNCHES[k] for k in SOURCES}
    outcomes = [o for b in rec["batches"] for o in b.outcomes]
    where = "card" if on_card else "CPU"
    log(f"    scenarios {label} ({where}): wall {wall:.3f} s; batches "
        + ", ".join(f"{b.batch_sizes} ({b.rung}, solve {b.solve_s:.3f} s)"
                    for b in rec["batches"])
        + "; lanes " + ", ".join(f"{lane['seconds']:.3f}"
                                 for lane in rec["lanes"]) + " s")
    for o in outcomes:
        log(f"      {o.spec.name}: feasible {o.feasible}"
            f"{'' if o.feasible else ' (' + o.reason + ')'}, rung {o.rung}"
            f", rounds {sum(o.rounds_by_goal.values())}, proposals "
            f"{len(o.proposals)}, replica moves {o.num_replica_moves}, "
            f"leadership moves {o.num_leadership_moves}, data to move "
            f"{o.data_to_move:.6g}, balancedness {o.balancedness:.3f}")
    if on_card:
        log(f"      launches {launches}")
        for i, lane in enumerate(rec["lanes"]):
            log(f"      lane {i}: {lane['seconds']:.3f} s, launches "
                f"{lane['launches']}, movement K13 "
                f"{lane.get('movement_k13')}")
        missing = [k for k in kernels if launches[k] <= 0]
        if missing:
            raise AssertionError(f"scenarios {label}: kernels {missing} "
                                 "were not launched")
    wrong = [o.spec.name for o in outcomes if o.rung != rung]
    if wrong:
        raise AssertionError(f"scenarios {label}: {wrong} not served at "
                             f"{rung}")
    trace = cc.last_solve_trace
    if (trace.outcome == "degraded") != degraded:
        raise AssertionError(f"scenarios {label}: trace outcome "
                             f"{trace.outcome}")
    if rung == "FUSED" and cc.scenario_engine.total_descents != descents:
        raise AssertionError(f"scenarios {label}: the engine descended")
    return dict(label=label, answer=answer, wall=wall, launches=launches,
                batches=rec["batches"], lanes=rec["lanes"],
                outcomes=outcomes)


def outcome_differences(a, b) -> dict:
    """What two scenario outcomes do not share: verdicts, instruments,
    movement (data to move bit for bit), proposals (logdirs and new
    leaders included) and the stats, before, after and by goal, bit for
    bit."""
    import numpy as np
    from cruise_control_tpu_torch.analyzer.optimizer import proposal_set
    same = {
        "verdict": (a.feasible, a.reason, a.invalid_input)
        == (b.feasible, b.reason, b.invalid_input),
        "counts": (a.violated_broker_counts, a.entry_broker_counts,
                   a.violated_goals_before, a.violated_goals_after,
                   a.regressed_goals)
        == (b.violated_broker_counts, b.entry_broker_counts,
            b.violated_goals_before, b.violated_goals_after,
            b.regressed_goals),
        "rounds": (a.rounds_by_goal, a.converged_at_by_goal)
        == (b.rounds_by_goal, b.converged_at_by_goal),
        "movement": (a.num_replica_moves, a.num_leadership_moves,
                     np.float32(a.data_to_move).tobytes(), a.balancedness)
        == (b.num_replica_moves, b.num_leadership_moves,
            np.float32(b.data_to_move).tobytes(), b.balancedness),
        "proposals and leaders": (
            proposal_set(a) == proposal_set(b)
            and _logdir_moves(a) == _logdir_moves(b)
            and sorted((str(p.partition), p.new_leader) for p in a.proposals)
            == sorted((str(p.partition), p.new_leader) for p in b.proposals)),
        "stats": not _stats_differences(a, b)}
    return {k: v for k, v in same.items() if not v}


def scenarios_equal(card: dict, cpu: dict) -> None:
    """Every lane of the card's request equals the CPU facade's."""
    pairs = list(zip(card["outcomes"], cpu["outcomes"]))
    if len(card["outcomes"]) != len(cpu["outcomes"]):
        raise AssertionError(f"scenarios {card['label']}: lane counts")
    for a, b in pairs:
        diff = outcome_differences(a, b)
        log(f"    scenarios {card['label']}, {a.spec.name}: card and CPU "
            f"identical (verdict, counts, rounds, movement, proposals and "
            f"leaders, stats bit for bit): {not diff}")
        if diff or a.spec.name != b.spec.name:
            raise AssertionError(f"scenarios {card['label']}, "
                                 f"{a.spec.name}: the card differs from "
                                 f"the CPU facade in {sorted(diff)}")


def winner_equals_single(label: str, candidates: dict, single) -> None:
    """The winning lane's proposals are the single-set request's."""
    from cruise_control_tpu_torch.analyzer.optimizer import proposal_set
    answer = candidates["answer"]
    best = answer.scenario_report["scenarios"][0]["name"]
    same = (proposal_set(answer) == proposal_set(single)
            and _logdir_moves(answer) == _logdir_moves(single))
    log(f"    {label}: winner {best}, {len(answer.proposals)} proposals; "
        f"equal to its single-set request ({len(single.proposals)}): "
        f"{same}")
    if not same:
        raise AssertionError(f"{label}: the winning lane's proposals "
                             "differ from its single-set request")


def _ids(name: str, prefix: str) -> list:
    """The broker ids of a candidate scenario's name ("remove-0-100")."""
    return [int(b) for b in name.removeprefix(prefix).split("-")]


def host_rung_wall(cc, dead, label: str) -> float:
    """The host rung (`host_fallback_solve`) on the facade's model with
    `dead` brokers killed: its wall, every offline replica placed."""
    from cruise_control_tpu_torch.model import state as S
    from cruise_control_tpu_torch.model.cpu_model import host_fallback_solve
    state, topo = cc._model_for_solve()
    for b in dead:
        state = S.set_broker_state(state, topo.broker_index[b], alive=False)
    offline = int(S.self_healing_eligible(state).sum())
    t0 = time.perf_counter()
    result = host_fallback_solve(state, topo)
    wall = time.perf_counter() - t0
    left = int(S.self_healing_eligible(result.final_state).sum())
    log(f"    host rung ({label}, brokers {list(dead)} dead): {wall:.3f} s "
        f"for {offline} offline replicas, {len(result.proposals)} "
        f"proposals, {left} left offline")
    if left or result.rounds_by_goal["__host_fallback__"] != offline:
        raise AssertionError(f"host rung ({label}): {left} replicas left "
                             "offline")
    return wall


def _scenario_slice(device: str, inputs, add_inputs, new_ids,
                    full: bool) -> dict:
    """The scenario requests of the slice on `device`, in order (see
    `run_scenarios`): the batch, which the CPU facade repeats, and with
    `full` the rest."""
    import dataclasses
    from cruise_control_tpu_torch.analyzer.degradation import SolverRung
    from cruise_control_tpu_torch.utils import faults
    card = device == "cuda"
    monitor, cc = served_facade(inputs, device, **SCENARIO_LADDER)
    out = {"batch": scenario_request(
        "base + 3", lambda: cc.evaluate_scenarios(scenario_specs()), cc,
        SERVED_STACK_KERNELS)}
    if not full:
        return out
    out["remove"] = scenario_request(
        "remove [[0, 100], [50, 150]]",
        lambda: cc.remove_brokers([[0, 100], [50, 150]]), cc,
        SERVED_HEAL_KERNELS)
    # the batch's lanes one at a time (each at its own geometry): K
    # single requests
    out["singles"] = [scenario_request(
        f"single {s.name}", lambda s=s: cc.evaluate_scenarios(
            [s], include_base=False), cc) for s in
        [o.spec for o in out["batch"]["outcomes"]]]
    # a deliberate descent: one fault at the batch's dispatch, the lane
    # served by the per-scenario EAGER rung (the eager driver at the
    # spec's own geometry), which must equal its FUSED twin: the single
    # request of the same spec, at the same geometry
    twin = out["singles"][3]["outcomes"][0]
    with faults.injected(faults.FaultPlan().fail_nth("scenario.execute",
                                                     1)):
        out["eager"] = scenario_request(
            "disk x 1.2 after a fault at scenario.execute",
            lambda: cc.evaluate_scenarios([twin.spec], include_base=False),
            cc, rung="EAGER")
    eager = out["eager"]["outcomes"][0]
    # the EAGER rung's outcome carries no per-goal stats and no regressed
    # goals, counts leadership-only moves a proposal and sums the data to
    # move over the proposals (`_outcome_from_result`), where a FUSED
    # lane counts a replica and sums on the device (`_movement_metrics`),
    # as the reference's rungs do (tests/test_torch_scenario.py): the
    # twin's leadership count is taken from its proposals, and its data
    # to move held to 1e-6 relative
    leaders = sum(1 for p in twin.proposals
                  if p.has_leader_action and not p.has_replica_action)
    data_close = (abs(eager.data_to_move - twin.data_to_move)
                  <= 1e-6 * abs(twin.data_to_move))
    diff = outcome_differences(eager, dataclasses.replace(
        twin, stats_by_goal={}, regressed_goals=[],
        num_leadership_moves=leaders, data_to_move=eager.data_to_move))
    log(f"    the EAGER outcome equals its FUSED twin (verdict, counts, "
        f"rounds, movement, proposals and leaders, stats before and after "
        f"bit for bit; leadership moves {eager.num_leadership_moves}, the "
        f"twin's proposals {leaders}, its lane {twin.num_leadership_moves}"
        f"; data to move within 1e-6: {data_close}): {not diff}; engine "
        f"rung {cc.scenario_engine.ladder.rung.name}, descents "
        f"{cc.scenario_engine.total_descents}")
    if diff or not data_close or eager.stats_by_goal:
        raise AssertionError(f"the EAGER outcome differs from its FUSED "
                             f"twin in {sorted(diff)} (data to move "
                             f"close: {data_close})")
    if cc.scenario_engine.total_descents != 1:
        raise AssertionError("the faulted batch did not descend once")
    best = out["remove"]["answer"].scenario_report["scenarios"][0]["name"]
    winner_equals_single("remove candidates", out["remove"],
                         cc.remove_brokers(_ids(best, "remove-")))
    out["demote"] = scenario_request(
        "demote [[0], [100]]", lambda: cc.demote_brokers([[0], [100]]), cc,
        SUM_KERNELS)
    best = out["demote"]["answer"].scenario_report["scenarios"][0]["name"]
    winner_equals_single("demote candidates", out["demote"],
                         cc.demote_brokers(_ids(best, "demote-")))
    _, add_cc = served_facade(add_inputs, device, **SCENARIO_LADDER)
    sets = [new_ids[:5], new_ids[5:10]]
    out["add"] = scenario_request(
        f"add {sets}", lambda: add_cc.add_brokers(sets), add_cc,
        SERVED_STACK_KERNELS)
    best = out["add"]["answer"].scenario_report["scenarios"][0]["name"]
    winner_equals_single("add candidates", out["add"],
                         add_cc.add_brokers(_ids(best, "add-")))
    # every optimizer site failing: the request is served by the host
    # rung, then the breaker's probes climb back one rung a request
    ladder = []
    plan = faults.FaultPlan().fail_always("optimizer.execute")
    for step, want, degraded in (("all rungs failing", SolverRung.CPU, True),
                                 ("the probe", SolverRung.EAGER, True),
                                 ("recovered", SolverRung.FUSED, False)):
        t0 = time.perf_counter()
        with (faults.injected(plan) if step == "all rungs failing"
              else contextlib.nullcontext()):
            result = cc.optimizations(ignore_proposal_cache=True)
        if card:
            import torch
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ladder.append(dict(step=step, rung=cc.last_solve_rung.name,
                           outcome=cc.last_solve_trace.outcome, wall=wall,
                           descents=cc.solver_descents,
                           retries=cc.solver_retries,
                           invalidations=cc.model_store.invalidations,
                           proposals=len(result.proposals)))
        log(f"    ladder, {step}: {ladder[-1]}")
        if (cc.last_solve_rung is not want
                or (cc.last_solve_trace.outcome == "degraded") != degraded
                or cc.solver_descents != 2
                or cc.model_store.invalidations < 1):
            raise AssertionError(f"ladder, {step}: {ladder[-1]}")
    out["ladder"] = ladder
    out["host_rung_s"] = host_rung_wall(cc, (0, 100), "200 brokers")
    return out


def run_scenarios(results: dict, north: bool) -> None:
    """What-if requests through the port's facade (`evaluate_scenarios`
    and candidate broker sets), the scenario engine's lanes on the card.

    At 200 brokers, over the self-healing request's rack-aware placement
    (the default stack at 192 rounds): the base scenario and three
    what-ifs in one batch (10 hypothetical brokers the only
    destinations, brokers 0 and 100 removed, disk loads x 1.2), each lane
    equal to the CPU facade's bit for bit, and
    `remove_brokers([[0, 100], [50, 150]])` (held against the CPU until
    the script's time limit cut that twin); then, on the card only, the
    batch's lanes as K
    single requests, one batch of the disk what-if after one fault at
    `scenario.execute` (served at EAGER, the per-scenario eager driver,
    equal to its FUSED twin: the single request of the same spec),
    `demote_brokers([[0], [100]])` (a sub-batch of the
    preferred-leader goal beside the base lane) and `add_brokers` of two
    sets of 5 appended brokers (on the add-broker request's placement),
    each winner equal to its single-set request; every outcome but the
    faulted one at FUSED, no other descent, no degraded trace.  Then
    every optimizer site failing for one `optimizations`
    request (served from the host rung, the trace degraded, the ladder's
    two descents counted), the two requests after it climbing back one
    rung each; and the host rung's wall with brokers 0 and 100 dead.  At
    2,600 brokers (`run_served`'s facade when it ran first):
    `remove_brokers` of two sets of 26 brokers, every lane feasible, and
    the host rung's wall with broker 0 dead."""
    from cruise_control_tpu_torch.testing.random_cluster import (
        RandomClusterSpec, random_cluster, served_inputs)
    where = "2,600 brokers" if north else "slice"
    log(f"  -- what-if scenarios ({where}): the port's CruiseControl, its "
        "scenario engine and degradation ladder")
    summary: dict = {}
    if north:
        # the served requests' facade, its model resident, when they ran
        # before
        cc = results.get("_served_facade_north")
        if cc is None:
            t0 = time.perf_counter()
            inputs = sim_description(served_inputs(*random_cluster(
                RandomClusterSpec(**NORTH_SPEC), device="cuda")))
            log(f"    described {len(inputs[0].brokers)} brokers in "
                f"{time.perf_counter() - t0:.3f} s")
            _, cc = served_facade(inputs, "cuda", **SCENARIO_LADDER)
        sets = [list(range(0, 2600, 100)), list(range(50, 2600, 100))]
        north_run = scenario_request(
            "remove two sets of 26 brokers", lambda: cc.remove_brokers(sets),
            cc, SERVED_HEAL_KERNELS)
        infeasible = [o.spec.name for o in north_run["outcomes"]
                      if not o.feasible]
        if infeasible:
            raise AssertionError(f"north scenarios infeasible: {infeasible}")
        summary = dict(wall=north_run["wall"],
                       lanes=[lane["seconds"] for lane in north_run["lanes"]],
                       host_rung_s=host_rung_wall(cc, (0,),
                                                  "2,600 brokers"))
        results["_scenarios_north"] = summary
        return
    inputs = sim_description(served_inputs(
        *rack_aware_start(SLICE_HEAL_REQUEST)))
    prep, topo = rack_aware_start(SLICE_ADD_REQUEST)
    new_ids = [topo.broker_ids[i] for i in
               prep.broker_new.nonzero().flatten().tolist()]
    add_inputs = served_inputs(prep, topo)
    card = _scenario_slice("cuda", inputs, add_inputs, new_ids, full=True)
    import torch
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cpu = _scenario_slice("cpu", inputs, add_inputs, new_ids, full=False)
    # the CPU facade repeats the batch only (the remove candidate sets'
    # CPU twin was cut for the script's time limit: their winner is held
    # to its single request on the card)
    scenarios_equal(card["batch"], cpu["batch"])
    # the batch's lanes (held against the CPU facade), for run_scheduled
    results["_scenario_batch_slice"] = (card["batch"]["outcomes"],
                                        card["batch"]["wall"])
    summary = {
        key: dict(wall=card[key]["wall"],
                  lanes=[lane["seconds"] for lane in card[key]["lanes"]],
                  lane_launches=[lane["launches"]
                                 for lane in card[key]["lanes"]])
        for key in ("batch", "remove", "demote", "add", "eager")}
    summary["singles_wall"] = [one["wall"] for one in card["singles"]]
    summary["cpu_walls"] = {"batch": cpu["batch"]["wall"]}
    summary["ladder"] = card["ladder"]
    summary["host_rung_s"] = card["host_rung_s"]
    results["_scenarios_slice"] = summary


#: the scheduled requests' facade settings: the scheduler on (the
#: reference's default), everything else as the served facades'
SCHEDULED = dict(scheduler_enabled=True)


def state_hash(state) -> str:
    """sha256 of every field of a model state, bytes as they lie."""
    import hashlib
    from cruise_control_tpu_torch.model.state import STATE_FIELDS
    h = hashlib.sha256()
    for f in STATE_FIELDS:
        h.update(getattr(state, f).detach().cpu().contiguous().numpy()
                 .tobytes())
    return h.hexdigest()


def result_differences(a, b) -> list:
    """What two request results do not share: proposals (logdirs and new
    leaders included), placement and leader flags, rounds and the stats
    (before, after and by goal) bit for bit."""
    import torch
    from cruise_control_tpu_torch.analyzer.optimizer import proposal_set
    same = {
        "proposals": (proposal_set(a) == proposal_set(b)
                      and _logdir_moves(a) == _logdir_moves(b)
                      and sorted((str(p.partition), p.new_leader)
                                 for p in a.proposals)
                      == sorted((str(p.partition), p.new_leader)
                                for p in b.proposals)),
        "placement and leaders": all(
            torch.equal(getattr(a.final_state, f).cpu(),
                        getattr(b.final_state, f).cpu())
            for f in ("replica_broker", "replica_disk",
                      "replica_is_leader")),
        "rounds": a.rounds_by_goal == b.rounds_by_goal,
        "stats": not _stats_differences(a, b)}
    return [k for k, v in same.items() if not v]


def _store_counts(cc) -> tuple:
    counts = cc.model_store.to_json()
    return (counts["hits"], counts["misses"], counts["fallbacks"],
            counts["deltaApplies"])


def preemption_sequence(cc, label: str, expect_store: tuple,
                        interactive) -> dict:
    """One precompute pass on its thread, parked at its first goal-segment
    checkpoint until the interactive request `interactive()` (a dry run
    of the facade's default stack) is queued; it then runs first and the
    precompute runs again to its end.  Gates: that order,
    one preemption counted, the precompute's trace marked "preempted" and
    pinned in the flight recorder, the resident model unchanged, the warm
    seed the precompute's final state, the store's counters moved by
    `expect_store` (hits, misses, fallbacks, delta applies), K9's
    scratch zero, no new counter slot, every kernel of the default stack
    launched.  Returns the
    results, the preemption latency (the interactive ticket's submission
    to its dispatch), the precompute's attempts, each goal segment's
    span of its completed run, and the walls."""
    import threading
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.obs import recorder as obs_recorder
    from cruise_control_tpu_torch.obs import trace as obs_trace
    from cruise_control_tpu_torch.sched import runtime as R
    on_card = cc.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    order, attempts, marks = [], [], []
    blocked, queued = threading.Event(), threading.Event()
    real_checkpoint = R.segment_checkpoint
    real_solve = cc.goal_optimizer.optimizations

    def checkpoint():
        # only the precompute (the one preemptible job) has a check
        if getattr(R._TLS, "preempt_check", None) is not None:
            sync()
            marks.append(time.perf_counter())
            if len(marks) == 1:
                blocked.set()
                if not queued.wait(600.0):
                    raise AssertionError("the interactive request never "
                                         "queued")
        real_checkpoint()

    def noted(state, topo, options=None, **kw):
        # the job's class, from the trace the dispatch thread runs under
        trace = obs_trace.current()
        heal = trace.tags.get("schedulerClass") != "PRECOMPUTE"
        order.append("interactive-solve" if heal else "pre-solve")
        t0 = time.perf_counter()
        try:
            result = real_solve(state, topo, options, **kw)
        except R.SolvePreempted:
            sync()
            attempts.append(dict(preempted=True,
                                 seconds=time.perf_counter() - t0,
                                 segments_done=len(marks) - 1))
            raise
        sync()
        if not heal:
            order.append("pre-complete")
            attempts.append(dict(preempted=False,
                                 seconds=time.perf_counter() - t0,
                                 end=time.perf_counter()))
        return result

    store = cc.model_store
    slots = {d: len(v) for d, v in cuda_kernels._ORDERED_SLOTS.items()}
    sched = cc.solve_scheduler
    preemptions = sched.stats.preemptions
    store_before = _store_counts(cc)
    recorder = obs_recorder.get_recorder()
    pinned_before = recorder.to_json()["pinnedTotal"]
    cuda_kernels.reset_launches()
    R.segment_checkpoint = checkpoint
    cc.goal_optimizer.optimizations = noted
    out, tickets = {}, []
    try:
        def precompute():
            t0 = time.perf_counter()
            try:
                out["status"] = cc._precompute_once_status()
            finally:
                out["pre_wall"] = time.perf_counter() - t0

        def request():
            R.set_submission_listener(tickets.append)
            t0 = time.perf_counter()
            try:
                out["heal"] = interactive()
                sync()
            except BaseException as exc:  # noqa: BLE001 - raised below
                out["heal_error"] = exc
            finally:
                out["heal_wall"] = time.perf_counter() - t0
                R.clear_submission_listener()
        pre = threading.Thread(target=precompute, name="precompute-pass")
        pre.start()
        if not blocked.wait(600.0):
            raise AssertionError(f"{label}: the precompute never reached "
                                 "a segment checkpoint")
        resident = state_hash(store._state)
        heal = threading.Thread(target=request, name="interactive")
        heal.start()
        deadline = time.monotonic() + 300.0
        while sched.queue.depth() < 1:
            if not heal.is_alive() and "heal_error" in out:
                raise out["heal_error"]
            if time.monotonic() > deadline or not heal.is_alive():
                raise AssertionError(
                    f"{label}: the interactive request never queued "
                    f"(its thread alive: {heal.is_alive()}, answer "
                    f"{'heal' in out})")
            time.sleep(0.001)
        queued.set()
        heal.join()
        pre.join()
    finally:
        R.segment_checkpoint = real_checkpoint
        del cc.goal_optimizer.optimizations
        queued.set()
    if "heal_error" in out:
        raise out["heal_error"]
    launches = {k: cuda_kernels.LAUNCHES[k] for k in SOURCES}
    ticket = tickets[0]
    latency = ticket.started_at - ticket.enqueued_at
    plan = cc.goal_optimizer._plan_segments()
    goals = [g.name for g in cc.goal_optimizer.goals]
    done = [a for a in attempts if not a["preempted"]][0]
    # the completed run's checkpoints (after the first attempt's one)
    run_marks = marks[len(marks) - len(plan):] + [done["end"]]
    spans = [dict(goals=goals[a:b], seconds=run_marks[i + 1] - run_marks[i])
             for i, (a, b) in enumerate(plan)]
    # before its first segment: stats, self-healing and the pre-balance;
    # the last span runs to the solve's end (the post sweep included)
    pre_program = run_marks[0] - (done["end"] - done["seconds"])
    preempted = [d for d in recorder.query(outcome="preempted",
                                           export=False)
                 if d["tags"].get("schedulerClass") == "PRECOMPUTE"]
    result = cc._cached_result
    summary = dict(
        order=order, latency_s=latency, attempts=attempts,
        preempted_in_segment=dict(index=0, goals=goals[plan[0][0]:
                                                      plan[0][1]]),
        segment_spans=spans, pre_program_s=pre_program,
        precompute_wall_s=out["pre_wall"],
        interactive_wall_s=out["heal_wall"],
        store=_store_counts(cc), launches=launches,
        scheduler=sched.to_json())
    log(f"    scheduled ({label}): order {order}; preemption latency "
        f"{latency * 1e3:.3f} ms; precompute attempts "
        + ", ".join(f"{a['seconds']:.3f} s"
                    + (" (preempted)" if a["preempted"] else "")
                    for a in attempts)
        + f", pass wall {out['pre_wall']:.3f} s; interactive wall "
        f"{out['heal_wall']:.3f} s; the re-run's pre-program "
        f"{pre_program:.3f} s, segments "
        + ", ".join(f"{'+'.join(s['goals'])} {s['seconds']:.3f} s"
                    for s in spans)
        + f"; store {summary['store']}; card {CARD[0]}")
    if on_card:
        log(f"      launches {launches}")
    gates = {
        "status": out["status"] == "computed",
        "order": order == ["pre-solve", "interactive-solve", "pre-solve",
                           "pre-complete"],
        "one preemption": sched.stats.preemptions == preemptions + 1
        and cc.metrics.to_json()["sched-preemptions"]["count"] >= 1,
        "trace preempted and pinned": bool(preempted)
        and recorder.to_json()["pinnedTotal"] > pinned_before,
        "resident unchanged": state_hash(store._state) == resident,
        "seed is the precompute's": cc._warm_seed is not None
        and cc._warm_seed[0] is result.final_state,
        "store": tuple(a - b for a, b in zip(summary["store"],
                                             store_before)) == expect_store,
        "counter slots": {d: len(v) for d, v in
                          cuda_kernels._ORDERED_SLOTS.items()} == slots,
        "scratch": (not on_card) or scratch_is_zero(),
        "launches": (not on_card) or all(
            launches[k] > 0 for k in SERVED_STACK_KERNELS)}
    log(f"      gates {gates}")
    if not all(gates.values()):
        raise AssertionError(f"scheduled ({label}): gates {gates}")
    return dict(summary, precompute=result,
                interactive=out["heal"].optimizer_result, resident=resident)


def coalesce_and_fold(cc, batch_outcomes) -> dict:
    """Two concurrent identical `optimizations(ignore_proposal_cache=True)`
    coalesce to one solve (one result object), then two compatible
    what-if sweeps of two specs each fold into one engine batch (the base
    solved once), each split outcome equal to that spec's lane of
    `batch_outcomes` (phase 3's batch of the base and three what-ifs);
    the dispatch thread parked on a gate job while each pair queues."""
    import threading
    import torch
    from cruise_control_tpu_torch.sched.policy import SchedulerClass
    from cruise_control_tpu_torch.sched.scheduler import SolveJob
    sched = cc.solve_scheduler

    def parked():
        gate, started = threading.Event(), threading.Event()

        def hold():
            started.set()
            gate.wait(600.0)
        t = threading.Thread(target=lambda: sched.submit(SolveJob(
            klass=SchedulerClass.ANOMALY_HEAL, run=hold, label="gate")))
        t.start()
        started.wait(60.0)
        return gate, t

    def wait_for(pred):
        deadline = time.monotonic() + 60.0
        while not pred():
            if time.monotonic() > deadline:
                raise AssertionError("scheduled: a request never queued")
            time.sleep(0.001)
    solves = []
    real_solve = cc.goal_optimizer.optimizations
    cc.goal_optimizer.optimizations = lambda *a, **kw: (
        solves.append(1), real_solve(*a, **kw))[1]
    got = {}
    try:
        coalesced = sched.stats.coalesced
        gate, gate_thread = parked()
        pair = [threading.Thread(target=lambda i=i: got.setdefault(
            i, cc.optimizations(ignore_proposal_cache=True)))
            for i in range(2)]
        t0 = time.perf_counter()
        for t in pair:
            t.start()
        wait_for(lambda: sched.stats.coalesced == coalesced + 1)
        gate.set()
        for t in pair + [gate_thread]:
            t.join()
        if cc.device.type == "cuda":
            torch.cuda.synchronize()
        coalesce_wall = time.perf_counter() - t0
    finally:
        del cc.goal_optimizer.optimizations
    by_name = {o.spec.name: o for o in batch_outcomes}
    specs = [o.spec for o in batch_outcomes if o.spec.name != "__base__"]
    sweeps = [specs[:2], specs[1:]]
    engine = cc.scenario_engine
    batches, folded = engine.total_batches, sched.stats.folded
    answers = {}
    gate, gate_thread = parked()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=lambda i=i, s=s: answers.setdefault(
        i, cc.evaluate_scenarios(s))) for i, s in enumerate(sweeps)]
    for n, t in enumerate(threads, 1):
        t.start()
        wait_for(lambda n=n: sched.queue.depth() == n)
    gate.set()
    for t in threads + [gate_thread]:
        t.join()
    if cc.device.type == "cuda":
        torch.cuda.synchronize()
    fold_wall = time.perf_counter() - t0
    diffs = {f"sweep {i} {o.spec.name}": outcome_differences(
        o, by_name[o.spec.name])
        for i, a in answers.items() for o in a.outcomes}
    diffs = {k: sorted(v) for k, v in diffs.items() if v}
    summary = dict(coalesced_solves=len(solves),
                   coalesce_wall_s=coalesce_wall,
                   fold_batch_size=engine.last_batch_size,
                   sweeps_alone=[len(s) + 1 for s in sweeps],
                   fold_wall_s=fold_wall,
                   fold_lane_s=answers[0].solve_s)
    log(f"    scheduled: two identical requests, {len(solves)} solve "
        f"({coalesce_wall:.3f} s); two sweeps of {len(sweeps[0])} specs "
        f"folded into one batch of {engine.last_batch_size} (alone "
        f"{summary['sweeps_alone']}) in {fold_wall:.3f} s; lanes equal to "
        f"phase 3's batch: {not diffs}")
    gates = {
        "one solve": len(solves) == 1 and got[0] is got[1],
        "one batch": engine.total_batches == batches + 1
        and sched.stats.folded == folded + 1
        and engine.last_batch_size == 1 + sum(len(s) for s in sweeps),
        "base shared": answers[0].outcomes[0] is answers[1].outcomes[0],
        "lanes": not diffs}
    if not all(gates.values()):
        raise AssertionError(f"scheduled: gates {gates}, lane "
                             f"differences {diffs}")
    return summary


def observability_gate(cc) -> dict:
    """`state()` (every substate the port has, sensors included) renders
    to JSON, and the OpenMetrics page parses with every sensor on it."""
    import re
    from cruise_control_tpu_torch.obs import export as obs_export
    from cruise_control_tpu_torch.utils.metrics import canonical_sensor_name
    doc = cc.state(["monitor", "executor", "analyzer", "scenario",
                    "scheduler", "incremental", "slo", "sensors"])
    text = json.dumps(doc, sort_keys=True)
    page = obs_export.render_for(cc)
    sample = re.compile(r'^[a-zA-Z_][a-zA-Z0-9_]*(\{[^}]*\})? '
                        r'(-?[0-9.]+(e[+-]?[0-9]+)?|NaN)$')
    bad = [line for line in page.splitlines()[:-1]
           if not (line.startswith("# TYPE ") or sample.match(line))]
    missing = [s for s in doc["Sensors"]
               if canonical_sensor_name(s) not in page]
    log(f"    state(): {len(text)} bytes, {len(doc['Sensors'])} sensors; "
        f"OpenMetrics page {len(page.splitlines())} lines; scheduler "
        f"{json.dumps({k: doc['SchedulerState'][k] for k in ('submitted', 'completed', 'coalesced', 'folded', 'preemptions', 'occupancy')})}"
        f"; SLO {doc['sloStatus']['status']}")
    if bad or missing or not page.endswith("# EOF\n"):
        raise AssertionError(f"OpenMetrics page: unparseable {bad[:3]}, "
                             f"missing {missing}")
    return dict(sensors=len(doc["Sensors"]), page_lines=len(
        page.splitlines()), slo=doc["sloStatus"]["status"])


def run_scheduled(results: dict, north: bool, device: str = "cuda") -> None:
    """Requests through the port's device-time scheduler (`sched/`): every
    solve a job of its dispatch thread.

    At 200 brokers, a facade with its scheduler on over the served
    requests' description: one precompute pass preempted by the
    interactive self-healing request (`preemption_sequence`), each
    result equal bit for bit to its inline twin of `run_served` (the
    cold request and the self-healing one, both held against the CPU
    there), the resident model equal to the served one's; then two
    identical requests coalesced and two what-if sweeps folded
    (`coalesce_and_fold`), and `state()` and the OpenMetrics page.  At
    2,600 brokers, on `run_served`'s facade (its scheduler turned on, the
    served cold model put back as the store's resident at a new
    generation, so no rebuild): the same preemption sequence with the
    served `remove_brokers` of 26 brokers as the interactive request, the
    precompute equal to the served cold request bit for bit."""
    from cruise_control_tpu_torch.sched import runtime as R
    where = "2,600 brokers" if north else "slice"
    log(f"  -- scheduled requests ({where}): the port's CruiseControl "
        "behind its device-time scheduler")
    key = "north" if north else "slice"
    if f"_served_cold_{key}" not in results:
        # run alone (--scheduled-only): the inline yardsticks on the card
        inputs = served_description(north)
        _, inline = served_facade(inputs, "cuda")
        inline._options_generator = HealingPatternGenerator()
        cold = inline.optimizations()
        results[f"_served_cold_{key}"] = (inputs, cold)
        results[f"_served_resident_{key}"] = (inline.model_store._state,
                                              inline.model_store._topology)
        if north:
            results["_served_facade_north"] = inline
        else:
            t0 = time.perf_counter()
            heal = inline.rebalance(options=healing_options(inline))
            results["_served_heal_slice"] = (heal.optimizer_result,
                                             time.perf_counter() - t0)
            results["_scenario_batch_slice"] = (inline.evaluate_scenarios(
                scenario_specs()).outcomes, None)
    inputs, cold = results[f"_served_cold_{key}"]
    state0, topo0 = results[f"_served_resident_{key}"]
    if north:
        cc = results["_served_facade_north"]
        cc.solve_scheduler.enabled = True
        # the served cold model back as the resident one, at a new
        # generation (the overlay cleared: the monitor builds that model)
        generation = cc.load_monitor.clear_model_overlay()
        cc.model_store.install(generation, state0, topo0, True,
                               cc.load_monitor.follower_cpu_estimator())
    else:
        _, cc = served_facade(inputs, device, **SCHEDULED)
        # the served self-healing request's pattern (on the random north
        # placement a request with excluded topics cannot fix the rack
        # violations and aborts, in the reference too: PERF.md §4)
        cc._options_generator = HealingPatternGenerator()
    if cc.solve_scheduler.enabled is not True or R.under_gateway():
        raise AssertionError("scheduled: the facade's scheduler is off")
    # the store: at 200 brokers the first attempt rebuilds (a miss, as
    # the served cold request did), the interactive request and the
    # re-run hit; at 2,600 all three hit the model put back.  The
    # interactive request at 200 brokers is the served self-healing
    # `rebalance`; at 2,600 brokers, where a `rebalance` with the
    # self-healing options leaves the random placement's rack violations
    # (RackAwareGoal still violated, chip runs of this change), the
    # served `remove_brokers` of 26 brokers
    removed = list(range(0, 2600, 100))
    interactive = ((lambda: cc.remove_brokers(removed)) if north
                   else (lambda: cc.rebalance(options=healing_options(cc))))
    seq = preemption_sequence(cc, where, (3, 0, 0, 0) if north
                              else (2, 1, 0, 0), interactive)
    twins = {"precompute": cold}
    if not north:
        twins["interactive"] = results["_served_heal_slice"][0]
    diffs = {k: result_differences(seq[k], twin)
             for k, twin in twins.items()}
    resident_equal = seq["resident"] == state_hash(state0)
    seed_equal = state_hash(cc._warm_seed[0]) == state_hash(
        cold.final_state)
    log(f"    scheduled ({where}): equal to the inline twins "
        f"{ {k: not v for k, v in diffs.items()} }, resident model equal "
        f"to the served one {resident_equal}, seed equal to the served "
        f"cold final state {seed_equal}")
    if any(diffs.values()) or not resident_equal or not seed_equal:
        raise AssertionError(f"scheduled ({where}): differences {diffs}, "
                             f"resident {resident_equal}, seed "
                             f"{seed_equal}")
    summary = {k: seq[k] for k in (
        "latency_s", "attempts", "preempted_in_segment", "segment_spans",
        "pre_program_s", "precompute_wall_s", "interactive_wall_s", "store", "order")}
    summary["inline_wall_s"] = {
        "interactive": (None if north
                        else results["_served_heal_slice"][1]),
        "cold": next((r["wall"] for r in results.get(f"_served_{key}", [])
                      if r["label"] == "cold"), None)}
    summary["card"] = CARD[0]
    if not north:
        outcomes, batch_wall = results["_scenario_batch_slice"]
        summary.update(coalesce_and_fold(cc, outcomes))
        summary["phase3_batch_wall_s"] = batch_wall
        summary["observability"] = observability_gate(cc)
    cc.shutdown()
    results[f"_scheduled_{key}"] = summary


def profile_slice(solve: dict, device: str = "cuda",
                  lexsort_dispatch: bool = False) -> None:
    """torch.profiler over one solve on the card: wall time, the device's
    busy and idle share, the Python garbage collector's passes, host and
    device time by labelled port function, the device time by kernel and
    the host's self time by torch op and CUDA runtime call.  With
    `lexsort_dispatch` the solve runs K8's lexsort dispatch (the torch
    lexsort, the kernel on that order and, after each multi-commit pass,
    the ordered scatters) in place of the one-launch K8."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from cruise_control_tpu_torch import ops
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.analyzer import kernels as K
    from cruise_control_tpu_torch.analyzer import leadership as L
    from cruise_control_tpu_torch.analyzer import optimizer as O
    from cruise_control_tpu_torch.analyzer import prebalance as P
    from cruise_control_tpu_torch.analyzer.goals import kafkaassigner as KA

    # label the port's hot functions so the trace attributes host and
    # device time to them (restored afterwards)
    targets = [(ops, "segment_sum"), (ops, "scatter_add_seq"),
               (ops, "sum_f32"),
               (K, "row_topk"), (K, "table_topk"), (K, "assign_pass"),
               (K, "prefix_gate"),
               (K, "rank_accept"),
               (K, "rank_accept_commit"),
               (K, "resolve_dest_conflicts"), (K, "assign_destinations"),
               (K, "move_round"), (K, "swap_round"),
               (K, "commit_moves_cached"), (K, "commit_swaps_cached"),
               (C, "commit_moves"), (C, "arrival_rank"),
               (C, "make_round_cache"), (C, "refresh_float_aggregates"),
               (P, "prebalance"),
               (K, "leadership_round"), (K, "leader_assign_pass"),
               (K, "commit_leadership_cached"), (K, "rotation_salt"),
               (C, "commit_leadership"), (L, "run_sweep_threaded"),
               (L, "sweep_window"), (L, "update_cache_for_leadership"),
               (O, "refresh_float_aggregates"), (O, "make_round_cache"),
               (O, "compute_stats"), (O, "compute_stats_fresh_loads"),
               (K, "forced_move_round"), (K, "forced_select"),
               (K, "per_segment_argmax"), (K, "swap_shortlist"),
               (K, "swap_pair"),
               (K, "assign_pref"), (K, "dest_has"),
               (O, "heal_offline_replicas"), (O, "diff_proposals_host"),
               (KA.KafkaAssignerEvenRackAwareGoal, "optimize_cached"),
               (KA.KafkaAssignerDiskUsageDistributionGoal, "optimize")]

    def wrap(fn, name):
        def labelled(*a, **kw):
            with record_function(f"port::{name}"):
                return fn(*a, **kw)
        return labelled

    # the profiler starts after a request's untimed preparation
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with collector_passes() as gc_passes, \
            (lexsort_k8() if lexsort_dispatch
             else contextlib.nullcontext()), \
            _wrapped(targets, wrap):
        def before():
            gc_passes.clear()
            prof.start()
        try:
            _, _, _, secs = _solve(solve, device, before)
        finally:
            prof.stop()
    kernels, labels = [], []
    for evt in prof.key_averages():
        if evt.key.startswith("port::") and evt.device_type == DeviceType.CUDA:
            continue    # the labels' device-side ranges, not activities
        if evt.device_type == DeviceType.CUDA:
            kernels.append((evt.self_device_time_total, evt.count, evt.key))
        elif evt.key.startswith("port::"):
            labels.append((evt.cpu_time_total, evt.count, evt.key,
                           evt.device_time_total))
    busy_ms = sum(k[0] for k in kernels) / 1e3
    launches = sum(k[1] for k in kernels)
    log(f"  profiled solve {secs:.3f} s wall (profiler on); device busy "
        f"{busy_ms:.1f} ms = {100 * busy_ms / (secs * 1e3):.1f}% of the "
        f"wall (idle {100 - 100 * busy_ms / (secs * 1e3):.1f}%); "
        f"{launches} device activities (kernels and copies)")
    longest = max(gc_passes, default=(0.0, None))
    log(f"  Python garbage collection in the solve: {len(gc_passes)} "
        f"passes, {sum(t for t, _ in gc_passes) * 1e3:.1f} ms, the longest "
        f"{longest[0] * 1e3:.1f} ms (generation {longest[1]})")
    log("  by port function (nested: totals include callees): host ms, "
        "calls, device ms")
    for cpu_us, count, key, dev_us in sorted(labels, reverse=True):
        log(f"    {cpu_us / 1e3:9.1f} ms {count:6d}x  {key[6:]:28s} "
            f"device {dev_us / 1e3:8.2f} ms")
    log("  top device activities: ms, count, name")
    for dev_us, count, key in sorted(kernels, reverse=True)[:10]:
        log(f"    {dev_us / 1e3:9.2f} ms {count:6d}x  {key[:80]}")
    host = sorted(((evt.self_cpu_time_total, evt.count, evt.key)
                   for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CPU
                   and not evt.key.startswith("port::")), reverse=True)
    log("  top host activities by self time (torch ops and CUDA runtime "
        "calls): ms, count, name")
    for cpu_us, count, key in host[:12]:
        log(f"    {cpu_us / 1e3:9.1f} ms {count:6d}x  {key[:80]}")
    torch.cuda.synchronize()


def run_scale(results: dict) -> None:
    """The 2,600-broker solves, one each (no warm-up, no CPU run), with
    the same gates."""
    _, _, result, secs, launches = _timed_path(
        NORTH_STACK, STACK_KERNELS, "default stack north (15 goals), 2,600 "
        "brokers", warm=False)
    results["_north_stack_s"] = secs
    results["_launches_north_stack"] = launches
    results["_north_stack_balancedness"] = result.balancedness_score()
    _, _, _, secs, _ = _timed_path(NORTH_FOUR, SWEEP_ONLY_KERNELS,
                                   "four-goal north, 2,600 brokers",
                                   warm=False)
    results["_north_s"] = secs
    _, _, _, secs, launches = _timed_path(
        NORTH_CONFIG5, CONFIG5_KERNELS, "config 5 north (52 broken "
        "logdirs), 2,600 brokers", warm=False)
    results["_north_config5_s"] = secs
    results["_launches_north_config5"] = launches
    _, _, _, secs, launches = _timed_path(
        NORTH_HARD, HARD_KERNELS, "six hard goals north (26 brokers "
        "killed), 2,600 brokers", warm=False)
    results["_north_hard_s"] = secs
    results["_launches_north_hard"] = launches
    run_modes(results, north=True)
    run_requests(results, north=True)
    run_served(results, north=True)
    run_executed(results, north=True)
    run_sampled(results, north=True)
    run_scenarios(results, north=True)
    run_scheduled(results, north=True)


def _most_launched(splits: dict, prefix: str, measured) -> str:
    """The measured entry of a kernel the default stack launched most,
    from its launch splits ("row_topk table k=1" -> "table k=1")."""
    best = max(((n, key[len(prefix):]) for key, n in (splits or {}).items()
                if key.startswith(prefix) and key[len(prefix):] in measured),
               default=None)
    return None if best is None else best[1]


def pick_records(results: dict) -> None:
    """K1's and K4's kernel-line records: the entry (source and k; commit
    mode) that the default-stack slice launched most, at the slice's
    shapes, with the slice's launches; every case kept beside them."""
    splits = (results.get("_launches_stack") or {}).get("splits") or {}
    cases = results.get("row_topk") or {}
    measured = {k: v for k, v in cases.items() if k.startswith(("plane",
                                                                 "table"))}
    if measured:
        key = _most_launched(splits, "row_topk ", measured) or "plane k=4"
        results["_row_topk_cases"] = measured
        results["row_topk"] = dict(measured[key],
                                   launches=cases.get("launches"))
        log(f"[5] row_topk: the record of the most launched entry, {key}")
    modes = results.get("leader_assign_pass") or {}
    if "multi" in modes:
        counts = {m: sum(n for key, n in splits.items()
                         if key.startswith(f"leader_assign_pass {m}"))
                  for m in ("multi", "single")}
        mode = max(counts, key=lambda m: (counts[m], m == "multi"))
        results["_leader_assign_cases"] = {m: modes[m] for m in
                                           ("multi", "single")}
        results["leader_assign_pass"] = dict(modes[mode]["pass 3"],
                                             launches=modes.get("launches"))
        log(f"[5] leader_assign_pass: the record of {mode}-commit pass 3 "
            f"(the default stack's launches by mode {counts})")


def build_from_two_threads(cuda_kernels) -> int:
    """The kernel library built by two threads at once, as a scheduler's
    dispatch thread and a caller could both reach the first launch: one
    nvcc compile per source (none when the library is already built) and
    one library for both.  Returns the compiles."""
    import threading
    real = subprocess.Popen
    compiles, libs, errors = [], [], []

    def popen(args, *a, **kw):
        if "-c" in args:
            compiles.append(args)
        return real(args, *a, **kw)

    def build():
        try:
            libs.append(cuda_kernels.build())
        except BaseException as exc:  # noqa: BLE001 - raised below
            errors.append(exc)
    subprocess.Popen = popen
    try:
        threads = [threading.Thread(target=build) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        subprocess.Popen = real
    if errors:
        raise errors[0]
    if len(compiles) not in (0, len(cuda_kernels.SOURCES)) \
            or libs[0] is not libs[1]:
        raise AssertionError(f"two threads built the kernels "
                             f"{len(compiles)} times over "
                             f"{len(cuda_kernels.SOURCES)} sources")
    return len(compiles)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one slice solve (torch.profiler)")
    ap.add_argument("--requests-only", action="store_true",
                    help="phases 3 and 4 run only the request paths "
                         "(add-broker, self-healing, incremental, fast "
                         "mode under the fused solver) and the requests "
                         "served and executed through the port's facade")
    ap.add_argument("--scenarios-only", action="store_true",
                    help="phases 3 and 4 run only the what-if scenario "
                         "requests and the degradation ladder's checks")
    ap.add_argument("--sampled-only", action="store_true",
                    help="phases 3 and 4 run only the requests served "
                         "from metric samples (the facade's own "
                         "LoadMonitor over a simulated cluster)")
    ap.add_argument("--scheduled-only", action="store_true",
                    help="phases 3 and 4 run only the requests through "
                         "the device-time scheduler (preemption, "
                         "coalescing, folding, state())")
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent tree: phase 2 times its "
                         "K6 and K10 chains as yardsticks and its K7 beside "
                         "this tree's")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",") if p}

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "cruise_control_tpu_torch")):
        print("chip_smoke: cruise_control_tpu_torch is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    CARD[0] = smi
    log(smi)
    log(f"[1] card: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {name}")
    from cruise_control_tpu_torch import cuda_kernels
    compiles = build_from_two_threads(cuda_kernels)
    log(f"[1] kernels built in {cuda_kernels.BUILD_INFO['seconds']:.1f} s, "
        f"by two threads at once: {compiles} nvcc compiles, one library")
    for line in cuda_kernels.BUILD_INFO["log"].splitlines():
        if ("registers" in line or "spill" in line or "error" in line
                or line.startswith("==")):
            log(f"    {line.strip()}")

    t_run = T_RUN[0] = time.time()
    results: dict = {}
    widest = [0]
    def widest_call(fn, name):
        def call(dest, *a, **kw):
            widest[0] = max(widest[0], dest.shape[0])
            return fn(dest, *a, **kw)
        return call

    if 2 in phases:
        pk = parent_kernels(args.parent)
        log("[2] kernels against their plain versions on the card, at the "
            "slice's shapes")
        results["row_topk"] = check_row_topk(200, 1152, seed=11)
        results["assign_pass"] = check_assign_pass(2048, (256, 200), seed=12)
        log("[2] K2 through a chain of multi-commit passes (K2, K8 with the "
            "commit), each pass against its plain version")
        results["_assign_chain"] = check_assign_chain(2048, 200, 200,
                                                      seed=18)
        results["commit_moves"] = check_commit_moves(
            SLICE_SPEC, seed=13, shapes=((2048, 64, True),
                                         (4096, 64, False)))
        results["leader_assign_pass"] = check_leader_assign(
            2048, 200, 60_000, seed=14)
        results["commit_leadership"] = check_commit_leadership(SLICE_SPEC,
                                                               seed=15)
        log("[2] K6, one sweep round's window, at the slice's P = 20,000 "
            "and at P = 3,000 (no compaction)")
        results["sweep_pick"] = check_sweep_window(SLICE_SPEC, seed=16,
                                                   pk=pk)
        results["_sweep_pick_whole"] = check_sweep_window(
            dict(SLICE_SPEC, num_partitions=3000), seed=38, pk=pk)
        results["forced_select"] = check_forced_select(SLICE_SPEC, seed=17,
                                                       pk=pk)
        log("[2] K7 with k = R on a small cluster (24 brokers)")
        results["_forced_select_small"] = check_forced_select(
            dict(SLICE_SPEC, num_brokers=24, num_partitions=1000), seed=40,
            pk=pk)
        results["rank_accept"] = check_rank_accept(seed=30)
        results["_rank_accept_breakdown"] = rank_accept_breakdown(seed=36)
        results["_segment_argmax_dense"] = check_segment_argmax(seed=31)
        results["segment_argmax"] = check_segment_keep(seed=37)
        log("[2] K10, a swap round's shortlists and pair plane, at 200 "
            "brokers and at 100 (a shortlist of every broker)")
        results["swap_pair"] = check_swap(SLICE_SPEC, seed=32, pk=pk)
        results["_swap_pair_small"] = check_swap(
            dict(SLICE_SPEC, num_brokers=100, num_partitions=10_000),
            seed=39, pk=pk)
        results["dest_feasibility"] = check_dest_feasibility(
            SLICE_SPEC, ((2048, 200), (2048, 131)), seed=33)
        log("[2] K2 at the forced-move round's C = 4096, against the "
            "shortlist (K = 256) and every broker (K = 2600)")
        results["_assign_pass_4096"] = check_assign_pass(4096, (256, 2600),
                                                         seed=19)
        log("[2] the same at the 2,600-broker shapes of phase 4 (K2 at the "
            "escalated width K = B, K4 also at C = R)")
        results["_row_topk_north"] = check_row_topk(2600, 1024, seed=21)
        check_assign_pass(2048, (2600,), seed=22)
        results["_assign_chain_north"] = check_assign_chain(2048, 256, 2600,
                                                            seed=29)
        results["_commit_moves_north"] = check_commit_moves(
            NORTH_SPEC, seed=23, shapes=((2048, 64, True),
                                         (10_400, 2600, True),
                                         (4096, 64, False)))
        results["_leader_assign_north"] = check_leader_assign(
            2048, 2600, 600_000, seed=24)
        results["_leader_assign_full"] = check_leader_assign(
            600_000, 2600, 600_000, seed=25)
        results["_commit_leadership_north"] = check_commit_leadership(
            NORTH_SPEC, seed=26)
        results["_sweep_pick_north"] = check_sweep_window(NORTH_SPEC,
                                                          seed=27, pk=pk)
        results["_forced_select_north"] = check_forced_select(NORTH_SPEC,
                                                              seed=28, pk=pk)
        results["_swap_pair_north"] = check_swap(NORTH_SPEC, seed=34,
                                                 pk=pk)
        results["_dest_feasibility_north"] = check_dest_feasibility(
            NORTH_SPEC, ((2048, 256), (4096, 2600)), seed=35)
        log("[2] the ordered sums K12-K14, at the slice's and the "
            "2,600-broker shapes and their edge cases")
        results["segment_sum"] = check_segment_sum(seed=41)
        results["ordered_sum"] = check_ordered_sum(seed=42)
        results["cumsum_blocks"] = check_prefix_gate(seed=44)
        log("[2] the dirty-region functions (torch ops: apply_delta, "
            "set_broker_capacities, restrict_context_to_dirty) at the "
            "slice's and the 2,600-broker shapes")
        results["_dirty_ops"] = {"slice": check_dirty_ops(SLICE_SPEC),
                                 "north": check_dirty_ops(NORTH_SPEC)}
        log("[2] K12 and K13's device launches a call (torch.profiler), "
            "after every timing")
        take_launch_counts()
    log(f"[t] {time.time() - t_run:.1f} s")
    with _wrapped([(cuda_kernels, "rank_accept")], widest_call):
        if 3 in phases:
            log("[3] slice: 200 brokers, the two-goal path, config 2's four "
                "goals, the default stack and the add-broker solve, then "
                "config 5 and the six hard goals (self-healing), then the "
                "demote, kafka-assigner and intra-broker modes")
            if args.scenarios_only:
                run_scenarios(results, north=False)
            elif args.sampled_only:
                run_sampled(results, north=False)
            elif args.scheduled_only:
                run_scheduled(results, north=False)
            elif args.requests_only:
                run_requests(results, north=False)
                run_served(results, north=False)
                run_executed(results, north=False)
                run_sampled(results, north=False)
                run_scenarios(results, north=False)
                run_scheduled(results, north=False)
            else:
                run_slice(results)
            log(f"[t] {time.time() - t_run:.1f} s")
        if 4 in phases:
            log("[4] scale: the default stack, the four-goal solve, config 5, "
                "the six hard goals and the demote, kafka-assigner and "
                "intra-broker modes at 2,600 brokers / 200K partitions")
            if args.scenarios_only:
                run_scenarios(results, north=True)
            elif args.sampled_only:
                run_sampled(results, north=True)
            elif args.scheduled_only:
                run_scheduled(results, north=True)
            elif args.requests_only:
                run_requests(results, north=True)
                run_served(results, north=True)
                run_executed(results, north=True)
                run_sampled(results, north=True)
                run_scenarios(results, north=True)
                run_scheduled(results, north=True)
            else:
                run_scale(results)
            log(f"[t] {time.time() - t_run:.1f} s")
    log(f"[4] the widest rank_accept call of the run: C = {widest[0]}")
    if widest[0] > RANK_CHECKED_C:
        raise AssertionError(f"a path called rank_accept at C = {widest[0]}, "
                             f"wider than phase 2 checks ({RANK_CHECKED_C})")
    if args.profile and args.requests_only:
        for solve, label in ((SLICE_ADD, "add-broker slice"),
                             (SLICE_ADD_REQUEST, "add-broker request"),
                             (SLICE_STACK, "default stack slice"),
                             (SLICE_HEAL_REQUEST, "self-healing request"),
                             (SLICE_INCREMENTAL, "incremental warm solve"),
                             (SLICE_FAST_FUSED, "fast mode, fused solver")):
            log(f"[3p] profile of one {label} solve on the card")
            profile_slice(solve)
    elif args.profile:
        log("[3p] default-stack slice solves in turns, K8's lexsort "
            "dispatch against the one-launch K8 (unprofiled)")
        results["_k8_turns"] = dispatch_turns(
            SLICE_STACK, lexsort_k8, ("one-launch K8", "lexsort dispatch"))
        log("[3p] profile of one default-stack slice solve on the card")
        profile_slice(SLICE_STACK)
        log("[3p] the same with K8's lexsort dispatch (torch lexsort, the "
            "kernel on its order, the ordered scatters after each pass)")
        profile_slice(SLICE_STACK, lexsort_dispatch=True)
        log("[3p] profile of one config 5 slice solve on the card")
        profile_slice(SLICE_CONFIG5)
        log("[3p] profile of one kafka-assigner and one intra-broker slice "
            "solve on the card")
        profile_slice(SLICE_KAFKA_ASSIGNER)
        profile_slice(SLICE_INTRA)
        log("[3p] the default-stack and intra-broker slice solves in turns, "
            "K12-K14 against their plain versions (unprofiled)")
        results["_sums_turns"] = {
            key: dispatch_turns(solve, plain_sums,
                                ("K12-K14", "plain ordered sums"))
            for key, solve in (("stack", SLICE_STACK),
                               ("intra", SLICE_INTRA))}
        log(f"[t] {time.time() - t_run:.1f} s")

    # a kernel the default stack did not launch reports its own path's
    # launches (the swap pair plane: the kafka-assigner solve)
    ka = results.get("_launches_kafka_assigner") or {}
    for k in SOURCES:
        r = results.setdefault(k, {})
        if not r.get("launches") and ka.get(k):
            r["launches"] = ka[k]
            log(f"[5] {k}: launches of the kafka-assigner slice solve")
    pick_records(results)
    kernels = []
    for k in SOURCES:
        r = results.get(k, {})
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": r.get("launches"),
            "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
            "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
            "bound_by": r.get("bound_by"),
            "library_ms": r.get("library_ms")})
        log(f"[5] {k}: timed at {r.get('shape')}")
    log("[5] " + json.dumps({
        "card": smi, "slice_two_goal_solve_s": results.get("_slice2_s"),
        "config2_seed4_solve_s": results.get("_config2_s"),
        "main_path_seed2_solve_s": results.get("_slice_s"),
        "config5_slice_solve_s": results.get("_config5_s"),
        "hard_slice_solve_s": results.get("_hard_s"),
        "north_solve_s": results.get("_north_s"),
        "north_config5_solve_s": results.get("_north_config5_s"),
        "north_hard_solve_s": results.get("_north_hard_s"),
        "stack_slice_solve_s": results.get("_stack_s"),
        "add_broker_slice_solve_s": results.get("_add_s"),
        "north_stack_solve_s": results.get("_north_stack_s"),
        "north_stack_balancedness":
            results.get("_north_stack_balancedness"),
        "modes_solve_s": {k: results.get(f"_{k}_s") for k in (
            "demote", "kafka_assigner", "intra", "intra_broken",
            "north_demote", "north_kafka_assigner", "north_intra")},
        "requests_solve_s": {k: results.get(f"_{k}_s") for k in (
            "add_request", "heal_request", "incremental", "fast_fused",
            "north_add_request", "north_incremental")},
        "requests_proposals": {k: results.get(f"_{k}_proposals") for k in (
            "add_request", "heal_request", "incremental", "fast_fused",
            "north_add_request", "north_incremental")},
        "incremental_cold_solve_s": {
            k: results.get(f"_{k}incremental_cold_s") for k in ("", "north_")},
        "add_request_old_to_old": {
            k: results.get(f"_{k}add_old_to_old") for k in ("", "north_")},
        "heal_request_counts": results.get("_heal_counts"),
        "dirty_region_ops": results.get("_dirty_ops"),
        "rank_accept_widest_c": widest[0],
        "stack_slice_pass_counts": results.get("_pass_counts"),
        "stack_slice_k8_turns_s": results.get("_k8_turns"),
        "sums_turns_s": results.get("_sums_turns"),
        "card_cpu_identical": results.get("_identical"),
        "row_topk_cases": results.get("_row_topk_cases"),
        "row_topk_north": results.get("_row_topk_north"),
        "leader_assign_pass_cases": results.get("_leader_assign_cases"),
        "leader_assign_north": results.get("_leader_assign_north"),
        "leader_assign_full_plane": results.get("_leader_assign_full"),
        "leadership_pass_counts": (results.get("_pass_counts") or {}).get(
            "leadership assignments"),
        "launch_splits": {k: (results.get(f"_launches_{k}") or {}).get(
            "splits") for k in ("four", "stack", "add", "hard",
                                "kafka_assigner", "north_stack")}}))
    log("[5] " + json.dumps({
        "forced_select_north": results.get("_forced_select_north"),
        "forced_select_k_equals_r": results.get("_forced_select_small"),
        "rank_accept_breakdown": results.get("_rank_accept_breakdown"),
        "assign_pass_C4096": results.get("_assign_pass_4096"),
        "assign_pass_chain": results.get("_assign_chain"),
        "assign_pass_chain_north": results.get("_assign_chain_north"),
        "swap_pair_north": results.get("_swap_pair_north"),
        "swap_pair_small": results.get("_swap_pair_small"),
        "sweep_pick": results.get("sweep_pick"),
        "sweep_pick_north": results.get("_sweep_pick_north"),
        "sweep_pick_whole": results.get("_sweep_pick_whole"),
        "swap_pair": results.get("swap_pair"),
        "dest_feasibility_north": results.get("_dest_feasibility_north"),
        "dest_feasibility_guard": results.get("dest_feasibility", {}).get(
            "guard"),
        "dest_pref": results.get("dest_feasibility", {}).get("pref"),
        "segment_keep": results.get("segment_argmax", {}).get("cases"),
        "segment_argmax_dense": results.get("_segment_argmax_dense")}))
    log("[5] launches by path: " + json.dumps({
        k: results.get(f"_launches_{k}") for k in (
            "four", "stack", "add", "config5", "hard", "demote",
            "kafka_assigner", "intra", "intra_broken", "north_stack",
            "north_config5", "north_hard", "north_demote",
            "north_kafka_assigner", "north_intra", "add_request",
            "heal_request", "incremental", "fast_fused",
            "north_add_request", "north_incremental")}))
    log("[5] served requests: " + json.dumps({
        k: results.get(f"_served_{k}") for k in ("slice", "north")}))
    log("[5] executed requests: " + json.dumps({
        k: results.get(f"_executed_{k}") for k in ("slice", "north")}
        | {"rebuilt_stats_largest_relative_difference":
           results.get("_executed_stats_rel")}))
    log("[5] sampled requests: " + json.dumps({
        k: results.get(f"_sampled_{k}") for k in ("slice", "north")}))
    log("[5] what-if scenarios and the ladder: " + json.dumps({
        k: results.get(f"_scenarios_{k}") for k in ("slice", "north")}))
    log("[5] scheduled requests: " + json.dumps({
        k: results.get(f"_scheduled_{k}") for k in ("slice", "north")}))
    log("[5] rank_accept: " + json.dumps(results.get("rank_accept")))
    for k in ("commit_moves", "_commit_moves_north", "commit_leadership",
              "_commit_leadership_north", "segment_sum", "ordered_sum",
              "cumsum_blocks"):
        log(f"[5] {k.strip('_')} cases: "
            + json.dumps(results.get(k, {}).get("cases")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
