#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (cruise_control_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--phases 1,2,3,4] [--profile]

Phases:
  1. the card's name and power limit (nvidia-smi), then the build of the
     port's eight CUDA kernels from csrc/ (one nvcc per source, started
     together, with nvcc's resource report);
  2. each kernel against its plain PyTorch version on the card at the
     slice's shapes and again at the 2,600-broker shapes of phase 4
     (integers and booleans exactly, floats bit for bit): K1 at k = 1, 4,
     8, 16 and 64, K2 (also at the forced-move round's C = 4096 against K
     = 256 and 2600), K3 with the broker table and table-less
     (self-healing's commits), K4 in both commit modes for passes 0 and 3
     (and at C = R, the full-plane width, at 2,600 brokers), K5 on a
     4,096-transfer table-less batch and on a phase-a batch with the
     table, K6 on a 4,096-partition window with and without the
     improvement gate and tiebreak, K7 at R = 60,000 and 600,000, k =
     4096, with 0.5 % forced, equal weights, fewer forced than k and every
     replica forced (and its guard-only launch), K8 at C = 1 to 4096 (B =
     200 and 2600, T = 0 to 6 terms) in seven cases and at C = 10,400,
     20,800 and 600,000.  Device times per call (20 calls captured in a
     CUDA graph, median of 5 replays timed with CUDA events; K3 and K5
     also without the wrapper's copies of the cache planes) beside the
     bound for the bytes the function needs and a one-call PyTorch
     yardstick where one exists;
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
     distribution); and the remove-broker drain (brokers 0 and 100
     killed) under the six hard goals.  One warm-up and one timed solve
     each, the kernels' launch counts of each timed solve (every kernel
     the path reaches must be > 0; the default stack's counts go into the
     kernel JSON for K1-K6 and K8, config 5's for K7), self-healing's
     rounds and moves, the per-goal violated counts, the sanity / no
     offline replica left / proposal-replay (new leaders included) /
     cache-equals-rebuild / no-self-regression gates, and each solve but
     the first again on the port's CPU path: its proposals and final
     leader flags must equal the card's;
  4. scale, 2,600 brokers / 200K partitions / 26 racks / 100 topics: the
     whole default stack (bench.py's "north" preset), the four-goal solve,
     config 5 (52 broken logdirs) and the six hard goals with brokers 0,
     100, ..., 2500 killed, with the same gates (no CPU comparison); then
     the widest rank_accept call of the run must be one phase 2 checked.
With --profile, two more default-stack solves (with K8, then with
rank_accept's plain version) and one more config-5 solve run under
torch.profiler and the device's busy share and time by kernel are
printed.

Every phase that fails raises, so the run exits non-zero.  The line
before the last is the kernel JSON; the last line is the device JSON.
Exits non-zero without a result when no card is present or when the
port's package is not beside this script.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
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
    "leader_assign_pass": "cruise_control_tpu/analyzer/kernels.py:959",
    "commit_leadership": "cruise_control_tpu/analyzer/context.py:732",
    "sweep_pick": "cruise_control_tpu/analyzer/leadership.py:238",
    "forced_select": "cruise_control_tpu/analyzer/kernels.py:1235",
    "rank_accept": "cruise_control_tpu/analyzer/kernels.py:145",
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
}
#: the kernels each solve must launch: the leadership table rounds (K4)
#: run only when a sweep leaves an over-limit broker; every path runs
#: multi-commit passes or sweeps, so K8 in all
TWO_GOAL_KERNELS = ("row_topk", "assign_pass", "commit_moves", "rank_accept")
FOUR_GOAL_KERNELS = ("row_topk", "assign_pass", "commit_moves",
                     "leader_assign_pass", "commit_leadership", "sweep_pick",
                     "rank_accept")
SWEEP_ONLY_KERNELS = tuple(k for k in FOUR_GOAL_KERNELS
                           if k != "leader_assign_pass")
#: self-healing selects with K7 and commits with K3 (table-less); the hard
#: goals' rack awareness and capacity rounds pick with K1
CONFIG5_KERNELS = ("forced_select", "commit_moves", "assign_pass",
                   "rank_accept")
HARD_KERNELS = ("forced_select", "commit_moves", "assign_pass", "row_topk",
                "rank_accept")
#: the whole default stack: the leader-count goal's transfer rounds run K4
STACK_KERNELS = FOUR_GOAL_KERNELS
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


def path(spec: dict, goals, max_rounds=None, kill=()) -> dict:
    """A solve: the random cluster `spec` with the brokers `kill` killed
    (set_broker_state(alive=False), the bench's remove-broker drain),
    optimized by `goals` (registry names; None is the whole default
    order) at `max_rounds`."""
    return dict(spec=spec, goals=None if goals is None else list(goals),
                max_rounds=max_rounds, kill=tuple(kill))


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


def log(msg: str) -> None:
    print(msg, flush=True)


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
    with torch.cuda.graph(graph):
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

def check_row_topk(b: int, s: int, seed: int) -> dict:
    """K1 at B x S for k in {1, 4, 8} (the block path) and {16, 64} (the
    warp path of the leadership round and its deep pick); the record of
    k = 4 (the goals' move rounds), with the k = 16 and 64 times beside
    it."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import kernels as K
    g = torch.Generator(device="cuda").manual_seed(seed)
    # quantized scores plant many ties; a third of the slots ineligible
    sc = torch.round(torch.rand((b, s), generator=g, device="cuda") * 50.0)
    sc = torch.where(torch.rand((b, s), generator=g, device="cuda") < 0.33,
                     torch.full((), K.NEG, device="cuda"), sc)
    sc[0] = K.NEG                       # a row with nothing eligible
    sc[1, :] = 7.0                      # a row of pure ties
    table = torch.randperm(b * s, generator=g, device="cuda").to(
        torch.int32).reshape(b, s)
    errs, times = [], {}
    for k in (1, 4, 8, 16, 64):
        got = cuda_kernels.row_topk(sc, table, k)
        want = K.row_topk_plain(sc, table, k)
        torch.cuda.synchronize()
        for x, y, what in zip(got, want, ("cand", "has", "top", "slot")):
            if not equal_exact(x, y):
                raise AssertionError(f"row_topk B={b} S={s} k={k}: {what} "
                                     "differs from the plain version")
        errs.append(max_abs_err([(got[2], want[2])]))
        times[k] = (graph_time_ms(lambda: cuda_kernels.row_topk(sc, table, k)),
                    graph_time_ms(lambda: K.row_topk_plain(sc, table, k)),
                    graph_time_ms(lambda: torch.topk(sc, k, dim=1)))
        call = cuda_time_ms(lambda: cuda_kernels.row_topk(sc, table, k))
        log(f"  row_topk B={b} S={s} k={k}: exact match; device time per "
            f"call: kernel {times[k][0]:.4f} ms, plain {times[k][1]:.4f} ms, "
            f"torch.topk {times[k][2]:.4f} ms; one wrapper call with its "
            f"host overhead {call:.4f} ms")
    out = {}
    for k in (4, 16, 64):
        # the scores once, then per output its table gather, id, flag,
        # score and slot
        t_b, by = bound(b * s * 4 + b * k * (4 + 4 + 1 + 4 + 4), b * s * k)
        out[k] = dict(max_abs_err=max(errs), ms=times[k][0],
                      plain_ms=times[k][1], bound_ms=t_b, bound_by=by,
                      library_ms=times[k][2], shape=f"B={b} S={s} k={k}")
        log(f"  row_topk B={b} S={s} k={k}: bound {t_b:.5f} ms ({by})")
    rec = dict(out[4])
    rec["deep"] = {k: out[k] for k in (16, 64)}
    return rec


def check_assign_pass(c: int, widths, seed: int) -> dict:
    """K2 at C x K for each K in `widths`, passes 0 and 3; the record of
    the first width's pass 3."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import kernels as K
    g = torch.Generator(device="cuda").manual_seed(seed)
    timed = None
    for kk in widths:
        pref = -torch.rand((c, kk), generator=g, device="cuda")
        pref = torch.where(torch.rand((c, kk), generator=g, device="cuda")
                           < 0.3, torch.full((), K.NEG, device="cuda"), pref)
        pref[:, 5] = pref[:, 3]          # planted ties between slots
        dest_open = torch.rand(kk, generator=g, device="cuda") < 0.8
        assigned = torch.rand(c, generator=g, device="cuda") < 0.2
        cand_has = torch.rand(c, generator=g, device="cuda") < 0.9
        finite = pref > K.NEG / 2
        inf = torch.full((), float("inf"), device="cuda")
        spread = (torch.max(torch.where(finite, pref, -inf))
                  - torch.min(torch.where(finite, pref, inf)))
        amp = 0.35 * spread + 1e-6
        for k in (0, 3):
            got = cuda_kernels.assign_pass(pref, dest_open, assigned,
                                           cand_has, k, amp)
            want = K.assign_pass_plain(pref, dest_open, assigned, cand_has,
                                       k, amp)
            torch.cuda.synchronize()
            for x, y, what in zip(got, want, ("best_slot", "has")):
                if not equal_exact(x, y):
                    raise AssertionError(
                        f"assign_pass C={c} K={kk} pass {k}: {what} "
                        "differs from the plain version")
            t = (graph_time_ms(lambda: cuda_kernels.assign_pass(
                     pref, dest_open, assigned, cand_has, k, amp)),
                 graph_time_ms(lambda: K.assign_pass_plain(
                     pref, dest_open, assigned, cand_has, k, amp)))
            log(f"  assign_pass C={c} K={kk} pass {k}: exact match; device "
                f"time per call: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms")
            if timed is None and k == 3:
                timed = (kk, t)
    kk, t = timed
    # pref once, the masks, then per row the slot and the flag
    t_b, by = bound(c * kk * 4 + kk + c * 2 + c * 5, c * kk * 2)
    return dict(max_abs_err=0.0, ms=t[0], plain_ms=t[1], bound_ms=t_b,
                bound_by=by, library_ms=None, shape=f"C={c} K={kk} pass 3")


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


def kernel_only_ms(state, cache, r, dst, valid, rank, reps: int = 20,
                   trials: int = 5) -> float:
    """K3's device time per launch without the wrapper's copies: `reps`
    launches captured in one CUDA graph, each into its own copy of the
    cache planes, which are restored before each timed replay; the median
    replay over `reps`."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    pristine = {f: getattr(cache, f)
                for f in cuda_kernels.commit_fields(cache)}
    bufs = []
    for _ in range(reps):
        out = {f: t.clone() for f, t in pristine.items()}
        out["broker_util"] = torch.empty_like(cache.broker_load)
        bufs.append(out)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for out in bufs:
            cuda_kernels.commit_moves_into(out, state, cache, r, dst, valid,
                                           rank)
    times = []
    for _ in range(trials):
        for out in bufs:
            for f, t in pristine.items():
                out[f].copy_(t)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    got = bufs[0]
    want = cuda_kernels.commit_moves(state, cache, r, dst, valid, rank)
    torch.cuda.synchronize()
    for f in want:
        if not equal_exact(got[f], want[f]):
            raise AssertionError(f"commit_moves replay: {f} differs")
    return statistics.median(times)


def check_commit_moves(spec: dict, seed: int) -> dict:
    """K3 on a 2,048-move batch with several arrivals per destination, on
    the round cache of the cluster `spec`."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.testing.random_cluster import (
        RandomClusterSpec, random_cluster)
    state, _ = random_cluster(RandomClusterSpec(**spec))
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    cache = C.make_round_cache(state, ctx.table_slots, ctx)
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = 2048
    r = torch.randperm(state.num_replicas, generator=g,
                       device="cuda")[:n].to(torch.int32)
    # destinations drawn from 64 brokers: several arrivals each
    hubs = torch.randperm(state.num_brokers, generator=g, device="cuda")[:64]
    dst = hubs[torch.randint(0, 64, (n,), generator=g, device="cuda")].to(
        torch.int32)
    valid = (torch.rand(n, generator=g, device="cuda") < 0.9) & (
        state.replica_broker[r.long()] != dst)
    rank = C.arrival_rank(dst, valid, state.num_brokers)
    got = cuda_kernels.commit_moves(state, cache, r, dst, valid, rank)
    want = C.commit_moves_plain(state, cache, r, dst, valid, rank)
    torch.cuda.synchronize()
    for f in sorted(want):
        if not equal_exact(got[f], want[f]):
            raise AssertionError(f"commit_moves B={state.num_brokers}: {f} "
                                 "differs from the plain version")
    err = max_abs_err([(got[f], want[f]) for f in want
                       if want[f].dtype.is_floating_point])
    per_dest = torch.bincount(dst[valid].long()).max()
    kernel = kernel_only_ms(state, cache, r, dst, valid, rank)
    wrapper = graph_time_ms(lambda: cuda_kernels.commit_moves(
        state, cache, r, dst, valid, rank))
    # the plain version synchronises with the host (its ordered float
    # scatter counts rounds), so it is timed per call with its host time
    plain = cuda_time_ms(lambda: C.commit_moves_plain(
        state, cache, r, dst, valid, rank), reps=5)
    nbytes = commit_bytes(state, cache, r, dst, valid, rank)
    t_b, by = bound(nbytes, int(valid.sum()) * 2 * 6)
    log(f"  commit_moves B={state.num_brokers} S={cache.broker_table.shape[1]}"
        f" batch={n} ({int(valid.sum())} valid, up to {int(per_dest)} "
        f"arrivals per destination): bit-exact; device time per call: "
        f"kernel {kernel:.4f} ms, wrapper with its cache-plane copies "
        f"{wrapper:.4f} ms; plain version, one call with its host time, "
        f"{plain:.4f} ms; bound {t_b:.5f} ms ({nbytes} bytes)")
    return dict(max_abs_err=err, ms=kernel, plain_ms=plain, bound_ms=t_b,
                bound_by=by, library_ms=None,
                shape=f"B={state.num_brokers} batch={n}")


def check_commit_moves_tableless(spec: dict, seed: int) -> dict:
    """K3's table-less mode (self-healing's commits) on a 4,096-move batch
    with many arrivals per destination, on the cluster `spec`'s cache
    without a broker table."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.testing.random_cluster import (
        RandomClusterSpec, random_cluster)
    state, _ = random_cluster(RandomClusterSpec(**spec))
    cache = C.make_round_cache(state)
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = 4096
    r = torch.randperm(state.num_replicas, generator=g,
                       device="cuda")[:n].to(torch.int32)
    hubs = torch.randperm(state.num_brokers, generator=g, device="cuda")[:64]
    dst = hubs[torch.randint(0, 64, (n,), generator=g, device="cuda")].to(
        torch.int32)
    valid = (torch.rand(n, generator=g, device="cuda") < 0.9) & (
        state.replica_broker[r.long()] != dst)
    got = cuda_kernels.commit_moves(state, cache, r, dst, valid, None)
    want = C.commit_moves_plain(state, cache, r, dst, valid, None)
    torch.cuda.synchronize()
    if sorted(got) != sorted(want):
        raise AssertionError(f"commit_moves table-less writes {sorted(got)},"
                             f" the plain version {sorted(want)}")
    for f in sorted(want):
        if not equal_exact(got[f], want[f]):
            raise AssertionError(f"commit_moves table-less B="
                                 f"{state.num_brokers}: {f} differs from "
                                 "the plain version")
    err = max_abs_err([(got[f], want[f]) for f in want
                       if want[f].dtype.is_floating_point])
    kernel = kernel_only_ms(state, cache, r, dst, valid, None)
    plain = cuda_time_ms(lambda: C.commit_moves_plain(
        state, cache, r, dst, valid, None), reps=5)
    nbytes = commit_bytes(state, cache, r, dst, valid, None)
    t_b, by = bound(nbytes, int(valid.sum()) * 2 * 6)
    log(f"  commit_moves table-less B={state.num_brokers} batch={n} "
        f"({int(valid.sum())} valid): bit-exact; device time per call: "
        f"kernel {kernel:.4f} ms; plain version, one call with its host "
        f"time, {plain:.4f} ms; bound {t_b:.5f} ms ({nbytes} bytes)")
    return dict(max_abs_err=err, ms=kernel, plain_ms=plain, bound_ms=t_b,
                bound_by=by, library_ms=None,
                shape=f"B={state.num_brokers} batch={n} table-less")


def check_forced_select(spec: dict, seed: int) -> dict:
    """K7 at R = the cluster `spec`'s replicas, k = min(4096, R), in four
    cases: about 0.5 % forced (config 5's broken logdirs), many equal
    weights, fewer forced than k (the -inf tail in play), every replica
    forced; each bit for bit against its plain version, and the guard-only
    launch (k = 0).  The record of the 0.5 % case."""
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
        log(f"  forced_select R={num_r} k={k} {label} ({n_forced} forced, "
            f"{n_ok} with a destination): exact match, guard-only too; "
            f"device time per call: kernel {t[0]:.4f} ms (guard only "
            f"{t[3]:.4f} ms), plain {t[1]:.4f} ms, torch.topk {t[2]:.4f} "
            f"ms; bound {t_b:.5f} ms ({nbytes} bytes)")
        if rec is None:
            rec = dict(max_abs_err=0.0, ms=t[0], plain_ms=t[1], bound_ms=t_b,
                       bound_by=by, library_ms=t[2],
                       shape=f"R={num_r} k={k} {label}")
    return rec


def check_leader_assign(c: int, num_b: int, seed: int) -> dict:
    """K4 at C rows of RF = 3 options in both commit modes, passes 0 and
    3; the record of the multi-commit pass 3 (the goals' mode)."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import kernels as K
    g = torch.Generator(device="cuda").manual_seed(seed)
    rf = 3

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    pref = -torch.rand((c, rf), generator=g, device="cuda")
    pref = torch.where(torch.rand((c, rf), generator=g, device="cuda") < 0.3,
                       torch.full((), K.NEG, device="cuda"), pref)
    pref[:, 2] = pref[:, 0]                 # planted ties between options
    sib_b, sib_r, src = ints(num_b, (c, rf)), ints(10 ** 6, (c, rf)), ints(
        num_b, (c,))
    assigned = torch.rand(c, generator=g, device="cuda") < 0.2
    cand_has = torch.rand(c, generator=g, device="cuda") < 0.9
    dep = ints(2, (num_b,))
    finite = pref > K.NEG / 2
    inf = torch.full((), float("inf"), device="cuda")
    amp = 0.35 * (torch.max(torch.where(finite, pref, -inf))
                  - torch.min(torch.where(finite, pref, inf))) + 1e-6
    rec = None
    for multi in (False, True):
        # multi: some destinations at the arrival ceiling
        taken = ints(3, (num_b,)) * (K.MAX_ARRIVALS_PER_ROUND // 2
                                     if multi else 1)
        args = (pref, sib_b, sib_r, src, taken, dep, assigned, cand_has)
        for k in (0, 3):
            got = cuda_kernels.leader_assign_pass(*args, k, amp, multi)
            want = K.leader_assign_pass_plain(*args, k, amp, multi)
            torch.cuda.synchronize()
            for x, y, what in zip(got, want, ("slot", "broker", "replica",
                                              "has")):
                if not equal_exact(x, y):
                    raise AssertionError(
                        f"leader_assign_pass C={c} multi={multi} pass {k}: "
                        f"{what} differs from the plain version")
            t = (graph_time_ms(lambda: cuda_kernels.leader_assign_pass(
                     *args, k, amp, multi)),
                 graph_time_ms(lambda: K.leader_assign_pass_plain(
                     *args, k, amp, multi)))
            log(f"  leader_assign_pass C={c} B={num_b} multi={multi} pass "
                f"{k}: exact match; device time per call: kernel "
                f"{t[0]:.4f} ms, plain {t[1]:.4f} ms")
            if multi and k == 3:
                rec = t
    # preferences and option brokers once, the winning replica, the source
    # broker, the two counter planes and the row masks; four outputs
    nbytes = c * rf * 8 + c * 4 + c * 4 + num_b * 8 + c * 2 + c * 13
    t_b, by = bound(nbytes, c * rf * 4)
    log(f"  leader_assign_pass C={c}: bound {t_b:.5f} ms ({nbytes} bytes)")
    return dict(max_abs_err=0.0, ms=rec[0], plain_ms=rec[1], bound_ms=t_b,
                bound_by=by, library_ms=None,
                shape=f"C={c} RF={rf} multi pass 3")


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
    a B*16-row batch with the broker table (phase a's); the record of the
    table-less batch."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.testing.random_cluster import (
        RandomClusterSpec, random_cluster)
    state, _ = random_cluster(RandomClusterSpec(**spec))
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    g = torch.Generator(device="cuda").manual_seed(seed)
    rec = None
    for label, slots, n, share in (
            ("table-less", 0, 4096, 0.9),
            ("with table", ctx.table_slots, state.num_brokers * 16, 0.5)):
        cache = C.make_round_cache(state, slots, ctx)
        sr, dr, valid = _leadership_batch(state, n, g, share)
        got = cuda_kernels.commit_leadership(state, cache, sr, dr, valid)
        want = C.commit_leadership_plain(state, cache, sr, dr, valid)
        torch.cuda.synchronize()
        for f in sorted(want):
            if not equal_exact(got[f], want[f]):
                raise AssertionError(
                    f"commit_leadership B={state.num_brokers} {label}: {f} "
                    "differs from the plain version")
        err = max_abs_err([(got[f], want[f]) for f in want
                           if want[f].dtype.is_floating_point])
        kernel = kernel_only_leadership_ms(state, cache, sr, dr, valid)
        wrapper = graph_time_ms(lambda: cuda_kernels.commit_leadership(
            state, cache, sr, dr, valid))
        plain = cuda_time_ms(lambda: C.commit_leadership_plain(
            state, cache, sr, dr, valid), reps=5)
        nbytes = leadership_bytes(state, cache, sr, dr, valid)
        t_b, by = bound(nbytes, int(valid.sum()) * 2 * 5)
        log(f"  commit_leadership B={state.num_brokers} {label} batch={n} "
            f"({int(valid.sum())} valid): bit-exact; device time per call: "
            f"kernel {kernel:.4f} ms, wrapper with copies of the planes it "
            f"writes {wrapper:.4f} ms; plain version, one call with its "
            f"host time, {plain:.4f} ms; bound {t_b:.5f} ms ({nbytes} "
            "bytes)")
        if rec is None:
            rec = dict(max_abs_err=err, ms=kernel, plain_ms=plain,
                       bound_ms=t_b, bound_by=by, library_ms=None,
                       shape=f"B={state.num_brokers} batch={n} table-less")
    return rec


def kernel_only_leadership_ms(state, cache, sr, dr, valid, reps: int = 20,
                              trials: int = 5) -> float:
    """K5's device time per launch without the wrapper's copies: `reps`
    launches captured in one CUDA graph, each into its own copy of the
    planes, restored before each timed replay; the median replay over
    `reps`.  The first copy's result must equal a wrapper call's."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer.context import LEADERSHIP_FIELDS
    sw = cache.broker_table.shape[1]
    pristine = {f: getattr(cache, f) for f in LEADERSHIP_FIELDS
                if f != "broker_util" and (sw or not f.startswith("table_"))}
    bufs = []
    for _ in range(reps):
        out = {f: t.clone() for f, t in pristine.items()}
        out["broker_util"] = torch.empty_like(cache.broker_load)
        bufs.append(out)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for out in bufs:
            cuda_kernels.commit_leadership_into(out, state, cache, sr, dr,
                                                valid)
    times = []
    for _ in range(trials):
        for out in bufs:
            for f, t in pristine.items():
                out[f].copy_(t)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    want = cuda_kernels.commit_leadership(state, cache, sr, dr, valid)
    torch.cuda.synchronize()
    for f in want:
        if not equal_exact(bufs[0][f], want[f]):
            raise AssertionError(f"commit_leadership replay: {f} differs")
    return statistics.median(times)


def check_sweep_pick(spec: dict, seed: int) -> dict:
    """K6 on a window of min(4096, P) partitions of the cluster `spec`, in
    limit mode and in mean mode with a tiebreak; the record of limit mode
    (the goals')."""
    import numpy as np
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.analyzer import kernels as K
    from cruise_control_tpu_torch.analyzer import leadership as L
    from cruise_control_tpu_torch.model import state as S
    from cruise_control_tpu_torch.testing.random_cluster import (
        RandomClusterSpec, random_cluster)
    state, _ = random_cluster(RandomClusterSpec(**spec))
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    cache = C.make_round_cache(state, 0, ctx)
    g = torch.Generator(device="cuda").manual_seed(seed)
    res = 2
    rows = ctx.partition_replicas
    num_p, rf = rows.shape
    wn = min(L.SWEEP_COMPACT, num_p)
    sel = torch.randperm(num_p, generator=g, device="cuda")[:wn].to(
        torch.int32)
    cur = torch.clamp_min(S.partition_leader_replica(state)[sel.long()],
                          0).to(torch.int32)
    has_in = torch.rand(wn, generator=g, device="cuda") < 0.9
    jit_plane = K._pairwise_jitter(num_p, rf, salt=0, device="cuda")
    value = (state.partition_leader_bonus[state.replica_partition.long(),
                                          res] * state.replica_valid)
    static_ok = C.replica_static_ok(state, ctx)
    cap = state.broker_capacity[:, res]
    upper = (ctx.balance_upper_pct[res] * cap).contiguous()
    fill_to = ((upper + ctx.balance_lower_pct[res] * cap) / 2.0).contiguous()
    W = cache.broker_load[:, res].contiguous()
    tb = torch.rand(state.num_brokers, generator=g, device="cuda")
    salt = float(np.float32(3) * np.float32(0.37))
    rec = None
    for improve, tb_norm in ((False, None), (True, tb)):
        args = (sel, has_in, cur, rows, jit_plane, state.replica_broker,
                value, static_ok, state.broker_alive, ctx.broker_leader_ok,
                W, fill_to, upper, tb_norm, salt, improve)
        got = cuda_kernels.sweep_pick(*args)
        want = L.sweep_pick_plain(*args)
        torch.cuda.synchronize()
        for x, y, what in zip(got, want, ("dst_r", "has")):
            if not equal_exact(x, y):
                raise AssertionError(
                    f"sweep_pick W={wn} improve_gate={improve}: {what} "
                    "differs from the plain version")
        t = (graph_time_ms(lambda: cuda_kernels.sweep_pick(*args)),
             graph_time_ms(lambda: L.sweep_pick_plain(*args)))
        log(f"  sweep_pick P={num_p} W={wn} improve_gate={improve} "
            f"tiebreak={tb_norm is not None}: exact match "
            f"({int(got[1].sum())} with a pick); device time per call: "
            f"kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms")
        if rec is None:
            rec = t
    # the window's ids, flags and current leaders, its option rows and
    # jitter, per option the broker id, value and eligibility, five
    # broker planes, two outputs
    nb = state.num_brokers
    nbytes = wn * 9 + wn * rf * (4 + 4 + 4 + 4 + 1) + nb * 14 + wn * 5
    t_b, by = bound(nbytes, wn * rf * 8)
    log(f"  sweep_pick W={wn}: bound {t_b:.5f} ms ({nbytes} bytes)")
    return dict(max_abs_err=0.0, ms=rec[0], plain_ms=rec[1], bound_ms=t_b,
                bound_by=by, library_ms=None, shape=f"W={wn} RF={rf}")


#: K8's cases (see _rank_inputs for what each plants)
RANK_CASES = ("random", "all invalid", "one segment", "equal gains",
              "signed zeros", "taken at cap", "mid-segment failure")


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
    return dest, gain, has, taken, cap, cum, d_w, hr


def check_rank_accept(seed: int) -> dict:
    """K8 against rank_accept_plain on the card, exactly, at C = 1, 16,
    17, 256, 257, 2048 and 4096 (B = 200 and 2600), T = 0, 1, 3 and 6, in
    every case of RANK_CASES; then at the paths' widest calls (C = 4 B =
    10,400, the rack goal's table branch and the capacity goals' fallback
    at 2,600 brokers; 20,800; and C = R = 600,000) with T = 3.  Times per
    call at C = 2048, T = 3, B = 200 (the record) and at C = 4096 and
    10,400: the kernel alone (after the lexsort, terms pre-stacked), the
    dispatch (sort, stacks and kernel) and the plain version."""
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import kernels as K
    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = [(c, b, t) for c in (1, 16, 17, 256, 257, 2048, 4096)
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
            torch.cuda.synchronize()
            if not equal_exact(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"rank_accept C={c} B={b} T={t} case "
                                     f"{case!r}: {bad} flags differ from the "
                                     "plain version")
            n_checked += 1
            accepted += int(got.sum())
    log(f"  rank_accept: exact match in all {n_checked} checks ({accepted} "
        f"acceptances), C up to 600,000")
    rec = None
    for c, b, t in ((2048, 200, 3), (4096, 200, 3), (10_400, 2600, 3)):
        dest, gain, has, taken, cap, cum, d_w, hr = _rank_inputs(
            c, b, t, "random", g)
        seg = torch.where(has, dest.long(), torch.full_like(dest, b).long())
        order = K._lexsort_dest_gain(seg, gain)
        args = (dest, gain, has, b, taken, cap, list(cum), list(d_w),
                list(hr))
        times = (graph_time_ms(lambda: cuda_kernels.rank_accept(
                     order, dest, has, b, taken, cap, cum, d_w, hr)),
                 graph_time_ms(lambda: K.rank_accept(*args)),
                 graph_time_ms(lambda: K.rank_accept_plain(*args)))
        # the order, destinations and flags, the T weight rows in, the
        # flags out; per broker the counts and the T cumulants/headrooms
        nbytes = c * (8 + 4 + 1 + 4 * t + 1) + b * (8 + 8 * t)
        t_b, by = bound(nbytes, c * t * 4)
        log(f"  rank_accept C={c} B={b} T={t}: device time per call: kernel "
            f"{times[0]:.4f} ms, dispatch with the sort {times[1]:.4f} ms, "
            f"plain {times[2]:.4f} ms; bound {t_b:.6f} ms ({by}, {nbytes} "
            "bytes)")
        if rec is None:
            rec = dict(max_abs_err=0.0, ms=times[0], plain_ms=times[2],
                       dispatch_ms=times[1], bound_ms=t_b, bound_by=by,
                       library_ms=None, shape=f"C={c} B={b} T={t}")
    return rec


# ---------------------------------------------------------------------------
# phases 3 and 4: the solve
# ---------------------------------------------------------------------------

def _solve(solve: dict, device: str):
    """Build the cluster of `solve` (see `path`) on `device` and run its
    goals through GoalOptimizer.optimizations: (initial state, topology,
    result, solve seconds)."""
    import torch
    from cruise_control_tpu_torch.analyzer.goals.registry import \
        default_goals
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.model import state as S
    from cruise_control_tpu_torch.testing.random_cluster import (
        RandomClusterSpec, random_cluster)
    state, topo = random_cluster(RandomClusterSpec(**solve["spec"]),
                                 device=device)
    for b in solve["kill"]:
        state = S.set_broker_state(state, b, alive=False)
    goals = default_goals(solve["max_rounds"], solve["goals"])
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    result = GoalOptimizer(goals).optimizations(state, topo, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return state, topo, result, time.time() - t0


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
    rebuild, no goal above its own entry violated count."""
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.model.sanity import sanity_check
    from cruise_control_tpu_torch.testing import checks
    sanity_check(result.final_state)
    # includes: no replica on a dead broker or broken disk, no offline
    # replica left
    checks.verify_result(state, result, topo)
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions(), topo)
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


def _timed_path(solve: dict, kernels, label: str, warm: bool = True):
    """One warm-up (unless `warm` is False) and one timed card solve; the
    launches of the timed solve (counts set to 0 just before it, read just
    after), each of `kernels` > 0."""
    from cruise_control_tpu_torch import cuda_kernels
    if warm:
        _, _, _, warm_s = _solve(solve, "cuda")
        log(f"  {label}: warm-up solve {warm_s:.3f} s")
    cuda_kernels.reset_launches()
    (state, topo, result, secs), sweeps = _sweep_rounds(
        lambda: _solve(solve, "cuda"))
    launches = dict(cuda_kernels.LAUNCHES)
    four = solve["goals"] == FOUR_GOALS
    _report(f"{label} on the card", result, secs, sweeps if four else None)
    log(f"    kernel launches in the timed solve {launches}")
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"{label} solve")
    _gates(state, topo, result)
    return state, topo, result, secs, launches


def _card_equals_cpu(solve: dict, result, label: str) -> None:
    """The same solve on the port's CPU path: its proposals, final leader
    flags and proposals' new leaders must equal the card's; on a
    difference, both solves rerun with every commit logged and the first
    differing commit is named."""
    import torch
    from cruise_control_tpu_torch.analyzer.optimizer import proposal_set
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    _, _, cpu_result, cpu_s = _solve(solve, "cpu")
    _report(f"{label}, port on the CPU", cpu_result, cpu_s)
    same = proposal_set(cpu_result) == proposal_set(result)
    same_leaders = bool(torch.equal(
        cpu_result.final_state.replica_is_leader,
        result.final_state.replica_is_leader.cpu()))
    same_new_leaders = ({(p.partition, p.new_leader)
                         for p in cpu_result.proposals}
                        == {(p.partition, p.new_leader)
                            for p in result.proposals})
    log(f"    card and CPU: proposals identical {same}, final leader flags "
        f"identical {same_leaders}, proposals' new leaders identical "
        f"{same_new_leaders}")
    if not (same and same_leaders and same_new_leaders):
        card_log = _commit_log(solve, "cuda")
        cpu_log = _commit_log(solve, "cpu")
        first = next((i for i, (a, b) in enumerate(zip(card_log, cpu_log))
                      if a != b), min(len(card_log), len(cpu_log)))
        log(f"    first differing commit: {first} (card {len(card_log)} "
            f"commits, CPU {len(cpu_log)})")
        raise AssertionError(f"the card's {label} solve differs from the "
                             "port's CPU path")


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
    for name in STACK_KERNELS:
        results.setdefault(name, {})["launches"] = launches[name]
    results["_launches_stack"] = launches
    results["_stack_s"] = secs
    _card_equals_cpu(SLICE_STACK, result, "default stack slice")
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
    results["_identical"] = True


def profile_slice(solve: dict, device: str = "cuda",
                  plain_rank_accept: bool = False) -> None:
    """torch.profiler over one solve on the card: wall time, the device's
    busy and idle share, and the device time by kernel.  With
    `plain_rank_accept` the solve runs rank_accept's plain version in
    place of K8 (to compare its host time per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from cruise_control_tpu_torch import ops
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.analyzer import kernels as K
    from cruise_control_tpu_torch.analyzer import leadership as L
    from cruise_control_tpu_torch.analyzer import optimizer as O
    from cruise_control_tpu_torch.analyzer import prebalance as P
    from cruise_control_tpu_torch.model import stats as ST

    # label the port's hot functions so the trace attributes host and
    # device time to them (restored afterwards)
    targets = [(ops, "segment_sum"), (ops, "scatter_add_seq"),
               (ops, "cumsum_f32"), (ops, "sum_f32"),
               (K, "row_topk"), (K, "assign_pass"), (K, "rank_accept"),
               (K, "resolve_dest_conflicts"), (K, "assign_destinations"),
               (K, "move_round"), (K, "swap_round"),
               (K, "commit_moves_cached"), (K, "commit_swaps_cached"),
               (C, "commit_moves"), (C, "arrival_rank"),
               (C, "make_round_cache"), (C, "refresh_float_aggregates"),
               (P, "prebalance"), (ST, "sum_f32"),
               (K, "leadership_round"), (K, "leader_assign_pass"),
               (K, "commit_leadership_cached"), (K, "rotation_salt"),
               (C, "commit_leadership"), (L, "run_sweep_threaded"),
               (L, "sweep_pick"), (L, "update_cache_for_leadership"),
               (O, "refresh_float_aggregates"), (O, "make_round_cache"),
               (O, "compute_stats"), (O, "compute_stats_fresh_loads"),
               (K, "forced_move_round"), (K, "forced_select"),
               (O, "heal_offline_replicas")]

    def wrap(fn, name):
        def labelled(*a, **kw):
            with record_function(f"port::{name}"):
                return fn(*a, **kw)
        return labelled

    swap = ([(K, "rank_accept")] if plain_rank_accept else [])
    def to_plain(fn, name):
        def plain(*a, **kw):
            return K.rank_accept_plain(*a, **kw)
        return plain

    with _wrapped(swap, to_plain), \
            _wrapped(targets, wrap), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
        _, _, _, secs = _solve(solve, device)
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
    log("  by port function (nested: totals include callees): host ms, "
        "calls, device ms")
    for cpu_us, count, key, dev_us in sorted(labels, reverse=True):
        log(f"    {cpu_us / 1e3:9.1f} ms {count:6d}x  {key[6:]:28s} "
            f"device {dev_us / 1e3:8.2f} ms")
    log("  top device activities: ms, count, name")
    for dev_us, count, key in sorted(kernels, reverse=True)[:10]:
        log(f"    {dev_us / 1e3:9.2f} ms {count:6d}x  {key[:80]}")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one slice solve (torch.profiler)")
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
    log(smi)
    log(f"[1] card: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {name}")
    from cruise_control_tpu_torch import cuda_kernels
    cuda_kernels.build()
    log(f"[1] kernels built in {cuda_kernels.BUILD_INFO['seconds']:.1f} s")
    for line in cuda_kernels.BUILD_INFO["log"].splitlines():
        if ("registers" in line or "spill" in line or "error" in line
                or line.startswith("==")):
            log(f"    {line.strip()}")

    t_run = time.time()
    results: dict = {}
    widest = [0]

    def widest_call(fn, name):
        def call(order, *a, **kw):
            widest[0] = max(widest[0], order.shape[0])
            return fn(order, *a, **kw)
        return call

    if 2 in phases:
        log("[2] kernels against their plain versions on the card, at the "
            "slice's shapes")
        results["row_topk"] = check_row_topk(200, 1152, seed=11)
        results["assign_pass"] = check_assign_pass(2048, (256, 200), seed=12)
        results["commit_moves"] = check_commit_moves(SLICE_SPEC, seed=13)
        results["leader_assign_pass"] = check_leader_assign(2048, 200,
                                                            seed=14)
        results["commit_leadership"] = check_commit_leadership(SLICE_SPEC,
                                                               seed=15)
        results["sweep_pick"] = check_sweep_pick(SLICE_SPEC, seed=16)
        results["forced_select"] = check_forced_select(SLICE_SPEC, seed=17)
        results["rank_accept"] = check_rank_accept(seed=30)
        results["_commit_moves_tableless"] = check_commit_moves_tableless(
            SLICE_SPEC, seed=18)
        log("[2] K2 at the forced-move round's C = 4096, against the "
            "shortlist (K = 256) and every broker (K = 2600)")
        results["_assign_pass_4096"] = check_assign_pass(4096, (256, 2600),
                                                         seed=19)
        log("[2] the same at the 2,600-broker shapes of phase 4 (K2 at the "
            "escalated width K = B, K4 also at C = R)")
        check_row_topk(2600, 1024, seed=21)
        check_assign_pass(2048, (2600,), seed=22)
        check_commit_moves(NORTH_SPEC, seed=23)
        check_leader_assign(2048, 2600, seed=24)
        check_leader_assign(600_000, 2600, seed=25)
        check_commit_leadership(NORTH_SPEC, seed=26)
        check_sweep_pick(NORTH_SPEC, seed=27)
        results["_forced_select_north"] = check_forced_select(NORTH_SPEC,
                                                              seed=28)
        results["_commit_moves_tableless_north"] = \
            check_commit_moves_tableless(NORTH_SPEC, seed=29)
    log(f"[t] {time.time() - t_run:.1f} s")
    with _wrapped([(cuda_kernels, "rank_accept")], widest_call):
        if 3 in phases:
            log("[3] slice: 200 brokers, the two-goal path, config 2's four "
                "goals, the default stack and the add-broker solve, then "
                "config 5 and the six hard goals (self-healing)")
            run_slice(results)
            log(f"[t] {time.time() - t_run:.1f} s")
        if 4 in phases:
            log("[4] scale: the default stack, the four-goal solve, config 5 "
                "and the six hard goals at 2,600 brokers / 200K partitions")
            run_scale(results)
            log(f"[t] {time.time() - t_run:.1f} s")
    log(f"[4] the widest rank_accept call of the run: C = {widest[0]}")
    if widest[0] > RANK_CHECKED_C:
        raise AssertionError(f"a path called rank_accept at C = {widest[0]}, "
                             f"wider than phase 2 checks ({RANK_CHECKED_C})")
    if args.profile:
        log("[3p] profile of one default-stack slice solve on the card")
        profile_slice(SLICE_STACK)
        log("[3p] the same with rank_accept's plain version in place of K8")
        profile_slice(SLICE_STACK, plain_rank_accept=True)
        log("[3p] profile of one config 5 slice solve on the card")
        profile_slice(SLICE_CONFIG5)
        log(f"[t] {time.time() - t_run:.1f} s")

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
        "rank_accept_widest_c": widest[0],
        "card_cpu_identical": results.get("_identical"),
        "row_topk_deep": results.get("row_topk", {}).get("deep")}))
    log("[5] " + json.dumps({
        "commit_moves_tableless": results.get("_commit_moves_tableless"),
        "commit_moves_tableless_north":
            results.get("_commit_moves_tableless_north"),
        "forced_select_north": results.get("_forced_select_north"),
        "assign_pass_C4096": results.get("_assign_pass_4096")}))
    log("[5] launches by path: " + json.dumps({
        k: results.get(f"_launches_{k}") for k in (
            "four", "stack", "add", "config5", "hard", "north_stack",
            "north_config5", "north_hard")}))
    log("[5] rank_accept: " + json.dumps(results.get("rank_accept")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
