#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (cruise_control_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--phases 1,2,3,4] [--profile]

Phases:
  1. the card's name and power limit (nvidia-smi), then the build of the
     port's CUDA kernels from csrc/ (with nvcc's resource report);
  2. each kernel against its plain PyTorch version on the card at the
     slice's shapes and again at the 2,600-broker shapes of phase 4
     (integers and booleans exactly, floats bit for bit), with device
     times per call (20 calls captured in a CUDA graph, median of 5
     replays timed with CUDA events; K3 also without the wrapper's copies
     of the cache planes) beside the bound for the bytes the function
     needs and a one-call PyTorch yardstick where one exists;
  3. the slice: the disk + network-inbound proposal solve on the
     200-broker / 20K-partition / rf-3 cluster (8 racks, 10 topics, seed
     4, skew 0.2) with default options, one warm-up and one timed solve,
     the kernels' launch counts of the timed solve (each must be > 0),
     the sanity / cache-equals-rebuild / no-self-regression gates, and the
     same solve on the port's CPU path for a proposal comparison;
  4. scale: one solve at 2,600 brokers / 200K partitions / 26 racks / 100
     topics.
With --profile, one more slice solve runs under torch.profiler and the
device's busy share and time by kernel are printed.

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
}
SOURCES = {
    "row_topk": "cruise_control_tpu_torch/csrc/row_topk.cu",
    "assign_pass": "cruise_control_tpu_torch/csrc/assign_pass.cu",
    "commit_moves": "cruise_control_tpu_torch/csrc/commit_moves.cu",
}

SLICE_SPEC = dict(num_brokers=200, num_partitions=20_000,
                  replication_factor=3, num_racks=8, num_topics=10, seed=4,
                  skew_fraction=0.2)
NORTH_SPEC = dict(num_brokers=2600, num_partitions=200_000,
                  replication_factor=3, num_racks=26, num_topics=100, seed=4,
                  skew_fraction=0.2)


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
    """K1 at B x S for k in {1, 4, 8}; the record of k = 4 (the goals'
    move rounds)."""
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
    for k in (1, 4, 8):
        got = cuda_kernels.row_topk(sc, table, k)
        want = K.row_topk_plain(sc, table, k)
        torch.cuda.synchronize()
        for x, y, what in zip(got, want, ("cand", "has", "top")):
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
    k = 4
    # the scores once, then per output its table gather, id, flag and score
    t_b, by = bound(b * s * 4 + b * k * (4 + 4 + 1 + 4), b * s * k)
    return dict(max_abs_err=max(errs), ms=times[k][0], plain_ms=times[k][1],
                bound_ms=t_b, bound_by=by, library_ms=times[k][2],
                shape=f"B={b} S={s} k={k}")


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
    slot = (cache.broker_table[src] == rv[:, None].int()).int().argmax(1)
    scan = torch.full((state.num_brokers,), -1, dtype=torch.int64,
                      device=src.device).scatter_reduce(
                          0, src, slot.long(), "amax")
    arrive = (cache.table_fill[dv] + rank[valid]) < s_w
    p = state.replica_partition[rv].long()
    t = state.partition_topic[p].long()
    k, nt = state.num_racks, state.num_topics
    prc = torch.unique(torch.cat([p * k + state.broker_rack[src].long(),
                                  p * k + state.broker_rack[dv].long()]))
    btc = torch.unique(torch.cat([src * nt + t, dv * nt + t]))
    brokers = torch.unique(torch.cat([src, dv]))
    n_v = rv.numel()
    return int(r.numel() * 13                      # r, dst, valid, rank
               + n_v * (4 + 4 + 1 + 16 + 1 + 16 + 4 + 4)   # replica rows
               + int((scan + 1).sum()) * 4         # source-row prefixes
               + n_v * 5                           # punched id and flag
               + int(arrive.sum()) * (4 + 16 + 16 + 1 + 1)  # appended slots
               + torch.unique(dv).numel() * 8      # fill pointers
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
    pristine = {f: getattr(cache, f) for f in cuda_kernels.COMMIT_FIELDS}
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


# ---------------------------------------------------------------------------
# phases 3 and 4: the solve
# ---------------------------------------------------------------------------

def _goals():
    from cruise_control_tpu_torch.analyzer.goals.resource_distribution import (
        DiskUsageDistributionGoal, NetworkInboundUsageDistributionGoal)
    return [DiskUsageDistributionGoal(), NetworkInboundUsageDistributionGoal()]


def _solve(spec: dict, device: str):
    import torch
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.testing.random_cluster import (
        RandomClusterSpec, random_cluster)
    state, topo = random_cluster(RandomClusterSpec(**spec), device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    result = GoalOptimizer(_goals()).optimizations(state, topo, device=device)
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


def _commit_log(spec: dict, device: str) -> list:
    """Solve once and return every cached commit's sorted (replica,
    destination) pairs, one list per commit (a host copy per commit)."""
    import torch
    from cruise_control_tpu_torch.analyzer import kernels as K
    commits = []

    def record(replicas, dests, ok):
        pairs = torch.stack([replicas[ok].long(), dests[ok].long()], 1)
        commits.append(sorted(map(tuple, pairs.cpu().tolist())))

    def wrap(fn, name):
        def logged(state, cache, *batch):
            if name == "commit_moves_cached":
                cand_r, cand_dest, cand_valid = batch
                record(cand_r, cand_dest, cand_valid & (cand_r >= 0))
            else:
                record(*K._swap_moves(state, *batch))
            return fn(state, cache, *batch)
        return logged

    with _wrapped([(K, "commit_moves_cached"), (K, "commit_swaps_cached")],
                  wrap):
        _solve(spec, device)
    return commits


def _report(label: str, result, seconds: float) -> None:
    log(f"  {label}: solve {seconds:.3f} s")
    log(f"    rounds {result.rounds_by_goal}")
    log(f"    converged_at {result.converged_at_by_goal}")
    for g, (b, o, a) in result.violated_broker_counts.items():
        e = result.entry_broker_counts[g]
        log(f"    violated {g}: before {b} -> entry {e} -> own {o} "
            f"-> after {a}")
    log(f"    proposals {len(result.proposals)}, replica moves "
        f"{result.num_replica_movements}, balancedness "
        f"{result.balancedness_score():.3f}")


def run_slice(results: dict) -> None:
    import torch
    from cruise_control_tpu_torch import cuda_kernels
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.analyzer.optimizer import proposal_set
    from cruise_control_tpu_torch.model.sanity import sanity_check
    from cruise_control_tpu_torch.testing import checks

    _, _, _, warm_s = _solve(SLICE_SPEC, "cuda")
    log(f"  warm-up solve {warm_s:.3f} s")
    cuda_kernels.reset_launches()
    state, topo, result, secs = _solve(SLICE_SPEC, "cuda")
    launches = dict(cuda_kernels.LAUNCHES)
    _report("card", result, secs)
    log(f"    kernel launches in the timed solve {launches}")
    for name, count in launches.items():
        results.setdefault(name, {})["launches"] = count
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "slice's solve")
    results["_slice_s"] = secs

    sanity_check(result.final_state)
    checks.verify_result(state, result, topo)
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions(), topo)
    bad = checks.cache_mismatches(result.final_state, ctx,
                                  result.final_cache)
    if bad:
        raise AssertionError(f"final cache differs from a rebuild: {bad}")
    log("    sanity, proposal replay and cache-equals-rebuild: ok")
    for g, (_, own, _) in result.violated_broker_counts.items():
        if own > result.entry_broker_counts[g]:
            raise AssertionError(f"{g} regressed itself: own {own} > entry "
                                 f"{result.entry_broker_counts[g]}")
    log("    no goal self-regression: ok")

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    _, _, cpu_result, cpu_s = _solve(SLICE_SPEC, "cpu")
    _report("port on the CPU", cpu_result, cpu_s)
    same = proposal_set(cpu_result) == proposal_set(result)
    results["_identical"] = same
    log(f"    card and CPU proposals identical: {same}")
    if not same:
        card_log = _commit_log(SLICE_SPEC, "cuda")
        cpu_log = _commit_log(SLICE_SPEC, "cpu")
        first = next((i for i, (a, b) in enumerate(zip(card_log, cpu_log))
                      if a != b), min(len(card_log), len(cpu_log)))
        log(f"    first differing commit round: {first} (card "
            f"{len(card_log)} commits, CPU {len(cpu_log)})")


def profile_slice(device: str = "cuda") -> None:
    """torch.profiler over one slice solve on the card: wall time, the
    device's busy and idle share, and the device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from cruise_control_tpu_torch import ops
    from cruise_control_tpu_torch.analyzer import context as C
    from cruise_control_tpu_torch.analyzer import kernels as K
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
               (O, "refresh_float_aggregates"), (O, "make_round_cache"),
               (O, "compute_stats"), (O, "compute_stats_fresh_loads")]

    def wrap(fn, name):
        def labelled(*a, **kw):
            with record_function(f"port::{name}"):
                return fn(*a, **kw)
        return labelled

    with _wrapped(targets, wrap), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, _, secs = _solve(SLICE_SPEC, device)
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
    from cruise_control_tpu_torch import cuda_kernels
    cuda_kernels.reset_launches()
    _, _, result, secs = _solve(NORTH_SPEC, "cuda")
    _report("north 2,600 brokers", result, secs)
    log(f"    kernel launches {dict(cuda_kernels.LAUNCHES)}")
    results["_north_s"] = secs


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

    results: dict = {}
    if 2 in phases:
        log("[2] kernels against their plain versions on the card, at the "
            "slice's shapes")
        results["row_topk"] = check_row_topk(200, 1152, seed=11)
        results["assign_pass"] = check_assign_pass(2048, (256, 200), seed=12)
        results["commit_moves"] = check_commit_moves(SLICE_SPEC, seed=13)
        log("[2] the same at the 2,600-broker shapes of phase 4 (K2 at the "
            "escalated width K = B)")
        check_row_topk(2600, 1024, seed=21)
        check_assign_pass(2048, (2600,), seed=22)
        check_commit_moves(NORTH_SPEC, seed=23)
    if 3 in phases:
        log("[3] slice: disk + network-inbound solve, 200 brokers")
        run_slice(results)
    if args.profile:
        log("[3p] profile of one slice solve on the card")
        profile_slice()
    if 4 in phases:
        log("[4] scale: 2,600 brokers / 200K partitions")
        run_scale(results)

    kernels = []
    for k in ("row_topk", "assign_pass", "commit_moves"):
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
        "card": smi, "slice_solve_s": results.get("_slice_s"),
        "north_solve_s": results.get("_north_s"),
        "card_cpu_proposals_identical": results.get("_identical")}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
