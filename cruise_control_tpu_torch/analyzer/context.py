"""Optimization context: constraints, options and the per-round cache
(port of cruise_control_tpu/analyzer/context.py).

`update_cache_for_moves` is the commit path of every search round; on the
card it runs kernel K3 (`commit_moves`, csrc/commit_moves.cu), on a CPU
tensor its plain version `commit_moves_plain` below.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch import ops
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model.state import ClusterState


@dataclasses.dataclass(frozen=True)
class BalancingConstraint:
    """Static thresholds (defaults of the reference analyzer config)."""

    resource_balance_percentage: Tuple[float, float, float, float] = (
        1.1, 1.1, 1.1, 1.1)
    capacity_threshold: Tuple[float, float, float, float] = (
        0.7, 0.8, 0.8, 0.8)
    low_utilization_threshold: Tuple[float, float, float, float] = (
        0.0, 0.0, 0.0, 0.0)
    replica_balance_percentage: float = 1.1
    leader_replica_balance_percentage: float = 1.1
    topic_replica_balance_percentage: float = 3.0
    max_replicas_per_broker: int = 10_000
    goal_violation_distribution_threshold_multiplier: float = 1.0
    balance_margin: float = 0.9

    def balance_pct_with_margin(self, resource: int,
                                triggered_by_violation: bool = False) -> float:
        pct = self.resource_balance_percentage[resource]
        if triggered_by_violation:
            pct *= self.goal_violation_distribution_threshold_multiplier
        return (pct - 1.0) * self.balance_margin


@dataclasses.dataclass(frozen=True)
class OptimizationOptions:
    """Per-request knobs."""

    excluded_topics: frozenset = frozenset()
    excluded_brokers_for_leadership: frozenset = frozenset()
    excluded_brokers_for_replica_move: frozenset = frozenset()
    requested_destination_broker_ids: frozenset = frozenset()
    is_triggered_by_goal_violation: bool = False
    only_move_immigrant_replicas: bool = False
    fast_mode: bool = False
    #: joint multi-resource pre-balance before the first goal
    prebalance: bool = True


CONTEXT_FIELDS = (
    "replica_excluded", "replica_movable", "broker_dest_ok",
    "broker_leader_ok", "partition_replicas", "balance_upper_pct",
    "balance_lower_pct", "capacity_threshold", "low_utilization_threshold")


@dataclasses.dataclass(frozen=True)
class OptimizationContext:
    """Tensor form of options + constraints + derived static indices."""

    replica_excluded: torch.Tensor    # bool[R]
    replica_movable: torch.Tensor     # bool[R]
    broker_dest_ok: torch.Tensor      # bool[B]
    broker_leader_ok: torch.Tensor    # bool[B]
    partition_replicas: torch.Tensor  # i32[P, RF_MAX], -1 padded
    balance_upper_pct: torch.Tensor   # f32[RES]
    balance_lower_pct: torch.Tensor   # f32[RES]
    capacity_threshold: torch.Tensor  # f32[RES]
    low_utilization_threshold: torch.Tensor  # f32[RES]
    max_replicas_per_broker: int = 10_000
    rf_max: int = 5
    fix_offline_replicas_only: bool = False
    #: width S of RoundCache.broker_table (0 disables the table)
    table_slots: int = 0
    fast_mode: bool = False
    prebalance: bool = True


def partition_replica_index(state: ClusterState,
                            rf_max: Optional[int] = None) -> np.ndarray:
    """i32[P, RF_MAX] — replica indices of each partition (-1 padding),
    computed on host; valid for the whole optimization."""
    part = state.replica_partition.cpu().numpy()
    valid = state.replica_valid.cpu().numpy()
    num_p = state.num_partitions
    rf = np.bincount(part[valid], minlength=num_p)
    width = int(rf_max or max(int(rf.max(initial=1)), 1))
    out = np.full((num_p, width), -1, dtype=np.int32)
    order = np.argsort(part[valid], kind="stable")
    rows = np.nonzero(valid)[0][order]
    cols = np.concatenate([np.arange(n) for n in rf]) if rf.sum() else \
        np.zeros(0, dtype=np.int64)
    out[part[rows], cols] = rows
    return out


def table_width(max_count: int, num_replicas: int) -> int:
    """Broker-table width for a largest per-broker replica count of
    `max_count`: half again as many slots plus 64, rounded up to 128."""
    return min(num_replicas, -(-int(max_count * 1.5 + 64) // 128) * 128)


def make_context(state: ClusterState,
                 constraint: BalancingConstraint,
                 options: OptimizationOptions,
                 topology=None,
                 fix_offline_replicas_only: bool = False,
                 table_slots: Optional[int] = None
                 ) -> OptimizationContext:
    """Assemble the tensor context from host-side options (on the
    state's device).  `table_slots` overrides the broker-table width
    derived from the per-broker replica counts (the optimizer's re-run
    after self-healing overfilled a row)."""
    dev = state.device
    num_t = state.num_topics
    excluded_topic_mask = np.zeros(num_t, dtype=bool)
    if options.excluded_topics:
        if topology is not None:
            topic_idx = {t: i for i, t in enumerate(topology.topics)}
            for name in options.excluded_topics:
                if name in topic_idx:
                    excluded_topic_mask[topic_idx[name]] = True
        else:
            for idx in options.excluded_topics:
                excluded_topic_mask[int(idx)] = True

    def broker_mask(ids) -> np.ndarray:
        mask = np.zeros(state.num_brokers, dtype=bool)
        if ids:
            if topology is not None:
                index = topology.broker_index
                for b in ids:
                    if b in index:
                        mask[index[b]] = True
            else:
                for b in ids:
                    mask[int(b)] = True
        return mask

    excluded_replica_move = broker_mask(
        options.excluded_brokers_for_replica_move)
    excluded_leadership = broker_mask(options.excluded_brokers_for_leadership)
    requested_dest = broker_mask(options.requested_destination_broker_ids)

    host = {f: getattr(state, f).cpu().numpy() for f in (
        "partition_topic", "replica_partition", "broker_alive",
        "broker_demoted", "replica_valid", "broker_new", "replica_broker",
        "replica_offline")}
    topic_of_r = host["partition_topic"][host["replica_partition"]]
    replica_excluded = excluded_topic_mask[topic_of_r]

    alive = host["broker_alive"]
    dest_ok = alive & ~excluded_replica_move
    if requested_dest.any():
        dest_ok &= requested_dest
    leader_ok = alive & ~excluded_leadership & ~host["broker_demoted"]

    movable = host["replica_valid"].copy()
    if options.only_move_immigrant_replicas:
        on_new = host["broker_new"][host["replica_broker"]]
        movable &= host["replica_offline"] | on_new

    pr = partition_replica_index(state)

    # broker-table width: max initial per-broker replica count plus
    # headroom for arrivals and removal holes between compactions
    counts = np.bincount(host["replica_broker"][host["replica_valid"]],
                         minlength=state.num_brokers)
    if table_slots is None:
        table_slots = table_width(int(counts.max(initial=0)),
                                  state.num_replicas)

    avg_util = S.average_utilization_percentage(state).cpu().numpy()
    upper = np.zeros(NUM_RESOURCES, dtype=np.float32)
    lower = np.zeros(NUM_RESOURCES, dtype=np.float32)
    for res in range(NUM_RESOURCES):
        margin = constraint.balance_pct_with_margin(
            res, options.is_triggered_by_goal_violation)
        upper[res] = avg_util[res] * (1.0 + margin)
        lower[res] = avg_util[res] * max(0.0, 1.0 - margin)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return OptimizationContext(
        replica_excluded=t(replica_excluded),
        replica_movable=t(movable),
        broker_dest_ok=t(dest_ok),
        broker_leader_ok=t(leader_ok),
        partition_replicas=t(pr),
        balance_upper_pct=t(upper),
        balance_lower_pct=t(lower),
        capacity_threshold=t(np.asarray(constraint.capacity_threshold,
                                        dtype=np.float32)),
        low_utilization_threshold=t(np.asarray(
            constraint.low_utilization_threshold, dtype=np.float32)),
        max_replicas_per_broker=constraint.max_replicas_per_broker,
        rf_max=pr.shape[1],
        fix_offline_replicas_only=fix_offline_replicas_only,
        table_slots=table_slots,
        fast_mode=options.fast_mode,
        prebalance=options.prebalance,
    )


def restrict_context_to_dirty(state: ClusterState,
                              ctx: OptimizationContext,
                              dirty_brokers) -> OptimizationContext:
    """The dirty-region solve's context: candidate replica sources shrink
    to the dirty brokers plus every broker above its upper balance
    threshold on some resource, and move destinations to the dirty
    brokers plus every alive broker at or under the upper threshold on
    every resource.  Leadership eligibility is untouched.  An all-dirty
    mask gives the unrestricted context value for value."""
    dirty = torch.as_tensor(dirty_brokers, dtype=torch.bool,
                            device=state.device)
    util = S.broker_load(state) / torch.clamp_min(state.broker_capacity,
                                                  1e-9)
    upper = ctx.balance_upper_pct[None, :]
    over = torch.any(util > upper, dim=1)
    under = state.broker_alive & torch.all(util <= upper, dim=1)
    src_ok = dirty | over
    return dataclasses.replace(
        ctx,
        replica_movable=ctx.replica_movable & src_ok[state.replica_broker],
        broker_dest_ok=ctx.broker_dest_ok & (dirty | under))


CACHE_FIELDS = (
    "broker_load", "broker_util", "replica_load", "replica_count",
    "leader_count", "partition_rack_count", "broker_topic_count",
    "potential_nw_out", "leader_bytes_in", "broker_table", "table_fill",
    "table_load", "table_bonus", "table_leader", "table_ok", "replica_ok")


@dataclasses.dataclass(frozen=True)
class RoundCache:
    """Derived tensors shared by every goal's acceptance check, kept up
    to date through each committed batch.

    The broker table lists, per broker row, the replica ids on it (pad =
    R); removals leave pad holes, arrivals append at `table_fill`, and
    rows are re-packed when a fill pointer nears S.  The aux tables
    mirror hot per-replica attributes per slot; consumers mask on
    `table_ok` (False at every non-live slot) first."""

    broker_load: torch.Tensor        # f32[B, RES]
    broker_util: torch.Tensor        # f32[B, RES]
    replica_load: torch.Tensor       # f32[R, RES]
    replica_count: torch.Tensor      # i32[B]
    leader_count: torch.Tensor       # i32[B]
    partition_rack_count: torch.Tensor  # i32[P, K]
    broker_topic_count: torch.Tensor    # i32[B, T]
    potential_nw_out: torch.Tensor      # f32[B]
    leader_bytes_in: torch.Tensor       # f32[B]
    broker_table: torch.Tensor       # i32[B, S], pad = R
    table_fill: torch.Tensor         # i32[B]
    table_load: torch.Tensor         # f32[B, S, RES]
    table_bonus: torch.Tensor        # f32[B, S, RES]
    table_leader: torch.Tensor       # bool[B, S]
    table_ok: torch.Tensor           # bool[B, S]
    replica_ok: torch.Tensor         # bool[R] ([1] placeholder, no table)

    def replace(self, **kwargs) -> "RoundCache":
        return dataclasses.replace(self, **kwargs)


def leader_nw_in(state: ClusterState) -> torch.Tensor:
    """f32[R] — NW_IN carried only by leaders."""
    return (state.replica_base_load[:, Resource.NW_IN]
            * (state.replica_valid & state.replica_is_leader))


def build_broker_table(state: ClusterState, table_slots: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(broker_table i32[B, S], fill i32[B]) — compact per-broker replica
    rows built with one stable sort."""
    num_r, num_b = state.num_replicas, state.num_brokers
    s = table_slots
    dev = state.device
    rb = torch.where(state.replica_valid, state.replica_broker,
                     torch.full_like(state.replica_broker, num_b)).long()
    order = ops.argsort_stable(rb)
    rb_sorted = rb[order]
    counts = torch.bincount(rb, minlength=num_b + 1)
    start = torch.cat([torch.zeros(1, dtype=counts.dtype, device=dev),
                       torch.cumsum(counts, 0)[:-1]])
    rank = torch.arange(num_r, device=dev) - start[rb_sorted]
    flat_idx = torch.where((rb_sorted < num_b) & (rank < s),
                           rb_sorted * s + rank,
                           torch.full_like(rb_sorted, num_b * s))
    table = torch.full((num_b * s + 1,), num_r, dtype=torch.int32,
                       device=dev)
    table[flat_idx] = order.to(torch.int32)
    fill = torch.clamp_max(counts[:num_b], s).to(torch.int32)
    return table[:num_b * s].reshape(num_b, s), fill


def replica_static_ok(state: ClusterState,
                      ctx: Optional[OptimizationContext]) -> torch.Tensor:
    """bool[R] — per-replica eligibility that is constant for the whole
    optimize() call."""
    ok = state.replica_valid & ~state.replica_offline
    if ctx is not None:
        ok = ok & ~ctx.replica_excluded & ctx.replica_movable
    return ok


def _gather_aux_tables(state: ClusterState, table: torch.Tensor,
                       ctx: Optional[OptimizationContext]):
    """[B, S, .] gathers of the hot per-replica attributes."""
    num_r = state.num_replicas
    tab_safe = torch.clamp_max(table, num_r - 1).long()
    pad = table >= num_r
    load = S.replica_current_load(state)[tab_safe]
    bonus = state.partition_leader_bonus[
        state.replica_partition[tab_safe].long()]
    leader = state.replica_is_leader[tab_safe] & ~pad
    ok = replica_static_ok(state, ctx)[tab_safe] & ~pad
    return load, bonus, leader, ok


def _empty_table_planes(num_b: int, dev) -> dict:
    return dict(
        broker_table=torch.zeros((num_b, 0), dtype=torch.int32, device=dev),
        table_fill=torch.zeros((num_b,), dtype=torch.int32, device=dev),
        table_load=torch.zeros((num_b, 0, NUM_RESOURCES), device=dev),
        table_bonus=torch.zeros((num_b, 0, NUM_RESOURCES), device=dev),
        table_leader=torch.zeros((num_b, 0), dtype=torch.bool, device=dev),
        table_ok=torch.zeros((num_b, 0), dtype=torch.bool, device=dev))


def make_round_cache(state: ClusterState, table_slots: int = 0,
                     ctx: Optional[OptimizationContext] = None
                     ) -> RoundCache:
    load = S.broker_load(state)
    cap = torch.clamp_min(state.broker_capacity, 1e-9)
    num_b = state.num_brokers
    if table_slots:
        table, fill = build_broker_table(state, table_slots)
        t_load, t_bonus, t_leader, t_ok = _gather_aux_tables(state, table,
                                                             ctx)
        planes = dict(broker_table=table, table_fill=fill, table_load=t_load,
                      table_bonus=t_bonus, table_leader=t_leader,
                      table_ok=t_ok)
        r_ok = replica_static_ok(state, ctx)
    else:
        planes = _empty_table_planes(num_b, state.device)
        r_ok = torch.zeros((1,), dtype=torch.bool, device=state.device)
    return RoundCache(
        broker_load=load,
        broker_util=load / cap,
        replica_load=S.replica_current_load(state),
        replica_count=S.broker_replica_count(state),
        leader_count=S.broker_leader_count(state),
        partition_rack_count=S.partition_rack_count(state),
        broker_topic_count=S.broker_topic_replica_count(state),
        potential_nw_out=S.potential_leadership_load(state),
        leader_bytes_in=ops.segment_sum(leader_nw_in(state),
                                        state.replica_broker, num_b),
        replica_ok=r_ok,
        **planes)


def ensure_full_cache(state: ClusterState, ctx: OptimizationContext,
                      cache: Optional[RoundCache]) -> RoundCache:
    """A cache WITH a broker table when ctx.table_slots demands one."""
    if cache is None:
        return make_round_cache(state, ctx.table_slots, ctx)
    if ctx.table_slots and cache.broker_table.shape[1] != ctx.table_slots:
        table, fill = build_broker_table(state, ctx.table_slots)
        t_load, t_bonus, t_leader, t_ok = _gather_aux_tables(state, table,
                                                             ctx)
        return cache.replace(
            broker_table=table, table_fill=fill, table_load=t_load,
            table_bonus=t_bonus, table_leader=t_leader, table_ok=t_ok,
            replica_ok=replica_static_ok(state, ctx))
    return cache


def refresh_float_aggregates(state: ClusterState,
                             cache: RoundCache) -> RoundCache:
    """Recompute the drift-prone float aggregates from state (table_load
    is deliberately not refreshed: it only ranks candidates)."""
    load = S.broker_load(state)
    cap = torch.clamp_min(state.broker_capacity, 1e-9)
    return cache.replace(
        broker_load=load, broker_util=load / cap,
        replica_load=S.replica_current_load(state),
        potential_nw_out=S.potential_leadership_load(state),
        leader_bytes_in=ops.segment_sum(leader_nw_in(state),
                                        state.replica_broker,
                                        state.num_brokers))


# ---------------------------------------------------------------------------
# Incremental cache maintenance
# ---------------------------------------------------------------------------

def _scatter_pm(arr: torch.Tensor, s: torch.Tensor, d: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """`arr.at[[s;d]].add([-x;+x])` (out-of-range rows dropped), adding
    in that order — removals first, then arrivals, each in batch order —
    as the reference's one fused scatter does (the plain primitive: this
    is the plain versions' helper)."""
    return ops.scatter_add_seq_plain(arr, torch.cat([s, d]),
                                     torch.cat([-x, x]))


def _row_slot_of(table: torch.Tensor, brokers: torch.Tensor,
                 r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot [C], found bool[C]) — locate replica r[i] in row brokers[i]."""
    rows = table[brokers.long()]
    slot = torch.argmax((rows == r[:, None]).to(torch.int8), dim=1)
    found = torch.gather(rows, 1, slot[:, None])[:, 0] == r
    return slot, found


def arrival_rank(dst: torch.Tensor, valid: torch.Tensor,
                 num_b: int) -> torch.Tensor:
    """i32[C] — each valid arrival's rank among the batch's valid
    arrivals at its destination (stable by batch index), the append-slot
    offset of the broker table (same primitive as the acceptance ranking,
    kernels.segment_rank)."""
    from cruise_control_tpu_torch.analyzer.kernels import segment_rank
    c = dst.shape[0]
    dst_or_oob = torch.where(valid, dst, torch.full_like(dst, num_b))
    order, _, _, rank_sorted = segment_rank(dst_or_oob, num_b + 1)
    rank = torch.zeros((c,), dtype=torch.int32, device=dst.device)
    rank[order] = rank_sorted.to(torch.int32)
    return rank


def _aggregates_plain(state_before: ClusterState, cache: RoundCache,
                      r: torch.Tensor, dst: torch.Tensor,
                      valid: torch.Tensor) -> dict:
    """The broker/partition aggregates after committing the batch; every
    float sum adds in the reference's order (`_scatter_pm`)."""
    num_b = state_before.num_brokers
    src = state_before.replica_broker[r].long()
    s = torch.where(valid, src, torch.full_like(src, num_b))
    d = torch.where(valid, dst, torch.full_like(dst, num_b))

    load_r = cache.replica_load[r]
    broker_load = _scatter_pm(cache.broker_load, s, d, load_r)
    cap = torch.clamp_min(state_before.broker_capacity, 1e-9)

    one = valid.to(torch.int32)
    replica_count = _scatter_pm(cache.replica_count, s, d, one)
    is_lead = state_before.replica_is_leader[r]
    lead = (valid & is_lead).to(torch.int32)
    leader_count = _scatter_pm(cache.leader_count, s, d, lead)

    p = state_before.replica_partition[r].long()
    k = state_before.num_racks
    rack_s = state_before.broker_rack[torch.clamp_max(s, num_b - 1)].long()
    rack_d = state_before.broker_rack[torch.clamp_max(d, num_b - 1)].long()
    prc_flat = cache.partition_rack_count.reshape(-1)
    oob = torch.full_like(p, prc_flat.shape[0])
    prc = _scatter_pm(prc_flat, torch.where(valid, p * k + rack_s, oob),
                      torch.where(valid, p * k + rack_d, oob),
                      one).reshape(cache.partition_rack_count.shape)

    t = state_before.partition_topic[p].long()
    num_t = state_before.num_topics
    btc_flat = cache.broker_topic_count.reshape(-1)
    oob = torch.full_like(p, btc_flat.shape[0])
    btc = _scatter_pm(btc_flat, torch.where(valid, src * num_t + t, oob),
                      torch.where(valid, dst * num_t + t, oob),
                      one).reshape(cache.broker_topic_count.shape)

    # leader-role NW_OUT travels with the replica (potential load)
    zero = torch.zeros((), device=r.device)
    bonus = state_before.partition_leader_bonus[p]
    lead_nw = (load_r[:, Resource.NW_OUT]
               + torch.where(is_lead, zero, bonus[:, Resource.NW_OUT])
               ) * valid
    pot = _scatter_pm(cache.potential_nw_out, s, d, lead_nw)
    lbi_w = (state_before.replica_base_load[r, Resource.NW_IN]
             * (valid & is_lead))
    lbi = _scatter_pm(cache.leader_bytes_in, s, d, lbi_w)
    return dict(broker_load=broker_load, broker_util=broker_load / cap,
                replica_count=replica_count, leader_count=leader_count,
                partition_rack_count=prc, broker_topic_count=btc,
                potential_nw_out=pot, leader_bytes_in=lbi)


def commit_moves_plain(state_before: ClusterState, cache: RoundCache,
                       r: torch.Tensor, dst: torch.Tensor,
                       valid: torch.Tensor,
                       rank: Optional[torch.Tensor]) -> dict:
    """Plain PyTorch version of kernel K3: the cache fields after
    committing the batch, before any re-pack.  `valid` already excludes
    no-op moves; `rank` is `arrival_rank(dst, valid)`.  A cache without
    a broker table (table-less mode, `rank` None) gets the aggregates
    only."""
    r = r.long()
    dst = dst.long()
    num_r = state_before.num_replicas
    num_b = state_before.num_brokers
    rv = r[valid]
    if rv.numel() != torch.unique(rv).numel():
        raise AssertionError("a replica appears twice in one commit batch")
    out = _aggregates_plain(state_before, cache, r, dst, valid)
    if not cache.broker_table.shape[1]:
        return out

    # --- broker table: punch departures, append arrivals ---
    src = state_before.replica_broker[r].long()
    sw = cache.broker_table.shape[1]
    oob_t = num_b * sw
    slot, found = _row_slot_of(cache.broker_table, src, r.to(torch.int32))
    rem_idx = torch.where(valid & found, src * sw + slot,
                          torch.full_like(src, oob_t))
    flat = ops.scatter_set(cache.broker_table.reshape(-1), rem_idx,
                           torch.full_like(r, num_r, dtype=torch.int32))
    aslot = cache.table_fill[dst].long() + rank.long()
    a_idx = torch.where(valid & (aslot < sw), dst * sw + aslot,
                        torch.full_like(aslot, oob_t))
    flat = ops.scatter_set(flat, a_idx, r.to(torch.int32))
    fill = cache.table_fill + ops.segment_sum_plain(
        valid.to(torch.int32), dst, num_b)
    bonus = state_before.partition_leader_bonus[
        state_before.replica_partition[r].long()]
    t_load = ops.scatter_set(cache.table_load.reshape(-1, NUM_RESOURCES),
                             a_idx, cache.replica_load[r])
    t_bonus = ops.scatter_set(cache.table_bonus.reshape(-1, NUM_RESOURCES),
                              a_idx, bonus)
    t_leader = ops.scatter_set(cache.table_leader.reshape(-1), a_idx,
                               state_before.replica_is_leader[r])
    t_ok = ops.scatter_set(cache.table_ok.reshape(-1), rem_idx,
                           torch.zeros_like(valid))
    r_ok = cache.replica_ok[torch.clamp_max(r, cache.replica_ok.shape[0] - 1)]
    t_ok = ops.scatter_set(t_ok, a_idx, r_ok)
    out.update(
        broker_table=flat.reshape(num_b, sw), table_fill=fill,
        table_load=t_load.reshape(cache.table_load.shape),
        table_bonus=t_bonus.reshape(cache.table_bonus.shape),
        table_leader=t_leader.reshape(cache.table_leader.shape),
        table_ok=t_ok.reshape(cache.table_ok.shape))
    return out


def _donated(cache: RoundCache, fields: dict) -> dict:
    """The plain result written into the cache's own planes: a commit
    updates the cache it is given in place on the CPU too, as the card's
    kernels do, so a caller that still reads a given-up cache shows up
    here as well."""
    for f, t in fields.items():
        getattr(cache, f).copy_(t)
    return {f: getattr(cache, f) for f in fields}


def commit_moves(state_before: ClusterState, cache: RoundCache,
                 r: torch.Tensor, dst: torch.Tensor,
                 valid: torch.Tensor) -> dict:
    """K3 dispatch: commit the moves that are `valid` and not no-ops (the
    replica already on its destination) into the cache's own planes, in
    place, and return them: the caller gives `cache` up.  On the card the
    kernel (csrc/commit_moves.cu) drops the no-ops and ranks the arrivals
    itself; on the CPU the plain version gets `valid & (src != dst)` and
    `arrival_rank`, and its result is copied into the planes."""
    if cache.broker_load.is_cuda:
        from cruise_control_tpu_torch import cuda_kernels
        return cuda_kernels.commit_moves(state_before, cache, r, dst, valid)
    src = state_before.replica_broker[r.long()]
    valid = valid & (src != dst)
    rank = (arrival_rank(dst, valid, state_before.num_brokers)
            if cache.broker_table.shape[1] else None)
    return _donated(cache, commit_moves_plain(state_before, cache, r, dst,
                                              valid, rank))


def _repack(cache: RoundCache, num_r: int) -> RoundCache:
    """Re-pack every row when an append pointer nears the edge: a stable
    argsort by id pushes the pad value to the end, and the same
    permutation re-packs every aux table."""
    sw = cache.broker_table.shape[1]
    if not bool(torch.max(cache.table_fill) >= sw - 1):
        return cache
    order = ops.argsort_stable(cache.broker_table, 1)
    table = torch.gather(cache.broker_table, 1, order)
    o3 = order[:, :, None].expand(-1, -1, NUM_RESOURCES)
    return cache.replace(
        broker_table=table,
        table_load=torch.gather(cache.table_load, 1, o3),
        table_bonus=torch.gather(cache.table_bonus, 1, o3),
        table_leader=torch.gather(cache.table_leader, 1, order),
        table_ok=torch.gather(cache.table_ok, 1, order),
        table_fill=torch.sum(table < num_r, 1).to(torch.int32))


def update_cache_for_moves(state_before: ClusterState, cache: RoundCache,
                           replicas: torch.Tensor,
                           dest_brokers: torch.Tensor,
                           valid: torch.Tensor) -> RoundCache:
    """Cache after `apply_moves(state_before, replicas, dest_brokers,
    valid)`.  `state_before` must be the pre-commit state.  Precondition
    (the search kernels guarantee it): the valid rows name each replica
    at most once.  The caller gives up `cache`: the commit updates its
    planes in place."""
    fields = commit_moves(state_before, cache, replicas.to(torch.int32),
                          dest_brokers.to(torch.int32), valid)
    new = cache.replace(**fields)
    if not cache.broker_table.shape[1]:
        return new          # table-less mode (self-healing)
    return _repack(new, state_before.num_replicas)


# ---------------------------------------------------------------------------
# Leadership commits
# ---------------------------------------------------------------------------

def strip_table(cache: RoundCache) -> RoundCache:
    """Detach the broker table (0-width planes): the leadership sweep runs
    table-less."""
    return cache.replace(**_empty_table_planes(cache.broker_load.shape[0],
                                               cache.broker_load.device))


def reattach_table(state: ClusterState, cache: RoundCache,
                   table: torch.Tensor, fill: torch.Tensor,
                   t_bonus: torch.Tensor, t_ok: torch.Tensor,
                   replica_ok: torch.Tensor) -> RoundCache:
    """Reattach a detached broker table after leadership-only commits:
    membership and the static planes are transfer-invariant, so only the
    role-dependent planes (current-role load, leader flags) re-gather."""
    num_r = state.num_replicas
    tab_safe = torch.clamp_max(table, num_r - 1).long()
    pad = table >= num_r
    return cache.replace(
        broker_table=table, table_fill=fill,
        table_load=S.replica_current_load(state)[tab_safe],
        table_bonus=t_bonus,
        table_leader=state.replica_is_leader[tab_safe] & ~pad,
        table_ok=t_ok, replica_ok=replica_ok)


#: the cache fields a leadership commit writes (the table planes only
#: when the cache carries a table)
LEADERSHIP_FIELDS = ("broker_load", "broker_util", "replica_load",
                     "leader_count", "leader_bytes_in", "table_load",
                     "table_leader")


def commit_leadership_plain(state_before: ClusterState, cache: RoundCache,
                            sr: torch.Tensor, dr: torch.Tensor,
                            valid: torch.Tensor) -> dict:
    """Plain PyTorch version of kernel K5: the cache fields after handing
    each valid transfer's partition leadership bonus from replica sr[i]
    to dr[i].  Float sums add in the reference's order: `broker_load`
    gets [-bonus at the sources; +bonus at the destinations] in batch
    order, `leader_bytes_in` the demoted replica's base NW_IN out and the
    promoted one's in.  Precondition (asserted): each partition has at
    most one valid transfer, so every replica row and table slot is
    touched at most once."""
    sr = sr.long()
    dr = dr.long()
    num_r = state_before.num_replicas
    num_b = state_before.num_brokers
    p = state_before.replica_partition[sr].long()
    pv = p[valid]
    if pv.numel() != torch.unique(pv).numel():
        raise AssertionError("a partition appears twice in one leadership "
                             "commit batch")
    bonus = state_before.partition_leader_bonus[p] * valid[:, None]
    b_src = state_before.replica_broker[sr].long()
    b_dst = state_before.replica_broker[dr].long()
    s = torch.where(valid, b_src, torch.full_like(b_src, num_b))
    d = torch.where(valid, b_dst, torch.full_like(b_dst, num_b))
    broker_load = _scatter_pm(cache.broker_load, s, d, bonus)
    cap = torch.clamp_min(state_before.broker_capacity, 1e-9)
    spill = torch.full_like(sr, num_r)
    replica_load = _scatter_pm(cache.replica_load, torch.where(valid, sr,
                                                               spill),
                               torch.where(valid, dr, spill), bonus)
    leader_count = _scatter_pm(cache.leader_count, s, d,
                               valid.to(torch.int32))
    nw_in = state_before.replica_base_load[:, Resource.NW_IN]
    lbi = ops.scatter_add_seq_plain(cache.leader_bytes_in,
                                    torch.cat([s, d]),
                                    torch.cat([-nw_in[sr] * valid,
                                               nw_in[dr] * valid]))
    out = dict(broker_load=broker_load, broker_util=broker_load / cap,
               replica_load=replica_load, leader_count=leader_count,
               leader_bytes_in=lbi)
    sw = cache.broker_table.shape[1]
    if sw:
        oob = num_b * sw
        src_slot, src_found = _row_slot_of(cache.broker_table, b_src,
                                           sr.to(torch.int32))
        dst_slot, dst_found = _row_slot_of(cache.broker_table, b_dst,
                                           dr.to(torch.int32))
        src_idx = torch.where(valid & src_found, b_src * sw + src_slot,
                              torch.full_like(b_src, oob))
        dst_idx = torch.where(valid & dst_found, b_dst * sw + dst_slot,
                              torch.full_like(b_dst, oob))
        t_load = ops.scatter_add_seq_plain(
            cache.table_load.reshape(-1, NUM_RESOURCES),
            torch.cat([src_idx, dst_idx]), torch.cat([-bonus, bonus]))
        t_lead = ops.scatter_set(cache.table_leader.reshape(-1), src_idx,
                                 torch.zeros_like(valid))
        t_lead = ops.scatter_set(t_lead, dst_idx, torch.ones_like(valid))
        out.update(table_load=t_load.reshape(cache.table_load.shape),
                   table_leader=t_lead.reshape(cache.table_leader.shape))
    return out


def commit_leadership(state_before: ClusterState, cache: RoundCache,
                      sr: torch.Tensor, dr: torch.Tensor,
                      valid: torch.Tensor, donate: bool = False) -> dict:
    """K5 dispatch: the plain version for a CPU cache, the CUDA kernel
    (csrc/commit_leadership.cu) for a cache on the card.  With `donate`
    the caller gives `cache` up and its planes carry the result."""
    if not cache.broker_load.is_cuda:
        fields = commit_leadership_plain(state_before, cache, sr, dr, valid)
        return _donated(cache, fields) if donate else fields
    from cruise_control_tpu_torch import cuda_kernels
    return cuda_kernels.commit_leadership(state_before, cache, sr, dr, valid,
                                          donate=donate)


def update_cache_for_leadership(state_before: ClusterState,
                                cache: RoundCache,
                                src_replicas: torch.Tensor,
                                dest_replicas: torch.Tensor,
                                valid: torch.Tensor,
                                donate: bool = False) -> RoundCache:
    """Cache after `apply_leadership_transfers(state_before, ...)`: each
    valid transfer's partition leadership bonus moves from the source
    replica to the destination replica.  Counts, racks, topics, potential
    NW_OUT and table membership are leadership-invariant."""
    fields = commit_leadership(state_before, cache,
                               src_replicas.to(torch.int32).contiguous(),
                               dest_replicas.to(torch.int32).contiguous(),
                               valid.contiguous(), donate=donate)
    return cache.replace(**fields)
