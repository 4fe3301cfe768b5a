"""Replica-count distribution goals (port of cruise_control_tpu/analyzer/
goals/count_distribution.py): per-broker replica, leader and per-topic
replica counts within [avg*(1-margin), avg*(1+margin)], at least one
replica away from the average.

Every bound is computed on float32 tensors (a Python float in the
product would move it by an ulp), and the alive-broker averages sum in
XLA's order (`ops.sum_f32`).
"""
from __future__ import annotations

import itertools
from typing import Sequence

import torch

from cruise_control_tpu_torch import ops
from cruise_control_tpu_torch.analyzer import kernels
from cruise_control_tpu_torch.analyzer.context import (OptimizationContext,
                                                       ensure_full_cache,
                                                       replica_static_ok)
from cruise_control_tpu_torch.analyzer.goals.base import (
    Goal, _ones, compose_leadership_acceptance, compose_move_acceptance,
    dest_side_only, leadership_commit_terms, move_commit_terms,
    new_broker_dest_mask, note_rounds, run_phase_sweeps, run_rounds,
    shed_rows)
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model.state import ClusterState


def _count_bounds(avg: torch.Tensor, pct_margin: float):
    """Limits avg*(1±margin), at least one replica away from the
    average: (lower, upper)."""
    upper = torch.ceil(torch.maximum(avg * (1 + pct_margin), avg + 1))
    lower = torch.floor(torch.minimum(avg * (1 - pct_margin), avg - 1))
    return torch.clamp_min(lower, 0.0), upper


def alive_mean(state: ClusterState, values: torch.Tensor) -> torch.Tensor:
    """0-d alive-broker average of a [B] plane."""
    alive = state.broker_alive
    return ops.sum_f32(values * alive) / torch.clamp_min(torch.sum(alive), 1)


class ReplicaDistributionGoal(Goal):
    """Even replica counts."""

    name = "ReplicaDistributionGoal"
    #: headroom-term quantity key (the leader subclass weighs by the
    #: leader flag, a different quantity)
    count_key = "count"

    def __init__(self, max_rounds: int = 64, balance_pct_margin: float = 0.09):
        self.max_rounds = max_rounds
        self.pct_margin = balance_pct_margin

    def _weights(self, state: ClusterState) -> torch.Tensor:
        return state.replica_valid.to(torch.float32)

    def _counts(self, cache) -> torch.Tensor:
        return cache.replica_count.to(torch.float32)

    def _weight_rows(self, state: ClusterState, cache) -> torch.Tensor:
        """[B, S] per-slot weights mirroring _weights."""
        return torch.ones_like(cache.table_ok, dtype=torch.float32)

    def _bounds(self, state: ClusterState, cache):
        """(counts, avg, lower, upper) from the cache's counts."""
        counts = self._counts(cache)
        avg = alive_mean(state, counts)
        lower, upper = _count_bounds(avg, self.pct_margin)
        return counts, avg, lower, upper

    def optimize_cached(self, state: ClusterState, ctx: OptimizationContext,
                        prev_goals: Sequence[Goal], cache=None):
        """Shed over-upper brokers, then fill under-lower ones, as
        progress-gated phases of a sweep loop.  The bounds pivot on the
        alive-broker average count, which moves do not change, so they
        are computed once."""
        avg = alive_mean(state, S.broker_replica_count(state).float())
        lower, upper = _count_bounds(avg, self.pct_margin)
        dest_ok = new_broker_dest_mask(
            state, ctx.broker_dest_ok & state.broker_alive)
        w_static = self._weights(state)
        base_movable = replica_static_ok(state, ctx) & (w_static > 0.0)

        def phase(fill: bool):
            def body(st, cache):
                counts = self._counts(cache)
                accept = compose_move_acceptance(prev_goals, st, ctx, cache)
                mt_d, mt_s = move_commit_terms(prev_goals, st, ctx, cache)
                if fill:
                    src_ok, excess = counts > avg, counts - lower
                    dest = dest_ok & (counts < lower)
                    wide = mt_d is not None
                else:
                    src_ok, excess = counts > upper, counts - upper
                    dest = dest_ok & (counts + 1 <= upper)
                    wide = mt_d is not None or dest_side_only(prev_goals)
                cand_r, cand_d, cand_v = kernels.move_round(
                    st, w_static, src_ok, excess, base_movable, dest,
                    upper - counts, accept, -counts, ctx.partition_replicas,
                    strict_allowance=fill, cache=cache,
                    sc_rows=shed_rows(cache, self._weight_rows(st, cache),
                                      src_ok, excess, strict=fill),
                    per_src_k=8 if wide else 1,
                    dest_terms=mt_d, src_terms=mt_s,
                    dest_stack_headroom=avg - counts)
                st, cache = kernels.commit_moves_cached(st, cache, cand_r,
                                                        cand_d, cand_v)
                return st, cache, torch.any(cand_v)
            return body

        def over_exists(st, cache):
            return torch.any(st.broker_alive & (self._counts(cache) > upper))

        def under_exists(st, cache):
            return torch.any(st.broker_alive & dest_ok
                             & (self._counts(cache) < lower))

        return run_phase_sweeps(
            state, [(phase(False), over_exists), (phase(True), under_exists)],
            self.rounds_for(ctx), table_slots=ctx.table_slots, ctx=ctx,
            cache=ensure_full_cache(state, ctx, cache))

    def no_work(self, state, ctx, cache):
        """Zero violated brokers makes the goal an identity."""
        return ~torch.any(self.violated_brokers(state, ctx, cache))

    def accept_move(self, state, ctx, cache, replica, dest_broker):
        """Strict band when both ends are within it, else the destination
        must not end above the source; a zero-weight move (a follower
        under the leader-count goal) is always acceptable."""
        counts, _, lower, upper = self._bounds(state, cache)
        src = state.replica_broker[replica].long()
        dest_broker = dest_broker.long()
        w = self._weights(state)[replica]
        strict = ((counts[dest_broker] + w <= upper)
                  & (counts[src] - w >= lower))
        relaxed = counts[dest_broker] + w <= counts[src]
        ok_before = (counts[src] >= lower) & (counts[dest_broker] <= upper)
        return (_ones(replica.shape, dest_broker.shape, device=w.device)
                & ((w == 0) | torch.where(ok_before, strict, relaxed)))

    def accept_swap(self, state, ctx, cache, out_replica, in_replica):
        """An exchange of equal weights keeps every count; otherwise both
        directions must pass accept_move."""
        w = self._weights(state)
        same = w[out_replica] == w[in_replica]
        b_out = state.replica_broker[out_replica]
        b_in = state.replica_broker[in_replica]
        both = (self.accept_move(state, ctx, cache, out_replica, b_in)
                & self.accept_move(state, ctx, cache, in_replica, b_out))
        return same | both

    def move_headroom_terms(self, state, ctx, cache):
        """Each arrival adds its weight to the destination's count,
        bounded by upper - count; each departure erodes count - lower."""
        counts, _, lower, upper = self._bounds(state, cache)
        return [(self.count_key, self._weights(state), upper - counts,
                 counts - lower)]

    def leadership_headroom_terms(self, state, ctx, cache):
        return []                # plain replica counts ignore leadership

    def violated_brokers(self, state, ctx, cache):
        counts, _, lower, upper = self._bounds(state, cache)
        return state.broker_alive & ((counts > upper) | (counts < lower))

    def stats_not_worse(self, before, after):
        return after.replica_count_std <= before.replica_count_std + 1e-6


class LeaderReplicaDistributionGoal(ReplicaDistributionGoal):
    """Even leader counts: a mean-seeking leadership sweep, then transfers,
    leader-replica moves and floor-unblocking refuels."""

    name = "LeaderReplicaDistributionGoal"
    count_key = "leadcount"

    def _weights(self, state: ClusterState) -> torch.Tensor:
        return (state.replica_valid
                & state.replica_is_leader).to(torch.float32)

    def _counts(self, cache) -> torch.Tensor:
        return cache.leader_count.to(torch.float32)

    def optimize_cached(self, state: ClusterState, ctx: OptimizationContext,
                        prev_goals: Sequence[Goal], cache=None):
        """Whole-cluster re-election toward the mean first, then the
        per-broker phases: transfers, leader-replica moves, and a refuel
        phase capped at two rounds per sweep."""
        from cruise_control_tpu_torch.analyzer.leadership import (
            mean_bounds, run_sweep_threaded)

        def _upper_of(st, W):
            _, up = _count_bounds(alive_mean(st, W), self.pct_margin)
            return up.reshape(1).expand(st.num_brokers).contiguous()

        state, sweep_rounds, cache, sweep_conv = run_sweep_threaded(
            state, ctx, prev_goals, cache,
            measure=lambda cache: cache.leader_count.to(torch.float32),
            value_r=torch.ones(state.num_replicas, device=state.device),
            bounds=mean_bounds(_upper_of), improve_gate=True,
            max_rounds=128,
            # same-deficit receivers tie-break toward low bytes-in
            dest_tiebreak=lambda cache: -cache.leader_bytes_in)
        note_rounds(sweep_rounds, converged_at=sweep_conv)

        avg = alive_mean(state, S.broker_leader_count(state).float())
        lower, upper = _count_bounds(avg, self.pct_margin)
        base_movable = replica_static_ok(state, ctx)
        dest_ok = new_broker_dest_mask(
            state, ctx.broker_dest_ok & state.broker_alive)
        neg = torch.full((), kernels.NEG, device=state.device)
        cpu, nwo = int(Resource.CPU), int(Resource.NW_OUT)

        def bonus_util_rows(st, cache):
            """[B, S] CPU + NW_OUT leadership bonus per slot in
            utilization units (float32)."""
            cap = torch.clamp_min(st.broker_capacity, 1e-9)
            return (cache.table_bonus[:, :, cpu] / cap[:, None, cpu]
                    + cache.table_bonus[:, :, nwo] / cap[:, None, nwo])

        def leader_rows(st, cache, rows_ok, util_sign):
            bonus = (st.replica_valid & st.replica_is_leader).float()
            rank_rows = torch.where(
                cache.table_ok & cache.table_leader & rows_ok[:, None],
                util_sign * bonus_util_rows(st, cache), neg)
            return bonus, rank_rows, cache.table_leader.float()

        def phase_transfer(st, cache):
            counts = self._counts(cache)
            accept = compose_leadership_acceptance(prev_goals, st, ctx,
                                                   cache)

            def accept_all(src_r, dst_r):
                db = st.replica_broker[dst_r].long()
                return (counts[db] + 1 <= upper) & accept(src_r, dst_r)

            # sheds ranked by the SMALLEST resource bonus: cheap handoffs
            # are the ones the prior goals' band floors still accept
            bonus, rank_rows, value_rows = leader_rows(st, cache,
                                                       counts > upper, -1.0)
            lt_d, lt_s = leadership_commit_terms(prev_goals, st, ctx, cache)
            cand_r, cand_f, cand_v = kernels.leadership_round(
                st, bonus, counts - upper, base_movable,
                ctx.broker_leader_ok, upper - counts, accept_all, -counts,
                ctx.partition_replicas, cache=cache, bonus_rows=rank_rows,
                value_rows=value_rows, dest_terms=lt_d, src_terms=lt_s,
                dest_stack_headroom=avg - counts)
            st, cache = kernels.commit_leadership_cached(
                st, cache, cand_r, cand_f, cand_v, donate=True)
            return st, cache, torch.any(cand_v)

        def phase_refuel(st, cache):
            """Pull high-bonus leaderships from in-band donors INTO
            floor-blocked over-count brokers, so that their next sheds
            unlock."""
            counts = self._counts(cache)
            blocked = st.broker_alive & (counts > upper)
            accept = compose_leadership_acceptance(prev_goals, st, ctx,
                                                   cache)

            def accept_all(src_r, dst_r):
                db = st.replica_broker[dst_r].long()
                return blocked[db] & accept(src_r, dst_r)

            donor = st.broker_alive & (counts - 1 >= lower) & ~blocked
            bonus, rank_rows, value_rows = leader_rows(st, cache, donor, 1.0)
            lt_d, lt_s = leadership_commit_terms(prev_goals, st, ctx, cache)
            cand_r, cand_f, cand_v = kernels.leadership_round(
                st, bonus, counts - lower, base_movable,
                ctx.broker_leader_ok & blocked,
                torch.full((st.num_brokers,), float("inf"),
                           device=st.device),
                accept_all,
                torch.where(blocked, 1.0, 0.0).to(torch.float32),
                ctx.partition_replicas, cache=cache, bonus_rows=rank_rows,
                value_rows=value_rows, dest_terms=lt_d, src_terms=lt_s,
                escalate=False)
            st, cache = kernels.commit_leadership_cached(
                st, cache, cand_r, cand_f, cand_v, donate=True)
            return st, cache, torch.any(cand_v)

        def phase_move(st, cache):
            counts = self._counts(cache)
            w = (st.replica_valid & st.replica_is_leader).float()
            accept = compose_move_acceptance(prev_goals, st, ctx, cache)
            mt_d, mt_s = move_commit_terms(prev_goals, st, ctx, cache)
            cand_r, cand_d, cand_v = kernels.move_round(
                st, w, counts > upper, counts - upper,
                base_movable & (w > 0.0),
                dest_ok & ctx.broker_leader_ok & (counts + 1 <= upper),
                upper - counts, accept, -counts, ctx.partition_replicas,
                cache=cache,
                sc_rows=shed_rows(cache, cache.table_leader.float(),
                                  counts > upper, counts - upper),
                per_src_k=8 if mt_d is not None else 1,
                dest_terms=mt_d, src_terms=mt_s,
                dest_stack_headroom=avg - counts)
            st, cache = kernels.commit_moves_cached(st, cache, cand_r,
                                                    cand_d, cand_v)
            return st, cache, torch.any(cand_v)

        def over_exists(st, cache):
            return torch.any(st.broker_alive & (self._counts(cache) > upper))

        return run_phase_sweeps(
            state, [(phase_transfer, over_exists),
                    (phase_move, over_exists),
                    (phase_refuel, over_exists, 2)],
            self.rounds_for(ctx), table_slots=ctx.table_slots, ctx=ctx,
            cache=ensure_full_cache(state, ctx, cache))

    def no_work(self, state, ctx, cache):
        """Never skipped: the mean-seeking pre-sweep rebalances toward the
        average even when no broker violates the band."""
        return None

    def accept_leadership(self, state, ctx, cache, src_replica, dest_replica):
        counts, _, lower, upper = self._bounds(state, cache)
        dest = state.replica_broker[dest_replica].long()
        src = state.replica_broker[src_replica].long()
        strict = (counts[dest] + 1 <= upper) & (counts[src] - 1 >= lower)
        relaxed = counts[dest] + 1 <= counts[src]
        ok_before = (counts[src] >= lower) & (counts[dest] <= upper)
        return torch.where(ok_before, strict, relaxed)

    def leadership_headroom_terms(self, state, ctx, cache):
        """Each transfer adds one leader at the destination broker and
        removes one at the source."""
        counts, _, lower, upper = self._bounds(state, cache)
        ones = torch.ones(state.num_replicas, device=state.device)
        return [("leadcount", ones, upper - counts, counts - lower)]

    def stats_not_worse(self, before, after):
        return after.leader_count_std <= before.leader_count_std + 1e-6



def mover_weights(num_replicas: int, salt: int, device) -> torch.Tensor:
    """f32[R] the topic goal's mover weights, 1 + 0.25 x a salted jitter.
    A jitter is a multiple of 2**-24 in [0, 1), so its product with 0.25
    is exact and one rounding and two give the same sum: whether the
    reference's compiled round contracts it into an FMA cannot show."""
    return 1.0 + 0.25 * kernels.salted_jitter(num_replicas, salt,
                                              device=device)

class TopicReplicaDistributionGoal(Goal):
    """Even per-topic replica counts."""

    name = "TopicReplicaDistributionGoal"

    def __init__(self, max_rounds: int = 64, balance_pct_margin: float = 1.8):
        # default topic balance pct is 3.0 -> (3-1)*0.9 = 1.8
        self.max_rounds = max_rounds
        self.pct_margin = balance_pct_margin

    def _bounds(self, state: ClusterState, topic_counts: torch.Tensor):
        """(lower f32[T], upper f32[T]) around the alive-broker average."""
        alive = state.broker_alive
        totals = ops.sum_f32(topic_counts * alive[:, None], 0)
        avg = totals / torch.clamp_min(torch.sum(alive), 1)
        upper = torch.ceil(torch.maximum(avg * (1 + self.pct_margin),
                                         avg + 1))
        lower = torch.floor(torch.clamp_min(
            torch.minimum(avg * (1 - self.pct_margin), avg - 1), 0.0))
        return lower, upper

    def optimize_cached(self, state: ClusterState, ctx: OptimizationContext,
                        prev_goals: Sequence[Goal], cache=None):
        """Forced-move rounds of the replicas in over-bound (broker, topic)
        cells, single-commit per destination (no headroom terms)."""
        salts = itertools.count()

        def round_body(st: ClusterState, cache):
            salt = next(salts)           # the loop's round counter
            tc = cache.broker_topic_count.to(torch.float32)          # [B,T]
            _, upper = self._bounds(st, tc)
            topic_of_r = st.partition_topic[st.replica_partition.long()].long()
            excess_r = tc[st.replica_broker.long(), topic_of_r] \
                - upper[topic_of_r]
            # a mover whose topic is at its bound on every eligible
            # destination would win its broker's candidacy forever
            dest_ok_b = ctx.broker_dest_ok & st.broker_alive
            topic_has_dest = torch.any(
                dest_ok_b[:, None] & (tc + 1 <= upper[None, :]), 0)   # [T]
            movable = (st.replica_valid & ~ctx.replica_excluded
                       & ctx.replica_movable & ~st.replica_offline
                       & (excess_r > 0) & topic_has_dest[topic_of_r])
            accept = compose_move_acceptance(prev_goals, st, ctx, cache)

            def accept_all(r, d):
                t = st.partition_topic[st.replica_partition[r].long()].long()
                return (tc[d.long(), t] + 1 <= upper[t]) & accept(r, d)

            # salted jitter on the otherwise equal mover weights: a vetoed
            # mover must not win its broker's slot every round
            w = mover_weights(st.num_replicas, salt, st.device)
            counts = cache.replica_count.to(torch.float32)
            cand_r, cand_d, cand_v = kernels.forced_move_round(
                st, movable, w, dest_ok_b, accept_all, -counts,
                ctx.partition_replicas, cache=cache)
            st, cache = kernels.commit_moves_cached(st, cache, cand_r,
                                                    cand_d, cand_v)
            return st, cache, bool(torch.any(cand_v))

        def work_exists(st, cache):
            return torch.any(self.violated_brokers(st, ctx, cache))

        return run_rounds(state, ensure_full_cache(state, ctx, cache),
                          round_body, work_exists, self.rounds_for(ctx))

    def no_work(self, state, ctx, cache):
        """The loop's work gate: no over-bound cell, 0 rounds."""
        return ~torch.any(self.violated_brokers(state, ctx, cache))

    def accept_move(self, state, ctx, cache, replica, dest_broker):
        tc = cache.broker_topic_count.to(torch.float32)
        _, upper = self._bounds(state, tc)
        t = state.partition_topic[state.replica_partition[replica].long()
                                  ].long()
        src = state.replica_broker[replica].long()
        dest_broker = dest_broker.long()
        strict = tc[dest_broker, t] + 1 <= upper[t]
        relaxed = tc[dest_broker, t] + 1 <= tc[src, t]
        ok_before = tc[dest_broker, t] <= upper[t]
        return torch.where(ok_before, strict, relaxed)

    def accept_swap(self, state, ctx, cache, out_replica, in_replica):
        """Same-topic exchanges keep per-topic counts; mixed topics fall
        back to the per-direction move checks."""
        t = state.partition_topic[state.replica_partition.long()]
        same = t[out_replica] == t[in_replica]
        b_out = state.replica_broker[out_replica]
        b_in = state.replica_broker[in_replica]
        both = (self.accept_move(state, ctx, cache, out_replica, b_in)
                & self.accept_move(state, ctx, cache, in_replica, b_out))
        return same | both

    def leadership_headroom_terms(self, state, ctx, cache):
        return []          # per-topic replica counts ignore leadership

    # move_headroom_terms stays None (inherited): the bound is per
    # (broker, topic) cell, which a scalar per-destination term cannot
    # express, so rounds behind this goal stay single-commit for moves.

    def violated_brokers(self, state, ctx, cache):
        tc = cache.broker_topic_count.to(torch.float32)
        _, upper = self._bounds(state, tc)
        return state.broker_alive & torch.any(tc > upper[None, :], 1)

    def stats_not_worse(self, before, after):
        return (after.topic_replica_count_std
                <= before.topic_replica_count_std + 0.3)
