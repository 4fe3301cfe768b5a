"""Network-shaped soft goals (port of cruise_control_tpu/analyzer/goals/
network.py): `PotentialNwOutGoal` caps each broker's potential outbound
rate (the NW_OUT it would serve as leader of every replica it hosts), and
`LeaderBytesInDistributionGoal` balances the leader-side bytes-in rate
with leadership transfers behind a self-regression gate, and
`PreferredLeaderElectionGoal` (the demote-broker request's goal) hands
each partition's leadership to its first eligible replica.
"""
from __future__ import annotations

from typing import Sequence

import torch

from cruise_control_tpu_torch import ops
from cruise_control_tpu_torch.analyzer import kernels
from cruise_control_tpu_torch.analyzer.context import (OptimizationContext,
                                                       ensure_full_cache,
                                                       leader_nw_in,
                                                       replica_static_ok)
from cruise_control_tpu_torch.analyzer.goals.base import (
    Goal, compose_leadership_acceptance, compose_move_acceptance,
    dest_side_only, leader_shed_rows, leadership_commit_terms,
    move_commit_terms, note_rounds, run_rounds, shed_rows)
from cruise_control_tpu_torch.analyzer.goals.count_distribution import \
    alive_mean
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model.state import ClusterState


class PotentialNwOutGoal(Goal):
    name = "PotentialNwOutGoal"
    source_side_acceptance = False   # caps the destination's potential NW_OUT

    def __init__(self, max_rounds: int = 64):
        self.max_rounds = max_rounds

    def _limit(self, state: ClusterState, ctx: OptimizationContext):
        res = int(Resource.NW_OUT)
        return state.broker_capacity[:, res] * ctx.capacity_threshold[res]

    @staticmethod
    def _leader_role_nw_out(state: ClusterState) -> torch.Tensor:
        return (S.replica_leader_role_load(state)[:, Resource.NW_OUT]
                * state.replica_valid)

    def optimize_cached(self, state: ClusterState, ctx: OptimizationContext,
                        prev_goals: Sequence[Goal], cache=None):
        """Move rounds off over-potential brokers while an alive broker is
        over the limit."""
        # the leader-ROLE load is leadership-independent: loop-invariant
        w = self._leader_role_nw_out(state)
        movable = replica_static_ok(state, ctx) & (w > 0.0)
        nwo = int(Resource.NW_OUT)

        def round_body(st: ClusterState, cache):
            pot = cache.potential_nw_out
            limit = self._limit(st, ctx)
            accept = compose_move_acceptance(prev_goals, st, ctx, cache)

            def accept_all(r, d):
                return (pot[d] + w[r] <= limit[d]) & accept(r, d)

            w_rows = (cache.table_load[:, :, nwo]
                      + torch.where(cache.table_leader,
                                    torch.zeros((), device=st.device),
                                    cache.table_bonus[:, :, nwo]))
            mt_d, mt_s = move_commit_terms(prev_goals, st, ctx, cache)
            cand_r, cand_d, cand_v = kernels.move_round(
                st, w, pot > limit, pot - limit, movable,
                ctx.broker_dest_ok & st.broker_alive, limit - pot,
                accept_all, -pot / torch.clamp_min(limit, 1e-9),
                ctx.partition_replicas, cache=cache,
                sc_rows=shed_rows(cache, w_rows, pot > limit, pot - limit),
                per_src_k=4 if (mt_d is not None
                                or dest_side_only(prev_goals)) else 1,
                dest_terms=mt_d, src_terms=mt_s,
                dest_stack_headroom=alive_mean(st, pot) - pot)
            st, cache = kernels.commit_moves_cached(st, cache, cand_r,
                                                    cand_d, cand_v)
            return st, cache, bool(torch.any(cand_v))

        def work_exists(st, cache):
            return torch.any(self.violated_brokers(st, ctx, cache))

        return run_rounds(state, ensure_full_cache(state, ctx, cache),
                          round_body, work_exists, self.rounds_for(ctx))

    def no_work(self, state, ctx, cache):
        """The loop needs an over-potential alive broker: skippable."""
        return ~torch.any(self.violated_brokers(state, ctx, cache))

    def accept_move(self, state, ctx, cache, replica, dest_broker):
        """Keep destinations under the potential-NW_OUT cap; a replica
        that carries none is always acceptable."""
        w = self._leader_role_nw_out(state)[replica]
        limit = self._limit(state, ctx)
        pot = cache.potential_nw_out
        dest_broker = dest_broker.long()
        return (pot[dest_broker] + w <= limit[dest_broker]) | (w <= 0.0)

    def accept_swap(self, state, ctx, cache, out_replica, in_replica):
        """Net-delta form: a side the exchange improves (or leaves
        untouched) is acceptable even while over the limit."""
        w = self._leader_role_nw_out(state)
        limit = self._limit(state, ctx)
        pot = cache.potential_nw_out
        b_out = state.replica_broker[out_replica].long()
        b_in = state.replica_broker[in_replica].long()
        d = w[out_replica] - w[in_replica]
        ok_out = (pot[b_out] - d <= limit[b_out]) | (d >= 0)
        ok_in = (pot[b_in] + d <= limit[b_in]) | (d <= 0)
        return ok_out & ok_in

    def move_headroom_terms(self, state, ctx, cache):
        """Arrivals add their leader-role NW_OUT to the destination's
        potential, bounded by limit - potential; no source side."""
        return [("potential", self._leader_role_nw_out(state),
                 self._limit(state, ctx) - cache.potential_nw_out, None)]

    def leadership_headroom_terms(self, state, ctx, cache):
        return []        # potential load is leadership-invariant

    def violated_brokers(self, state, ctx, cache):
        return state.broker_alive & (
            cache.potential_nw_out > self._limit(state, ctx))

    def stats_not_worse(self, before, after):
        return (after.potential_nw_out_max
                <= before.potential_nw_out_max * 1.0001 + 1e-3)


class LeaderBytesInDistributionGoal(Goal):
    """Balance per-broker leader bytes-in via leadership transfers."""

    name = "LeaderBytesInDistributionGoal"

    def __init__(self, max_rounds: int = 64, balance_pct_margin: float = 0.09):
        self.max_rounds = max_rounds
        self.pct_margin = balance_pct_margin

    def _bounds(self, state: ClusterState, lbi: torch.Tensor):
        """0-d upper bound: the alive-broker average times 1 + margin."""
        return alive_mean(state, lbi) * (1 + self.pct_margin)

    def _violated_count(self, st: ClusterState, ctx: OptimizationContext,
                        cache) -> int:
        return int(torch.sum(self.violated_brokers(st, ctx, cache)))

    def optimize_cached(self, state: ClusterState, ctx: OptimizationContext,
                        prev_goals: Sequence[Goal], cache=None):
        """The re-election sweep toward the mean, then leadership rounds.
        The sweep, and then each round, is kept only if it did not grow
        this goal's own violated-broker count; a rejected round reverts
        the state and the cache and ends the loop.  Every commit here is
        out of place, so the inputs of a step survive its rejection."""
        from cruise_control_tpu_torch.analyzer.leadership import (
            VALUE_WEIGHTED_SELECT_JITTER, mean_bounds, run_sweep_threaded)

        def _upper_of(st, W):
            return self._bounds(st, W).reshape(1).expand(
                st.num_brokers).contiguous()

        cache = ensure_full_cache(state, ctx, cache)
        v_enter = self._violated_count(state, ctx, cache)
        value_r = (state.replica_base_load[:, Resource.NW_IN]
                   * state.replica_valid)
        swept, sweep_rounds, swept_cache, sweep_conv = run_sweep_threaded(
            state, ctx, prev_goals, cache,
            measure=lambda cache: cache.leader_bytes_in,
            value_r=value_r, bounds=mean_bounds(_upper_of),
            improve_gate=True, max_rounds=128,
            select_jitter=VALUE_WEIGHTED_SELECT_JITTER,
            regress_guard=lambda st, ca: self._violated_count(st, ctx, ca))
        note_rounds(sweep_rounds, converged_at=sweep_conv)
        if self._violated_count(swept, ctx, swept_cache) <= v_enter:
            state, cache = swept, swept_cache

        movable = replica_static_ok(state, ctx)
        nwi = int(Resource.NW_IN)

        def round_body(st: ClusterState, cache):
            lbi = cache.leader_bytes_in
            upper = self._bounds(st, lbi)
            # tracks this goal's own transfers: in-round
            bonus = leader_nw_in(st)
            accept = compose_leadership_acceptance(prev_goals, st, ctx, cache)

            def accept_all(src_r, dst_r):
                db = st.replica_broker[dst_r].long()
                b = bonus[src_r].expand(torch.broadcast_shapes(
                    src_r.shape, dst_r.shape))
                return (lbi[db] + b <= upper) & accept(src_r, dst_r)

            value_rows = torch.where(cache.table_leader,
                                     cache.table_load[:, :, nwi],
                                     torch.zeros((), device=st.device))
            lt_d, lt_s = leadership_commit_terms(prev_goals, st, ctx, cache)
            cand_r, cand_f, cand_v = kernels.leadership_round(
                st, bonus, lbi - upper, movable, ctx.broker_leader_ok,
                upper - lbi, accept_all, -lbi, ctx.partition_replicas,
                cache=cache,
                bonus_rows=leader_shed_rows(cache, value_rows, lbi > upper,
                                            lbi - upper),
                value_rows=value_rows, dest_terms=lt_d, src_terms=lt_s,
                dest_stack_headroom=alive_mean(st, lbi) - lbi)
            st, cache = kernels.commit_leadership_cached(st, cache, cand_r,
                                                         cand_f, cand_v)
            return st, cache, bool(torch.any(cand_v))

        rounds = last_commit = 0
        progressed = True
        while progressed and rounds < self.rounds_for(ctx):
            v0 = self._violated_count(state, ctx, cache)
            st2, cache2, committed = round_body(state, cache)
            ok = self._violated_count(st2, ctx, cache2) <= v0
            if ok:
                state, cache = st2, cache2
            progressed = committed and ok
            rounds += 1
            if progressed:
                last_commit = rounds
        note_rounds(rounds, converged_at=last_commit)
        return state, cache

    def accept_leadership(self, state, ctx, cache, src_replica, dest_replica):
        lbi = cache.leader_bytes_in
        upper = self._bounds(state, lbi)
        dest = state.replica_broker[dest_replica].long()
        src = state.replica_broker[src_replica].long()
        bonus = leader_nw_in(state)[src_replica].expand(
            torch.broadcast_shapes(src_replica.shape, dest_replica.shape))
        strict = lbi[dest] + bonus <= upper
        relaxed = lbi[dest] + bonus <= lbi[src]
        return torch.where(lbi[dest] <= upper, strict, relaxed)

    def accept_move(self, state, ctx, cache, replica, dest_broker):
        """Follower moves carry no leader bytes (always accepted); a
        leader move lands its NW_IN at the destination, which must stay
        under the bound."""
        lbi = cache.leader_bytes_in
        upper = self._bounds(state, lbi)
        w = leader_nw_in(state)[replica].expand(
            torch.broadcast_shapes(replica.shape, dest_broker.shape))
        return (w <= 0.0) | (lbi[dest_broker.long()] + w <= upper)

    def leadership_headroom_terms(self, state, ctx, cache):
        """Each transfer lands the promoted replica's base NW_IN at its
        broker."""
        lbi = cache.leader_bytes_in
        return [("lbi", leader_nw_in(state), self._bounds(state, lbi) - lbi,
                 None)]

    def move_headroom_terms(self, state, ctx, cache):
        """A moved replica keeps its leadership flag, so a leader move
        lands its NW_IN at the destination broker."""
        return self.leadership_headroom_terms(state, ctx, cache)

    def violated_brokers(self, state, ctx, cache):
        lbi = cache.leader_bytes_in
        return state.broker_alive & (lbi > self._bounds(state, lbi))


class PreferredLeaderElectionGoal(Goal):
    """Make the first eligible replica in each partition's original order
    the leader (the demote-broker flow).  One batched pass, no search
    loop."""

    name = "PreferredLeaderElectionGoal"

    def __init__(self, max_rounds: int = 1):
        self.max_rounds = max_rounds

    @staticmethod
    def _elected_leader(state: ClusterState, ctx: OptimizationContext):
        """(has_candidate bool[P], chosen int64[P]): per partition the
        FIRST replica in ctx.partition_replicas order whose broker is
        alive, leadership-eligible and not demoted, and which is not
        offline.  Shared by optimize and violated_brokers, so the two
        never disagree."""
        rows = ctx.partition_replicas
        rows_safe = torch.clamp_min(rows, 0).long()
        broker = state.replica_broker[rows_safe].long()
        ok = ((rows >= 0) & state.broker_alive[broker]
              & ctx.broker_leader_ok[broker]
              & ~state.replica_offline[rows_safe]
              & ~state.broker_demoted[broker])
        has_candidate = torch.any(ok, 1)
        first = torch.argmax(ok.to(torch.int8), 1)
        chosen = torch.gather(rows_safe, 1, first[:, None])[:, 0]
        return has_candidate, chosen

    def _transfers(self, state, ctx):
        """(current leader int64[P] (-1: none), chosen, bool[P] to
        transfer)."""
        has_candidate, chosen = self._elected_leader(state, ctx)
        cur_leader = S.partition_leader_replica(state).long()
        bad = has_candidate & (cur_leader >= 0) & (chosen != cur_leader)
        return cur_leader, chosen, bad

    def optimize(self, state: ClusterState, ctx: OptimizationContext,
                 prev_goals: Sequence[Goal]) -> ClusterState:
        cur_leader, chosen, eligible = self._transfers(state, ctx)
        return S.apply_leadership_transfers(
            state, torch.clamp_min(cur_leader, 0), chosen, eligible)

    def violated_brokers(self, state, ctx, cache):
        cur_leader, _, bad = self._transfers(state, ctx)
        broker_of_leader = state.replica_broker[torch.clamp_min(cur_leader,
                                                                0)]
        return ops.segment_sum(bad.to(torch.int32), broker_of_leader,
                               state.num_brokers) > 0
