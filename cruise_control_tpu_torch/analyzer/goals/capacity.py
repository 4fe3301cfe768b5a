"""Capacity goals, hard (port of cruise_control_tpu/analyzer/goals/
capacity.py): no alive broker may exceed capacity x capacity-threshold
for a resource (`CapacityGoal` and its four resources), or the maximum
replica count (`ReplicaCapacityGoal`).

The round loops are host loops of the reference's rounds: for CPU and
NW_OUT a leadership sweep first and a leadership round in each round,
then a move round off the over-limit brokers.
"""
from __future__ import annotations

from typing import Sequence

import torch

from cruise_control_tpu_torch.analyzer import kernels
from cruise_control_tpu_torch.analyzer.context import (OptimizationContext,
                                                       ensure_full_cache,
                                                       replica_static_ok)
from cruise_control_tpu_torch.analyzer.goals.base import (
    Goal, compose_leadership_acceptance, compose_move_acceptance,
    dest_side_only, leader_shed_rows, leadership_commit_terms,
    move_commit_terms, note_rounds, run_rounds, shed_rows)
from cruise_control_tpu_torch.common.resources import (RESOURCE_GOAL_NAMES,
                                                       Resource)
from cruise_control_tpu_torch.model.state import ClusterState


class CapacityGoal(Goal):
    """Keep one resource's broker load under capacity x threshold."""

    resource: Resource = Resource.DISK
    is_hard = True
    source_side_acceptance = False   # acceptance checks the destination only

    def __init__(self, max_rounds: int = 64):
        self.max_rounds = max_rounds
        self.name = (RESOURCE_GOAL_NAMES[int(self.resource)]
                     + "CapacityGoal")

    def _limit(self, state: ClusterState, ctx: OptimizationContext):
        res = int(self.resource)
        return state.broker_capacity[:, res] * ctx.capacity_threshold[res]

    def optimize_cached(self, state: ClusterState, ctx: OptimizationContext,
                        prev_goals: Sequence[Goal], cache=None):
        res = int(self.resource)
        leadership_helps = self.resource in (Resource.NW_OUT, Resource.CPU)
        multi_k = 4 if dest_side_only(prev_goals) else 1
        # per-round stacking bound: fill a destination at most to the
        # balance-band midpoint per round
        mid_w = ((ctx.balance_upper_pct[res] + ctx.balance_lower_pct[res])
                 / 2.0 * state.broker_capacity[:, res])
        bonus = (state.partition_leader_bonus[
            state.replica_partition.long(), res] * state.replica_valid)
        base_movable = replica_static_ok(state, ctx)

        if leadership_helps:
            # whole-cluster re-election first: sheds the leadership-carried
            # share of over-limit load; the rounds below handle the rest
            from cruise_control_tpu_torch.analyzer.leadership import (
                VALUE_WEIGHTED_SELECT_JITTER, limit_bounds,
                run_sweep_threaded)
            state, sweep_rounds, cache, sweep_conv = run_sweep_threaded(
                state, ctx, prev_goals, cache,
                measure=lambda cache: cache.broker_load[:, res],
                value_r=bonus,
                bounds=limit_bounds(self._limit(state, ctx), mid_w),
                improve_gate=False,
                select_jitter=VALUE_WEIGHTED_SELECT_JITTER)
            note_rounds(sweep_rounds, converged_at=sweep_conv)

        def round_body(st: ClusterState, cache):
            committed = False
            if leadership_helps:
                limit = self._limit(st, ctx)
                W = cache.broker_load[:, res]
                accept = compose_leadership_acceptance(prev_goals, st, ctx,
                                                       cache)

                def accept_all(src_r, dst_r):
                    db = st.replica_broker[dst_r].long()
                    src_b = src_r.expand(torch.broadcast_shapes(
                        src_r.shape, dst_r.shape))
                    return ((W[db] + bonus[src_b] <= limit[db])
                            & accept(src_r, dst_r))

                value_rows = cache.table_bonus[:, :, res]
                lt_d, lt_s = leadership_commit_terms(prev_goals, st, ctx,
                                                     cache)
                cand_r, cand_f, cand_v = kernels.leadership_round(
                    st, bonus, W - limit, base_movable, ctx.broker_leader_ok,
                    limit - W, accept_all,
                    -W / torch.clamp_min(limit, 1e-9),
                    ctx.partition_replicas, cache=cache,
                    bonus_rows=leader_shed_rows(cache, value_rows,
                                                W > limit, W - limit),
                    value_rows=value_rows, dest_terms=lt_d, src_terms=lt_s,
                    dest_stack_headroom=mid_w - W)
                st, cache = kernels.commit_leadership_cached(
                    st, cache, cand_r, cand_f, cand_v, donate=True)
                committed = bool(torch.any(cand_v))

            limit = self._limit(st, ctx)
            W = cache.broker_load[:, res]
            w = cache.replica_load[:, res]
            accept = compose_move_acceptance(prev_goals, st, ctx, cache)
            mt_d, mt_s = move_commit_terms(prev_goals, st, ctx, cache)
            cand_r, cand_d, cand_v = kernels.move_round(
                st, w, W > limit, W - limit, base_movable & (w > 0.0),
                ctx.broker_dest_ok & st.broker_alive, limit - W, accept,
                -W / torch.clamp_min(limit, 1e-9), ctx.partition_replicas,
                cache=cache,
                sc_rows=shed_rows(cache, cache.table_load[:, :, res],
                                  W > limit, W - limit),
                per_src_k=4 if mt_d is not None else multi_k,
                dest_terms=mt_d, src_terms=mt_s,
                dest_stack_headroom=mid_w - W, assign_fallback=True)
            st, cache = kernels.commit_moves_cached(st, cache, cand_r,
                                                    cand_d, cand_v)
            return st, cache, committed or bool(torch.any(cand_v))

        def still_violated(st, cache):
            return torch.any((cache.broker_load[:, res]
                              > self._limit(st, ctx)) & st.broker_alive)

        return run_rounds(state, ensure_full_cache(state, ctx, cache),
                          round_body, still_violated, self.rounds_for(ctx))

    def no_work(self, state, ctx, cache):
        """All work is violated-gated (the sweep's and the rounds')."""
        return ~torch.any(self.violated_brokers(state, ctx, cache))

    def accept_move(self, state, ctx, cache, replica, dest_broker):
        """The destination must stay under capacity x threshold."""
        res = int(self.resource)
        limit = self._limit(state, ctx)
        w = cache.replica_load[:, res][replica]
        return (cache.broker_load[:, res][dest_broker] + w
                <= limit[dest_broker])

    def accept_swap(self, state, ctx, cache, out_replica, in_replica):
        """Net-delta form: each side's load changes by the difference of
        the exchanged replicas."""
        res = int(self.resource)
        limit = self._limit(state, ctx)
        W = cache.broker_load[:, res]
        w_out = cache.replica_load[:, res][out_replica]
        w_in = cache.replica_load[:, res][in_replica]
        b_out = state.replica_broker[out_replica].long()
        b_in = state.replica_broker[in_replica].long()
        d = w_out - w_in
        return ((W[b_out] - d <= limit[b_out])
                & (W[b_in] + d <= limit[b_in]))

    def accept_leadership(self, state, ctx, cache, src_replica,
                          dest_replica):
        if self.resource not in (Resource.NW_OUT, Resource.CPU):
            return super().accept_leadership(state, ctx, cache, src_replica,
                                             dest_replica)
        res = int(self.resource)
        limit = self._limit(state, ctx)
        bonus = state.partition_leader_bonus[
            state.replica_partition[src_replica].long(), res]
        dest = state.replica_broker[dest_replica].long()
        return cache.broker_load[:, res][dest] + bonus <= limit[dest]

    def move_headroom_terms(self, state, ctx, cache):
        """Arrivals at d may add up to limit[d] - load[d]."""
        res = int(self.resource)
        return [(f"load{res}", cache.replica_load[:, res],
                 self._limit(state, ctx) - cache.broker_load[:, res],
                 None)]

    def leadership_headroom_terms(self, state, ctx, cache):
        if self.resource not in (Resource.NW_OUT, Resource.CPU):
            return []            # leadership-invariant resources
        res = int(self.resource)
        bonus = (state.partition_leader_bonus[
            state.replica_partition.long(), res] * state.replica_valid)
        return [(f"bonus{res}", bonus,
                 self._limit(state, ctx) - cache.broker_load[:, res],
                 None)]

    def violated_brokers(self, state, ctx, cache):
        res = int(self.resource)
        return state.broker_alive & (
            cache.broker_load[:, res] > self._limit(state, ctx))

    def stats_not_worse(self, before, after):
        """The worst broker must not get worse (it may stay put where
        other goals legitimately filled headroom below the threshold)."""
        res = int(self.resource)
        return (after.util_max[res]
                <= torch.clamp_min(before.util_max[res], 1.0) + 1e-6)


class CpuCapacityGoal(CapacityGoal):
    resource = Resource.CPU


class DiskCapacityGoal(CapacityGoal):
    resource = Resource.DISK


class NetworkInboundCapacityGoal(CapacityGoal):
    resource = Resource.NW_IN


class NetworkOutboundCapacityGoal(CapacityGoal):
    resource = Resource.NW_OUT


class ReplicaCapacityGoal(Goal):
    """Maximum replicas per broker."""

    is_hard = True
    name = "ReplicaCapacityGoal"
    source_side_acceptance = False   # acceptance checks the destination only

    def __init__(self, max_rounds: int = 64):
        self.max_rounds = max_rounds

    def optimize_cached(self, state: ClusterState, ctx: OptimizationContext,
                        prev_goals: Sequence[Goal], cache=None):
        limit = float(ctx.max_replicas_per_broker)
        multi_k = 4 if dest_side_only(prev_goals) else 1
        base_movable = replica_static_ok(state, ctx)
        w = torch.ones(state.num_replicas, device=state.device)

        def round_body(st: ClusterState, cache):
            count = cache.replica_count.to(torch.float32)
            accept = compose_move_acceptance(prev_goals, st, ctx, cache)
            mt_d, mt_s = move_commit_terms(prev_goals, st, ctx, cache)
            alive = st.broker_alive
            avg_count = (torch.sum(count * alive)
                         / torch.clamp_min(torch.sum(alive), 1))
            cand_r, cand_d, cand_v = kernels.move_round(
                st, w, count > limit, count - limit, base_movable,
                ctx.broker_dest_ok & alive, limit - count, accept, -count,
                ctx.partition_replicas, cache=cache,
                sc_rows=shed_rows(cache,
                                  torch.ones_like(cache.table_ok,
                                                  dtype=torch.float32),
                                  count > limit, count - limit),
                per_src_k=4 if mt_d is not None else multi_k,
                dest_terms=mt_d, src_terms=mt_s,
                dest_stack_headroom=avg_count - count,
                assign_fallback=True)
            st, cache = kernels.commit_moves_cached(st, cache, cand_r,
                                                    cand_d, cand_v)
            return st, cache, bool(torch.any(cand_v))

        def over_limit(st, cache):
            return torch.any((cache.replica_count.to(torch.float32) > limit)
                             & st.broker_alive)

        return run_rounds(state, ensure_full_cache(state, ctx, cache),
                          round_body, over_limit, self.rounds_for(ctx))

    def no_work(self, state, ctx, cache):
        """The loop requires an over-limit alive broker."""
        return ~torch.any(self.violated_brokers(state, ctx, cache))

    def accept_move(self, state, ctx, cache, replica, dest_broker):
        ones = torch.ones(torch.broadcast_shapes(replica.shape,
                                                 dest_broker.shape),
                          dtype=torch.bool, device=replica.device)
        return ones & (cache.replica_count[dest_broker] + 1
                       <= ctx.max_replicas_per_broker)

    def accept_swap(self, state, ctx, cache, out_replica, in_replica):
        """A one-for-one exchange leaves both counts unchanged."""
        return torch.ones(torch.broadcast_shapes(out_replica.shape,
                                                 in_replica.shape),
                          dtype=torch.bool, device=out_replica.device)

    def move_headroom_terms(self, state, ctx, cache):
        ones = torch.ones(state.num_replicas, device=state.device)
        hr = (float(ctx.max_replicas_per_broker)
              - cache.replica_count.to(torch.float32))
        return [("count", ones, hr, None)]

    def leadership_headroom_terms(self, state, ctx, cache):
        return []                # transfers move no replicas

    def violated_brokers(self, state, ctx, cache):
        return state.broker_alive & (
            cache.replica_count > ctx.max_replicas_per_broker)
