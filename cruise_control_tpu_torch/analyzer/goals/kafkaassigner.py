"""Kafka-assigner mode goals (port of cruise_control_tpu/analyzer/goals/
kafkaassigner.py): the static-assignment mode of a `kafka_assigner=true`
request, for clusters whose load model is not trusted.

`KafkaAssignerEvenRackAwareGoal` is the rack-awareness goal with a
fewest-replicas destination preference, followed by a replica-count
evening pass at zero margin whose every move must keep passing this
goal's rack acceptance.  `KafkaAssignerDiskUsageDistributionGoal`
balances disk fill by swaps only, so per-broker replica counts stay as
they are: every round is a `swap_round` (K10 scores its pair plane on the
card) on the goal's own round cache.
"""
from __future__ import annotations

from typing import Sequence

import torch

from cruise_control_tpu_torch import ops
from cruise_control_tpu_torch.analyzer import kernels
from cruise_control_tpu_torch.analyzer.context import (OptimizationContext,
                                                       make_round_cache)
from cruise_control_tpu_torch.analyzer.goals.base import (
    Goal, compose_swap_acceptance, note_rounds)
from cruise_control_tpu_torch.analyzer.goals.count_distribution import \
    ReplicaDistributionGoal
from cruise_control_tpu_torch.analyzer.goals.rack_aware import RackAwareGoal
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model.state import ClusterState


class KafkaAssignerEvenRackAwareGoal(RackAwareGoal):
    """Rack spreading with even replica counts: the rack-aware rounds
    (fewest replicas first), then a zero-margin count-evening pass."""

    name = "KafkaAssignerEvenRackAwareGoal"
    is_hard = True

    def _dest_pref(self, st: ClusterState, cache) -> torch.Tensor:
        return -cache.replica_count.to(torch.float32)

    def optimize_cached(self, state: ClusterState, ctx: OptimizationContext,
                        prev_goals: Sequence[Goal], cache=None):
        state, cache = super().optimize_cached(state, ctx, prev_goals,
                                               cache)
        evener = ReplicaDistributionGoal(max_rounds=self.max_rounds,
                                         balance_pct_margin=0.0)
        return evener.optimize_cached(state, ctx,
                                      (self,) + tuple(prev_goals), cache)


class KafkaAssignerDiskUsageDistributionGoal(Goal):
    """Swap-based disk balancing that keeps per-broker replica counts."""

    name = "KafkaAssignerDiskUsageDistributionGoal"
    is_hard = False

    def __init__(self, max_rounds: int = 64, balance_margin: float = 0.1):
        self.max_rounds = max_rounds
        #: brokers within avg * (1 ± margin) are balanced
        self.balance_margin = balance_margin

    def _bounds(self, st: ClusterState, util: torch.Tensor):
        """(pct f32[B], avg 0-d) disk fill from a broker DISK load."""
        cap = st.broker_capacity[:, Resource.DISK]
        zero = torch.zeros((), device=util.device)
        pct = torch.where(cap > 0, util / torch.clamp_min(cap, 1e-9), zero)
        alive = st.broker_alive
        avg = (ops.sum_f32(torch.where(alive, pct, zero))
               / torch.clamp_min(torch.sum(alive), 1))
        return pct, avg

    def optimize(self, state: ClusterState, ctx: OptimizationContext,
                 prev_goals: Sequence[Goal]) -> ClusterState:
        disk = int(Resource.DISK)

        def round_body(st: ClusterState, cache):
            cap = st.broker_capacity[:, disk]
            util = cache.broker_load[:, disk]
            pct, avg = self._bounds(st, util)
            hot = st.broker_alive & (pct > avg * (1 + self.balance_margin))
            cold = (st.broker_alive & ctx.broker_dest_ok
                    & (pct < avg * (1 - self.balance_margin)))
            movable = (st.replica_valid & ~ctx.replica_excluded
                       & ctx.replica_movable & ~st.replica_offline)
            accept = compose_swap_acceptance(prev_goals, st, ctx, cache)
            # the same relative fill everywhere; no band gate (the
            # reference's swap bounds are convergence bounds: both ends
            # are outside the band by selection).  util - avg * cap is one
            # fused multiply-add in the reference's compiled round.
            out_r, in_r, cold_idx, valid = kernels.swap_round(
                st, cache.replica_load[:, disk], movable, hot, cold, util,
                avg * cap, accept, ctx.partition_replicas, cache=cache,
                w_rows=cache.table_load[:, :, disk],
                dev_u=ops.fma_f32(-avg, cap, util))
            st, cache = kernels.commit_swaps_cached(st, cache, out_r, in_r,
                                                    cold_idx, valid)
            return st, cache, bool(torch.any(valid))

        cache = make_round_cache(state, ctx.table_slots, ctx)
        rounds = 0
        progressed = True
        while progressed and rounds < self.rounds_for(ctx):
            state, cache, progressed = round_body(state, cache)
            rounds += 1
        note_rounds(rounds)
        return state

    def violated_brokers(self, state, ctx, cache):
        pct, avg = self._bounds(state, cache.broker_load[:, Resource.DISK])
        return state.broker_alive & (
            (pct > avg * (1 + self.balance_margin))
            | (pct < avg * (1 - self.balance_margin)))
