"""Intra-broker (JBOD) disk goals (port of cruise_control_tpu/analyzer/
goals/intra_broker.py).

`IntraBrokerDiskCapacityGoal` (hard: no alive logdir above its capacity
threshold) and `IntraBrokerDiskUsageDistributionGoal` (soft: each logdir
within a band around its broker's average fill).  Both move replicas
between the logdirs of their own broker, so broker-level loads and the
other goals' acceptance are untouched.

Each round the most over-loaded logdir of every broker sheds its
best-scoring replica to the broker's least-loaded alive logdir, all
brokers at once (`_disk_move_round`: three per-segment argmaxes, K9 on
the card, and one scatter).  The reference's `lax.while_loop` is a host
loop with the same predicate: the last round committed, rounds below
`rounds_for(ctx)`, and a logdir over (or out of band).  Like the
reference, the goals implement `optimize` only, report no rounds, and
hand the optimizer no cache (it rebuilds one).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from cruise_control_tpu_torch import ops
from cruise_control_tpu_torch.analyzer import kernels
from cruise_control_tpu_torch.analyzer.context import OptimizationContext
from cruise_control_tpu_torch.analyzer.goals.base import Goal
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model.state import ClusterState


def _disk_move_round(st: ClusterState, ctx: OptimizationContext,
                     over_amount: torch.Tensor, dest_bound: torch.Tensor
                     ) -> Tuple[ClusterState, torch.Tensor]:
    """One round: every broker whose worst logdir is over moves one
    replica to its best logdir.  `over_amount` f32[D] is how much each
    logdir wants to shed (<= 0: balanced), `dest_bound` f32[D] the most a
    destination may hold after the move.  Returns (state, any committed
    0-d bool)."""
    num_b = st.num_brokers
    num_d = st.num_disks
    dload = S.disk_load(st)
    w = ctx_replica_disk_load(st)

    # the worst over-loaded logdir of each broker
    src_disk, _, src_has = kernels.per_segment_argmax(
        over_amount, st.disk_broker, num_b,
        st.disk_alive & (over_amount > 0))
    # the least-loaded alive logdir of each broker
    dest_disk, _, dest_has = kernels.per_segment_argmax(
        -dload, st.disk_broker, num_b, st.disk_alive)
    src_safe = torch.clamp_min(src_disk, 0).long()
    dest_safe = torch.clamp_min(dest_disk, 0).long()

    # the candidate replica on each logdir
    on_disk = torch.clamp_min(st.replica_disk, 0).long()
    movable = (st.replica_valid & (st.replica_disk >= 0)
               & ~ctx.replica_excluded)
    score = kernels.shed_score(w, over_amount[on_disk])
    r_of_disk, _, r_has = kernels.per_segment_argmax(score, on_disk, num_d,
                                                     movable)

    cand_r = r_of_disk[src_safe]                       # i32[B]
    cand_r_safe = torch.clamp_min(cand_r, 0).long()
    fits = dload[dest_safe] + w[cand_r_safe] <= dest_bound[dest_safe]
    valid = (src_has & dest_has & r_has[src_safe] & (cand_r >= 0)
             & (dest_safe != src_safe) & fits)
    st = S.apply_disk_moves(st, cand_r_safe, dest_safe, valid)
    return st, torch.any(valid)


def ctx_replica_disk_load(st: ClusterState) -> torch.Tensor:
    """f32[R] — each replica's follower-role DISK load."""
    return st.replica_base_load[:, Resource.DISK]


def _run(state: ClusterState, round_body, work_exists,
         max_rounds: int) -> ClusterState:
    """The reference's while_loop on the host: rounds run while the last
    one committed, the budget allows and `work_exists(state)` holds."""
    rounds = 0
    progressed = True
    while progressed and rounds < max_rounds and bool(work_exists(state)):
        state, committed = round_body(state)
        progressed = bool(committed)
        rounds += 1
    return state


def _per_broker_any(flags: torch.Tensor, st: ClusterState) -> torch.Tensor:
    """bool[B] — brokers with a flagged alive logdir."""
    return (ops.segment_sum(flags.to(torch.int32), st.disk_broker,
                            st.num_brokers) > 0) & st.broker_alive


class IntraBrokerDiskCapacityGoal(Goal):
    """Hard: every alive logdir under capacity * threshold."""

    name = "IntraBrokerDiskCapacityGoal"
    is_hard = True

    def __init__(self, max_rounds: int = 64,
                 capacity_threshold: float = 0.8):
        self.max_rounds = max_rounds
        self.capacity_threshold = capacity_threshold

    def _limits(self, st: ClusterState) -> torch.Tensor:
        return st.disk_capacity * self.capacity_threshold

    def optimize(self, state: ClusterState, ctx: OptimizationContext,
                 prev_goals: Sequence[Goal]) -> ClusterState:
        limit = self._limits(state)

        def round_body(st):
            return _disk_move_round(st, ctx, S.disk_load(st) - limit, limit)

        def over_any(st):
            return torch.any(st.disk_alive & (S.disk_load(st) > limit))

        return _run(state, round_body, over_any, self.rounds_for(ctx))

    def violated_brokers(self, state, ctx, cache):
        over = state.disk_alive & (S.disk_load(state) > self._limits(state))
        return _per_broker_any(over, state)


class IntraBrokerDiskUsageDistributionGoal(Goal):
    """Soft: logdir usage within ±margin of the broker's average fill."""

    name = "IntraBrokerDiskUsageDistributionGoal"
    is_hard = False

    def __init__(self, max_rounds: int = 64, balance_margin: float = 0.1):
        self.max_rounds = max_rounds
        self.balance_margin = balance_margin

    def _bounds(self, st: ClusterState):
        """(disk load, upper, lower) f32[D]: each logdir's band around its
        broker's average fill over alive logdirs."""
        dload = S.disk_load(st)
        alive = st.disk_alive
        zero = torch.zeros((), device=dload.device)
        per_b_load = ops.segment_sum(torch.where(alive, dload, zero),
                                     st.disk_broker, st.num_brokers)
        per_b_cap = ops.segment_sum(torch.where(alive, st.disk_capacity,
                                                zero),
                                    st.disk_broker, st.num_brokers)
        avg_fill = per_b_load / torch.clamp_min(per_b_cap, 1e-9)
        target = avg_fill[st.disk_broker.long()] * st.disk_capacity
        upper = (target * (1 + self.balance_margin)
                 + 1e-6 * torch.clamp_min(st.disk_capacity, 1.0))
        lower = target * (1 - self.balance_margin)
        return dload, upper, lower

    def optimize(self, state: ClusterState, ctx: OptimizationContext,
                 prev_goals: Sequence[Goal]) -> ClusterState:
        # shedding is driven by the distance above the middle of the
        # band: an under-filled logdir is healed by its most-loaded
        # sibling shedding toward it, since the round always targets the
        # broker's least-loaded logdir

        def round_body(st):
            dload, upper, lower = self._bounds(st)
            return _disk_move_round(st, ctx, dload - (upper + lower) / 2.0,
                                    upper)

        def unbalanced(st):
            dload, upper, lower = self._bounds(st)
            return torch.any(st.disk_alive
                             & ((dload > upper) | (dload < lower)))

        return _run(state, round_body, unbalanced, self.rounds_for(ctx))

    def violated_brokers(self, state, ctx, cache):
        dload, upper, lower = self._bounds(state)
        bad = state.disk_alive & ((dload > upper) | (dload < lower))
        return _per_broker_any(bad, state)
