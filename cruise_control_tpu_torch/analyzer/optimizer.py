"""Multi-goal optimizer orchestration (port of cruise_control_tpu/
analyzer/optimizer.py).

Goals run in priority order, each goal's actions must be accepted by
every previously-optimized goal, per-goal statistics must not regress on
a healthy cluster, and the initial -> final placement diff becomes the
proposal set.  The reference fuses this sequence into a few jitted
programs; here it is a host-driven sequence of the same steps: the
pre-program (stats and violated counts before, input validity, joint
pre-balance), goal segments (float refresh at segment entry, then per
goal the entry count, the no-work skip, the search, the fresh stats, the
own count and the regression flag) and the post sweep.

Self-healing runs first when the model carries offline replicas (dead
brokers, broken logdirs): `heal_offline_replicas` moves every one of them
to an alive broker with capacity headroom, table-less, before the
pre-balance.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from cruise_control_tpu_torch.analyzer import kernels as K
from cruise_control_tpu_torch.analyzer.context import (
    BalancingConstraint, OptimizationContext, OptimizationOptions,
    ensure_full_cache, make_context, make_round_cache,
    refresh_float_aggregates, table_width)
from cruise_control_tpu_torch.analyzer.goals import base as goals_base
from cruise_control_tpu_torch.analyzer.goals.base import (Goal,
                                                          OptimizationFailure)
from cruise_control_tpu_torch.analyzer.proposals import (ExecutionProposal,
                                                         diff_proposals_host)
from cruise_control_tpu_torch.common.resources import (RESOURCE_GOAL_NAMES,
                                                       Resource)
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model.sanity import sanity_check
from cruise_control_tpu_torch.model.state import ClusterState
from cruise_control_tpu_torch.model.stats import (ClusterModelStats,
                                                  compute_stats,
                                                  compute_stats_fresh_loads)


LOG = logging.getLogger(__name__)

#: goals per segment: the float aggregates are refreshed at each segment's
#: entry, at the reference's default cadence (pipeline_segment_size=4)
SEGMENT_SIZE = 4


class InvalidModelInputError(ValueError):
    """The model carries NaN/Inf/negative loads or capacities."""


def inputs_invalid(state: ClusterState) -> torch.Tensor:
    """bool 0-d: any valid replica load, leadership bonus or broker
    capacity is NaN/Inf/negative."""
    def bad(x, mask=None):
        b = ~torch.isfinite(x) | (x < 0.0)
        if mask is not None:
            b = b & mask
        return torch.any(b)
    return (bad(state.replica_base_load, state.replica_valid[:, None])
            | bad(state.partition_leader_bonus)
            | bad(state.broker_capacity))


@dataclasses.dataclass
class OptimizerResult:
    """Proposals plus per-goal statistics and violation instruments."""

    proposals: List[ExecutionProposal]
    stats_before: ClusterModelStats
    stats_after: ClusterModelStats
    stats_by_goal: Dict[str, ClusterModelStats]
    violated_goals_before: List[str]
    violated_goals_after: List[str]
    regressed_goals: List[str]
    final_state: ClusterState
    duration_s: float = 0.0
    #: the maintained RoundCache describing final_state (table included)
    final_cache: Optional[object] = None
    #: {goal: (before, after-own-run, after-all-goals)}
    violated_broker_counts: Dict[str, Tuple[int, int, int]] = \
        dataclasses.field(default_factory=dict)
    rounds_by_goal: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: violated-broker count at each goal's own entry
    entry_broker_counts: Dict[str, int] = \
        dataclasses.field(default_factory=dict)
    #: 1-based index of each goal's last committing round (0 = none)
    converged_at_by_goal: Dict[str, int] = \
        dataclasses.field(default_factory=dict)
    hard_goal_names: frozenset = frozenset()
    #: self-healing's rounds and the replicas it moved (0, 0 when the
    #: model carried no offline replica)
    heal_rounds: int = 0
    heal_moves: int = 0

    @property
    def num_replica_movements(self) -> int:
        return sum(len(p.replicas_to_add) for p in self.proposals)

    @property
    def num_leadership_movements(self) -> int:
        """Proposals that only hand leadership to another replica."""
        return sum(1 for p in self.proposals
                   if p.has_leader_action and not p.has_replica_action)

    def balancedness_score(self) -> float:
        """[0, 100]: 100 minus the rank-weighted cost of the goals still
        violated after optimization."""
        goal_names = list(self.stats_by_goal) or sorted(
            set(self.violated_goals_before) | set(self.violated_goals_after))
        if not goal_names:
            return 100.0
        costs = goals_base.balancedness_cost_by_goal(goal_names,
                                                     self.hard_goal_names)
        violated = set(self.violated_goals_after)
        kept = sum(c for n, c in costs.items() if n not in violated)
        total = sum(costs.values())
        return 100.0 * kept / total if total else 100.0


def _count(mask: torch.Tensor) -> int:
    return int(mask.sum())


def heal_offline_replicas(state: ClusterState, ctx: OptimizationContext,
                          max_rounds: int = 256):
    """Batched self-healing: every offline replica moves to an alive
    broker with capacity headroom in every resource, preferring the least
    disk-utilized destinations, while a round commits anything (at most
    `max_rounds`).  Runs table-less (K7 selects, K3 commits the
    aggregates).  Returns (state, rounds, replicas moved)."""
    cache = make_round_cache(state)
    rounds = moved = 0
    while rounds < max_rounds:
        offline = S.self_healing_eligible(state)
        w = cache.replica_load[:, Resource.DISK]
        cap = state.broker_capacity * ctx.capacity_threshold[None, :]
        headroom_all = cap - cache.broker_load

        def accept(r, d, load=cache.replica_load, room=headroom_all):
            # capacity across every resource (CapacityGoal acceptance)
            return torch.all(load[r] <= room[d], -1)

        dest_ok = state.broker_alive & ctx.broker_dest_ok
        util = cache.broker_load[:, Resource.DISK] / torch.clamp_min(
            state.broker_capacity[:, Resource.DISK], 1e-9)
        # acceptance is capacity-only (destination-side), so several
        # offline replicas may leave one alive broker (bad disk) per round
        cand_r, cand_d, cand_v = K.forced_move_round(
            state, offline, w, dest_ok, accept, -util, ctx.partition_replicas,
            cap_alive_sources=False)
        state, cache = K.commit_moves_cached(state, cache, cand_r, cand_d,
                                             cand_v)
        rounds += 1
        n = _count(cand_v)
        moved += n
        if not n:
            break
    return state, rounds, moved


class GoalOptimizer:
    """Priority-ordered multi-goal optimization with acceptance
    stacking."""

    def __init__(self, goals: Sequence[Goal],
                 constraint: Optional[BalancingConstraint] = None):
        self.goals = list(goals)
        self.constraint = constraint or BalancingConstraint()

    def _plan_segments(self):
        """Goal chunks of SEGMENT_SIZE; the cache's float aggregates are
        refreshed at each chunk's entry, as in the reference."""
        g = len(self.goals)
        return [(s, min(s + SEGMENT_SIZE, g))
                for s in range(0, g, SEGMENT_SIZE)]

    def _prebalance_dims(self):
        """(active resources, balance_counts, count_margin) derived from
        the goals in this optimizer's list."""
        names = {g.name for g in self.goals}
        active = tuple((RESOURCE_GOAL_NAMES[r] + "UsageDistributionGoal")
                       in names for r in range(len(RESOURCE_GOAL_NAMES)))
        margin = 0.09
        for g in self.goals:
            if g.name == "ReplicaDistributionGoal":
                margin = getattr(g, "pct_margin", margin)
        return active, "ReplicaDistributionGoal" in names, margin

    def optimizations(self, state: ClusterState, topology,
                      options: Optional[OptimizationOptions] = None,
                      device=None,
                      _table_slots_override: Optional[int] = None
                      ) -> OptimizerResult:
        """Run all goals in priority order and diff out proposals, on
        `device` (the card unless "cpu" is asked for).
        `_table_slots_override` sets the broker-table width (the re-run
        after self-healing overfilled a row)."""
        t_start = time.time()
        dev = resolve_device(device)
        options = options or OptimizationOptions()
        state = state.to(dev)
        goals = self.goals
        ctx = make_context(state, self.constraint, options, topology,
                           table_slots=_table_slots_override)
        initial = state

        # --- pre: stats and violation sweep before, validity, pre-balance
        if bool(inputs_invalid(initial)):
            raise InvalidModelInputError(
                "cluster model carries NaN/Inf/negative replica loads, "
                "leadership bonuses, or broker capacities")
        stats_before = compute_stats(initial)
        cache0 = make_round_cache(initial)
        vb = [_count(g.violated_brokers(initial, ctx, cache0)) for g in goals]
        needs_heal = bool(S.self_healing_eligible(state).any())
        # a broken cluster (dead brokers, broken disks or offline
        # replicas) waives the stats-regression abort
        broken = (needs_heal or not bool(torch.all(state.broker_alive))
                  or not bool(torch.all(state.disk_alive)))
        heal_rounds = heal_moves = 0
        if needs_heal:
            state, heal_rounds, heal_moves = heal_offline_replicas(state,
                                                                   ctx)
        active_res, balance_counts, count_margin = self._prebalance_dims()
        pre_rounds = 0
        if (ctx.prebalance and not ctx.fix_offline_replicas_only
                and (any(active_res) or balance_counts)):
            from cruise_control_tpu_torch.analyzer.prebalance import \
                prebalance
            state, pre_rounds, cache = prebalance(
                state, ctx, count_margin=count_margin,
                active_resources=active_res, balance_counts=balance_counts)
        else:
            cache = ensure_full_cache(state, ctx, None)
        # self-healing runs table-less and may push a broker past the
        # table width sized from the pre-heal counts, and a rebuilt table
        # would drop the overflow; the reference then re-runs the whole
        # solve with a wider table (and discards this run), so the port
        # restarts as soon as it knows
        max_count = int(torch.max(S.broker_replica_count(state)))
        if ctx.table_slots and max_count > ctx.table_slots:
            new_slots = table_width(max_count, state.num_replicas)
            LOG.warning("post-heal per-broker replica count %d overflowed "
                        "the broker table width %d; re-running with width "
                        "%d", max_count, ctx.table_slots, new_slots)
            return self.optimizations(initial, topology, options,
                                      device=dev,
                                      _table_slots_override=new_slots)
        still_offline = _count(S.self_healing_eligible(state))
        if still_offline:
            raise OptimizationFailure(
                f"self-healing could not relocate {still_offline} "
                f"offline replicas (insufficient capacity or eligible "
                f"brokers)")

        # --- goal segments
        prev_stats = stats_before
        stats_by_goal: Dict[str, ClusterModelStats] = {}
        own, entry, rounds_by_goal, conv_by_goal = [], [], {}, {}
        regressed: List[str] = []
        for start, stop in self._plan_segments():
            cache = refresh_float_aggregates(state, cache)
            for i in range(start, stop):
                goal = goals[i]
                entry.append(_count(goal.violated_brokers(state, ctx, cache)))
                nw = goal.no_work(state, ctx, cache)
                if nw is not None and bool(nw):
                    g_rounds = g_conv = 0
                else:
                    sink: List = []
                    goals_base.set_round_sink(sink)
                    try:
                        state, cache = goal.optimize_cached(
                            state, ctx, goals[:i], cache)
                    finally:
                        goals_base.set_round_sink(None)
                    g_rounds, g_conv = goals_base.collapse_sink(sink)
                cache = ensure_full_cache(state, ctx, cache)
                rounds_by_goal[goal.name] = g_rounds
                conv_by_goal[goal.name] = g_conv
                goal_stats = compute_stats_fresh_loads(state, cache)
                stats_by_goal[goal.name] = goal_stats.cpu()
                own.append(_count(goal.violated_brokers(state, ctx, cache)))
                if not bool(goal.stats_not_worse(prev_stats, goal_stats)):
                    regressed.append(goal.name)
                prev_stats = goal_stats

        # --- post sweep
        cache1 = refresh_float_aggregates(state, cache)
        va = [_count(g.violated_brokers(state, ctx, cache1)) for g in goals]

        violated_before = [g.name for g, v in zip(goals, vb) if v]
        violated_after = [g.name for g, v in zip(goals, va) if v]
        if pre_rounds:
            rounds_by_goal["__prebalance__"] = pre_rounds
        if regressed and not broken:
            raise OptimizationFailure(
                "optimization made goal statistics worse than before "
                "for: " + ", ".join(regressed))
        for goal in goals:
            if goal.is_hard and goal.name in violated_after:
                raise OptimizationFailure(
                    f"hard goal {goal.name} still violated after "
                    f"optimization")
        sanity_check(state)

        keys = ("replica_broker", "replica_is_leader", "replica_disk")
        init_h = {k: getattr(initial, k).cpu().numpy() for k in keys}
        opt_h = {k: getattr(state, k).cpu().numpy() for k in keys}
        proposals = diff_proposals_host(
            init_h, opt_h, initial.replica_valid.cpu().numpy(),
            initial.replica_base_load[:, Resource.DISK].cpu().numpy(),
            initial.replica_partition.cpu().numpy(), topology,
            ctx.partition_replicas.cpu().numpy())
        stats_before = stats_before.cpu()
        result = OptimizerResult(
            proposals=proposals,
            stats_before=stats_before,
            stats_after=(stats_by_goal[goals[-1].name] if goals
                         else stats_before),
            stats_by_goal=stats_by_goal,
            violated_goals_before=violated_before,
            violated_goals_after=violated_after,
            regressed_goals=regressed,
            final_state=state,
            duration_s=time.time() - t_start,
            final_cache=cache,
            violated_broker_counts={
                g.name: (b, o, a)
                for g, b, o, a in zip(goals, vb, own, va)},
            rounds_by_goal=rounds_by_goal,
            entry_broker_counts={g.name: e for g, e in zip(goals, entry)},
            converged_at_by_goal=conv_by_goal,
            hard_goal_names=frozenset(g.name for g in goals if g.is_hard),
            heal_rounds=heal_rounds,
            heal_moves=heal_moves,
        )
        return result


def proposal_set(result: OptimizerResult) -> set:
    """{(partition, old broker ids, new broker ids)} of a result."""
    return {(p.partition, tuple(r.broker_id for r in p.old_replicas),
             tuple(r.broker_id for r in p.new_replicas))
            for p in result.proposals}
