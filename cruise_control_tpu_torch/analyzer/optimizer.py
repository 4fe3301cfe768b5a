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
own count and the regression flag) and the post sweep.  The segment plan
(`pipeline_segment_size`, `fused_segments`, `eager_driver`) decides where
the float refreshes fall, so it is part of the result, as in the
reference.

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
    refresh_float_aggregates, restrict_context_to_dirty, table_width)
from cruise_control_tpu_torch.analyzer.degradation import \
    InvalidModelInputError
from cruise_control_tpu_torch.analyzer.fusion import plan_segments
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
    #: devices the solve spanned (always 1: the port has no mesh yet)
    mesh_devices: int = 1
    #: goals whose segment the host-side skip elided (`host_side_skip`)
    skipped_goals: List[str] = dataclasses.field(default_factory=list)
    #: (priority, strictness) weights of `balancedness_score`
    balancedness_weights: Tuple[float, float] = (1.1, 1.5)
    #: which solver produced the result; None for the greedy solve (the
    #: port has no portfolio search)
    solver_provenance: Optional[dict] = None

    @property
    def num_replica_movements(self) -> int:
        return sum(len(p.replicas_to_add) for p in self.proposals)

    @property
    def num_leadership_movements(self) -> int:
        """Proposals that only hand leadership to another replica."""
        return sum(1 for p in self.proposals
                   if p.has_leader_action and not p.has_replica_action)

    @property
    def data_to_move(self) -> float:
        """Inter-broker data the proposals move."""
        return sum(p.inter_broker_data_to_move for p in self.proposals)

    def balancedness_score(self) -> float:
        """[0, 100]: 100 minus the rank-weighted cost of the goals still
        violated after optimization."""
        goal_names = list(self.stats_by_goal) or sorted(
            set(self.violated_goals_before) | set(self.violated_goals_after))
        if not goal_names:
            return 100.0
        pw, sw = self.balancedness_weights
        costs = goals_base.balancedness_cost_by_goal(
            goal_names, self.hard_goal_names, pw, sw)
        violated = set(self.violated_goals_after)
        kept = sum(c for n, c in costs.items() if n not in violated)
        total = sum(costs.values())
        return 100.0 * kept / total if total else 100.0


@dataclasses.dataclass
class PipelineRun:
    """What `GoalOptimizer._pipeline` measured on one model: the final
    state and cache, the stats and per-goal instruments, and the
    verdicts the caller raises (a request) or reports (a scenario
    lane)."""

    state: ClusterState
    cache: Optional[object] = None
    invalid: bool = False
    broken: bool = False
    still_offline: int = 0
    #: the post-heal largest per-broker replica count, and the wider
    #: broker-table width it calls for (0: the table held)
    max_count: int = 0
    new_slots: int = 0
    heal_rounds: int = 0
    heal_moves: int = 0
    stats_before: Optional[ClusterModelStats] = None
    stats_by_goal: Dict[str, ClusterModelStats] = \
        dataclasses.field(default_factory=dict)
    violated_before: List[str] = dataclasses.field(default_factory=list)
    violated_after: List[str] = dataclasses.field(default_factory=list)
    violated_broker_counts: Dict[str, Tuple[int, int, int]] = \
        dataclasses.field(default_factory=dict)
    entry_broker_counts: Dict[str, int] = \
        dataclasses.field(default_factory=dict)
    rounds_by_goal: Dict[str, int] = dataclasses.field(default_factory=dict)
    converged_at_by_goal: Dict[str, int] = \
        dataclasses.field(default_factory=dict)
    regressed: List[str] = dataclasses.field(default_factory=list)
    skipped_goals: List[str] = dataclasses.field(default_factory=list)


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
    stacking.

    `pipeline_segment_size` goals form a segment (the float aggregates of
    the round cache are refreshed at each segment's entry);
    `fused_segments` puts each run of adjacent goals of one fusion group
    in one segment instead (analyzer/fusion.py).  `eager_hard_abort`
    raises at the end of the first segment whose hard goal is still
    violated after its own run, in place of the check after the last
    goal.  `host_side_skip` skips a segment whose goals all report no
    work on its input state (`OptimizerResult.skipped_goals`).
    `balancedness_weights` are the (priority, strictness) weights of the
    balancedness score.  `jit_goals` and `auto_warmup` shape the
    reference's XLA programs and their compiles; the port compiles
    nothing ahead of a solve, so both are accepted and have no effect."""

    def __init__(self, goals: Sequence[Goal],
                 constraint: Optional[BalancingConstraint] = None,
                 jit_goals: bool = True,
                 pipeline_segment_size: int = 4,
                 balancedness_weights: Tuple[float, float] = (1.1, 1.5),
                 auto_warmup: bool = False,
                 eager_hard_abort: bool = False,
                 fused_segments: bool = False,
                 host_side_skip: bool = False):
        self.goals = list(goals)
        self.constraint = constraint or BalancingConstraint()
        self.balancedness_weights = balancedness_weights
        self.pipeline_segment_size = pipeline_segment_size
        self.fused_segments = fused_segments
        self.eager_hard_abort = eager_hard_abort
        self.host_side_skip = host_side_skip

    def _plan_segments(self, eager_driver: bool = False):
        """[(start, stop), ...]: one goal a segment under the eager
        driver, else the fusion plan or fixed-width chunks."""
        if eager_driver:
            return [(i, i + 1) for i in range(len(self.goals))]
        return plan_segments([g.name for g in self.goals],
                             max(1, self.pipeline_segment_size),
                             self.fused_segments)

    def _segment_no_work(self, start: int, stop: int, state, ctx,
                         cache) -> bool:
        """Host-side skip verdict for goals[start:stop] on the segment's
        input state and cache (before its float refresh): True iff every
        goal of the segment defines a no-work predicate and all hold."""
        verdict = None
        for g in self.goals[start:stop]:
            nw = g.no_work(state, ctx, cache)
            if nw is None:
                return False
            verdict = nw if verdict is None else verdict & nw
        return verdict is not None and bool(verdict)

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

    def _pipeline(self, initial: ClusterState, state: ClusterState,
                  ctx: OptimizationContext, *, eager: bool = False,
                  eager_driver: bool = False, host_skip: bool = False,
                  fault_site: Optional[str] = "optimizer.execute",
                  raise_verdicts: bool = True,
                  pre_only: bool = False) -> PipelineRun:
        """The pre-program, the goal segments and the post sweep on
        `state` (`initial` is the model before any warm start, read for
        the before-counts and the validity sweep).

        With `raise_verdicts` (a request's solve) an invalid model raises
        InvalidModelInputError, offline replicas left after self-healing
        raise OptimizationFailure and `eager` aborts on a hard goal still
        violated after its own segment; without it (a scenario lane) each
        verdict is recorded in the run, which stops after the pre-program
        only for an invalid model.  A broker table overflowed by
        self-healing stops the run after the pre-program with
        `new_slots` set.  `pre_only` stops there in any case.
        `fault_site` is injected before each program the reference
        dispatches: the pre-program, each segment (each goal's rounds and
        its epilogue under the eager driver) and the post sweep."""
        from cruise_control_tpu_torch.sched.runtime import \
            segment_checkpoint
        from cruise_control_tpu_torch.utils import faults

        def program() -> None:
            if fault_site is not None:
                faults.inject(fault_site)

        goals = self.goals
        run = PipelineRun(state=state)
        # --- pre: stats and violation sweep before, validity, pre-balance
        program()
        if bool(inputs_invalid(initial)):
            if raise_verdicts:
                raise InvalidModelInputError(
                    "cluster model carries NaN/Inf/negative replica "
                    "loads, leadership bonuses, or broker capacities")
            run.invalid = True
            return run
        stats_before = compute_stats(initial)
        cache0 = make_round_cache(initial)
        vb = [_count(g.violated_brokers(initial, ctx, cache0)) for g in goals]
        needs_heal = bool(S.self_healing_eligible(state).any())
        # a broken cluster (dead brokers, broken disks or offline
        # replicas) waives the stats-regression abort
        run.broken = (needs_heal or not bool(torch.all(state.broker_alive))
                      or not bool(torch.all(state.disk_alive)))
        if needs_heal:
            state, run.heal_rounds, run.heal_moves = heal_offline_replicas(
                state, ctx)
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
        run.max_count = int(torch.max(S.broker_replica_count(state)))
        if ctx.table_slots and run.max_count > ctx.table_slots:
            run.new_slots = table_width(run.max_count, state.num_replicas)
            return run
        run.still_offline = _count(S.self_healing_eligible(state))
        if run.still_offline and raise_verdicts:
            raise OptimizationFailure(
                f"self-healing could not relocate {run.still_offline} "
                f"offline replicas (insufficient capacity or eligible "
                f"brokers)")
        run.state, run.cache = state, cache
        if pre_only:
            return run

        # --- goal segments
        prev_stats = stats_before
        stats_by_goal: Dict[str, ClusterModelStats] = {}
        own, entry, rounds_by_goal, conv_by_goal = [], [], {}, {}
        regressed: List[str] = []
        skipped: List[str] = []
        for start, stop in self._plan_segments(eager_driver):
            segment_checkpoint()
            if (host_skip and not eager_driver
                    and self._segment_no_work(start, stop, state, ctx,
                                              cache)):
                # every goal of the segment is an identity at no work:
                # no refresh, unchanged stats, zero rounds and counts
                for goal in goals[start:stop]:
                    entry.append(0)
                    own.append(0)
                    rounds_by_goal[goal.name] = conv_by_goal[goal.name] = 0
                    stats_by_goal[goal.name] = prev_stats.cpu()
                    skipped.append(goal.name)
                continue
            program()
            cache = refresh_float_aggregates(state, cache)
            for i in range(start, stop):
                goal = goals[i]
                entry.append(_count(goal.violated_brokers(state, ctx, cache)))
                # the eager driver runs every goal (the reference's
                # per-goal programs have no no-work branch)
                nw = None if eager_driver else goal.no_work(state, ctx, cache)
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
                if eager_driver:
                    program()
                rounds_by_goal[goal.name] = g_rounds
                conv_by_goal[goal.name] = g_conv
                goal_stats = compute_stats_fresh_loads(state, cache)
                stats_by_goal[goal.name] = goal_stats.cpu()
                own.append(_count(goal.violated_brokers(state, ctx, cache)))
                if not bool(goal.stats_not_worse(prev_stats, goal_stats)):
                    regressed.append(goal.name)
                prev_stats = goal_stats
            if eager and raise_verdicts:
                for i in range(start, stop):
                    if goals[i].is_hard and own[i]:
                        raise OptimizationFailure(
                            f"hard goal {goals[i].name} still violated "
                            f"after its own optimization (eager abort)")

        # --- post sweep
        program()
        cache1 = refresh_float_aggregates(state, cache)
        va = [_count(g.violated_brokers(state, ctx, cache1)) for g in goals]
        if pre_rounds:
            rounds_by_goal["__prebalance__"] = pre_rounds
        run.state, run.cache = state, cache
        run.stats_before = stats_before
        run.stats_by_goal = stats_by_goal
        run.violated_before = [g.name for g, v in zip(goals, vb) if v]
        run.violated_after = [g.name for g, v in zip(goals, va) if v]
        run.violated_broker_counts = {
            g.name: (b, o, a) for g, b, o, a in zip(goals, vb, own, va)}
        run.entry_broker_counts = {g.name: e for g, e in zip(goals, entry)}
        run.rounds_by_goal = rounds_by_goal
        run.converged_at_by_goal = conv_by_goal
        run.regressed = regressed
        run.skipped_goals = skipped
        return run

    def optimizations(self, state: ClusterState, topology,
                      options: Optional[OptimizationOptions] = None,
                      check_sanity: bool = True,
                      _table_slots_override: Optional[int] = None,
                      warm_start: Optional[ClusterState] = None,
                      eager_hard_abort: Optional[bool] = None,
                      eager_driver: bool = False,
                      mesh=None,
                      dirty_brokers=None,
                      device=None) -> OptimizerResult:
        """Run all goals in priority order and diff out proposals, on
        `device` (the card unless "cpu" is asked for).

        `warm_start`, a previous solve's final state of the same shapes,
        seeds the search: its placement (brokers, logdirs, leader flags)
        replaces the state's before the pipeline, unless it repositions a
        replica that this request's options freeze (then it is dropped,
        with a log line).  Proposals diff against the given state.
        `dirty_brokers` (bool[B]) restricts the search to the dirty
        region (`restrict_context_to_dirty`, read on the given state).
        `eager_hard_abort` (None: the constructor's value) and
        `eager_driver` (one goal a segment, with no no-work skip) are the
        reference's; `check_sanity=False` skips the final sanity check.
        `mesh` must be None: the multi-device mesh is not ported.
        `_table_slots_override` sets the broker-table width (the re-run
        after self-healing overfilled a row).

        The reference reads its invalid-input, table-overflow and
        self-healing verdicts at the end of the solve; the port reads
        them before the goals run, so with `eager_hard_abort` a model
        that fails one of them raises that verdict here where the
        reference may raise a goal's eager abort first."""
        if mesh is not None:
            raise NotImplementedError(
                "the port has no multi-device mesh (the reference's "
                "parallel/mesh.py is not ported yet); pass mesh=None")
        t_start = time.time()
        dev = resolve_device(device)
        eager = (self.eager_hard_abort if eager_hard_abort is None
                 else eager_hard_abort)
        options = options or OptimizationOptions()
        state = state.to(dev)
        goals = self.goals
        ctx = make_context(state, self.constraint, options, topology,
                           table_slots=_table_slots_override)
        initial = state
        if warm_start is not None:
            warm_start = warm_start.to(dev)
            if self._seed_frozen(state, warm_start, ctx):
                LOG.info("warm-start seed ignored: it repositions replicas "
                         "this request's options freeze (excluded "
                         "topics/brokers)")
                warm_start = None
        if warm_start is not None:
            state = state.replace(
                replica_broker=warm_start.replica_broker,
                replica_is_leader=warm_start.replica_is_leader,
                replica_disk=warm_start.replica_disk)
        if dirty_brokers is not None:
            ctx = restrict_context_to_dirty(initial, ctx, dirty_brokers)

        run = self._pipeline(initial, state, ctx, eager=eager,
                             eager_driver=eager_driver,
                             host_skip=self.host_side_skip,
                             fault_site="optimizer.execute")
        if run.new_slots:
            # self-healing runs table-less and may push a broker past the
            # table width sized from the pre-heal counts, and a rebuilt
            # table would drop the overflow; the reference then re-runs
            # the whole solve with a wider table (and discards this run),
            # so the port restarts as soon as it knows
            LOG.warning("post-heal per-broker replica count %d overflowed "
                        "the broker table width %d; re-running with width "
                        "%d", run.max_count, ctx.table_slots, run.new_slots)
            return self.optimizations(
                initial, topology, options, check_sanity=check_sanity,
                _table_slots_override=run.new_slots, warm_start=warm_start,
                eager_hard_abort=eager, eager_driver=eager_driver,
                mesh=mesh, dirty_brokers=dirty_brokers, device=dev)
        state, cache = run.state, run.cache
        stats_before, stats_by_goal = run.stats_before, run.stats_by_goal
        rounds_by_goal, regressed = run.rounds_by_goal, run.regressed
        violated_before, violated_after = run.violated_before, \
            run.violated_after
        if regressed and not run.broken:
            raise OptimizationFailure(
                "optimization made goal statistics worse than before "
                "for: " + ", ".join(regressed))
        for goal in goals:
            if goal.is_hard and goal.name in violated_after:
                raise OptimizationFailure(
                    f"hard goal {goal.name} still violated after "
                    f"optimization")
        if check_sanity:
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
                         else compute_stats(state).cpu()),
            stats_by_goal=stats_by_goal,
            violated_goals_before=violated_before,
            violated_goals_after=violated_after,
            regressed_goals=regressed,
            final_state=state,
            duration_s=time.time() - t_start,
            final_cache=cache,
            violated_broker_counts=run.violated_broker_counts,
            rounds_by_goal=rounds_by_goal,
            entry_broker_counts=run.entry_broker_counts,
            converged_at_by_goal=run.converged_at_by_goal,
            hard_goal_names=frozenset(g.name for g in goals if g.is_hard),
            heal_rounds=run.heal_rounds,
            heal_moves=run.heal_moves,
            skipped_goals=run.skipped_goals,
            balancedness_weights=self.balancedness_weights,
        )
        return result

    @staticmethod
    def _seed_frozen(state: ClusterState, seed: ClusterState,
                     ctx: OptimizationContext) -> bool:
        """Does the warm-start `seed` reposition a replica that this
        request freezes: an excluded or unmovable replica moved, moved to
        another logdir or changed leadership, a replica moved to a broker
        that may not receive it, or leadership given to a broker that may
        not lead?"""
        frozen = ~(ctx.replica_movable & ~ctx.replica_excluded)
        valid = state.replica_valid
        seed_moved = valid & (seed.replica_broker != state.replica_broker)
        promoted = valid & seed.replica_is_leader & ~state.replica_is_leader
        seed_b = torch.clamp_max(seed.replica_broker,
                                 state.num_brokers - 1).long()
        bad = ((frozen & valid
                & ((seed.replica_broker != state.replica_broker)
                   | (seed.replica_disk != state.replica_disk)
                   | (seed.replica_is_leader != state.replica_is_leader)))
               | (seed_moved & ~ctx.broker_dest_ok[seed_b])
               | (promoted & ~ctx.broker_leader_ok[seed_b]))
        return bool(torch.any(bad))


def proposal_set(result: OptimizerResult) -> set:
    """{(partition, old broker ids, new broker ids)} of a result."""
    return {(p.partition, tuple(r.broker_id for r in p.old_replicas),
             tuple(r.broker_id for r in p.new_replicas))
            for p in result.proposals}
