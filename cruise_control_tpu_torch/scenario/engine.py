"""What-if scenario engine (port of cruise_control_tpu/scenario/engine.py):
K scenario solves as one batch.

The reference vmaps its fused goal pipeline over a scenario axis: one
program serves every scenario of a batch.  The port's solve is a host
loop with branches that depend on the data, which `torch.vmap` cannot
batch, so its FUSED rung (`_solve_batched`) runs the lanes of a batch
one after another on the engine's device and stream: each lane goes
through the goal pipeline (`GoalOptimizer._pipeline`, the body of
`GoalOptimizer.optimizations`) at the batch's padded geometry, launching
the hand-written kernels as a single solve does, and `_movement_metrics`
runs on each lane as torch ops (its data sum is K13 on the card).

Failure discipline (the degradation ladder, applied to batches):

* an out-of-memory failure of the batch halves it and solves both
  halves, up to `max_oom_halvings` times.  The lanes run one at a time,
  so a halving cannot shrink the working set of a lane's solve; what it
  frees is the resident lane states: the whole batch is dropped, and
  each half is materialized again (at the whole batch's geometry and
  table width, so its lanes see the same shapes) only when it runs, so
  at most K/2 lane states sit on the device beside the running solve
  instead of K;
* an out-of-memory batch of one, and an injected fault, descend the
  engine's own ladder (analyzer/degradation.py): EAGER is one
  eager-driver solve a scenario, CPU `model/cpu_model.host_fallback_solve`
  a scenario; the batch's lanes are released before the descent;
* a lane's solver verdicts (an unsatisfiable hard goal, a stats
  regression, invalid inputs, offline replicas left) are not failures:
  the lane is reported infeasible and its batchmates solve normally;
* anything else (a kernel that fails to build, load or launch, a bug)
  raises through at every rung, as in the facade's ladder
  (`degradation.ladder_material`).

Fault site: ``scenario.execute`` (once a batch); the EAGER rung runs
under the optimizer's own ``optimizer.execute``.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time as _time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from cruise_control_tpu_torch import ops
from cruise_control_tpu_torch.analyzer.context import (BalancingConstraint,
                                                       OptimizationOptions)
from cruise_control_tpu_torch.analyzer.degradation import (
    CircuitBreaker, DegradationLadder, InvalidModelInputError, SolverRung,
    classify_failure, ladder_material)
from cruise_control_tpu_torch.analyzer.goals.base import OptimizationFailure
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.model.state import ClusterState, own_copy
from cruise_control_tpu_torch.scenario.compiler import (CompiledBatch,
                                                        _batch_geometry,
                                                        compile_batch,
                                                        materialize,
                                                        merged_options)
from cruise_control_tpu_torch.scenario.spec import (BASE_SCENARIO_NAME,
                                                    ScenarioSpec)
from cruise_control_tpu_torch.utils import faults

LOG = logging.getLogger(__name__)

__all__ = ["BASE_SCENARIO_NAME", "ScenarioBatchResult", "ScenarioEngine",
           "ScenarioOutcome"]


class _TableOverflow(Exception):
    """Self-healing overfilled a lane's broker table; the chunk re-runs
    at `slots` (the single solve's re-run, for the whole batch)."""

    def __init__(self, slots: int) -> None:
        super().__init__(f"broker table overflow; need width {slots}")
        self.slots = slots


@dataclasses.dataclass
class ScenarioOutcome:
    """One scenario's verdict and instruments (host values only)."""

    spec: ScenarioSpec
    feasible: bool
    reason: str = ""                       #: why infeasible ("" when not)
    rung: str = "FUSED"                    #: the rung that served it
    violated_goals_before: List[str] = dataclasses.field(
        default_factory=list)
    violated_goals_after: List[str] = dataclasses.field(
        default_factory=list)
    violated_broker_counts: Dict[str, Tuple[int, int, int]] = \
        dataclasses.field(default_factory=dict)
    #: per-goal violated count at the goal's own entry
    entry_broker_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    rounds_by_goal: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: per-goal last committing round
    converged_at_by_goal: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    stats_before: Optional[object] = None  #: host ClusterModelStats
    stats_after: Optional[object] = None
    stats_by_goal: Dict[str, object] = dataclasses.field(
        default_factory=dict)
    regressed_goals: List[str] = dataclasses.field(default_factory=list)
    #: the infeasibility is an input-validity verdict
    invalid_input: bool = False
    #: the lane's final placement, kept only for batches whose lanes
    #: differ in membership (none in the port yet)
    final_placement: Optional[dict] = None
    balancedness: float = 0.0
    num_replica_moves: int = 0
    num_leadership_moves: int = 0
    data_to_move: float = 0.0
    proposals: List = dataclasses.field(default_factory=list)

    @property
    def num_violated_goals_after(self) -> int:
        return len(self.violated_goals_after)


@dataclasses.dataclass
class ScenarioBatchResult:
    """The whole evaluation: outcomes in request order and the batch's
    telemetry (`compile_s` stays 0: the port compiles no program)."""

    outcomes: List[ScenarioOutcome]
    duration_s: float = 0.0
    compile_s: float = 0.0
    solve_s: float = 0.0
    oom_halvings: int = 0
    batch_sizes: List[int] = dataclasses.field(default_factory=list)
    rung: str = "FUSED"

    def outcome(self, name: str) -> Optional[ScenarioOutcome]:
        for o in self.outcomes:
            if o.spec.name == name:
                return o
        return None


class ScenarioEngine:
    """Evaluates batches of what-if scenarios against one base model on
    `device` (the card unless "cpu" is asked for).

    `optimizer_factory(goal_names_or_None)` returns the GoalOptimizer to
    run.  The engine owns its own degradation ladder: a failing scenario
    batch must not pin the request solves, and vice versa."""

    def __init__(self, optimizer_factory: Callable,
                 constraint: Optional[BalancingConstraint] = None,
                 max_batch_size: int = 32,
                 max_oom_halvings: int = 4,
                 breaker_failure_threshold: int = 3,
                 breaker_cooldown_s: float = 300.0,
                 balancedness_weights: Tuple[float, float] = (1.1, 1.5),
                 time_fn: Optional[Callable[[], float]] = None,
                 device=None) -> None:
        self._optimizer_factory = optimizer_factory
        self._constraint = constraint or BalancingConstraint()
        self.balancedness_weights = balancedness_weights
        self.max_batch_size = max(1, max_batch_size)
        self.max_oom_halvings = max(0, max_oom_halvings)
        self.device = resolve_device(device)
        self._time = time_fn or _time.time
        self.breaker = CircuitBreaker(
            failure_threshold=breaker_failure_threshold,
            cooldown_s=breaker_cooldown_s, time_fn=self._time)
        self.ladder = DegradationLadder(self.breaker)
        self._lock = threading.Lock()
        #: serializes whole evaluations (per-call telemetry)
        self._eval_lock = threading.Lock()
        # telemetry (the reference's ScenarioEngineState and meters)
        self.last_batch_size = 0
        self.total_batches = 0
        self.total_scenarios = 0
        self.total_oom_halvings = 0
        self.total_descents = 0
        self.last_compile_s = 0.0
        self.last_solve_s = 0.0
        #: the facade's MetricRegistry once attached: the engine marks
        #: scenario-descents and scenario-oom-halvings and times
        #: scenario-execute-timer
        self._metrics = None

    def attach_metrics(self, registry) -> None:
        """Late-bind the facade's MetricRegistry (the engine is built
        before it)."""
        self._metrics = registry

    def to_json(self) -> dict:
        return {
            "rung": self.ladder.rung.name,
            "breaker": self.breaker.to_json(),
            "lastBatchSize": self.last_batch_size,
            "totalBatches": self.total_batches,
            "totalScenarios": self.total_scenarios,
            "totalOomHalvings": self.total_oom_halvings,
            "lastCompileS": round(self.last_compile_s, 3),
            "lastSolveS": round(self.last_solve_s, 3),
        }

    # ------------------------------------------------------------------
    def evaluate(self, base_state: ClusterState, topology,
                 specs: Sequence[ScenarioSpec],
                 goals: Optional[Sequence[str]] = None,
                 options: Optional[OptimizationOptions] = None,
                 include_proposals: bool = True) -> ScenarioBatchResult:
        """Solve every spec; outcomes return in request order.  Scenarios
        sharing a goal list share one batch (a per-spec `goals` override
        opens a sub-batch of its own); each batch holds at most
        `max_batch_size` scenarios."""
        for spec in specs:
            spec.validate(topology)
        from cruise_control_tpu_torch.obs import trace as obs_trace
        with self._eval_lock:
            with obs_trace.span("scenario.batch",
                                scenarios=len(specs)) as sp:
                result = self._evaluate_locked(base_state, topology,
                                               specs, goals, options,
                                               include_proposals)
                if sp is not None:
                    sp.set_tag("rung", result.rung)
                    sp.set_tag("oomHalvings", result.oom_halvings)
                return result

    def _evaluate_locked(self, base_state, topology, specs, goals,
                         options, include_proposals) -> ScenarioBatchResult:
        t0 = self._time()
        result = ScenarioBatchResult(outcomes=[None] * len(specs))
        self.last_compile_s = 0.0
        self.last_solve_s = 0.0

        groups: "OrderedDict[Optional[Tuple[str, ...]], list]" = \
            OrderedDict()
        default_key = tuple(goals) if goals is not None else None
        for i, spec in enumerate(specs):
            key = spec.goals if spec.goals is not None else default_key
            groups.setdefault(key, []).append((i, spec))

        for goal_key, group in groups.items():
            optimizer = self._optimizer_factory(
                list(goal_key) if goal_key is not None else None)
            for start in range(0, len(group), self.max_batch_size):
                chunk = group[start:start + self.max_batch_size]
                outs = self._solve_chunk(
                    optimizer, base_state, topology,
                    [s for _, s in chunk], options, include_proposals,
                    result)
                for (idx, _), out in zip(chunk, outs):
                    result.outcomes[idx] = out

        result.duration_s = self._time() - t0
        result.compile_s = self.last_compile_s
        result.solve_s = self.last_solve_s
        result.rung = self.ladder.rung.name
        with self._lock:
            self.last_batch_size = len(specs)
            self.total_batches += 1
            self.total_scenarios += len(specs)
        if self._metrics is not None:
            self._metrics.update_timer("scenario-execute-timer",
                                       result.duration_s)
        return result

    # ------------------------------------------------------------------
    # rung dispatch
    # ------------------------------------------------------------------
    def _solve_chunk(self, optimizer, base_state, topology,
                     specs: List[ScenarioSpec], options, include_proposals,
                     result: ScenarioBatchResult,
                     table_override: Optional[int] = None
                     ) -> List[ScenarioOutcome]:
        rung = self.ladder.entry_rung()
        if rung is SolverRung.FUSED:
            try:
                outs = self._solve_fused(
                    optimizer, base_state, topology, specs, options,
                    table_override, None, self.max_oom_halvings,
                    include_proposals, result)
                self.ladder.on_success(SolverRung.FUSED)
                return outs
            except _TableOverflow as overflow:
                return self._solve_chunk(optimizer, base_state, topology,
                                         specs, options, include_proposals,
                                         result,
                                         table_override=overflow.slots)
            except Exception as exc:  # noqa: BLE001 - the ladder classifies
                if not ladder_material(exc):
                    raise
                kind = classify_failure(exc)
                self.ladder.on_failure(SolverRung.FUSED)
                self._descend_metered(SolverRung.FUSED)
                LOG.warning("batched scenario solve failed (%s): %s; "
                            "descending to per-scenario EAGER solves",
                            kind.value, exc)
                rung = SolverRung.EAGER
        return self._solve_per_scenario(optimizer, base_state, topology,
                                        specs, options, include_proposals,
                                        rung, result)

    def _solve_per_scenario(self, optimizer, base_state, topology,
                            specs, options, include_proposals,
                            rung: SolverRung, result: ScenarioBatchResult
                            ) -> List[ScenarioOutcome]:
        """The degraded rungs: EAGER, one eager-driver solve a scenario;
        CPU, the numpy host fallback a scenario."""
        outs: List[ScenarioOutcome] = []
        eager_failed = False
        served_any_at_rung = False
        for spec in specs:
            geometry = _batch_geometry(base_state, topology, [spec])
            v_state, v_topo, spec_opts = materialize(
                base_state, topology, spec, *geometry, device=self.device)
            merged = merged_options(options or OptimizationOptions(),
                                    spec_opts)
            if rung is SolverRung.EAGER:
                try:
                    res = optimizer.optimizations(v_state, v_topo, merged,
                                                  check_sanity=False,
                                                  eager_driver=True,
                                                  device=self.device)
                    outs.append(self._outcome_from_result(
                        spec, res, "EAGER", include_proposals))
                    served_any_at_rung = True
                    continue
                except (OptimizationFailure,
                        InvalidModelInputError) as exc:
                    outs.append(ScenarioOutcome(
                        spec=spec, feasible=False, reason=str(exc),
                        rung="EAGER"))
                    served_any_at_rung = True
                    continue
                except Exception as exc:  # noqa: BLE001
                    if not ladder_material(exc):
                        raise
                    eager_failed = True
                    self.ladder.on_failure(SolverRung.EAGER)
                    LOG.warning("eager scenario solve %r failed (%s); "
                                "host fallback", spec.name,
                                classify_failure(exc).value)
                    # the eager solve consumed the variant's tensors
                    v_state, v_topo, _ = materialize(
                        base_state, topology, spec, *geometry,
                        device=self.device)
            try:
                from cruise_control_tpu_torch.model.cpu_model import \
                    host_fallback_solve
                res = host_fallback_solve(v_state, v_topo, options=merged,
                                          time_fn=self._time)
                outs.append(self._outcome_from_result(
                    spec, res, "CPU", include_proposals))
            except (OptimizationFailure, InvalidModelInputError) as exc:
                outs.append(ScenarioOutcome(
                    spec=spec, feasible=False, reason=str(exc),
                    rung="CPU"))
            except Exception as exc:  # noqa: BLE001 - the bottom rung failed
                if not ladder_material(exc):
                    raise
                self.ladder.on_failure(SolverRung.CPU)
                outs.append(ScenarioOutcome(
                    spec=spec, feasible=False,
                    reason=f"solve failed at every rung: {exc}",
                    rung="CPU"))
        if eager_failed:
            self._descend_metered(SolverRung.EAGER)
        elif served_any_at_rung:
            self.ladder.on_success(rung)
        result.batch_sizes.extend([1] * len(specs))
        return outs

    def _descend_metered(self, from_rung: SolverRung) -> None:
        """Descend, counting only when the resting rung moved."""
        before = self.ladder.rung
        self.ladder.descend(from_rung)
        if self.ladder.rung != before:
            with self._lock:
                self.total_descents += 1
            if self._metrics is not None:
                self._metrics.meter("scenario-descents").mark()

    def _outcome_from_result(self, spec, res, rung: str,
                             include_proposals: bool) -> ScenarioOutcome:
        return ScenarioOutcome(
            spec=spec, feasible=True, rung=rung,
            violated_goals_before=list(res.violated_goals_before),
            violated_goals_after=list(res.violated_goals_after),
            violated_broker_counts=dict(res.violated_broker_counts),
            entry_broker_counts=dict(res.entry_broker_counts),
            rounds_by_goal=dict(res.rounds_by_goal),
            converged_at_by_goal=dict(res.converged_at_by_goal),
            stats_before=res.stats_before, stats_after=res.stats_after,
            balancedness=res.balancedness_score(),
            num_replica_moves=res.num_replica_movements,
            num_leadership_moves=res.num_leadership_movements,
            data_to_move=res.data_to_move,
            proposals=list(res.proposals) if include_proposals else [])

    # ------------------------------------------------------------------
    # FUSED rung: the batch's lanes in sequence
    # ------------------------------------------------------------------
    def _solve_fused(self, optimizer, base_state, topology,
                     specs: List[ScenarioSpec], options,
                     table_slots: Optional[int], geometry,
                     halvings_left: int, include_proposals: bool,
                     result: ScenarioBatchResult) -> List[ScenarioOutcome]:
        """Compile the batch at `geometry` (None: its own) and solve it;
        an out-of-memory failure halves it (see the module docstring)."""
        if geometry is None:
            geometry = _batch_geometry(base_state, topology, specs)
        batch = None
        try:
            batch = compile_batch(base_state, topology, specs,
                                  self._constraint, options,
                                  table_slots_override=table_slots,
                                  device=self.device, geometry=geometry)
            return self._solve_batched(optimizer, batch,
                                       include_proposals, result)
        except torch.cuda.OutOfMemoryError:
            if len(specs) < 2 or halvings_left <= 0:
                raise
        # out of the handler, whose traceback held the lanes: drop them
        # before the halves are materialized (at the batch's table width
        # when its compile finished)
        if batch is not None:
            table_slots = batch.contexts[0].table_slots
        del batch
        with self._lock:
            self.total_oom_halvings += 1
        result.oom_halvings += 1
        if self._metrics is not None:
            self._metrics.meter("scenario-oom-halvings").mark()
        half = len(specs) // 2
        LOG.warning("batched scenario solve of %d ran out of memory; "
                    "retrying as %d + %d", len(specs), half,
                    len(specs) - half)
        return [out for part in (specs[:half], specs[half:])
                for out in self._solve_fused(
                    optimizer, base_state, topology, part, options,
                    table_slots, geometry, halvings_left - 1,
                    include_proposals, result)]

    def _solve_batched(self, optimizer, batch: CompiledBatch,
                       include_proposals: bool,
                       result: ScenarioBatchResult
                       ) -> List[ScenarioOutcome]:
        """The batch's lanes one after another on the engine's device:
        each lane's goal pipeline on its own copy of its variant, at the
        batch's geometry and table width, then its movement metrics and
        its host tail.  A lane whose self-healing overfills the broker
        table makes the whole batch re-run wider, as in the reference;
        the lanes after it stop after their pre-program, which is enough
        to size the table."""
        if not optimizer.goals:
            raise ValueError("scenario solves need at least one goal")
        k = len(batch.specs)
        t_solve = self._time()
        faults.inject("scenario.execute")
        runs = []
        overflowed = False
        for i in range(k):
            # the lane's solve commits in place; the batch may run again
            # after a halving or a re-widening
            state = own_copy(batch.states[i])
            run = optimizer._pipeline(
                state, state, batch.contexts[i], fault_site=None,
                raise_verdicts=False, pre_only=overflowed)
            overflowed = overflowed or bool(run.new_slots)
            moves = (None if run.invalid or overflowed
                     else _movement_metrics(batch.states[i], run.state))
            runs.append((run, moves))
        slots = batch.contexts[0].table_slots
        max_count = max(run.max_count for run, _ in runs)
        if slots and max_count > slots:
            new_slots = min(batch.states[0].num_replicas,
                            -(-int(max_count * 1.5 + 64) // 128) * 128)
            LOG.warning("scenario batch overflowed broker table width %d "
                        "(max count %d); re-running with width %d", slots,
                        max_count, new_slots)
            raise _TableOverflow(new_slots)
        self.last_solve_s += self._time() - t_solve
        result.batch_sizes.append(k)
        return [self._assemble_outcome(batch, i, optimizer.goals, run,
                                       moves, include_proposals)
                for i, (run, moves) in enumerate(runs)]

    def _assemble_outcome(self, batch, i, goals, run, moves,
                          include_proposals) -> ScenarioOutcome:
        """Host tail for lane i: the single solve's evaluation order, but
        verdicts become the lane's feasibility instead of exceptions."""
        spec = batch.specs[i]
        if run.invalid:
            return ScenarioOutcome(
                spec=spec, feasible=False, reason=(
                    "model carries NaN/Inf/negative loads or capacities"),
                invalid_input=True)
        stats_by_goal = run.stats_by_goal
        stats_before = run.stats_before.cpu()
        stats_after = (stats_by_goal[goals[-1].name] if goals
                       else stats_before)
        violated_after = run.violated_after
        regressed = run.regressed
        feasible, reason = True, ""
        if run.still_offline:
            feasible, reason = False, (
                f"{run.still_offline} offline replicas could not be "
                f"relocated (insufficient capacity or eligible brokers)")
        elif regressed and not run.broken:
            feasible, reason = False, (
                "optimization made goal statistics worse than before "
                "for: " + ", ".join(regressed))
        else:
            hard_violated = [g.name for g in goals
                             if g.is_hard and g.name in violated_after]
            if hard_violated:
                feasible, reason = False, (
                    "hard goals still violated after optimization: "
                    + ", ".join(hard_violated))

        from cruise_control_tpu_torch.scenario.report import \
            balancedness_score
        balancedness = balancedness_score(
            [g.name for g in goals],
            frozenset(g.name for g in goals if g.is_hard),
            violated_after, self.balancedness_weights)

        proposals: List = []
        if include_proposals and feasible:
            from cruise_control_tpu_torch.analyzer.proposals import \
                diff_proposals_host
            initial = batch.states[i]
            keys = ("replica_broker", "replica_is_leader")
            if initial.num_disks > 0:
                keys = keys + ("replica_disk",)
            init = {k: getattr(initial, k).cpu().numpy() for k in keys}
            opt = {k: getattr(run.state, k).cpu().numpy() for k in keys}
            proposals = diff_proposals_host(
                init, opt, initial.replica_valid.cpu().numpy(),
                initial.replica_base_load[:, Resource.DISK].cpu().numpy(),
                initial.replica_partition.cpu().numpy(),
                batch.topologies[i], batch.rows_of(i))

        num_moves, leader_moves, data = moves
        return ScenarioOutcome(
            spec=spec, feasible=feasible, reason=reason, rung="FUSED",
            violated_goals_before=list(run.violated_before),
            violated_goals_after=list(violated_after),
            violated_broker_counts=dict(run.violated_broker_counts),
            entry_broker_counts=dict(run.entry_broker_counts),
            rounds_by_goal=dict(run.rounds_by_goal),
            converged_at_by_goal=dict(run.converged_at_by_goal),
            stats_before=stats_before, stats_after=stats_after,
            stats_by_goal=dict(stats_by_goal),
            regressed_goals=list(regressed),
            balancedness=balancedness,
            num_replica_moves=num_moves,
            num_leadership_moves=leader_moves,
            data_to_move=data,
            proposals=proposals)


def _movement_metrics(initial: ClusterState, final: ClusterState):
    """(replica moves, leadership-only moves, data to move): the lane's
    movement cost from its placements, as torch ops on its device (the
    data sum in XLA:CPU's order: K13 on the card)."""
    valid = initial.replica_valid
    moved = valid & (final.replica_broker != initial.replica_broker)
    promoted = (valid & final.replica_is_leader
                & ~initial.replica_is_leader & ~moved)
    data = ops.sum_f32(initial.replica_base_load[:, Resource.DISK] * moved)
    return (int(torch.sum(moved.to(torch.int32))),
            int(torch.sum(promoted.to(torch.int32))),
            float(data))
