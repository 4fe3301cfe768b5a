"""The facade (port of the request methods, the proposal cache, the warm
seed, the dirty region, the device model store consult, the degradation
ladder, the what-if scenarios and the execution side of
cruise_control_tpu/facade.py).

`CruiseControl` serves the reference's proposal requests over a load
monitor: `optimizations`, `rebalance`, `add_brokers`, `remove_brokers`,
`demote_brokers`, `fix_offline_replicas`, `evaluate_scenarios` and
`update_topic_replication_factor`.  Built as the reference is, from the
cluster's admin client, a metric sampler and a capacity resolver, it
builds its own `LoadMonitor` (monitor/load_monitor.py), whose sampling
rounds feed the windows every model is built from; `load_monitor=` takes
a monitor built by the caller instead, such as a `SnapshotLoadMonitor`.
The model of each request comes from the device model store
(`_model_for_solve`): the resident model as it is,
fast-forwarded by the monitor's logged deltas, or rebuilt from the
monitor.  Default-stack requests with default options answer from the
proposal cache while the model generation holds; otherwise they solve
warm from the last such request's final placement, restricted to the
brokers its deltas touched when those are few enough.

Every solve runs inline on the facade's device (the card unless "cpu"
is asked for); there is no scheduler.  A proposal request's solve goes
through the degradation ladder (analyzer/degradation.py): a failure is
retried with backoff, then served from the next rung down — FUSED, then
EAGER, then the host fallback (model/cpu_model.py) — with the request's
trace marked ``degraded`` and the descent counted.  Only an injected
fault or the card running out of memory descends: solver verdicts,
invalid models, a kernel that fails to build, load or launch, and any
other error raise at once.
The resident model and the warm seed are shared, so each solve gets its
own copy of them.

Several candidate broker sets in `add_brokers`, `remove_brokers` or
`demote_brokers` are a what-if analysis: the scenario engine
(scenario/engine.py) solves them in one batch, with its own ladder, and
the best candidate's proposals come back with the ranked report.

With an `admin` client (cluster/admin.py), a request with `dryrun=False`
hands its proposals to the facade's `Executor` (executor/), which moves
replicas, logdirs and leadership through that client; with
`executor_journal_dir` every execution is journaled and
`recover_interrupted_execution` settles what a crashed process left in
flight.  The sampled monitor refreshes the cluster's metadata for each
model and samples the executed placement in its next rounds; a
`SnapshotLoadMonitor` is refreshed by its caller (`update_cluster`).
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time as _time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from cruise_control_tpu_torch.analyzer.context import (BalancingConstraint,
                                                       OptimizationOptions)
from cruise_control_tpu_torch.analyzer.degradation import (
    BackoffPolicy, CircuitBreaker, DegradationLadder, FailureKind,
    SolverRung, classify_failure, ladder_material)
from cruise_control_tpu_torch.analyzer.goals.base import OptimizationFailure
from cruise_control_tpu_torch.analyzer.goals.registry import (
    DEFAULT_GOAL_ORDER, KAFKA_ASSIGNER_GOAL_ORDER, default_goals, make_goal)
from cruise_control_tpu_torch.analyzer.optimizer import (GoalOptimizer,
                                                         OptimizerResult)
from cruise_control_tpu_torch.analyzer.options_generator import \
    DefaultOptimizationOptionsGenerator
from cruise_control_tpu_torch.analyzer.proposals import (ExecutionProposal,
                                                         ReplicaPlacement)
from cruise_control_tpu_torch.config.capacity import StaticCapacityResolver
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.executor.executor import (Executor,
                                                        ExecutorNotifier)
from cruise_control_tpu_torch.executor.journal import (
    DEFAULT_SEGMENT_MAX_BYTES, ExecutionJournal)
from cruise_control_tpu_torch.executor.strategy import \
    ReplicaMovementStrategy
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model.state import ClusterState
from cruise_control_tpu_torch.model.state import own_copy as _own_copy
from cruise_control_tpu_torch.model.store import DeviceModelStore
from cruise_control_tpu_torch.model.topology import PartitionId
from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor
from cruise_control_tpu_torch.obs import trace as obs_trace
from cruise_control_tpu_torch.scenario.engine import (BASE_SCENARIO_NAME,
                                                      ScenarioBatchResult,
                                                      ScenarioEngine)
from cruise_control_tpu_torch.scenario.spec import (BrokerAdd, ScenarioSpec,
                                                    candidate_broker_sets)
from cruise_control_tpu_torch.sched.policy import SchedulerClass

LOG = logging.getLogger(__name__)
#: operations audit log: one INFO line per requested mutation
OPERATION_LOG = logging.getLogger("operationLogger")


class OngoingExecutionError(RuntimeError):
    """An execution is already in progress."""


def _warm_start_compatible(seed: ClusterState, state: ClusterState) -> bool:
    """True when `seed` (a previous solve's final state) can warm-start a
    solve over `state`: the same replica, partition, broker and logdir
    axes, an unbroken cluster (no dead broker or logdir, no offline
    replica) and the same replica, topic, logdir and rack identities."""
    if (seed.num_replicas != state.num_replicas
            or seed.num_partitions != state.num_partitions
            or seed.num_brokers != state.num_brokers
            or seed.num_disks != state.num_disks):
        return False
    alive = bool(torch.all(state.broker_alive)
                 and torch.all(state.disk_alive)
                 and not torch.any(state.replica_offline))
    return alive and all(
        torch.equal(getattr(seed, f).to(state.device), getattr(state, f))
        for f in ("replica_partition", "replica_valid", "partition_topic",
                  "disk_broker", "broker_rack"))


def _not_ported(what: str, module: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs the reference's {module}, which the port does not "
        f"have yet")


@dataclasses.dataclass
class OperationResult:
    """What a request returns: the optimizer result and its proposals,
    and, when not a dry run, the uuid of the execution driving them.
    `dryrun` is what the caller asked for: an executed request that found
    nothing to do has no uuid and is still not a dry run."""

    optimizer_result: Optional[OptimizerResult]
    execution_uuid: Optional[str] = None
    proposals: List = dataclasses.field(default_factory=list)
    dryrun: bool = True
    #: the ranked what-if report when the request carried several
    #: candidate broker sets (always a dry run; `proposals` then holds
    #: the best candidate's)
    scenario_report: Optional[dict] = None

    def __post_init__(self) -> None:
        if self.optimizer_result is not None and not self.proposals:
            self.proposals = list(self.optimizer_result.proposals)


class CruiseControl:
    """The facade over the cluster's `admin` client: the reference's
    `(admin, sampler, capacity_resolver, ..., monitor_kwargs)` build a
    `LoadMonitor` that samples the cluster through `sampler`
    (`monitor_kwargs` are its settings; its time is the facade's
    `time_fn`, its device the facade's).  `load_monitor=` takes a built
    monitor instead (`LoadMonitor` or `SnapshotLoadMonitor`: any object
    with `model_generation`, `cluster_model`, `deltas_between`,
    `follower_cpu_estimator`, `acquire_for_model_generation`, `start_up`,
    `shutdown`, `pause_metric_sampling` and `resume_metric_sampling`);
    then `admin` is optional and without it the facade serves dry runs
    only.  The settings are the reference's, with its defaults;
    `max_optimization_rounds` sets the default stack's rounds (hard
    goals keep at least 1,024); `executor_kwargs` go to the `Executor`
    (its caps, intervals, timeouts and throttle); `sleep_fn` waits out
    the executor's polls and the ladder's retry backoff."""

    def __init__(self, admin=None, sampler=None, capacity_resolver=None, *,
                 load_monitor=None, monitor_kwargs: Optional[dict] = None,
                 device=None,
                 goal_names: Optional[Sequence[str]] = None,
                 max_optimization_rounds: Optional[int] = None,
                 constraint: Optional[BalancingConstraint] = None,
                 balancedness_weights: Tuple[float, float] = (1.1, 1.5),
                 options_generator=None,
                 proposal_expiration_s: float = 900.0,
                 warm_start_proposals: bool = True,
                 solver_fusion_enabled: bool = False,
                 solver_host_skip_enabled: bool = False,
                 solver_precision: str = "float32",
                 incremental_enabled: bool = True,
                 incremental_max_deltas: int = 64,
                 incremental_max_dirty_ratio: float = 0.5,
                 solver_degradation_enabled: bool = True,
                 solver_max_retries_per_rung: int = 1,
                 solver_retry_backoff_base_s: float = 1.0,
                 solver_retry_backoff_max_s: float = 60.0,
                 solver_breaker_failure_threshold: int = 3,
                 solver_breaker_cooldown_s: float = 300.0,
                 scenario_engine_enabled: bool = True,
                 scenario_max_batch_size: int = 32,
                 scenario_include_base: bool = True,
                 executor_notifier: Optional[ExecutorNotifier] = None,
                 executor_kwargs: Optional[dict] = None,
                 executor_journal_dir: Optional[str] = None,
                 executor_recovery_mode: str = "resume",
                 executor_journal_segment_max_bytes: Optional[int] = None,
                 time_fn: Optional[Callable[[], float]] = None,
                 sleep_fn: Optional[Callable[[float], None]] = None
                 ) -> None:
        if solver_precision != "float32":
            raise _not_ported(f"solver_precision={solver_precision!r}",
                              "analyzer/precision.py")
        if executor_recovery_mode not in ("resume", "abort"):
            raise ValueError(
                f"executor.recovery.mode must be resume|abort, got "
                f"{executor_recovery_mode!r}")
        self.device = resolve_device(device)
        self._time = time_fn or _time.time
        self._sleep = sleep_fn or _time.sleep
        if load_monitor is None:
            if admin is None or sampler is None:
                raise ValueError("CruiseControl needs the cluster's admin "
                                 "client and a metric sampler, or a built "
                                 "load_monitor")
            load_monitor = LoadMonitor(
                admin, sampler, capacity_resolver or StaticCapacityResolver(),
                time_fn=self._time, device=self.device,
                **(monitor_kwargs or {}))
        elif (sampler is not None or capacity_resolver is not None
              or monitor_kwargs):
            raise ValueError("a built load_monitor takes no sampler, "
                             "capacity_resolver or monitor_kwargs")
        self.load_monitor = load_monitor
        self._executor_recovery_mode = executor_recovery_mode
        self._executor_recovery_done = False
        #: the executor needs the cluster's admin client; without one the
        #: facade serves dry runs only
        self.executor_journal: Optional[ExecutionJournal] = None
        self.executor: Optional[Executor] = None
        if admin is not None:
            if executor_journal_dir:
                self.executor_journal = ExecutionJournal(
                    executor_journal_dir,
                    segment_max_bytes=(executor_journal_segment_max_bytes
                                       or DEFAULT_SEGMENT_MAX_BYTES),
                    time_fn=self._time)
                self.executor_journal.on_error = self._on_journal_error
            self.executor = Executor(
                admin, load_monitor=load_monitor,
                notifier=executor_notifier, time_fn=self._time,
                sleep_fn=sleep_fn, journal=self.executor_journal,
                **(executor_kwargs or {}))
        #: journal failures (the journal carried on journal-less): their
        #: count and the last one's text
        self.journal_error_events = 0
        self.last_journal_error: Optional[str] = None
        #: the trace of the last `recover_interrupted_execution`
        self.last_recovery_trace: Optional[obs_trace.Trace] = None
        self._constraint = constraint or BalancingConstraint()
        self._options_generator = (options_generator
                                   or DefaultOptimizationOptionsGenerator())
        self._incremental_enabled = incremental_enabled
        self._incremental_max_deltas = max(0, incremental_max_deltas)
        self._incremental_max_dirty_ratio = min(
            1.0, max(0.0, incremental_max_dirty_ratio))
        self.model_store = DeviceModelStore()
        self.goal_optimizer = GoalOptimizer(
            default_goals(names=list(goal_names or DEFAULT_GOAL_ORDER),
                          max_rounds=max_optimization_rounds),
            self._constraint, balancedness_weights=balancedness_weights,
            fused_segments=solver_fusion_enabled,
            host_side_skip=solver_host_skip_enabled)
        self._ple_optimizer = GoalOptimizer(
            [make_goal("PreferredLeaderElectionGoal")], self._constraint)
        self._cache_lock = threading.Lock()
        self._cached_result: Optional[OptimizerResult] = None
        self._cached_generation = None
        self._cached_at = 0.0
        self._cache_epoch = 0
        self._proposal_expiration_s = proposal_expiration_s
        self._warm_start_enabled = warm_start_proposals
        #: (final state, model generation it solved) of the last
        #: default-stack request with default options
        self._warm_seed: Optional[Tuple] = None
        #: dirty-region solves that failed their verdict and were retried
        #: as a full sweep
        self.incremental_solve_fallbacks = 0

        # the degradation ladder of the request solves
        self._solver_degradation_enabled = solver_degradation_enabled
        self._solver_max_retries_per_rung = max(0,
                                                solver_max_retries_per_rung)
        self._solver_backoff = BackoffPolicy(
            base_s=solver_retry_backoff_base_s,
            max_s=solver_retry_backoff_max_s)
        self.solver_breaker = CircuitBreaker(
            failure_threshold=solver_breaker_failure_threshold,
            cooldown_s=solver_breaker_cooldown_s, time_fn=self._time)
        #: the port has no mesh: its ladder tops out at FUSED
        self._solver_top_rung = SolverRung.FUSED
        self.solver_ladder = DegradationLadder(
            self.solver_breaker, top_rung=self._solver_top_rung)
        #: the ladder's meters (the reference's solver-descents and
        #: solver-retries) and the rung that served the last proposal
        #: solve
        self.solver_descents = 0
        self.solver_retries = 0
        self.last_solve_rung: Optional[SolverRung] = None
        #: the trace of the last request (its outcome: "ok", "degraded")
        self.last_solve_trace: Optional[obs_trace.Trace] = None

        # the what-if scenario engine, with its own ladder: a failing
        # what-if batch must not pin the request solves, nor they it
        self._scenario_enabled = scenario_engine_enabled
        self._scenario_include_base = scenario_include_base
        self.scenario_engine = ScenarioEngine(
            self._optimizer_for, constraint=self._constraint,
            max_batch_size=scenario_max_batch_size,
            breaker_failure_threshold=solver_breaker_failure_threshold,
            breaker_cooldown_s=solver_breaker_cooldown_s,
            balancedness_weights=balancedness_weights,
            time_fn=self._time, device=self.device)

    # ------------------------------------------------------------------
    # options
    # ------------------------------------------------------------------
    def _self_healing_options(self, recently_demoted=None,
                              recently_removed=None
                              ) -> Optional[OptimizationOptions]:
        """Exclusions for a self-healing fix: recently demoted brokers
        take no leadership, recently removed brokers take no replicas.
        Each list defaults to the executor's history (none without an
        executor)."""
        ex = self.executor
        if recently_demoted is None:
            recently_demoted = (ex.recently_demoted_brokers()
                                if ex is not None else ())
        if recently_removed is None:
            recently_removed = (ex.recently_removed_brokers()
                                if ex is not None else ())
        excl_lead = frozenset(recently_demoted)
        excl_move = frozenset(recently_removed)
        if not excl_lead and not excl_move:
            return None
        return OptimizationOptions(
            excluded_brokers_for_leadership=excl_lead,
            excluded_brokers_for_replica_move=excl_move,
            is_triggered_by_goal_violation=True)

    def _optimizer_for(self, goals: Optional[Sequence[str]]
                       ) -> GoalOptimizer:
        if goals is None:
            return self.goal_optimizer
        return GoalOptimizer(default_goals(names=list(goals)),
                             self._constraint)

    def _sanity_check_execution(self, dryrun: bool) -> None:
        if dryrun:
            return
        if self.executor is None:
            raise ValueError("dryrun=False needs the cluster's admin client "
                             "(CruiseControl(admin=...))")
        if self.executor.has_ongoing_execution:
            raise OngoingExecutionError(
                "cannot start execution: another execution is in progress")

    def _maybe_execute(self, result: OptimizerResult, dryrun: bool,
                       reason: str,
                       strategy: Optional[ReplicaMovementStrategy],
                       **execute_kwargs) -> OperationResult:
        OPERATION_LOG.info(
            "%s: %d proposals (%d replica moves, %d leadership moves), "
            "dryrun=%s", reason, len(result.proposals),
            result.num_replica_movements, result.num_leadership_movements,
            dryrun)
        if dryrun or not result.proposals:
            return OperationResult(result, dryrun=dryrun)
        uuid = self.executor.execute_proposals(
            result.proposals, reason=reason, strategy=strategy,
            **execute_kwargs)
        self._invalidate_proposal_cache()
        return OperationResult(result, execution_uuid=uuid, dryrun=False)

    # ------------------------------------------------------------------
    # executions: crash recovery, journal errors, shutdown
    # ------------------------------------------------------------------
    def recover_interrupted_execution(self) -> Optional[dict]:
        """Replay the executor journal and settle what the previous
        process left in flight (executor/recovery.py): per
        `executor_recovery_mode` the interrupted execution is resumed
        under its original uuid or aborted and cleaned; in both modes
        orphaned replication throttles are removed.  Idempotent (the
        first call wins) and best effort: a failed recovery is logged,
        never raised.  Returns the recovery report, or None when there
        was nothing to recover (or journaling is off).  The recovery's
        trace is kept as `last_recovery_trace`."""
        if self.executor_journal is None or self._executor_recovery_done:
            return None
        self._executor_recovery_done = True
        mode = self._executor_recovery_mode
        trace = obs_trace.start("executor.recovery", mode=mode)
        self.last_recovery_trace = trace
        try:
            report = self.executor.recover(mode=mode)
        except Exception as exc:  # noqa: BLE001 - startup must survive
            LOG.exception("executor crash recovery failed; the journal "
                          "is left in place for manual inspection")
            obs_trace.finish(trace, error=exc)
            return None
        obs_trace.finish(trace)
        if report is not None:
            LOG.warning("execution %s recovered (mode=%s): %d terminal, "
                        "%d adopted, %d pending tasks; throttles cleared "
                        "on %s", report.get("uuid"), mode,
                        report.get("tasksTerminal", 0),
                        report.get("tasksAdopted", 0),
                        report.get("tasksPending", 0),
                        report.get("clearedThrottleBrokers", []))
        return report

    def _on_journal_error(self, exc: BaseException) -> None:
        """The executor journal degraded to journal-less execution (disk
        full, EIO): count it and keep it; the rebalance continues."""
        self.journal_error_events += 1
        self.last_journal_error = f"{type(exc).__name__}: {exc}"
        LOG.error("executor journal degraded (%s); the execution "
                  "continues journal-less", self.last_journal_error)

    def start_up(self, do_sampling: bool = True,
                 skip_loading_samples: bool = False) -> None:
        """Crash recovery first (an execution the previous process left
        in flight is settled before anything samples or solves over a
        half-moved cluster), then the monitor's start-up: the stored
        samples reloaded, and unless `do_sampling` is False its sampling
        thread started."""
        self.recover_interrupted_execution()
        self.load_monitor.start_up(do_sampling=do_sampling,
                                   skip_loading_samples=skip_loading_samples)

    def shutdown(self) -> None:
        """Stop the executor (force-stop: in-flight reassignments are
        cancelled), wait for it, close the journal, then stop the
        monitor (its sampling thread and fetcher pool)."""
        if self.executor is not None:
            self.executor.stop_execution(force=True)
            self.executor.await_completion(timeout=30.0)
        if self.executor_journal is not None:
            self.executor_journal.close()
        self.load_monitor.shutdown()

    def stop_execution(self, force: bool = False) -> None:
        """Stop the ongoing execution, if any."""
        if self.executor is not None:
            self.executor.stop_execution(force=force)

    def pause_sampling(self, reason: str = "paused by user") -> None:
        self.load_monitor.pause_metric_sampling(reason)

    def resume_sampling(self, reason: str = "resumed by user") -> None:
        self.load_monitor.resume_metric_sampling(reason)

    # ------------------------------------------------------------------
    # proposals
    # ------------------------------------------------------------------
    def optimizations(self, goals: Optional[Sequence[str]] = None,
                      options: Optional[OptimizationOptions] = None,
                      ignore_proposal_cache: bool = False,
                      portfolio_width: Optional[int] = None,
                      _allow_capacity_estimation: Optional[bool] = None,
                      _eager_hard_abort: Optional[bool] = None,
                      _scheduler_class: Optional[SchedulerClass] = None
                      ) -> OptimizerResult:
        """Proposals for the current model.  The cache serves the default
        goal list with default options while the model generation holds;
        such a request otherwise solves warm from the last one's final
        placement, and an interactive one only over the brokers the
        deltas since touched when they are at most
        `incremental_max_dirty_ratio` of the cluster.  A restricted solve
        that fails its verdict is retried as a full sweep."""
        if portfolio_width is not None and int(portfolio_width) > 1:
            raise _not_ported("portfolio_width > 1", "portfolio search")
        klass = (_scheduler_class if _scheduler_class is not None
                 else SchedulerClass.USER_INTERACTIVE)
        cacheable = goals is None and options is None
        generation = self.load_monitor.model_generation()
        if cacheable and not ignore_proposal_cache:
            with self._cache_lock:
                if self._cache_valid(generation):
                    return self._cached_result
        optimizer = self._optimizer_for(goals)
        allow_incremental = (self._incremental_enabled and cacheable
                             and klass is SchedulerClass.USER_INTERACTIVE)

        def run_solve() -> OptimizerResult:
            with self._cache_lock:
                epoch = self._cache_epoch
            cell: Optional[Dict] = {} if allow_incremental else None
            try:
                result = self._solve(optimizer, cacheable, options,
                                     _allow_capacity_estimation,
                                     _eager_hard_abort, incremental=cell)
            except OptimizationFailure:
                if not (cell and cell.get("dirty")):
                    raise
                # a restricted solve may fail a verdict that the full
                # sweep can meet (a hard violation outside the region)
                self.incremental_solve_fallbacks += 1
                self.model_store.record_fallback(
                    "dirty-region solve verdict; full sweep retry")
                LOG.info("dirty-region solve failed its verdict; retrying "
                         "as a full sweep")
                result = self._solve(optimizer, cacheable, options,
                                     _allow_capacity_estimation,
                                     _eager_hard_abort)
            if cacheable:
                with self._cache_lock:
                    self._warm_seed = (result.final_state, generation)
                    if self._cache_epoch == epoch:
                        self._cached_result = result
                        self._cached_generation = generation
                        self._cached_at = self._time()
            return result

        return self._traced(klass, run_solve, "optimizations")

    def _cache_valid(self, generation) -> bool:
        """Caller holds _cache_lock."""
        return (self._cached_result is not None
                and self._cached_generation == generation
                and (self._time() - self._cached_at
                     < self._proposal_expiration_s))

    def _invalidate_proposal_cache(self) -> None:
        with self._cache_lock:
            self._cached_result = None
            self._cache_epoch += 1

    def cluster_model(self, requirements=None,
                      allow_capacity_estimation: Optional[bool] = None):
        """A fresh build of the monitor's model under `requirements` (the
        monitor's default when None), behind the monitor's model-build
        semaphore."""
        if allow_capacity_estimation is None:
            allow_capacity_estimation = True
        with self.load_monitor.acquire_for_model_generation():
            return self.load_monitor.cluster_model(
                requirements,
                allow_capacity_estimation=allow_capacity_estimation)

    def _model_for_solve(self, allow_capacity_estimation=None):
        """(state, topology) resident in the device model store: the
        store's model as it is, fast-forwarded through the monitor's
        logged deltas, or rebuilt from the monitor and installed.  The
        state is the store's own; a solve takes a copy."""
        if allow_capacity_estimation is None:
            allow_capacity_estimation = True
        monitor = self.load_monitor
        if not self._incremental_enabled:
            return self.cluster_model(
                allow_capacity_estimation=allow_capacity_estimation)
        store = self.model_store
        generation = monitor.model_generation()
        hit = store.get(generation, allow_capacity_estimation)
        if hit is not None:
            return hit
        store_gen = store.generation
        if store_gen is None:
            store.count_miss()
        elif store.capacity_flag != bool(allow_capacity_estimation):
            store.record_fallback("capacity-estimation-flag")
        else:
            chain = monitor.deltas_between(store_gen, generation)
            if chain and len(chain) <= self._incremental_max_deltas:
                adv = store.advance(chain, generation)
                if adv is not None:
                    return adv
            elif chain:
                store.record_fallback(
                    f"delta-chain too long ({len(chain)} > "
                    f"{self._incremental_max_deltas})")
            else:
                store.record_fallback("generation-gap")
        state, topo = self.cluster_model(
            allow_capacity_estimation=allow_capacity_estimation)
        # install only when the generation did not move under the build
        if monitor.model_generation() == generation:
            store.install(generation, state, topo,
                          allow_capacity_estimation,
                          monitor.follower_cpu_estimator())
        return state, topo

    def _materialize_solve_inputs(self, cacheable: bool,
                                  allow_capacity_estimation,
                                  incremental=None):
        """(state, topology, warm seed, dirty-broker mask) of one solve.
        The seed counts only when the monitor can account for its
        generation (unchanged, or reached by logged deltas); a move the
        log does not cover drops it.  `incremental` (a dict, or None)
        asks for the dirty mask and records that it engaged."""
        generation = self.load_monitor.model_generation()
        state, topo = self._model_for_solve(allow_capacity_estimation)
        num_brokers = state.num_brokers
        warm = None
        dirty = None
        if cacheable and self._warm_start_enabled:
            with self._cache_lock:
                seed = self._warm_seed
            if seed is not None:
                seed_state, seed_gen = seed
                ok = True
                if seed_gen != generation:
                    chain = self.load_monitor.deltas_between(seed_gen,
                                                             generation)
                    if chain is None:
                        with self._cache_lock:
                            if self._warm_seed is seed:
                                self._warm_seed = None
                        ok = False
                    elif incremental is not None:
                        dirty = self._dirty_mask_for(seed_gen, num_brokers)
                if ok and _warm_start_compatible(seed_state, state):
                    warm = seed_state
        if warm is None:
            dirty = None
        if dirty is not None:
            incremental["dirty"] = True
        return state, topo, warm, dirty

    def _dirty_mask_for(self, seed_generation, num_brokers: int):
        """The dirty-broker mask of every delta between the seed's
        generation and the resident model, or None: no coverage, or more
        than `incremental_max_dirty_ratio` of the brokers dirty (counted
        as a store fallback)."""
        if not self._incremental_enabled:
            return None
        dirty = self.model_store.dirty_since(seed_generation)
        if dirty is None:
            return None
        count = int(torch.sum(dirty.to(torch.int32)))
        if count > self._incremental_max_dirty_ratio * num_brokers:
            self.model_store.record_fallback(
                f"dirty region too large ({count}/{num_brokers} "
                f"brokers)")
            return None
        return dirty

    def _solve_on_rung(self, rung: SolverRung, optimizer: GoalOptimizer,
                       cacheable: bool, options, allow_capacity_estimation,
                       eager_hard_abort,
                       incremental=None) -> OptimizerResult:
        """One solve on `rung`: FUSED with the warm seed and the dirty
        region, EAGER with the seed but no dirty region, CPU the host
        fallback (self-healing repair only, the request's broker-level
        exclusions kept)."""
        incr = incremental if rung is SolverRung.FUSED else None
        state, topo, warm, dirty = self._materialize_solve_inputs(
            cacheable, allow_capacity_estimation, incremental=incr)
        gen_options = self._options_generator.generate(
            options or OptimizationOptions(), topo)
        with obs_trace.span("device.solve", rung=rung.name,
                            dirtyRegion=dirty is not None):
            if rung is SolverRung.CPU:
                from cruise_control_tpu_torch.model.cpu_model import \
                    host_fallback_solve
                return host_fallback_solve(state, topo,
                                           options=gen_options,
                                           time_fn=self._time)
            state = _own_copy(state)
            warm = None if warm is None else _own_copy(warm)
            if rung is SolverRung.FUSED:
                return optimizer.optimizations(
                    state, topo, gen_options, warm_start=warm,
                    eager_hard_abort=eager_hard_abort, dirty_brokers=dirty,
                    device=self.device)
            return optimizer.optimizations(
                state, topo, gen_options, warm_start=warm,
                eager_hard_abort=True, eager_driver=True,
                device=self.device)

    def _solve(self, optimizer: GoalOptimizer, cacheable: bool, options,
               allow_capacity_estimation, eager_hard_abort,
               incremental=None) -> OptimizerResult:
        """A proposal request's solve through the degradation ladder:
        retried with exponential backoff and jitter on its rung, served
        from the next rung down (FUSED, EAGER, CPU) once the rung has
        used its retries, with the breaker pinning a degraded rung until
        its cooldown.  A descent marks the request's trace ``degraded``,
        emits ``solve.descend`` and counts on the facade; a descent below
        FUSED invalidates the device model store.

        Only an injected fault or the card running out of memory is
        ladder material (`degradation.ladder_material`); anything else
        raises at once: OptimizationFailure (a solver verdict, the same
        at every rung), InvalidModelInputError (garbage at every rung),
        SolvePreempted (control flow), a kernel that fails to build,
        load or launch (it must not hide behind the host rung) and any
        other error of the port."""
        if not self._solver_degradation_enabled:
            with obs_trace.span("solve.rung-attempt",
                                rung=self._solver_top_rung.name, retry=0):
                result = self._solve_on_rung(
                    self._solver_top_rung, optimizer, cacheable, options,
                    allow_capacity_estimation, eager_hard_abort,
                    incremental=incremental)
            self.last_solve_rung = self._solver_top_rung
            return result
        rung = self.solver_ladder.entry_rung()
        delays = self._solver_backoff.delays()
        attempts_on_rung = 0
        while True:
            try:
                with obs_trace.span("solve.rung-attempt", rung=rung.name,
                                    retry=attempts_on_rung):
                    result = self._solve_on_rung(
                        rung, optimizer, cacheable, options,
                        allow_capacity_estimation, eager_hard_abort,
                        incremental=incremental)
            except Exception as exc:  # noqa: BLE001 - the ladder classifies
                if not ladder_material(exc):
                    raise
                kind = classify_failure(exc)
                obs_trace.event("solve.failure", rung=rung.name,
                                kind=kind.value, retry=attempts_on_rung)
                tripped = self.solver_ladder.on_failure(rung)
                LOG.warning("solve failed at rung %s (%s): %s", rung.name,
                            kind.value, exc)
                if tripped:
                    self._report_solver_degraded(
                        rung, self.solver_ladder.rung, kind, exc, True)
                attempts_on_rung += 1
                if attempts_on_rung <= self._solver_max_retries_per_rung:
                    self.solver_retries += 1
                    self._sleep(next(delays))
                    continue
                nxt = self.solver_ladder.descend(rung)
                if nxt is None:
                    # the bottom rung failed: nothing left to degrade to
                    if not tripped:
                        self._report_solver_degraded(rung, None, kind, exc,
                                                     False)
                    raise
                if nxt >= SolverRung.EAGER:
                    # a device sick enough to fail the pipeline is no
                    # place to trust resident buffers
                    self.model_store.invalidate(
                        f"ladder descent to {nxt.name}")
                self.solver_descents += 1
                obs_trace.mark("degraded")
                obs_trace.event("solve.descend", from_rung=rung.name,
                                to_rung=nxt.name, kind=kind.value)
                if not tripped:
                    self._report_solver_degraded(rung, nxt, kind, exc,
                                                 False)
                rung = nxt
                attempts_on_rung = 0
                continue
            self.solver_ladder.on_success(rung)
            self.last_solve_rung = rung
            if rung > self._solver_top_rung:
                # served degraded: mark the trace even when the descent
                # happened in an earlier request (a pinned rung)
                obs_trace.mark("degraded")
                LOG.info("solve served from degraded rung %s", rung.name)
            return result

    def _report_solver_degraded(self, from_rung: SolverRung,
                                to_rung: Optional[SolverRung],
                                kind: FailureKind, exc: BaseException,
                                breaker_tripped: bool) -> None:
        """Mark the request's trace degraded and log the report (the
        reference also raises a SolverDegraded anomaly and dumps its
        flight recorder: neither is ported)."""
        obs_trace.mark("degraded")
        LOG.warning("solver degraded %s -> %s (%s, breaker tripped: %s): "
                    "%s: %s", from_rung.name,
                    to_rung.name if to_rung is not None else "none",
                    kind.value, breaker_tripped, type(exc).__name__, exc)

    def _traced(self, klass: SchedulerClass, run, label: str):
        """Run a request's solve inside its trace (the reference's
        `_scheduled_solve` without the scheduler): the active trace, or
        one minted and finished around the solve, kept as
        `last_solve_trace`."""
        with obs_trace.solve_trace(f"solve.{label}",
                                   schedulerClass=klass.name) as trace:
            self.last_solve_trace = trace
            return run()

    def _solve_request(self, optimizer: GoalOptimizer, state: ClusterState,
                       topo, options=None) -> OptimizerResult:
        """A broker request's solve on its own copy of the state."""
        return optimizer.optimizations(_own_copy(state), topo, options,
                                       device=self.device)

    # ------------------------------------------------------------------
    # requests
    # ------------------------------------------------------------------
    def rebalance(self, goals: Optional[Sequence[str]] = None,
                  dryrun: bool = True,
                  options: Optional[OptimizationOptions] = None,
                  reason: str = "rebalance",
                  strategy: Optional[ReplicaMovementStrategy] = None,
                  ignore_proposal_cache: bool = False,
                  kafka_assigner: bool = False,
                  portfolio_width: Optional[int] = None,
                  _scheduler_class: Optional[SchedulerClass] = None,
                  **execute_kwargs) -> OperationResult:
        """Proposals of `optimizations`, executed unless `dryrun`;
        `kafka_assigner` swaps in the kafka-assigner goal order."""
        self._sanity_check_execution(dryrun)
        if kafka_assigner:
            goals = list(KAFKA_ASSIGNER_GOAL_ORDER)
        result = self.optimizations(
            goals, options,
            ignore_proposal_cache=ignore_proposal_cache
            or options is not None or kafka_assigner,
            portfolio_width=portfolio_width,
            _scheduler_class=_scheduler_class)
        return self._maybe_execute(result, dryrun, reason, strategy,
                                   **execute_kwargs)

    # ------------------------------------------------------------------
    # what-if scenarios
    # ------------------------------------------------------------------
    def evaluate_scenarios(self, specs: Sequence[ScenarioSpec],
                           goals: Optional[Sequence[str]] = None,
                           include_base: Optional[bool] = None,
                           include_proposals: bool = True,
                           reason: str = "scenarios",
                           _scheduler_class: Optional[SchedulerClass]
                           = None) -> ScenarioBatchResult:
        """Evaluate what-if cluster variants in one batch of the scenario
        engine, a dry run only.  Unless `include_base` (default:
        `scenario_include_base`) is False, the no-op base scenario comes
        first, so the report can diff every variant against doing
        nothing.  Runs inline (the reference's single-caller fold: the
        port has no scheduler to fold sweeps in)."""
        if not self._scenario_enabled:
            raise ValueError("the scenario engine is disabled "
                             "(scenario.engine.enabled=false)")
        specs = list(specs)
        if not specs:
            raise ValueError("no scenarios given")
        if include_base is None:
            include_base = self._scenario_include_base
        if include_base and not any(s.name == BASE_SCENARIO_NAME
                                    for s in specs):
            specs = [ScenarioSpec(name=BASE_SCENARIO_NAME)] + specs
        klass = (_scheduler_class if _scheduler_class is not None
                 else SchedulerClass.SCENARIO_SWEEP)
        OPERATION_LOG.info("%s: evaluating %d scenarios (dry run)",
                           reason, len(specs))

        def fold_run(spec_lists: List[List[ScenarioSpec]]
                     ) -> List[ScenarioBatchResult]:
            state, topo = self._model_for_solve()
            gen_options = self._options_generator.generate(
                OptimizationOptions(), topo)
            return [self.scenario_engine.evaluate(
                state, topo, lst, goals=goals, options=gen_options,
                include_proposals=include_proposals) for lst in spec_lists]

        return self._traced(klass, lambda: fold_run([specs])[0],
                            "scenarios")

    def _broker_candidates(self, op: str, sets, goals, dryrun: bool,
                           reason: str) -> OperationResult:
        """ADD/REMOVE/DEMOTE_BROKER with several candidate broker sets:
        one batched what-if ranks them and the best candidate's proposals
        come back with the whole report.  Never executes: submit the
        winner as one set to act on it."""
        from cruise_control_tpu_torch.scenario.report import (batch_report,
                                                              rank)
        if not dryrun:
            raise ValueError(
                f"{op} with multiple candidate broker sets is a what-if "
                f"analysis (dry-run only); execute with ONE broker set")
        specs = []
        for s in sets:
            name = f"{op}-{'-'.join(str(b) for b in s)}"
            if op == "add":
                specs.append(ScenarioSpec(
                    name=name,
                    add_brokers=tuple(BrokerAdd(broker_id=b) for b in s),
                    only_move_to_added=True,
                    goals=tuple(goals) if goals else None))
            elif op == "remove":
                specs.append(ScenarioSpec(
                    name=name, remove_brokers=tuple(s),
                    goals=tuple(goals) if goals else None))
            else:
                specs.append(ScenarioSpec(
                    name=name, demote_brokers=tuple(s),
                    goals=("PreferredLeaderElectionGoal",)))
        result = self.evaluate_scenarios(specs, reason=reason)
        candidates = [o for o in result.outcomes
                      if o.spec.name != BASE_SCENARIO_NAME]
        best = rank(candidates)[0]
        OPERATION_LOG.info(
            "%s: best of %d candidates is %r (feasible=%s, "
            "balancedness=%.1f), dryrun=True", reason, len(candidates),
            best.spec.name, best.feasible, best.balancedness)
        return OperationResult(None, proposals=list(best.proposals),
                               dryrun=True,
                               scenario_report=batch_report(result))

    # ------------------------------------------------------------------
    # broker requests
    # ------------------------------------------------------------------
    def add_brokers(self, broker_ids: Sequence[int],
                    goals: Optional[Sequence[str]] = None,
                    dryrun: bool = True, reason: str = "add brokers",
                    _scheduler_class: Optional[SchedulerClass] = None,
                    **execute_kwargs) -> OperationResult:
        """Move replicas onto the given brokers only: they are marked new
        and are the only move destinations (no options generator).  A
        sequence of sequences is several candidate sets, ranked by the
        scenario engine (a dry run)."""
        sets = candidate_broker_sets(broker_ids)
        if sets is not None and len(sets) > 1:
            return self._broker_candidates("add", sets, goals, dryrun,
                                           reason)
        if sets is not None:
            broker_ids = sets[0]
        self._sanity_check_execution(dryrun)
        state, topo = self._model_for_solve()
        idx = topo.broker_index
        for b in broker_ids:
            state = S.set_broker_state(state, idx[b], new=True)
        options = OptimizationOptions(
            requested_destination_broker_ids=frozenset(broker_ids))
        optimizer = self._optimizer_for(goals)
        result = self._traced(
            _scheduler_class or SchedulerClass.USER_INTERACTIVE,
            lambda: self._solve_request(optimizer, state, topo, options),
            "add-brokers")
        return self._maybe_execute(result, dryrun, reason, None,
                                   **execute_kwargs)

    def remove_brokers(self, broker_ids: Sequence[int],
                       goals: Optional[Sequence[str]] = None,
                       dryrun: bool = True, reason: str = "remove brokers",
                       _scheduler_class: Optional[SchedulerClass] = None,
                       **execute_kwargs) -> OperationResult:
        """Drain every replica off the given brokers (modeled dead, so
        self-healing moves them); an execution records them as recently
        removed.  Several candidate sets: see `add_brokers`."""
        sets = candidate_broker_sets(broker_ids)
        if sets is not None and len(sets) > 1:
            return self._broker_candidates("remove", sets, goals, dryrun,
                                           reason)
        if sets is not None:
            broker_ids = sets[0]
        self._sanity_check_execution(dryrun)
        state, topo = self._model_for_solve()
        idx = topo.broker_index
        for b in broker_ids:
            state = S.set_broker_state(state, idx[b], alive=False)
        optimizer = self._optimizer_for(goals)
        result = self._traced(
            _scheduler_class or SchedulerClass.USER_INTERACTIVE,
            lambda: self._solve_request(optimizer, state, topo),
            "remove-brokers")
        return self._maybe_execute(result, dryrun, reason, None,
                                   removed_brokers=list(broker_ids),
                                   **execute_kwargs)

    def demote_brokers(self, broker_ids: Sequence[int],
                       dryrun: bool = True, reason: str = "demote brokers",
                       _scheduler_class: Optional[SchedulerClass] = None,
                       **execute_kwargs) -> OperationResult:
        """Move leadership off the given brokers (preferred leader
        election); an execution records them as recently demoted.
        Several candidate sets: see `add_brokers`."""
        sets = candidate_broker_sets(broker_ids)
        if sets is not None and len(sets) > 1:
            return self._broker_candidates("demote", sets, None, dryrun,
                                           reason)
        if sets is not None:
            broker_ids = sets[0]
        self._sanity_check_execution(dryrun)
        state, topo = self._model_for_solve()
        idx = topo.broker_index
        for b in broker_ids:
            state = S.set_broker_state(state, idx[b], demoted=True)
        result = self._traced(
            _scheduler_class or SchedulerClass.USER_INTERACTIVE,
            lambda: self._solve_request(self._ple_optimizer, state, topo),
            "demote-brokers")
        return self._maybe_execute(result, dryrun, reason, None,
                                   demoted_brokers=list(broker_ids),
                                   **execute_kwargs)

    def fix_offline_replicas(self, goals: Optional[Sequence[str]] = None,
                             dryrun: bool = True,
                             reason: str = "fix offline replicas",
                             _scheduler_class: Optional[SchedulerClass]
                             = None,
                             **execute_kwargs) -> OperationResult:
        """Move the offline replicas onto healthy brokers and logdirs;
        ValueError when there is none."""
        self._sanity_check_execution(dryrun)
        state, topo = self._model_for_solve()
        if not bool(S.self_healing_eligible(state).any()):
            raise ValueError("no offline replicas to fix")
        optimizer = self._optimizer_for(goals)
        result = self._traced(
            _scheduler_class or SchedulerClass.USER_INTERACTIVE,
            lambda: self._solve_request(optimizer, state, topo),
            "fix-offline-replicas")
        return self._maybe_execute(result, dryrun, reason, None,
                                   **execute_kwargs)

    # ------------------------------------------------------------------
    # topic configuration
    # ------------------------------------------------------------------
    def update_topic_replication_factor(
            self, topic: str, target_rf: int,
            goals: Optional[Sequence[str]] = None,
            dryrun: bool = True,
            reason: str = "topic configuration",
            **execute_kwargs) -> OperationResult:
        """Grow or shrink a topic's replication factor (Cruise Control's
        TopicConfigurationRunnable and ClusterModel.createOrDeleteReplicas):
        new replicas land rack-aware on the brokers with the fewest
        replicas; removals drop rack-duplicate followers first and never
        the leader.  Reads the monitor's metadata client, so it needs the
        sampled `LoadMonitor`."""
        if target_rf < 1:
            raise ValueError("replication factor must be >= 1")
        self._sanity_check_execution(dryrun)
        metadata = getattr(self.load_monitor, "metadata", None)
        if metadata is None:
            raise ValueError("update_topic_replication_factor reads the "
                             "monitor's metadata client (LoadMonitor)")
        snapshot = metadata.refresh_metadata()
        parts = snapshot.partitions_of(topic)
        if not parts:
            raise ValueError(f"unknown topic {topic!r}")
        rack_of = {b.broker_id: (b.rack or b.host) for b in snapshot.brokers}
        alive = sorted(snapshot.alive_broker_ids)
        if target_rf > len(alive):
            raise ValueError(
                f"replication factor {target_rf} exceeds {len(alive)} "
                f"alive brokers")
        counts: Dict[int, int] = {b: 0 for b in alive}
        for p in snapshot.partitions:
            for b in p.replicas:
                if b in counts:
                    counts[b] += 1

        proposals = []
        for p in sorted(parts, key=lambda x: x.tp.partition):
            old = list(p.replicas)
            new = list(old)
            while len(new) < target_rf:
                used_racks = {rack_of[b] for b in new if b in rack_of}
                candidates = [b for b in alive if b not in new]
                if not candidates:
                    raise ValueError(
                        f"not enough brokers for rf={target_rf}")
                # unused rack first, then fewest replicas
                candidates.sort(key=lambda b: (rack_of[b] in used_racks,
                                               counts[b], b))
                pick = candidates[0]
                new.append(pick)
                counts[pick] += 1
            while len(new) > target_rf:
                followers = [b for b in new if b != p.leader]
                if not followers:
                    break
                rack_tally: Dict[str, int] = {}
                for b in new:
                    rack_tally[rack_of.get(b, "?")] = rack_tally.get(
                        rack_of.get(b, "?"), 0) + 1
                # duplicated rack first, then the broker with most replicas
                followers.sort(key=lambda b: (
                    -rack_tally.get(rack_of.get(b, "?"), 0),
                    -counts.get(b, 0), -b))
                drop = followers[0]
                new.remove(drop)
                if drop in counts:
                    counts[drop] -= 1
            if new != old:
                leader = p.leader if p.leader is not None else new[0]
                ordered_old = [leader] + [b for b in old if b != leader]
                ordered_new = [leader] + [b for b in new if b != leader]
                proposals.append(ExecutionProposal(
                    partition=PartitionId(topic, p.tp.partition),
                    old_leader=leader,
                    old_replicas=tuple(ReplicaPlacement(b)
                                       for b in ordered_old),
                    new_replicas=tuple(ReplicaPlacement(b)
                                       for b in ordered_new)))
        if dryrun or not proposals:
            return OperationResult(None, proposals=proposals, dryrun=dryrun)
        uuid = self.executor.execute_proposals(proposals, reason=reason,
                                               **execute_kwargs)
        self._invalidate_proposal_cache()
        return OperationResult(None, execution_uuid=uuid,
                               proposals=proposals, dryrun=False)
