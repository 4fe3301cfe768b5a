"""The facade (port of the request methods, the proposal cache, the warm
seed, the dirty region, the device model store consult, the degradation
ladder, the what-if scenarios, the execution side, the device-time
scheduler gateway, the background proposal precompute and the
observability surface of cruise_control_tpu/facade.py).

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

Every solve runs on the facade's device (the card unless "cpu" is asked
for) through one gateway, `_scheduled_solve`: the device-time scheduler
(sched/) runs it on its dispatch thread in priority order, coalesces
identical requests, folds compatible what-if sweeps into one batch and
preempts the background precompute at a goal-segment boundary when a
more urgent request queues (`scheduler_enabled=False` runs each job
inline on the caller's thread, with the same results).  With
`start_up(start_proposal_precompute=True)` a background thread keeps the
proposal cache warm.  A proposal request's solve goes
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

The facade's sensors live in one `MetricRegistry` (`metrics`; OpenMetrics
through obs/export.py), every finished trace in the flight recorder
(obs/recorder.py), and `state()` reports the monitor, the executor, the
analyzer, the scenario engine, the scheduler, the model store, the SLOs
(obs/slo.py) and the sensors.
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
    InvalidModelInputError, SolverRung, classify_failure, ladder_material)
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
from cruise_control_tpu_torch.executor.state import ExecutorPhase
from cruise_control_tpu_torch.executor.strategy import \
    ReplicaMovementStrategy
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model.state import ClusterState
from cruise_control_tpu_torch.model.state import own_copy as _own_copy
from cruise_control_tpu_torch.model.store import DeviceModelStore
from cruise_control_tpu_torch.model.topology import PartitionId
from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor
from cruise_control_tpu_torch.obs import recorder as obs_recorder
from cruise_control_tpu_torch.obs import trace as obs_trace
from cruise_control_tpu_torch.obs.slo import SloEvaluator
from cruise_control_tpu_torch.scenario.engine import (BASE_SCENARIO_NAME,
                                                      ScenarioBatchResult,
                                                      ScenarioEngine)
from cruise_control_tpu_torch.scenario.spec import (BrokerAdd, ScenarioSpec,
                                                    candidate_broker_sets)
from cruise_control_tpu_torch.sched import runtime as sched_runtime
from cruise_control_tpu_torch.sched.policy import (SchedulerClass,
                                                   SchedulerPolicy)
from cruise_control_tpu_torch.sched.scheduler import (DeviceTimeScheduler,
                                                      SolveJob)
from cruise_control_tpu_torch.utils import faults
from cruise_control_tpu_torch.utils.metrics import MetricRegistry

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
    the executor's polls and the ladder's retry backoff.  The
    `scheduler_*` settings build the facade's `DeviceTimeScheduler`, or
    `solve_scheduler=` brings one (the facade then neither attaches its
    sensors nor stops it); the `obs_*` settings reconfigure the
    process-wide tracing and flight recorder when given; the `slo_*`
    settings are the SLO evaluator's."""

    def __init__(self, admin=None, sampler=None, capacity_resolver=None, *,
                 load_monitor=None, monitor_kwargs: Optional[dict] = None,
                 device=None,
                 goal_names: Optional[Sequence[str]] = None,
                 max_optimization_rounds: Optional[int] = None,
                 constraint: Optional[BalancingConstraint] = None,
                 balancedness_weights: Tuple[float, float] = (1.1, 1.5),
                 options_generator=None,
                 proposal_expiration_s: float = 900.0,
                 proposal_precompute_interval_s: float = 30.0,
                 allow_capacity_estimation_on_precompute: bool = True,
                 precompute_eager_hard_abort: bool = False,
                 precompute_solve_deadline_s: float = 1800.0,
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
                 scheduler_enabled: bool = True,
                 scheduler_preemption_enabled: bool = True,
                 scheduler_class_weights: Optional[Sequence[float]] = None,
                 scheduler_class_queue_caps: Optional[Sequence[int]] = None,
                 scheduler_class_deadline_budgets_s: Optional[
                     Sequence[float]] = None,
                 solve_scheduler: Optional[DeviceTimeScheduler] = None,
                 obs_tracing_enabled: Optional[bool] = None,
                 obs_trace_log_enabled: Optional[bool] = None,
                 obs_flight_recorder_capacity: Optional[int] = None,
                 obs_flight_recorder_max_pinned: Optional[int] = None,
                 obs_trace_sample_rate: Optional[float] = None,
                 metrics_bucket_overrides: Optional[dict] = None,
                 slo_enabled: bool = True,
                 slo_objectives: Optional[dict] = None,
                 slo_window_s: float = 300.0,
                 slo_alert_threshold: float = 2.0,
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
        # process-wide tracing and flight-recorder switches: only an
        # explicit setting reconfigures them
        if (obs_tracing_enabled is not None
                or obs_trace_log_enabled is not None
                or obs_trace_sample_rate is not None):
            obs_trace.configure(enabled=obs_tracing_enabled,
                                trace_log_enabled=obs_trace_log_enabled,
                                sample_rate=obs_trace_sample_rate)
        if (obs_flight_recorder_capacity is not None
                or obs_flight_recorder_max_pinned is not None):
            obs_recorder.configure(
                capacity=obs_flight_recorder_capacity,
                max_pinned=obs_flight_recorder_max_pinned)
        #: the reference's sampler (read for sampler-corrupt-records);
        #: None over a built monitor
        self._sampler = sampler
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
        #: the text of the last journal failure (the journal carried on
        #: journal-less; `journal_error_events` counts them)
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
        self._goal_names = list(goal_names or DEFAULT_GOAL_ORDER)
        self.goal_optimizer = GoalOptimizer(
            default_goals(names=self._goal_names,
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

        # the background proposal precompute (the reference's
        # GoalOptimizer.run loop): keeps the proposal cache warm
        self._precompute_interval_s = proposal_precompute_interval_s
        self._allow_capacity_estimation_precompute = \
            allow_capacity_estimation_on_precompute
        #: the precompute's solves abort at the first hard goal still
        #: violated after its segment (it retries every interval anyway)
        self._precompute_eager_hard_abort = precompute_eager_hard_abort
        self._precompute_stop = threading.Event()
        self._precompute_thread: Optional[threading.Thread] = None
        #: the wall clock of the precompute pass in flight (None when
        #: idle) and its scheduler ticket: the watchdog clocks the ticket's
        #: dispatch, so queue wait does not read as a wedge
        self._precompute_solve_started_at: Optional[float] = None
        self._precompute_solve_deadline_s = precompute_solve_deadline_s
        self._precompute_ticket = None

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
        #: the rung that served the last proposal solve
        self.last_solve_rung: Optional[SolverRung] = None
        #: goals whose own pass worsened their violated-broker count in
        #: the last solve (the goal-self-regressions sensor)
        self._goal_self_regressions: List[str] = []
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

        # the device-time scheduler: the single gateway of every solve
        self._owns_scheduler = solve_scheduler is None
        self.solve_scheduler = solve_scheduler or DeviceTimeScheduler(
            SchedulerPolicy.from_lists(
                weights=scheduler_class_weights,
                queue_caps=scheduler_class_queue_caps,
                deadline_budgets_s=scheduler_class_deadline_budgets_s,
                preemption_enabled=scheduler_preemption_enabled),
            enabled=scheduler_enabled, time_fn=self._time)
        #: scopes coalesce and fold keys to this facade (model
        #: generations of two facades collide in value)
        self._coalesce_scope = f"cc-{id(self):x}"

        # sensors (the reference's dropwizard registry); bucket overrides
        # apply to histograms created after them
        self.metrics = MetricRegistry(
            self._time, bucket_overrides=metrics_bucket_overrides)
        self._register_sensors()
        sched_registry = (self.metrics if self._owns_scheduler
                          else (getattr(self.solve_scheduler, "_metrics",
                                        None) or self.metrics))
        self.slo_evaluator = SloEvaluator(
            sched_registry, objectives=slo_objectives, enabled=slo_enabled,
            window_s=slo_window_s, alert_threshold=slo_alert_threshold,
            time_fn=self._time)
        self.slo_evaluator.attach_metrics(self.metrics)

    def _register_sensors(self) -> None:
        """The reference's gauges and meters for every module the port
        has (the goal-violation detector's balancedness-score, the
        program cache's and the portfolio's sensors and the mesh's
        recovery sensors come with their modules)."""
        m = self.metrics
        m.gauge("solver-rung", lambda: int(self.solver_ladder.rung))
        m.gauge("mesh-devices", lambda: 1.0)
        store = self.model_store
        m.gauge("incremental-store-hits", lambda: float(store.hits))
        m.gauge("incremental-store-misses", lambda: float(store.misses))
        m.gauge("incremental-store-fallbacks",
                lambda: float(store.fallbacks))
        m.gauge("incremental-store-delta-applies",
                lambda: float(store.delta_applies))
        m.gauge("incremental-store-dirty-brokers",
                lambda: float(store.last_dirty_brokers))
        m.gauge("goal-self-regressions",
                lambda: float(len(self._goal_self_regressions)))
        m.gauge("solver-breaker-open",
                lambda: 0.0 if self.solver_breaker.cooldown_remaining_s()
                == 0.0 else 1.0)
        jrn = lambda: self.executor_journal  # noqa: E731
        m.gauge("executor-journal-writes",
                lambda: float(jrn().writes) if jrn() is not None else 0.0)
        m.gauge("executor-journal-bytes",
                lambda: (float(jrn().bytes_written)
                         if jrn() is not None else 0.0))
        m.gauge("executor-journal-errors",
                lambda: float(jrn().errors) if jrn() is not None else 0.0)
        m.gauge("sampler-quarantined-samples",
                lambda: getattr(self.load_monitor,
                                "num_quarantined_samples", 0))
        m.gauge("sampler-corrupt-records",
                lambda: getattr(self._sampler, "num_corrupt_records", 0))
        self.scenario_engine.attach_metrics(m)
        m.gauge("scenario-batch-size",
                lambda: self.scenario_engine.last_batch_size)
        m.gauge("scenario-rung",
                lambda: int(self.scenario_engine.ladder.rung))
        if self._owns_scheduler:
            self.solve_scheduler.attach_metrics(m)

    def _meter_count(self, name: str) -> int:
        """A meter's count, read without creating the meter."""
        meter = self.metrics.peek(name)
        return 0 if meter is None else meter.to_json()["count"]

    @property
    def solver_descents(self) -> int:
        """Ladder descents (the solver-descents meter)."""
        return self._meter_count("solver-descents")

    @property
    def solver_retries(self) -> int:
        """Retries on a rung (the solver-retries meter)."""
        return self._meter_count("solver-retries")

    @property
    def incremental_solve_fallbacks(self) -> int:
        """Dirty-region solves that failed their verdict and were retried
        as a full sweep (the incremental-solve-fallbacks meter)."""
        return self._meter_count("incremental-solve-fallbacks")

    @property
    def journal_error_events(self) -> int:
        """Journal failures (the executor-journal-error-events meter)."""
        return self._meter_count("executor-journal-error-events")

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
            self._report_execution_recovery(
                None, mode, error=f"{type(exc).__name__}: {exc}")
            return None
        obs_trace.finish(trace)
        if report is not None:
            self.metrics.meter("executor-recoveries").mark()
            if report.get("resumed"):
                # an abort-mode recovery resumes nothing: the meter counts
                # the work the resumed execution carries
                self.metrics.meter("executor-resumed-tasks").mark(
                    report.get("tasksAdopted", 0)
                    + report.get("tasksPending", 0))
            if report.get("clearedThrottleBrokers"):
                self.metrics.meter(
                    "executor-orphaned-throttles-cleared").mark(
                    len(report["clearedThrottleBrokers"]))
            self._report_execution_recovery(report, mode)
            LOG.warning("execution %s recovered (mode=%s): %d terminal, "
                        "%d adopted, %d pending tasks; throttles cleared "
                        "on %s", report.get("uuid"), mode,
                        report.get("tasksTerminal", 0),
                        report.get("tasksAdopted", 0),
                        report.get("tasksPending", 0),
                        report.get("clearedThrottleBrokers", []))
        return report

    def _report_execution_recovery(self, report: Optional[dict], mode: str,
                                   error: str = "") -> None:
        """Dump the flight recorder for a recovery (the reference also
        raises an ExecutionRecovery anomaly, which waits for the port's
        detector)."""
        desc = error or (f"recovered execution "
                         f"{report.get('uuid', '?')}" if report else "")
        obs_recorder.get_recorder().dump(
            reason=f"ExecutionRecovery mode={mode} "
                   f"({desc or 'no report'})")

    def _on_journal_error(self, exc: BaseException) -> None:
        """The executor journal degraded to journal-less execution (disk
        full, EIO): count it (executor-journal-error-events) and keep it;
        the rebalance continues."""
        self.metrics.meter("executor-journal-error-events").mark()
        self.last_journal_error = f"{type(exc).__name__}: {exc}"
        LOG.error("executor journal degraded (%s); the execution "
                  "continues journal-less", self.last_journal_error)

    def start_up(self, do_sampling: bool = True,
                 skip_loading_samples: bool = False,
                 start_proposal_precompute: bool = False) -> None:
        """Crash recovery first (an execution the previous process left
        in flight is settled before anything samples or solves over a
        half-moved cluster), then the monitor's start-up: the stored
        samples reloaded, and unless `do_sampling` is False its sampling
        thread started; with `start_proposal_precompute` the background
        precompute thread."""
        self.recover_interrupted_execution()
        self.load_monitor.start_up(do_sampling=do_sampling,
                                   skip_loading_samples=skip_loading_samples)
        if start_proposal_precompute:
            self._precompute_stop.clear()
            self._precompute_thread = threading.Thread(
                target=self._precompute_loop, name="proposal-precompute",
                daemon=True)
            self._precompute_thread.start()

    def shutdown(self) -> None:
        """Stop the precompute, then the scheduler (queued tickets fail
        at once, and nothing new is admitted), wait for the precompute
        thread unless its solve overran its deadline, then stop the
        executor (force-stop: in-flight reassignments are cancelled),
        wait for it, close the journal and stop the monitor (its sampling
        thread and fetcher pool)."""
        self._precompute_stop.set()
        if self._owns_scheduler:
            self.solve_scheduler.stop()
        if self._precompute_thread is not None:
            started = self._precompute_solve_started_at
            if self.precompute_wedged() and started is not None:
                # the solve overran its deadline: it cannot be aborted,
                # so shutdown does not wait for it (a daemon thread)
                LOG.error(
                    "proposal-precompute solve exceeded its %.0fs "
                    "deadline (started %.0fs ago); shutting down without "
                    "waiting for it", self._precompute_solve_deadline_s,
                    self._time() - started)
            else:
                self._precompute_thread.join(timeout=5.0)
                if self._precompute_thread.is_alive():
                    LOG.warning("proposal-precompute still running after "
                                "5s join timeout; shutting down around it")
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
    # the background proposal precompute (the reference's
    # GoalOptimizer.run loop): the cache stays warm, so a request answers
    # from it instead of paying a full solve
    # ------------------------------------------------------------------
    def precompute_proposals_once(self) -> bool:
        """One precompute pass; True when a fresh result was computed.
        Skipped while the monitor has no valid window, while an execution
        moves the cluster, or while the cache is valid for the current
        model generation."""
        return self._precompute_once_status() == "computed"

    def _precompute_once_status(self) -> str:
        """'computed' | 'skipped' | 'failed': the loop backs off on
        failures only, never on the routine skips."""
        if not self._monitor_ready():
            return "skipped"
        if self.executor is not None and self.executor.has_ongoing_execution:
            return "skipped"
        generation = self.load_monitor.model_generation()
        with self._cache_lock:
            if self._cache_valid(generation):
                return "skipped"
        # published under _cache_lock: precompute_wedged and shutdown
        # read them from other threads
        with self._cache_lock:
            self._precompute_solve_started_at = self._time()
            self._precompute_ticket = None
        try:
            faults.inject("facade.precompute")
            # the watchdog clocks the solve from its dispatch, not the
            # queue wait in front of it
            sched_runtime.set_submission_listener(
                self._note_precompute_ticket)
            try:
                self.optimizations(
                    _allow_capacity_estimation=(
                        self._allow_capacity_estimation_precompute),
                    _eager_hard_abort=(True
                                       if self._precompute_eager_hard_abort
                                       else None),
                    _scheduler_class=SchedulerClass.PRECOMPUTE)
            finally:
                sched_runtime.clear_submission_listener()
            return "computed"
        except Exception as exc:  # noqa: BLE001 - keep the loop alive
            LOG.warning("proposal precompute failed (%s): %s",
                        classify_failure(exc).value, exc)
            return "failed"
        finally:
            with self._cache_lock:
                self._precompute_solve_started_at = None
                self._precompute_ticket = None

    def _note_precompute_ticket(self, ticket) -> None:
        """Submission listener of the precompute solve (on the precompute
        thread, outside any _cache_lock region)."""
        with self._cache_lock:
            self._precompute_ticket = ticket

    def precompute_wedged(self) -> bool:
        """True when the precompute solve in flight has overrun
        `precompute_solve_deadline_s` (shutdown then stops waiting for
        it).  Queue wait does not count: the clock starts when the
        dispatch loop takes the solve (the ticket's `started_at`), or at
        the pass's start when it had no ticket (an inline solve)."""
        with self._cache_lock:
            started = self._precompute_solve_started_at
            ticket = self._precompute_ticket
        if started is None:
            return False
        if ticket is not None:
            started = ticket.started_at
            if started is None:        # queued, or re-queued after a
                return False           # preemption: waiting, not wedged
        return self._time() - started > self._precompute_solve_deadline_s

    def _precompute_loop(self) -> None:
        """The first pass at once (a cold cache for a whole interval
        after start-up would defeat the precompute), unless shutdown came
        first; then one pass an interval, failures backing off
        exponentially up to 32 intervals."""
        consecutive_failures = 0
        if not self._precompute_stop.is_set():
            if self._precompute_once_status() == "failed":
                consecutive_failures = 1
        while True:
            delay = self._precompute_interval_s * min(
                2 ** consecutive_failures, 32)
            if self._precompute_stop.wait(delay):
                return
            status = self._precompute_once_status()
            if status == "failed":
                consecutive_failures += 1
            else:
                consecutive_failures = 0

    def _monitor_ready(self) -> bool:
        return self.load_monitor.get_state().num_valid_windows > 0

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
        that fails its verdict is retried as a full sweep.

        The solve is a job of the device-time scheduler keyed on (goal
        list, model generation, options), so identical concurrent
        requests coalesce into one solve.  `_scheduler_class` picks its
        priority class (USER_INTERACTIVE by default; the precompute
        passes PRECOMPUTE)."""
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
                self.metrics.meter("incremental-solve-fallbacks").mark()
                obs_trace.mark("fallback")
                obs_trace.event("incremental.fallback",
                                reason="dirty-region solve verdict")
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

        # the options' frozen dataclass is their identity: requests whose
        # options differ in any field never share a solve
        key = ("optimizations", self._coalesce_scope,
               tuple(goals) if goals is not None else None,
               generation, options, _allow_capacity_estimation,
               _eager_hard_abort)
        return self._scheduled_solve(klass, run_solve, coalesce_key=key,
                                     label="optimizations")

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
        with self.load_monitor.acquire_for_model_generation(), \
                self.metrics.timer("cluster-model-creation-timer").time():
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
        with self.metrics.timer("proposal-computation-timer").time(), \
                obs_trace.span("device.solve", rung=rung.name,
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
            self._note_goal_self_regressions(result)
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
                    if isinstance(exc, InvalidModelInputError):
                        self.metrics.meter("solver-invalid-input").mark()
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
                    self.metrics.meter("solver-retries").mark()
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
                self.metrics.meter("solver-descents").mark()
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
            self._note_goal_self_regressions(result)
            return result

    def _note_goal_self_regressions(self, result) -> None:
        """Goals whose own pass worsened their violated-broker count
        (after-own above the count at the goal's entry; results without
        entry counts, the host rung's, compare with `before`): the
        goal-self-regressions sensor.  Goals the host-side skip elided
        count into solver-goals-skipped."""
        counts = getattr(result, "violated_broker_counts", None) or {}
        entries = getattr(result, "entry_broker_counts", None) or {}
        regressions = [g for g, (b, own, _a) in counts.items()
                       if own > entries.get(g, b)]
        if regressions:
            self.metrics.meter("goal-self-regression-events").mark(
                len(regressions))
            LOG.warning("goal self-regression: %s worsened their own "
                        "violated-broker counts (at-entry -> after-own: "
                        "%s)", ", ".join(regressions),
                        {g: (entries.get(g, counts[g][0]), counts[g][1])
                         for g in regressions})
        self._goal_self_regressions = regressions
        skipped = getattr(result, "skipped_goals", None) or []
        if skipped:
            self.metrics.meter("solver-goals-skipped").mark(len(skipped))

    def _report_solver_degraded(self, from_rung: SolverRung,
                                to_rung: Optional[SolverRung],
                                kind: FailureKind, exc: BaseException,
                                breaker_tripped: bool) -> None:
        """Mark the request's trace degraded (pinning it in the flight
        recorder), dump the recorder with the in-flight trace's partial
        tree, and log the report (the reference also raises a
        SolverDegraded anomaly, which waits for the port's detector)."""
        obs_trace.mark("degraded")
        active = obs_trace.current()
        obs_recorder.get_recorder().dump(
            reason=f"SolverDegraded {from_rung.name}->"
                   f"{to_rung.name if to_rung is not None else 'none'} "
                   f"({kind.value})",
            active=active.to_json() if active is not None else None)
        LOG.warning("solver degraded %s -> %s (%s, breaker tripped: %s): "
                    "%s: %s", from_rung.name,
                    to_rung.name if to_rung is not None else "none",
                    kind.value, breaker_tripped, type(exc).__name__, exc)

    def _scheduled_solve(self, klass: SchedulerClass, run,
                         coalesce_key=None, label: str = "",
                         fold_key=None, fold_payload=None, fold_run=None):
        """Submit one solve to the device-time scheduler and block until
        it ran (QueueFullError at the class's queue cap).  Every solve of
        the facade goes through here: the single gateway.  The solve runs
        inside its trace — the active one, or one minted and finished
        here, kept as `last_solve_trace` — and on the card, on its
        default stream, whichever thread runs it."""
        with obs_trace.solve_trace(f"solve.{label or 'solve'}",
                                   cluster=self._coalesce_scope,
                                   schedulerClass=klass.name) as trace:
            self.last_solve_trace = trace
            return self.solve_scheduler.submit(SolveJob(
                klass=klass, run=self._on_device(run), label=label,
                coalesce_key=coalesce_key,
                preemptible=self.solve_scheduler.policy.is_preemptible(
                    klass),
                fold_key=fold_key, fold_payload=fold_payload,
                fold_run=(None if fold_run is None
                          else self._on_device(fold_run)),
                trace=obs_trace.current_context()))

    def _on_device(self, fn):
        """`fn` run with the facade's card current and its default stream
        (a dispatch thread otherwise launches on its own current device
        and stream); on the CPU, `fn` itself."""
        if self.device.type != "cuda":
            return fn

        def run(*args):
            with torch.cuda.device(self.device), torch.cuda.stream(
                    torch.cuda.default_stream(self.device)):
                return fn(*args)
        return run

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
        nothing.

        A SCENARIO_SWEEP job of the scheduler: compatible sweeps queued
        at dispatch (the same goal list, model generation and proposal
        switch) fold into one engine batch that solves their shared base
        once, and each caller gets back its own outcomes."""
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
        generation = self.load_monitor.model_generation()
        goal_key = tuple(goals) if goals is not None else None
        OPERATION_LOG.info("%s: evaluating %d scenarios (dry run)",
                           reason, len(specs))

        def fold_run(spec_lists: List[List[ScenarioSpec]]
                     ) -> List[ScenarioBatchResult]:
            state, topo = self._model_for_solve()
            gen_options = self._options_generator.generate(
                OptimizationOptions(), topo)
            if len(spec_lists) == 1:
                return [self.scenario_engine.evaluate(
                    state, topo, spec_lists[0], goals=goals,
                    options=gen_options,
                    include_proposals=include_proposals)]
            # every folded caller prepends the same no-op base scenario:
            # it is solved once and its outcome handed to each
            has_base = [bool(lst) and lst[0].name == BASE_SCENARIO_NAME
                        and lst[0].is_noop() for lst in spec_lists]
            merged: List[ScenarioSpec] = (
                [ScenarioSpec(name=BASE_SCENARIO_NAME)] if any(has_base)
                else [])
            for lst, hb in zip(spec_lists, has_base):
                merged.extend(lst[1:] if hb else lst)
            OPERATION_LOG.info(
                "scenario fold: %d compatible sweeps merged into one "
                "%d-scenario batch", len(spec_lists), len(merged))
            batch = self.scenario_engine.evaluate(
                state, topo, merged, goals=goals, options=gen_options,
                include_proposals=include_proposals)
            base_outcome = batch.outcomes[0] if any(has_base) else None
            split, i = [], 1 if any(has_base) else 0
            for lst, hb in zip(spec_lists, has_base):
                n = len(lst) - (1 if hb else 0)
                outs = batch.outcomes[i:i + n]
                i += n
                if hb:
                    outs = [base_outcome] + outs
                split.append(ScenarioBatchResult(
                    outcomes=outs, duration_s=batch.duration_s,
                    compile_s=batch.compile_s, solve_s=batch.solve_s,
                    oom_halvings=batch.oom_halvings,
                    batch_sizes=list(batch.batch_sizes),
                    rung=batch.rung))
            return split

        fold_key = ("scenarios", self._coalesce_scope, goal_key,
                    generation, include_proposals)
        coalesce_key = fold_key + (tuple(repr(s) for s in specs),)
        return self._scheduled_solve(
            klass, lambda: fold_run([specs])[0],
            coalesce_key=coalesce_key, label="scenarios",
            fold_key=fold_key, fold_payload=specs, fold_run=fold_run)

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
        result = self._scheduled_solve(
            _scheduler_class or SchedulerClass.USER_INTERACTIVE,
            lambda: self._solve_request(optimizer, state, topo, options),
            label="add-brokers")
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
        result = self._scheduled_solve(
            _scheduler_class or SchedulerClass.USER_INTERACTIVE,
            lambda: self._solve_request(optimizer, state, topo),
            label="remove-brokers")
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
        result = self._scheduled_solve(
            _scheduler_class or SchedulerClass.USER_INTERACTIVE,
            lambda: self._solve_request(self._ple_optimizer, state, topo),
            label="demote-brokers")
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
        result = self._scheduled_solve(
            _scheduler_class or SchedulerClass.USER_INTERACTIVE,
            lambda: self._solve_request(optimizer, state, topo),
            label="fix-offline-replicas")
        return self._maybe_execute(result, dryrun, reason, None,
                                   **execute_kwargs)

    # ------------------------------------------------------------------
    # state (Cruise Control's CruiseControlState)
    # ------------------------------------------------------------------
    def state(self, substates: Optional[Sequence[str]] = None) -> dict:
        """The service's state by substate: "monitor", "executor",
        "analyzer", "scenario", "scheduler", "incremental" and "slo" by
        default, "sensors" when asked for.  The reference's
        "anomaly_detector" and "portfolio" raise NotImplementedError
        until their modules are ported."""
        want = {s.lower() for s in (substates or (
            "monitor", "executor", "analyzer", "scenario", "scheduler",
            "incremental", "slo"))}
        if "anomaly_detector" in want:
            raise _not_ported("state substate 'anomaly_detector'",
                              "detector/ package")
        if "portfolio" in want:
            raise _not_ported("state substate 'portfolio'",
                              "portfolio/ package")
        out: dict = {}
        if "monitor" in want:
            ms = self.load_monitor.get_state()
            out["MonitorState"] = {
                "state": ms.state,
                "numValidWindows": ms.num_valid_windows,
                "totalNumWindows": ms.total_num_windows,
                "monitoredPartitionsPercentage":
                    ms.monitored_partitions_percentage,
                "numMonitoredPartitions": ms.num_monitored_partitions,
                "numTotalPartitions": ms.num_total_partitions,
                "reasonOfPause": ms.reason_of_pause,
            }
        if "executor" in want:
            out["ExecutorState"] = (
                self.executor.state.to_json() if self.executor is not None
                else {"state": ExecutorPhase.NO_TASK_IN_PROGRESS.value})
        if "analyzer" in want:
            with self._cache_lock:
                cached = self._cached_result
            out["AnalyzerState"] = {
                "isProposalReady": cached is not None,
                "goals": self._goal_names,
                "readyGoals": self._goal_names if cached is not None else [],
                "solverDegradation": {
                    **self.solver_ladder.to_json(),
                    "precomputeWedged": self.precompute_wedged(),
                    "meshDevices": 1,
                    "meshRecovery": {"enabled": False, "span": 1},
                },
                "goalSelfRegressions": list(self._goal_self_regressions),
            }
        if "scenario" in want:
            out["ScenarioEngineState"] = {
                "enabled": self._scenario_enabled,
                **self.scenario_engine.to_json(),
            }
        if "scheduler" in want:
            out["SchedulerState"] = self.solve_scheduler.to_json()
        if "incremental" in want:
            out["IncrementalStoreState"] = {
                "enabled": self._incremental_enabled,
                **self.model_store.to_json(),
            }
        if "slo" in want:
            # the reference adds its SLO burn detector's state, which
            # waits for the port's detector
            out["sloStatus"] = self.slo_evaluator.evaluate()
        if "sensors" in want:
            out["Sensors"] = self.metrics.to_json()
        return out

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
