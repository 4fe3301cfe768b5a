"""The execution engine (port of cruise_control_tpu/executor/executor.py).

Drives accepted proposals against the cluster in Cruise Control's three
phases — inter-broker replica moves, intra-broker (logdir) moves,
leadership moves — each a batching loop that polls cluster metadata on a
check interval, marks tasks completed or dead, re-executes reassignments
the cluster lost, and applies replication throttles around moves.  Every
admin call goes through `_admin_call` and its fault site
`executor.admin.<op>`; with a journal, every execution is a resumable
write-ahead-logged operation (`recover`).

Host code, I/O-bound by design: data moves inside the managed cluster;
this engine only requests and observes it.  Time and sleep are
injectable, so the loops run the same against a wall clock and a
simulated cluster's virtual one.  Iteration orders (sorted broker ids,
task and batch order) are the JAX package's, so the admin calls come in
the same sequence with the same arguments.
"""
from __future__ import annotations

import logging
import threading
import time as _time
import uuid as _uuid
from typing import Callable, Dict, List, Optional, Sequence, Set

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.cluster.admin import ClusterAdminClient
from cruise_control_tpu_torch.cluster.types import TopicPartition
from cruise_control_tpu_torch.executor import recovery as recovery_mod
from cruise_control_tpu_torch.executor.journal import ExecutionJournal
from cruise_control_tpu_torch.executor.state import (ExecutorPhase,
                                                     ExecutorState)
from cruise_control_tpu_torch.executor.strategy import (
    ReplicaMovementStrategy, strategy_from_names)
from cruise_control_tpu_torch.executor.task import (ExecutionTask, TaskState,
                                                    TaskType)
from cruise_control_tpu_torch.executor.task_manager import ExecutionTaskManager
from cruise_control_tpu_torch.obs import trace as obs_trace
from cruise_control_tpu_torch.utils import faults

LOG = logging.getLogger(__name__)
#: operations audit log — one INFO line per started execution, emitted here
#: so every path (facade, self-healing, topic-RF change) is covered
#: (reference Executor.java:76,775-781 operationLogger)
OPERATION_LOG = logging.getLogger("operationLogger")


class ExecutorNotifier:
    """SPI notified when an execution finishes (reference
    ExecutorNotifier.java).  The default implementation logs the
    completion (the executor.notifier.class default)."""

    def on_execution_finished(self, uuid: str, succeeded: bool,
                              message: str) -> None:
        LOG.info("execution %s finished (succeeded=%s): %s", uuid,
                 succeeded, message)


class ExecutionStoppedException(RuntimeError):
    pass


class Executor:
    """Thread-safe, single-execution-at-a-time engine."""

    def __init__(self, admin: ClusterAdminClient,
                 load_monitor=None,
                 notifier: Optional[ExecutorNotifier] = None,
                 concurrent_inter_broker_moves_per_broker: int = 5,
                 concurrent_intra_broker_moves_per_broker: int = 2,
                 concurrent_leader_movements: int = 1000,
                 progress_check_interval_s: float = 10.0,
                 max_task_execution_idle_s: float = 190.0,
                 max_task_lifetime_s: float = 6 * 3600.0,
                 task_alerting_threshold_s: float = 90.0,
                 inter_rate_alert_threshold_mb_s: float = 0.1,
                 intra_rate_alert_threshold_mb_s: float = 0.2,
                 logdir_response_timeout_s: float = 10.0,
                 leader_movement_timeout_s: float = 180.0,
                 replication_throttle_bytes_per_s: Optional[float] = None,
                 removal_history_retention_s: float = 12 * 3600.0,
                 demotion_history_retention_s: Optional[float] = None,
                 max_cluster_movements: Optional[int] = None,
                 default_strategy: Optional[ReplicaMovementStrategy] = None,
                 max_consecutive_poll_failures: int = 10,
                 journal: Optional[ExecutionJournal] = None,
                 time_fn: Optional[Callable[[], float]] = None,
                 sleep_fn: Optional[Callable[[float], None]] = None) -> None:
        self._admin = admin
        self._load_monitor = load_monitor
        self._notifier = notifier
        self._inter_cap = concurrent_inter_broker_moves_per_broker
        self._intra_cap = concurrent_intra_broker_moves_per_broker
        self._leader_cap = concurrent_leader_movements
        self._check_interval = progress_check_interval_s
        self._max_idle = max_task_execution_idle_s
        #: absolute kill switch: any task alive longer than this is DEAD
        #: (reference max.execution.task.lifetime.ms)
        self._max_lifetime = max_task_lifetime_s
        #: warn (and notify) once a task runs longer than this (reference
        #: task.execution.alerting.threshold.ms)
        self._alert_threshold = task_alerting_threshold_s
        self._alerted_tasks: set = set()
        #: movement-rate alerting floors in MB/s (reference
        #: {inter,intra}.broker.replica.movement.rate.alerting.threshold):
        #: a task slower than its phase's floor alerts even before the
        #: age-based threshold
        self._inter_rate_alert_mb_s = inter_rate_alert_threshold_mb_s
        self._intra_rate_alert_mb_s = intra_rate_alert_threshold_mb_s
        #: timeout for logdir describe/alter calls (reference
        #: logdir.response.timeout.ms); honest-signaling: the stdlib admin
        #: SPI is synchronous, so this caps the WARNING we raise when a
        #: call overruns, it cannot abort the call
        self._logdir_timeout_s = logdir_response_timeout_s
        #: refuse executions whose task count exceeds this (reference
        #: max.num.cluster.movements guards memory/controller pressure)
        self._max_cluster_movements = max_cluster_movements
        self._default_strategy = default_strategy
        self._leader_timeout = leader_movement_timeout_s
        self._throttle_rate = replication_throttle_bytes_per_s
        self._history_retention = removal_history_retention_s
        self._demotion_retention = (demotion_history_retention_s
                                    if demotion_history_retention_s
                                    is not None
                                    else removal_history_retention_s)
        self._time = time_fn or _time.time
        self._sleep = sleep_fn or _time.sleep

        self._lock = threading.RLock()
        #: transient admin-client failures tolerated during progress
        #: polls (the poll retries next interval instead of failing the
        #: whole execution; submission paths stay fail-fast)
        self.num_poll_failures_tolerated = 0
        #: CONSECUTIVE tolerated poll failures before the execution
        #: fails anyway: tolerance is for transient blips — a
        #: permanently broken admin client must still fail the execution
        #: (pre-tolerance behavior) instead of wedging it forever with
        #: has_ongoing_execution pinned true (config key
        #: executor.max.consecutive.poll.failures; =1 is the fail-fast
        #: edge: the SECOND consecutive failure fails the run)
        self._max_consecutive_poll_failures = max(
            1, int(max_consecutive_poll_failures))
        self._consecutive_poll_failures = 0
        self._manager: Optional[ExecutionTaskManager] = None
        self._phase = ExecutorPhase.NO_TASK_IN_PROGRESS
        self._stop_requested = False
        self._force_stop = False
        self._uuid: Optional[str] = None
        self._reason: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        #: broker id -> removal/demotion time (reference Executor.java:309-366)
        self._removed_brokers: Dict[int, float] = {}
        self._demoted_brokers: Dict[int, float] = {}
        #: durable executor journal (executor/journal.py): None = the
        #: pre-journal in-memory behavior, byte for byte.  With one,
        #: every execution is a resumable WAL'd operation and the
        #: removal/demotion history survives restarts.
        self._journal = journal
        #: adopted in-flight tasks a recovery seeded for the phase
        #: loops to poll (set by _start_recovered, consumed by _run)
        self._resume_seed: Optional[Dict[TaskType, List[ExecutionTask]]] \
            = None
        #: True from replay until reconciliation settles (resume
        #: started or abort cleaned) — a self-healing caller's
        #: fix-in-progress gate includes it so a self-heal can never
        #: race an unreconciled half-moved cluster
        self._recovery_in_progress = False
        #: last recovery outcome (recovery.RecoveryReport json)
        self.last_recovery: Optional[dict] = None
        if journal is not None:
            removed, demoted = journal.load_history()
            self._removed_brokers.update(removed)
            self._demoted_brokers.update(demoted)

    def _admin_call(self, op: str, *args, **kwargs):
        """Every admin-client interaction funnels through here so the
        fault harness (utils/faults.py, sites `executor.admin.<op>`) can
        script transient cluster failures against the exact call the
        executor makes."""
        faults.inject(f"executor.admin.{op}")
        return getattr(self._admin, op)(*args, **kwargs)

    # ------------------------------------------------------------------
    # public surface
    # ------------------------------------------------------------------
    def execute_proposals(self, proposals: Sequence[ExecutionProposal],
                          reason: str = "",
                          uuid: Optional[str] = None,
                          removed_brokers: Sequence[int] = (),
                          demoted_brokers: Sequence[int] = (),
                          strategy: Optional[ReplicaMovementStrategy] = None,
                          concurrent_inter_broker_moves: Optional[int] = None,
                          concurrent_leader_movements: Optional[int] = None,
                          replication_throttle: Optional[float] = None,
                          wait: bool = False) -> str:
        """Register and start executing proposals.  Returns the execution
        uuid.  Raises if an execution is already in progress (reference
        sanityCheckExecuteProposals)."""
        for name, value in (("concurrent_inter_broker_moves",
                             concurrent_inter_broker_moves),
                            ("concurrent_leader_movements",
                             concurrent_leader_movements)):
            if value is not None and value < 1:
                raise ValueError(f"{name} must be >= 1, got {value}")
        if replication_throttle is not None and replication_throttle <= 0:
            raise ValueError("replication_throttle must be positive")
        with self._lock:
            if self._phase != ExecutorPhase.NO_TASK_IN_PROGRESS:
                raise RuntimeError(
                    f"cannot start execution in state {self._phase}")
            self._phase = ExecutorPhase.STARTING_EXECUTION
            self._stop_requested = False
            self._force_stop = False
            self._uuid = uuid or str(_uuid.uuid4())
            self._reason = reason
            self._alerted_tasks.clear()
            self._consecutive_poll_failures = 0
            now = self._time()
            for b in removed_brokers:
                self._removed_brokers[b] = now
            for b in demoted_brokers:
                self._demoted_brokers[b] = now
            inter_cap = (concurrent_inter_broker_moves
                         if concurrent_inter_broker_moves is not None
                         else self._inter_cap)
            leader_cap = (concurrent_leader_movements
                          if concurrent_leader_movements is not None
                          else self._leader_cap)
            strategy_used = strategy or self._default_strategy
            mgr = ExecutionTaskManager(
                inter_cap, self._intra_cap, leader_cap, strategy_used)
            snapshot = self._admin_call("describe_cluster")
            mgr.load_proposals(proposals,
                               sorted(snapshot.all_broker_ids))
            if (self._max_cluster_movements is not None
                    and mgr.counts().total > self._max_cluster_movements):
                self._phase = ExecutorPhase.NO_TASK_IN_PROGRESS
                raise ValueError(
                    f"execution of {mgr.counts().total} tasks exceeds "
                    f"max.num.cluster.movements="
                    f"{self._max_cluster_movements}")
            self._manager = mgr
            throttle = (replication_throttle
                        if replication_throttle is not None
                        else self._throttle_rate)
            run_uuid = self._uuid
        # outside the lock: counts() walks every task and a blocking log
        # handler must not stall state queries / stop_execution
        OPERATION_LOG.info(
            "execution %s started: %d proposals (%d inter-broker, "
            "%d intra-broker, %d leadership tasks), reason: %s",
            run_uuid, len(proposals),
            mgr.counts(TaskType.INTER_BROKER_REPLICA_ACTION).total,
            mgr.counts(TaskType.INTRA_BROKER_REPLICA_ACTION).total,
            mgr.counts(TaskType.LEADER_ACTION).total,
            reason or "(unspecified)")
        # write-ahead: the start record (full proposals + caps +
        # strategy + throttle) commits BEFORE the runnable touches the
        # cluster, so a crash at any later point is recoverable
        if self._journal is not None:
            self._journal.log_start(
                uuid=run_uuid, reason=reason, proposals=proposals,
                caps={"inter": inter_cap, "intra": self._intra_cap,
                      "leader": leader_cap},
                strategy_names=(strategy_used.chain_names()
                                if strategy_used is not None else []),
                removed_brokers=removed_brokers,
                demoted_brokers=demoted_brokers,
                throttle=throttle)
            self._save_history()
        self._thread = threading.Thread(
            target=self._run, args=(throttle,),
            name=f"proposal-execution-{run_uuid[:8]}", daemon=True)
        self._thread.start()
        if wait:
            self._thread.join()
        return run_uuid

    def stop_execution(self, force: bool = False) -> None:
        """Request graceful (or forced — cancel in-flight reassignments)
        stop (reference Executor.stopExecution / force-stop znode deletion
        :1153-1163)."""
        with self._lock:
            if self._phase == ExecutorPhase.NO_TASK_IN_PROGRESS:
                return
            self._stop_requested = True
            self._force_stop = force
            self._phase = ExecutorPhase.STOPPING_EXECUTION

    def await_completion(self, timeout: Optional[float] = None) -> bool:
        t = self._thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    @property
    def state(self) -> ExecutorState:
        with self._lock:
            if (self._phase == ExecutorPhase.NO_TASK_IN_PROGRESS
                    or self._manager is None):
                return ExecutorState.idle(recovery=self.recovery_json())
            return ExecutorState.snapshot(self._phase, self._uuid,
                                          self._reason, self._manager,
                                          recovery=self.recovery_json())

    @property
    def has_ongoing_execution(self) -> bool:
        with self._lock:
            return self._phase != ExecutorPhase.NO_TASK_IN_PROGRESS

    @property
    def recovery_in_progress(self) -> bool:
        """True while a journal replay is being reconciled — callers
        gating on has_ongoing_execution (a self-healing caller's
        one-fix-at-a-time rule) must treat this exactly the same: the
        cluster may be half-moved until reconciliation settles."""
        return self._recovery_in_progress

    def recovery_json(self) -> Optional[dict]:
        """The `recovery` block of ExecutorState: journal health + the
        last reconcile-and-resume outcome.  None (block omitted) when
        journaling is off and nothing was ever recovered — journal-less
        deployments see the exact pre-journal STATE body."""
        if self._journal is None and self.last_recovery is None \
                and not self._recovery_in_progress:
            return None
        out: dict = {
            "journalEnabled": self._journal is not None,
            "recoveryInProgress": self._recovery_in_progress,
        }
        if self._journal is not None:
            out["journal"] = self._journal.to_json()
        if self.last_recovery is not None:
            out["lastRecovery"] = self.last_recovery
        return out

    @property
    def journal(self) -> Optional[ExecutionJournal]:
        return self._journal

    def recently_removed_brokers(self) -> Set[int]:
        return self._recent(self._removed_brokers)

    def recently_demoted_brokers(self) -> Set[int]:
        return self._recent(self._demoted_brokers,
                            self._demotion_retention)

    def drop_recently_removed_brokers(self, brokers: Sequence[int]) -> None:
        with self._lock:
            for b in brokers:
                self._removed_brokers.pop(b, None)
        self._save_history()

    def drop_recently_demoted_brokers(self, brokers: Sequence[int]) -> None:
        with self._lock:
            for b in brokers:
                self._demoted_brokers.pop(b, None)
        self._save_history()

    def _save_history(self) -> None:
        """Persist the removal/demotion tables next to the journal so
        exclusion windows survive a process bounce (the reference kept
        these in ZooKeeper for the same reason)."""
        if self._journal is None:
            return
        with self._lock:
            removed = dict(self._removed_brokers)
            demoted = dict(self._demoted_brokers)
        self._journal.save_history(removed, demoted)

    def _recent(self, table: Dict[int, float],
                retention_s: Optional[float] = None) -> Set[int]:
        with self._lock:
            cutoff = self._time() - (retention_s
                                     if retention_s is not None
                                     else self._history_retention)
            for b in [b for b, t in table.items() if t < cutoff]:
                del table[b]
            return set(table)

    # ------------------------------------------------------------------
    # the execution runnable (reference ProposalExecutionRunnable)
    # ------------------------------------------------------------------
    def _run(self, throttle: Optional[float]) -> None:
        mgr = self._manager
        assert mgr is not None
        succeeded = True
        message = "execution completed"
        throttled_brokers: List[int] = []
        # adopted in-flight tasks from a crash recovery: the phase
        # loops start polling them instead of (re-)submitting
        seed = self._resume_seed or {}
        self._resume_seed = None
        try:
            if self._load_monitor is not None:
                self._load_monitor.pause_metric_sampling(
                    "executing proposals")
            if throttle is not None:
                snapshot = self._admin_call("describe_cluster")
                throttled_brokers = sorted(snapshot.alive_broker_ids)
                self._admin_call("set_replication_throttle",
                                 throttled_brokers, throttle)
                self._journal_throttle(throttled_brokers, throttle)
            self._set_phase(
                ExecutorPhase.INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS)
            self._inter_broker_move_replicas(
                mgr, seed.get(TaskType.INTER_BROKER_REPLICA_ACTION))
            self._set_phase(
                ExecutorPhase.INTRA_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS)
            self._intra_broker_move_replicas(
                mgr, seed.get(TaskType.INTRA_BROKER_REPLICA_ACTION))
            self._set_phase(ExecutorPhase.LEADER_MOVEMENT_TASK_IN_PROGRESS)
            self._move_leaderships(mgr)
        except ExecutionStoppedException:
            succeeded = False
            message = "execution stopped by user"
        except Exception as exc:  # noqa: BLE001 - report any failure
            LOG.exception("execution failed")
            succeeded = False
            message = f"execution failed: {exc}"
        finally:
            if throttled_brokers:
                try:
                    self._admin_call("clear_replication_throttle",
                                     throttled_brokers)
                    self._journal_throttle_cleared(throttled_brokers)
                except Exception:  # noqa: BLE001
                    LOG.exception("failed to clear throttles")
            if self._load_monitor is not None:
                self._load_monitor.resume_metric_sampling(
                    "execution finished")
            with self._lock:
                uuid = self._uuid
            # the finish record commits BEFORE the phase flips to
            # NO_TASK: a crash in between replays as an already-settled
            # execution (nothing to recover), never as in-flight
            if self._journal is not None:
                self._journal.log_finish(uuid, succeeded, message)
            with self._lock:
                self._phase = ExecutorPhase.NO_TASK_IN_PROGRESS
            if self._notifier is not None and uuid is not None:
                self._notifier.on_execution_finished(uuid, succeeded, message)

    def _set_phase(self, phase: ExecutorPhase) -> None:
        with self._lock:
            if self._stop_requested:
                raise ExecutionStoppedException()
            self._phase = phase
        if self._journal is not None:
            self._journal.log_phase(self._uuid, phase.value)

    # ------------------------------------------------------------------
    # journal hooks (no-ops without a journal; called only from the
    # single-writer runnable / the execute_proposals caller thread, so
    # they add no locking to the executor)
    # ------------------------------------------------------------------
    def _journal_task(self, task: ExecutionTask, now_ms: float) -> None:
        if self._journal is not None:
            self._journal.log_task(self._uuid, task.stable_key,
                                   task.state.value, now_ms,
                                   task.reexecution_count)

    def _journal_tasks(self, tasks: Sequence[ExecutionTask],
                       now_ms: float) -> None:
        for t in tasks:
            self._journal_task(t, now_ms)

    def _journal_throttle(self, brokers: Sequence[int],
                          rate: float) -> None:
        if self._journal is not None:
            self._journal.log_throttle(self._uuid, brokers, rate)

    def _journal_throttle_cleared(self, brokers: Sequence[int]) -> None:
        if self._journal is not None:
            self._journal.log_throttle_cleared(self._uuid, brokers)

    def _finish_task(self, mgr: ExecutionTaskManager, task: ExecutionTask,
                     state: TaskState, now_ms: float) -> None:
        """finish_task + journal in one step (every terminal
        transition must reach the WAL)."""
        mgr.finish_task(task, state, now_ms)
        self._journal_task(task, now_ms)

    def _check_stop(self, mgr: ExecutionTaskManager,
                    in_flight: List[ExecutionTask]) -> None:
        with self._lock:
            if not self._stop_requested:
                return
            force = self._force_stop
        now_ms = self._time() * 1000.0
        if force:
            # cancel in-flight reassignments outright
            cancel = {TopicPartition(t.proposal.partition.topic,
                                     t.proposal.partition.partition): None
                      for t in in_flight
                      if t.task_type == TaskType.INTER_BROKER_REPLICA_ACTION}
            if cancel:
                self._admin_call("alter_partition_reassignments", cancel)
            for t in list(in_flight):
                mgr.mark_aborting(t, now_ms)
                self._finish_task(mgr, t, TaskState.ABORTED, now_ms)
                in_flight.remove(t)
        else:
            for t in in_flight:
                mgr.mark_aborting(t, now_ms)
                self._journal_task(t, now_ms)
        raise ExecutionStoppedException()

    # ------------------------------------------------------------------
    # phase 1: inter-broker replica movement
    # ------------------------------------------------------------------
    def _inter_broker_move_replicas(
            self, mgr: ExecutionTaskManager,
            adopted: Optional[List[ExecutionTask]] = None) -> None:
        #: `adopted`: in-flight reassignments a crash recovery found
        #: still running in the cluster — polled to completion exactly
        #: like own submissions, NEVER re-submitted
        in_flight: List[ExecutionTask] = list(adopted or [])
        while True:
            now_ms = self._time() * 1000.0
            new_tasks = mgr.next_inter_broker_tasks(now_ms)
            # write-ahead: IN_PROGRESS records commit before the
            # submission reaches the cluster (a crash in between reads
            # as requested-but-not-submitted; reconciliation re-submits
            # safely because the cluster never saw it)
            self._journal_tasks(new_tasks, now_ms)
            if new_tasks:
                alive = self._admin_call("describe_cluster").alive_broker_ids
                targets = {}
                for t in new_tasks:
                    if any(b not in alive
                           for b in t.proposal.replicas_to_add):
                        # destination already dead — never submit
                        self._finish_task(mgr, t, TaskState.DEAD, now_ms)
                        continue
                    tp = TopicPartition(t.proposal.partition.topic,
                                        t.proposal.partition.partition)
                    targets[tp] = [r.broker_id
                                   for r in t.proposal.new_replicas]
                    in_flight.append(t)
                if targets:
                    self._admin_call("alter_partition_reassignments", targets)
            if not in_flight and not new_tasks:
                counts = mgr.counts(TaskType.INTER_BROKER_REPLICA_ACTION)
                if counts.pending == 0:
                    return
            try:
                self._check_stop(mgr, in_flight)
            except ExecutionStoppedException:
                if in_flight:
                    # graceful stop: wait for in-flight tasks to finish
                    self._drain_inter_broker(mgr, in_flight)
                raise
            self._sleep(self._check_interval)
            self._poll_inter_broker(mgr, in_flight)

    def _drain_inter_broker(self, mgr: ExecutionTaskManager,
                            in_flight: List[ExecutionTask]) -> None:
        while in_flight:
            self._sleep(self._check_interval)
            self._poll_inter_broker(mgr, in_flight)
            with self._lock:
                if self._force_stop:
                    now_ms = self._time() * 1000.0
                    cancel = {
                        TopicPartition(t.proposal.partition.topic,
                                       t.proposal.partition.partition): None
                        for t in in_flight}
                    if cancel:
                        self._admin_call("alter_partition_reassignments", cancel)
                    for t in list(in_flight):
                        self._finish_task(mgr, t, TaskState.ABORTED, now_ms)
                    in_flight.clear()

    def _tolerate_poll_failure(self, phase: str, exc: Exception) -> None:
        """A progress POLL hit a transient admin/cluster failure: the
        in-flight work is still running inside the cluster, so failing
        the whole execution would abandon it for an observation error —
        count it, log it, and observe again next interval.  (Submission
        paths stay fail-fast: not requesting work is recoverable by the
        caller, silently dropping requested work is not.)  Bounded:
        after `_max_consecutive_poll_failures` in a row the failure is
        re-raised and the execution fails — a permanently dead admin
        client must not wedge has_ongoing_execution forever."""
        self.num_poll_failures_tolerated += 1
        self._consecutive_poll_failures += 1
        if self._consecutive_poll_failures \
                > self._max_consecutive_poll_failures:
            LOG.error(
                "%s progress poll failed %d consecutive times; the admin "
                "client looks permanently broken — failing the execution",
                phase, self._consecutive_poll_failures)
            raise exc
        LOG.warning(
            "%s progress poll failed (%s: %s); retrying next interval "
            "(%d/%d consecutive, %d tolerated this process)", phase,
            type(exc).__name__, exc, self._consecutive_poll_failures,
            self._max_consecutive_poll_failures,
            self.num_poll_failures_tolerated)

    def _poll_inter_broker(self, mgr: ExecutionTaskManager,
                           in_flight: List[ExecutionTask]) -> None:
        """One metadata poll: classify each in-flight reassignment as done,
        dead, lost (re-execute), or still moving (reference
        waitForExecutionTaskToFinish + maybeReexecuteTasks — re-execution
        happens only when the cluster no longer knows about the
        reassignment, never on a wall-clock timer, so slow transfers are
        simply waited out).  Transient admin failures skip the poll
        (retried next interval) instead of failing the execution."""
        try:
            self._poll_inter_broker_once(mgr, in_flight)
            self._consecutive_poll_failures = 0
        except Exception as exc:  # noqa: BLE001 - poll is observational
            self._tolerate_poll_failure("inter-broker", exc)

    def _poll_inter_broker_once(self, mgr: ExecutionTaskManager,
                                in_flight: List[ExecutionTask]) -> None:
        snapshot = self._admin_call("describe_cluster")
        reassigning = {r.tp for r in
                       self._admin_call("list_partition_reassignments")}
        alive = snapshot.alive_broker_ids
        now_ms = self._time() * 1000.0
        for task in list(in_flight):
            p = task.proposal
            tp = TopicPartition(p.partition.topic, p.partition.partition)
            info = snapshot.partition(tp)
            new_brokers = [r.broker_id for r in p.new_replicas]
            if info is None:
                # partition deleted out from under us
                self._finish_task(mgr, task, TaskState.DEAD, now_ms)
                in_flight.remove(task)
                continue
            if tp not in reassigning and set(info.replicas) == set(new_brokers):
                state = (TaskState.ABORTED
                         if task.state == TaskState.ABORTING
                         else TaskState.COMPLETED)
                self._finish_task(mgr, task, state, now_ms)
                in_flight.remove(task)
            elif any(b not in alive for b in p.replicas_to_add):
                # a destination broker died: task cannot finish
                self._admin_call("alter_partition_reassignments", {tp: None})
                self._finish_task(mgr, task, TaskState.DEAD, now_ms)
                in_flight.remove(task)
            elif tp not in reassigning:
                # the cluster lost the reassignment (e.g. controller
                # failover): re-submit it
                task.reexecution_count += 1
                self._journal_task(task, now_ms)
                self._admin_call("alter_partition_reassignments",
                                 {tp: new_brokers})
            else:
                age_s = (now_ms - task.start_time_ms) / 1e3
                if age_s > self._max_lifetime:
                    # absolute lifetime exceeded (reference
                    # max.execution.task.lifetime.ms): cancel + mark dead
                    self._admin_call("alter_partition_reassignments", {tp: None})
                    self._finish_task(mgr, task, TaskState.DEAD, now_ms)
                    in_flight.remove(task)
                else:
                    mb = task.proposal.inter_broker_data_to_move / 1e6
                    rate = mb / max(age_s, 1e-9)
                    slow = (age_s > self._alert_threshold
                            or (age_s > self._check_interval
                                and rate < self._inter_rate_alert_mb_s
                                and mb > 0.0))
                    if slow and task.task_id not in self._alerted_tasks:
                        self._alerted_tasks.add(task.task_id)
                        LOG.warning(
                            "task %s (%s) running for %.0fs at %.2f MB/s "
                            "(alert thresholds: %.0fs / %.2f MB/s)",
                            task.task_id, tp, age_s, rate,
                            self._alert_threshold,
                            self._inter_rate_alert_mb_s)

    # ------------------------------------------------------------------
    # phase 2: intra-broker (logdir) movement
    # ------------------------------------------------------------------
    def _intra_broker_move_replicas(
            self, mgr: ExecutionTaskManager,
            adopted: Optional[List[ExecutionTask]] = None) -> None:
        in_flight: List[ExecutionTask] = list(adopted or [])
        while True:
            now_ms = self._time() * 1000.0
            new_tasks = mgr.next_intra_broker_tasks(now_ms)
            self._journal_tasks(new_tasks, now_ms)
            if new_tasks:
                moves: Dict[TopicPartition, Dict[int, str]] = {}
                for t in new_tasks:
                    tp = TopicPartition(t.proposal.partition.topic,
                                        t.proposal.partition.partition)
                    old_dirs = {r.broker_id: r.logdir
                                for r in t.proposal.old_replicas}
                    for r in t.proposal.new_replicas:
                        if (r.logdir is not None
                                and old_dirs.get(r.broker_id) is not None
                                and old_dirs[r.broker_id] != r.logdir):
                            moves.setdefault(tp, {})[r.broker_id] = r.logdir
                if moves:
                    _t0 = self._time()
                    self._admin_call("alter_replica_log_dirs", moves)
                    if self._time() - _t0 > self._logdir_timeout_s:
                        LOG.warning(
                            "alter_replica_log_dirs took %.1fs (> "
                            "logdir.response.timeout.ms)",
                            self._time() - _t0)
                in_flight.extend(new_tasks)
            if not in_flight and not new_tasks:
                if mgr.counts(TaskType.INTRA_BROKER_REPLICA_ACTION).pending \
                        == 0:
                    return
            self._check_stop(mgr, in_flight)
            self._sleep(self._check_interval)
            # poll: logdir placement matches the proposal
            try:
                snapshot = self._admin_call("describe_cluster")
                self._consecutive_poll_failures = 0
            except Exception as exc:  # noqa: BLE001 - observational
                self._tolerate_poll_failure("intra-broker", exc)
                continue
            alive = snapshot.alive_broker_ids
            now_ms = self._time() * 1000.0
            for task in list(in_flight):
                p = task.proposal
                tp = TopicPartition(p.partition.topic, p.partition.partition)
                info = snapshot.partition(tp)
                want = {r.broker_id: r.logdir for r in p.new_replicas
                        if r.logdir is not None}
                if info is None or any(b not in alive for b in want):
                    # partition deleted or the hosting broker died
                    self._finish_task(mgr, task, TaskState.DEAD, now_ms)
                    in_flight.remove(task)
                    continue
                have = dict(info.logdir_by_broker)
                if all(have.get(b) == d for b, d in want.items()):
                    self._finish_task(mgr, task, TaskState.COMPLETED,
                                      now_ms)
                    in_flight.remove(task)
                elif (now_ms - task.start_time_ms
                      > self._max_idle * 1000.0):
                    # logdir move stalled beyond the idle budget
                    self._finish_task(mgr, task, TaskState.DEAD, now_ms)
                    in_flight.remove(task)
                else:
                    age_s = (now_ms - task.start_time_ms) / 1e3
                    mb = p.intra_broker_data_to_move / 1e6
                    if (age_s > self._check_interval and mb > 0.0
                            and mb / age_s < self._intra_rate_alert_mb_s
                            and task.task_id not in self._alerted_tasks):
                        self._alerted_tasks.add(task.task_id)
                        LOG.warning(
                            "intra-broker task %s (%s) at %.2f MB/s, "
                            "below the %.2f MB/s alerting floor",
                            task.task_id, tp, mb / age_s,
                            self._intra_rate_alert_mb_s)

    # ------------------------------------------------------------------
    # phase 3: leadership movement
    # ------------------------------------------------------------------
    def _move_leaderships(self, mgr: ExecutionTaskManager) -> None:
        while True:
            now_ms = self._time() * 1000.0
            batch = mgr.next_leadership_tasks(now_ms)
            self._journal_tasks(batch, now_ms)
            if not batch:
                if mgr.counts(TaskType.LEADER_ACTION).pending == 0:
                    return
                self._sleep(self._check_interval)
                continue
            self._check_stop(mgr, batch)
            # reorder each partition's replica list so the desired leader is
            # the preferred replica (an in-place same-set reassignment), then
            # trigger preferred-leader election — the modern equivalent of
            # the reference's ZK PLE path (ExecutorUtils.scala:95-101)
            snapshot = self._admin_call("describe_cluster")
            alive = snapshot.alive_broker_ids
            tps = []
            reorders = {}
            for t in list(batch):
                p = t.proposal
                tp = TopicPartition(p.partition.topic, p.partition.partition)
                info = snapshot.partition(tp)
                want = [r.broker_id for r in p.new_replicas]
                if (info is None or p.new_leader not in alive
                        or set(info.replicas) != set(want)):
                    # leader is dead or its replica never arrived (e.g. the
                    # inter-broker task died): leadership cannot move
                    self._finish_task(mgr, t, TaskState.DEAD, now_ms)
                    batch.remove(t)
                    continue
                tps.append(tp)
                reorders[tp] = want
            if reorders:
                try:
                    self._admin_call("alter_partition_reassignments",
                                     reorders)
                    self._admin_call("elect_preferred_leaders", tps)
                except Exception as exc:  # noqa: BLE001 - deadline decides
                    # the election request failed (transient admin/
                    # controller trouble): leadership may still land if
                    # part of the request went through — poll until the
                    # leader-movement timeout marks the stragglers DEAD
                    self._tolerate_poll_failure("leadership-submit", exc)
            deadline_ms = (self._time() + self._leader_timeout) * 1000.0
            pending = list(batch)
            while pending:
                with self._lock:
                    stop = self._stop_requested
                if stop:
                    # leadership movements are instantaneous requests; on
                    # stop just abandon what hasn't landed yet
                    now_ms = self._time() * 1000.0
                    for task in pending:
                        mgr.mark_aborting(task, now_ms)
                        self._finish_task(mgr, task, TaskState.ABORTED,
                                          now_ms)
                    raise ExecutionStoppedException()
                self._sleep(min(self._check_interval,
                                self._leader_timeout / 10.0))
                now_ms = self._time() * 1000.0
                try:
                    snapshot = self._admin_call("describe_cluster")
                    self._consecutive_poll_failures = 0
                except Exception as exc:  # noqa: BLE001 - observational
                    self._tolerate_poll_failure("leadership", exc)
                    if now_ms > deadline_ms:
                        for task in pending:
                            self._finish_task(mgr, task, TaskState.DEAD,
                                              now_ms)
                        pending.clear()
                    continue
                alive = snapshot.alive_broker_ids
                for task in list(pending):
                    p = task.proposal
                    tp = TopicPartition(p.partition.topic,
                                        p.partition.partition)
                    info = snapshot.partition(tp)
                    if info is None or p.new_leader not in alive:
                        self._finish_task(mgr, task, TaskState.DEAD,
                                          now_ms)
                        pending.remove(task)
                    elif info.leader == p.new_leader:
                        self._finish_task(mgr, task, TaskState.COMPLETED,
                                          now_ms)
                        pending.remove(task)
                if now_ms > deadline_ms:
                    for task in pending:
                        self._finish_task(mgr, task, TaskState.DEAD,
                                          now_ms)
                    pending.clear()

    # ------------------------------------------------------------------
    # crash recovery: replay -> reconcile -> resume | abort-and-clean
    # (executor/journal.py + executor/recovery.py)
    # ------------------------------------------------------------------
    def recover(self, mode: str = "resume",
                wait: bool = False) -> Optional[dict]:
        """Replay the journal and settle whatever the crashed process
        left behind.  Returns the RecoveryReport json (also kept as
        `last_recovery`), or None when there is nothing to recover.

        `mode="resume"` restarts the interrupted execution under its
        ORIGINAL uuid/caps/strategy/throttle, with moves the cluster
        already finished sealed as completed and moves still running
        adopted (polled, never re-submitted).  `mode="abort"` cancels
        the in-flight reassignments and settles the journal, leaving
        `has_ongoing_execution` false.  Both modes clear orphaned
        replication throttles FIRST.  While reconciliation runs,
        `recovery_in_progress` is True — a self-healing caller must not
        start a self-heal over a half-moved cluster."""
        if mode not in ("resume", "abort"):
            raise ValueError(
                f"executor.recovery.mode must be resume|abort, "
                f"got {mode!r}")
        if self._journal is None:
            return None
        with self._lock:
            if self._phase != ExecutorPhase.NO_TASK_IN_PROGRESS:
                raise RuntimeError(
                    "cannot recover while an execution is in progress")
            self._recovery_in_progress = True
        try:
            with obs_trace.span("recovery.replay") as sp:
                replay = self._journal.replay()
                if sp is not None:
                    sp.set_tag("records", replay.records)
                    sp.set_tag("truncated", replay.truncated)
            # orphaned throttles are cleared even for executions whose
            # finish record landed but whose clear call failed
            cleared = self._clear_orphaned_throttles(
                replay.throttle_brokers,
                replay.start.get("uuid") if replay.start else None)
            if not replay.in_flight:
                if cleared:
                    LOG.info("recovery: cleared %d orphaned "
                             "replication throttles from a settled "
                             "execution", len(cleared))
                return None
            with obs_trace.span("recovery.reconcile") as sp:
                snapshot = self._admin_call("describe_cluster")
                reassigning = [
                    r.tp for r in
                    self._admin_call("list_partition_reassignments")]
                plan = recovery_mod.reconcile(replay, snapshot,
                                              reassigning)
                if sp is not None and plan is not None:
                    sp.set_tag("adopted", plan.count(recovery_mod.ADOPT))
                    sp.set_tag("pending",
                               plan.count(recovery_mod.PENDING))
            if plan is None:
                return None
            LOG.warning("recovery: %s — mode=%s",
                        recovery_mod.plan_summary(plan), mode)
            now_ms = self._time() * 1000.0
            if mode == "abort":
                with obs_trace.span("recovery.abort"):
                    cancelled = self._abort_recovered(plan)
                report = recovery_mod.report_from_plan(
                    plan, mode, resumed=False, cancelled=cancelled,
                    now_ms=now_ms)
            else:
                with obs_trace.span("recovery.resume"):
                    self._start_recovered(plan)
                report = recovery_mod.report_from_plan(
                    plan, mode, resumed=True, cancelled=0,
                    now_ms=now_ms)
            report.cleared_throttle_brokers = cleared
            self.last_recovery = report.to_json()
        finally:
            self._recovery_in_progress = False
        if wait and mode == "resume":
            self.await_completion()
        return self.last_recovery

    def _clear_orphaned_throttles(self, brokers: List[int],
                                  uuid: Optional[str]) -> List[int]:
        if not brokers:
            return []
        try:
            self._admin_call("clear_replication_throttle", brokers)
            if self._journal is not None:
                # the clear must carry the REPLAYED execution's uuid
                # (self._uuid is None in a fresh process): replay
                # filters records by the active start's uuid, and an
                # unattributed clear would be dropped — every later
                # restart would re-clear, stripping throttles someone
                # else applied in the meantime
                self._journal.log_throttle_cleared(uuid, brokers)
            return list(brokers)
        except Exception:  # noqa: BLE001 - best effort; the resumed
            # execution re-applies and re-clears its own throttle anyway
            LOG.exception("recovery: clearing orphaned throttles on "
                          "%s failed", brokers)
            return []

    def _start_recovered(self, plan) -> str:
        """Resume the interrupted execution under its original uuid:
        reload the journaled proposals through the same deterministic
        planner, seal reconciled terminal states, adopt in-flight
        moves, and start the runnable — the phase loops then treat the
        adopted tasks exactly like own submissions."""
        now_ms = self._time() * 1000.0
        with self._lock:
            if self._phase != ExecutorPhase.NO_TASK_IN_PROGRESS:
                raise RuntimeError(
                    f"cannot resume in state {self._phase}")
            self._phase = ExecutorPhase.STARTING_EXECUTION
            self._stop_requested = False
            self._force_stop = False
            self._uuid = plan.uuid
            self._reason = (plan.reason or "recovered execution")
            self._alerted_tasks.clear()
            self._consecutive_poll_failures = 0
            now = self._time()
            for b in plan.removed_brokers:
                self._removed_brokers.setdefault(b, now)
            for b in plan.demoted_brokers:
                self._demoted_brokers.setdefault(b, now)
            caps = plan.caps
            mgr = ExecutionTaskManager(
                int(caps.get("inter", self._inter_cap)),
                int(caps.get("intra", self._intra_cap)),
                int(caps.get("leader", self._leader_cap)),
                (strategy_from_names(plan.strategy_names)
                 if plan.strategy_names else self._default_strategy))
            snapshot = self._admin_call("describe_cluster")
            mgr.load_proposals(plan.proposals,
                               sorted(snapshot.all_broker_ids))
            adopted = mgr.apply_recovery(plan.resolutions, now_ms)
            self._manager = mgr
            self._resume_seed = adopted
            run_uuid = self._uuid
        OPERATION_LOG.info(
            "execution %s RESUMED after process restart: %d tasks "
            "(%d already terminal, %d adopted in flight, %d pending), "
            "crashed in phase %s, reason: %s",
            run_uuid, len(plan.tasks),
            plan.count(recovery_mod.TERMINAL),
            plan.count(recovery_mod.ADOPT),
            plan.count(recovery_mod.PENDING),
            plan.phase_at_crash or "(unknown)",
            plan.reason or "(unspecified)")
        if self._journal is not None:
            # re-journal the execution self-contained in a fresh
            # segment: start (resumed=true) + every non-pending
            # RESOLUTION (not the fresh planner tasks, which are still
            # PENDING — a second crash must replay the sealed/adopted
            # states, and adopted tasks must keep their ORIGINAL start
            # time so the max-lifetime clock survives the bounce)
            self._journal.log_start(
                uuid=run_uuid, reason=plan.reason,
                proposals=plan.proposals, caps=plan.caps,
                strategy_names=plan.strategy_names,
                removed_brokers=plan.removed_brokers,
                demoted_brokers=plan.demoted_brokers,
                throttle=plan.throttle, resumed=True)
            for task in plan.tasks:
                res = plan.resolutions[task.stable_key]
                if res.action == recovery_mod.TERMINAL:
                    self._journal.log_task(run_uuid, task.stable_key,
                                           res.state, now_ms,
                                           res.reexecution_count)
                elif res.action == recovery_mod.ADOPT:
                    self._journal.log_task(
                        run_uuid, task.stable_key,
                        TaskState.IN_PROGRESS.value,
                        res.start_ms if res.start_ms > 0 else now_ms,
                        res.reexecution_count)
            self._save_history()
        self._thread = threading.Thread(
            target=self._run, args=(plan.throttle,),
            name=f"proposal-execution-{run_uuid[:8]}", daemon=True)
        self._thread.start()
        return run_uuid

    def _abort_recovered(self, plan) -> int:
        """Abort-and-clean: cancel adopted in-flight reassignments,
        seal every non-terminal task as aborted in the journal, and
        settle the journal with a finish record — the cluster keeps
        whatever moves already completed (metadata is truth; unwinding
        them would be a second rebalance, the operator's call)."""
        now_ms = self._time() * 1000.0
        cancel = {}
        for task in plan.adopted_tasks(
                TaskType.INTER_BROKER_REPLICA_ACTION):
            p = task.proposal
            cancel[TopicPartition(p.partition.topic,
                                  p.partition.partition)] = None
        if cancel:
            self._admin_call("alter_partition_reassignments", cancel)
        if self._journal is not None:
            for task in plan.tasks:
                res = plan.resolutions[task.stable_key]
                if res.action == recovery_mod.TERMINAL:
                    self._journal.log_task(plan.uuid, task.stable_key,
                                           res.state, now_ms,
                                           res.reexecution_count)
                else:
                    self._journal.log_task(plan.uuid, task.stable_key,
                                           TaskState.ABORTED.value,
                                           now_ms,
                                           res.reexecution_count)
            self._journal.log_finish(
                plan.uuid, False,
                f"aborted by crash recovery "
                f"({len(cancel)} in-flight reassignments cancelled)")
            self._save_history()
        OPERATION_LOG.info(
            "execution %s ABORTED by crash recovery: %d in-flight "
            "reassignments cancelled, %d tasks were already terminal",
            plan.uuid, len(cancel), plan.count(recovery_mod.TERMINAL))
        return len(cancel)
