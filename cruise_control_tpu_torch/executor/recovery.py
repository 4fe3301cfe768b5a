"""Reconcile and resume (port of cruise_control_tpu/executor/recovery.py):
turn a replayed executor journal into action.

The journal records what the executor requested; the cluster records
what happened.  Reconciliation takes live metadata as ground truth and
classifies every journaled task:

* **terminal** — the journal already recorded COMPLETED/ABORTED/DEAD, or
  the cluster proves the move landed (placement == target and no ongoing
  reassignment), or the partition vanished (DEAD);
* **adopt**   — the cluster still lists the reassignment: the resumed
  execution polls it to completion and never re-submits it;
* **pending** — neither: the request never reached the cluster (or the
  cluster lost it), so the task executes normally.

`resume` restarts the same execution (uuid, caps, strategy, throttle)
with terminal tasks sealed and adopted tasks polled; `abort` cancels the
adopted reassignments and settles the journal.  In both modes orphaned
replication throttles are removed first.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.cluster.types import TopicPartition
from cruise_control_tpu_torch.executor.journal import JournalReplay
from cruise_control_tpu_torch.executor.planner import ExecutionTaskPlanner
from cruise_control_tpu_torch.executor.task import (ExecutionTask, TaskState,
                                                    TaskType)

LOG = logging.getLogger(__name__)

#: reconciliation verdict per task
TERMINAL = "terminal"
ADOPT = "adopt"
PENDING = "pending"


@dataclasses.dataclass
class TaskResolution:
    key: str
    action: str                      # TERMINAL | ADOPT | PENDING
    state: Optional[str] = None      # terminal TaskState name
    start_ms: float = -1.0           # adopted: original start time
    reexecution_count: int = 0


@dataclasses.dataclass
class ReconcilePlan:
    """Everything `Executor` needs to resume or abort one recovered
    execution."""

    uuid: str
    reason: str
    proposals: List[ExecutionProposal]
    caps: dict
    strategy_names: List[str]
    throttle: Optional[float]
    removed_brokers: List[int]
    demoted_brokers: List[int]
    resolutions: Dict[str, TaskResolution]
    #: planner-decomposed tasks (fresh objects, stable keys assigned)
    tasks: List[ExecutionTask]
    clear_throttle_brokers: List[int]
    phase_at_crash: Optional[str]
    journal_truncated: bool = False

    def count(self, action: str) -> int:
        return sum(1 for r in self.resolutions.values()
                   if r.action == action)

    def adopted_tasks(self, task_type: TaskType) -> List[ExecutionTask]:
        return [t for t in self.tasks
                if t.task_type is task_type
                and self.resolutions[t.stable_key].action == ADOPT]

    def to_json(self) -> dict:
        return {
            "uuid": self.uuid,
            "phaseAtCrash": self.phase_at_crash,
            "tasksTotal": len(self.tasks),
            "tasksTerminal": self.count(TERMINAL),
            "tasksAdopted": self.count(ADOPT),
            "tasksPending": self.count(PENDING),
            "clearThrottleBrokers": list(self.clear_throttle_brokers),
            "journalTruncated": self.journal_truncated,
        }


def reconcile(replay: JournalReplay, snapshot,
              reassigning_tps: Sequence[TopicPartition]
              ) -> Optional[ReconcilePlan]:
    """Build the recovery plan for the replayed journal against one
    consistent metadata observation (`snapshot` +
    `reassigning_tps` fetched by the caller through its admin client).
    Returns None when the journal holds no unfinished execution."""
    if not replay.in_flight:
        return None
    start = replay.start
    proposals = replay.proposals()
    # the SAME deterministic decomposition the original process ran:
    # stable keys line up because the planner derives them from the
    # proposal content, not from process-local counters
    planner = ExecutionTaskPlanner()
    planner.add_proposals(proposals)
    tasks = planner.all_tasks()
    reassigning = set(reassigning_tps)
    resolutions: Dict[str, TaskResolution] = {}
    for task in tasks:
        resolutions[task.stable_key] = _resolve(
            task, replay.tasks.get(task.stable_key), snapshot,
            reassigning)
    return ReconcilePlan(
        uuid=start["uuid"],
        reason=start.get("reason") or "",
        proposals=proposals,
        caps=dict(start.get("caps") or {}),
        strategy_names=list(start.get("strategy") or []),
        throttle=start.get("throttle"),
        removed_brokers=list(start.get("removed") or []),
        demoted_brokers=list(start.get("demoted") or []),
        resolutions=resolutions,
        tasks=tasks,
        clear_throttle_brokers=list(replay.throttle_brokers),
        phase_at_crash=replay.phase,
        journal_truncated=replay.truncated,
    )


def _resolve(task: ExecutionTask, recorded: Optional[dict], snapshot,
             reassigning: set) -> TaskResolution:
    """Classify one task: journal says what was requested, the cluster
    says what happened — the cluster wins."""
    key = task.stable_key
    reexec = int(recorded.get("reexec", 0)) if recorded else 0
    rec_state = recorded.get("state") if recorded else None
    if rec_state in (TaskState.COMPLETED.value, TaskState.ABORTED.value,
                     TaskState.DEAD.value):
        return TaskResolution(key, TERMINAL, state=rec_state,
                              reexecution_count=reexec)
    p = task.proposal
    tp = TopicPartition(p.partition.topic, p.partition.partition)
    info = snapshot.partition(tp)
    if info is None:
        # partition deleted while we were down
        return TaskResolution(key, TERMINAL, state=TaskState.DEAD.value,
                              reexecution_count=reexec)
    start_ms = float(recorded.get("ts", -1.0)) if recorded else -1.0
    if task.task_type is TaskType.INTER_BROKER_REPLICA_ACTION:
        want = {r.broker_id for r in p.new_replicas}
        if tp in reassigning:
            # Kafka is executing it right now: poll, never re-submit
            return TaskResolution(key, ADOPT, start_ms=start_ms,
                                  reexecution_count=reexec)
        if set(info.replicas) == want:
            return TaskResolution(key, TERMINAL,
                                  state=TaskState.COMPLETED.value,
                                  reexecution_count=reexec)
        return TaskResolution(key, PENDING, reexecution_count=reexec)
    if task.task_type is TaskType.INTRA_BROKER_REPLICA_ACTION:
        want = {r.broker_id: r.logdir for r in p.new_replicas
                if r.logdir is not None}
        have = dict(info.logdir_by_broker)
        if want and all(have.get(b) == d for b, d in want.items()):
            return TaskResolution(key, TERMINAL,
                                  state=TaskState.COMPLETED.value,
                                  reexecution_count=reexec)
        # logdir moves have no in-flight listing to prove the alter
        # ever reached the cluster (unlike reassignments), and
        # re-requesting a move to the same destination dir is
        # idempotent — so an unlanded move is always re-submitted;
        # adopting a possibly-never-submitted one would stall until
        # the idle timeout killed it
        return TaskResolution(key, PENDING, reexecution_count=reexec)
    # LEADER_ACTION: elections are near-instant requests — done if the
    # leader matches, otherwise re-request (idempotent)
    if info.leader == p.new_leader:
        return TaskResolution(key, TERMINAL,
                              state=TaskState.COMPLETED.value,
                              reexecution_count=reexec)
    return TaskResolution(key, PENDING, reexecution_count=reexec)


@dataclasses.dataclass
class RecoveryReport:
    """What a recovery pass did (the ExecutorState `recovery` block)."""

    mode: str
    uuid: str
    resumed: bool
    tasks_total: int = 0
    tasks_terminal: int = 0
    tasks_adopted: int = 0
    tasks_pending: int = 0
    cleared_throttle_brokers: List[int] = dataclasses.field(
        default_factory=list)
    cancelled_reassignments: int = 0
    journal_truncated: bool = False
    phase_at_crash: Optional[str] = None
    recovered_at_ms: float = 0.0

    def to_json(self) -> dict:
        return {
            "mode": self.mode,
            "uuid": self.uuid,
            "resumed": self.resumed,
            "tasksTotal": self.tasks_total,
            "tasksTerminal": self.tasks_terminal,
            "tasksAdopted": self.tasks_adopted,
            "tasksPending": self.tasks_pending,
            "clearedThrottleBrokers": list(self.cleared_throttle_brokers),
            "cancelledReassignments": self.cancelled_reassignments,
            "journalTruncated": self.journal_truncated,
            "phaseAtCrash": self.phase_at_crash,
            "recoveredAtMs": self.recovered_at_ms,
        }


def report_from_plan(plan: ReconcilePlan, mode: str, resumed: bool,
                     cancelled: int, now_ms: float) -> RecoveryReport:
    return RecoveryReport(
        mode=mode, uuid=plan.uuid, resumed=resumed,
        tasks_total=len(plan.tasks),
        tasks_terminal=plan.count(TERMINAL),
        tasks_adopted=plan.count(ADOPT),
        tasks_pending=plan.count(PENDING),
        cleared_throttle_brokers=list(plan.clear_throttle_brokers),
        cancelled_reassignments=cancelled,
        journal_truncated=plan.journal_truncated,
        phase_at_crash=plan.phase_at_crash,
        recovered_at_ms=now_ms)


def plan_summary(plan: Optional[ReconcilePlan]) -> str:
    if plan is None:
        return "nothing to recover"
    return (f"execution {plan.uuid}: {len(plan.tasks)} tasks "
            f"({plan.count(TERMINAL)} terminal, {plan.count(ADOPT)} "
            f"adopted in-flight, {plan.count(PENDING)} pending), "
            f"crashed in phase {plan.phase_at_crash or 'unknown'}")


def stable_keys(tasks: Sequence[ExecutionTask]) -> Tuple[str, ...]:
    return tuple(t.stable_key for t in tasks)
