"""Execution tasks (port of cruise_control_tpu/executor/task.py): a task
wraps one ExecutionProposal with an action type and walks the state
machine PENDING -> IN_PROGRESS -> {COMPLETED, ABORTING -> ABORTED, DEAD}
(Cruise Control's ExecutionTask).  Host objects only.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal


class TaskType(enum.Enum):
    """Reference ExecutionTask.TaskType."""

    INTER_BROKER_REPLICA_ACTION = "INTER_BROKER_REPLICA_ACTION"
    INTRA_BROKER_REPLICA_ACTION = "INTRA_BROKER_REPLICA_ACTION"
    LEADER_ACTION = "LEADER_ACTION"


class TaskState(enum.Enum):
    """Reference ExecutionTask.State (ExecutionTask.java:31-44)."""

    PENDING = "PENDING"
    IN_PROGRESS = "IN_PROGRESS"
    ABORTING = "ABORTING"
    ABORTED = "ABORTED"
    DEAD = "DEAD"
    COMPLETED = "COMPLETED"


#: legal state-machine transitions (ExecutionTask.java VALID_TRANSFER map)
_VALID = {
    TaskState.PENDING: {TaskState.IN_PROGRESS},
    TaskState.IN_PROGRESS: {TaskState.ABORTING, TaskState.DEAD,
                            TaskState.COMPLETED},
    TaskState.ABORTING: {TaskState.ABORTED, TaskState.DEAD},
    TaskState.ABORTED: set(),
    TaskState.DEAD: set(),
    TaskState.COMPLETED: set(),
}

_task_ids = itertools.count()


@dataclasses.dataclass
class ExecutionTask:
    """One executable action derived from a proposal."""

    task_id: int
    proposal: ExecutionProposal
    task_type: TaskType
    state: TaskState = TaskState.PENDING
    start_time_ms: float = -1.0
    end_time_ms: float = -1.0
    #: how often the executor has observed no progress and re-submitted
    reexecution_count: int = 0
    #: process-independent identity for the durable journal: derived
    #: from the proposal CONTENT by the planner (type:topic:partition
    #: [:index]), so a restarted process decomposing the same journaled
    #: proposals lines its tasks up with the crashed process's records
    #: (task_id is a process-local counter and cannot)
    stable_key: str = ""

    @staticmethod
    def next_id() -> int:
        return next(_task_ids)

    # ---- state machine ----
    def _transition(self, to: TaskState, now_ms: float) -> None:
        if to not in _VALID[self.state]:
            raise ValueError(
                f"illegal task transition {self.state} -> {to} "
                f"(task {self.task_id})")
        self.state = to
        if to == TaskState.IN_PROGRESS:
            self.start_time_ms = now_ms
        if to in (TaskState.COMPLETED, TaskState.ABORTED, TaskState.DEAD):
            self.end_time_ms = now_ms

    def in_progress(self, now_ms: float) -> None:
        self._transition(TaskState.IN_PROGRESS, now_ms)

    def completed(self, now_ms: float) -> None:
        self._transition(TaskState.COMPLETED, now_ms)

    def aborting(self, now_ms: float) -> None:
        self._transition(TaskState.ABORTING, now_ms)

    def aborted(self, now_ms: float) -> None:
        self._transition(TaskState.ABORTED, now_ms)

    def kill(self, now_ms: float) -> None:
        self._transition(TaskState.DEAD, now_ms)

    # ---- queries ----
    def participants(self) -> set:
        """Brokers touched by this task (old + new replica sets) — the
        slot-accounting unit for inter-broker concurrency."""
        p = self.proposal
        return ({r.broker_id for r in p.old_replicas}
                | {r.broker_id for r in p.new_replicas})

    def intra_brokers(self) -> set:
        """Brokers where this task moves a replica between logdirs (the
        new∩old set) — the slot-accounting unit for intra-broker moves."""
        p = self.proposal
        return ({r.broker_id for r in p.new_replicas}
                & {r.broker_id for r in p.old_replicas})

    @property
    def done(self) -> bool:
        return self.state in (TaskState.COMPLETED, TaskState.ABORTED,
                              TaskState.DEAD)

    @property
    def active(self) -> bool:
        return self.state in (TaskState.IN_PROGRESS, TaskState.ABORTING)

    def to_json(self) -> dict:
        return {
            "executionId": self.task_id,
            "type": self.task_type.value,
            "state": self.state.value,
            "proposal": self.proposal.to_json(),
        }
