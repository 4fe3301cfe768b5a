"""Executor state (port of cruise_control_tpu/executor/state.py): one of
NO_TASK_IN_PROGRESS, STARTING_EXECUTION, three per-phase IN_PROGRESS
states and STOPPING_EXECUTION, with progress counters per task type.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional

from cruise_control_tpu_torch.executor.task_manager import (
    ExecutionCounts, ExecutionTaskManager)
from cruise_control_tpu_torch.executor.task import TaskType


class ExecutorPhase(enum.Enum):
    NO_TASK_IN_PROGRESS = "NO_TASK_IN_PROGRESS"
    STARTING_EXECUTION = "STARTING_EXECUTION"
    INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS = (
        "INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS")
    INTRA_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS = (
        "INTRA_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS")
    LEADER_MOVEMENT_TASK_IN_PROGRESS = "LEADER_MOVEMENT_TASK_IN_PROGRESS"
    STOPPING_EXECUTION = "STOPPING_EXECUTION"


@dataclasses.dataclass(frozen=True)
class ExecutorState:
    """Immutable snapshot for the STATE endpoint."""

    phase: ExecutorPhase
    uuid: Optional[str] = None
    reason: Optional[str] = None
    inter_broker: Optional[ExecutionCounts] = None
    intra_broker: Optional[ExecutionCounts] = None
    leadership: Optional[ExecutionCounts] = None
    data_to_move_mb: float = 0.0
    data_moved_mb: float = 0.0
    #: crash-recovery telemetry (executor/journal.py + recovery.py):
    #: journal health and the last reconcile-and-resume outcome
    recovery: Optional[Dict] = None

    @staticmethod
    def idle(recovery: Optional[Dict] = None) -> "ExecutorState":
        return ExecutorState(ExecutorPhase.NO_TASK_IN_PROGRESS,
                             recovery=recovery)

    @staticmethod
    def snapshot(phase: ExecutorPhase, uuid: Optional[str],
                 reason: Optional[str],
                 manager: ExecutionTaskManager,
                 recovery: Optional[Dict] = None) -> "ExecutorState":
        return ExecutorState(
            phase=phase, uuid=uuid, reason=reason,
            inter_broker=manager.counts(TaskType.INTER_BROKER_REPLICA_ACTION),
            intra_broker=manager.counts(TaskType.INTRA_BROKER_REPLICA_ACTION),
            leadership=manager.counts(TaskType.LEADER_ACTION),
            data_to_move_mb=manager.inter_broker_data_to_move / 1e6,
            data_moved_mb=manager.inter_broker_data_moved / 1e6,
            recovery=recovery,
        )

    def to_json(self) -> Dict:
        out: Dict = {"state": self.phase.value}
        if self.recovery is not None:
            out["recovery"] = self.recovery
        if self.phase == ExecutorPhase.NO_TASK_IN_PROGRESS:
            return out
        out["triggeredUserTaskId"] = self.uuid
        out["reason"] = self.reason
        for name, counts in (("interBrokerReplicaMovement", self.inter_broker),
                             ("intraBrokerReplicaMovement", self.intra_broker),
                             ("leadershipMovement", self.leadership)):
            if counts is not None:
                out[name] = {
                    "total": counts.total, "pending": counts.pending,
                    "inProgress": counts.in_progress,
                    "aborting": counts.aborting, "aborted": counts.aborted,
                    "dead": counts.dead, "completed": counts.completed,
                }
        out["finishedDataMovementMB"] = self.data_moved_mb
        out["totalDataToMoveMB"] = self.data_to_move_mb
        return out
