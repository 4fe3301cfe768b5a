"""The executor plane (port of cruise_control_tpu/executor/): drives
proposals against the cluster through the `ClusterAdminClient` SPI, with
a durable journal and crash recovery.  Host code only.
"""
from cruise_control_tpu_torch.executor.executor import (Executor,
                                                        ExecutorNotifier)
from cruise_control_tpu_torch.executor.journal import (ExecutionJournal,
                                                       JournalReplay)
from cruise_control_tpu_torch.executor.planner import ExecutionTaskPlanner
from cruise_control_tpu_torch.executor.recovery import (ReconcilePlan,
                                                        RecoveryReport,
                                                        reconcile)
from cruise_control_tpu_torch.executor.state import (ExecutorPhase,
                                                     ExecutorState)
from cruise_control_tpu_torch.executor.strategy import (
    BaseReplicaMovementStrategy, PostponeUrpReplicaMovementStrategy,
    PrioritizeLargeReplicaMovementStrategy,
    PrioritizeSmallReplicaMovementStrategy, ReplicaMovementStrategy,
    strategy_from_names)
from cruise_control_tpu_torch.executor.task import (ExecutionTask, TaskState,
                                                    TaskType)
from cruise_control_tpu_torch.executor.task_manager import (
    ExecutionCounts, ExecutionTaskManager)

__all__ = [
    "Executor", "ExecutorNotifier", "ExecutorPhase", "ExecutorState",
    "ExecutionJournal", "JournalReplay", "ReconcilePlan",
    "RecoveryReport", "reconcile",
    "ExecutionTask", "ExecutionTaskManager", "ExecutionTaskPlanner",
    "ExecutionCounts", "TaskState", "TaskType",
    "ReplicaMovementStrategy", "BaseReplicaMovementStrategy",
    "PrioritizeSmallReplicaMovementStrategy",
    "PrioritizeLargeReplicaMovementStrategy",
    "PostponeUrpReplicaMovementStrategy", "strategy_from_names",
]
