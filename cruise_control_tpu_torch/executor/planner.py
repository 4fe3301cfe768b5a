"""Execution task planner (port of cruise_control_tpu/executor/planner.py):
each ExecutionProposal becomes at most one leadership task, at most one
inter-broker movement task and any number of intra-broker (logdir)
movement tasks, served per broker in strategy order (Cruise Control's
ExecutionTaskPlanner).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.executor.strategy import (
    BaseReplicaMovementStrategy, ReplicaMovementStrategy)
from cruise_control_tpu_torch.executor.task import (ExecutionTask, TaskState,
                                                    TaskType)


class ExecutionTaskPlanner:
    """Stateful planner: load proposals once, pop executable tasks as
    concurrency slots open."""

    def __init__(self,
                 strategy: Optional[ReplicaMovementStrategy] = None) -> None:
        self._strategy = strategy or BaseReplicaMovementStrategy()
        self._leadership_tasks: List[ExecutionTask] = []
        self._inter_broker_tasks: List[ExecutionTask] = []
        self._intra_broker_tasks: List[ExecutionTask] = []

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------
    def add_proposals(self, proposals: Sequence[ExecutionProposal]) -> None:
        """Decompose proposals into typed tasks
        (ExecutionTaskPlanner.addExecutionProposal).  Stable keys are
        assigned here, from proposal content — the decomposition is
        deterministic, so a restarted process replaying the journaled
        proposals derives the SAME keys (executor/journal.py)."""
        for p in proposals:
            tp = f"{p.partition.topic}:{p.partition.partition}"
            if p.has_replica_action:
                self._inter_broker_tasks.append(ExecutionTask(
                    ExecutionTask.next_id(), p,
                    TaskType.INTER_BROKER_REPLICA_ACTION,
                    stable_key=f"INTER:{tp}"))
            if p.has_leader_action:
                # runs in phase 3, after any replica movement has landed the
                # new leader's replica (Executor.java execute() phase order)
                self._leadership_tasks.append(ExecutionTask(
                    ExecutionTask.next_id(), p, TaskType.LEADER_ACTION,
                    stable_key=f"LEADER:{tp}"))
            for intra in self._intra_broker_moves(p):
                self._intra_broker_tasks.append(intra)
        self._inter_broker_tasks = self._strategy.sorted_tasks(
            self._inter_broker_tasks)

    @staticmethod
    def _intra_broker_moves(p: ExecutionProposal) -> List[ExecutionTask]:
        """Same-broker logdir changes (reference planner's
        maybeAddIntraBrokerReplicaMovementTasks)."""
        old_by_broker = {r.broker_id: r.logdir for r in p.old_replicas}
        tasks = []
        for r in p.new_replicas:
            old_dir = old_by_broker.get(r.broker_id)
            if (r.broker_id in old_by_broker and r.logdir is not None
                    and old_dir is not None and r.logdir != old_dir):
                tasks.append(ExecutionTask(
                    ExecutionTask.next_id(), p,
                    TaskType.INTRA_BROKER_REPLICA_ACTION,
                    stable_key=(f"INTRA:{p.partition.topic}:"
                                f"{p.partition.partition}:{len(tasks)}")))
        return tasks

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    @property
    def remaining_leadership_tasks(self) -> List[ExecutionTask]:
        return [t for t in self._leadership_tasks
                if t.state == TaskState.PENDING]

    @property
    def remaining_inter_broker_tasks(self) -> List[ExecutionTask]:
        return [t for t in self._inter_broker_tasks
                if t.state == TaskState.PENDING]

    @property
    def remaining_intra_broker_tasks(self) -> List[ExecutionTask]:
        return [t for t in self._intra_broker_tasks
                if t.state == TaskState.PENDING]

    def pop_inter_broker_tasks(
            self, slots_by_broker: Dict[int, int]) -> List[ExecutionTask]:
        """Next batch of inter-broker moves honoring per-broker concurrency
        slots.  A task consumes a slot on EVERY participating broker (both
        adding and removing sides), matching the reference's per-broker
        in-flight accounting (ExecutionTaskPlanner.getInterBrokerReplica
        MovementTasks)."""
        picked: List[ExecutionTask] = []
        slots = dict(slots_by_broker)
        for task in self.remaining_inter_broker_tasks:
            brokers = task.participants()
            if all(slots.get(b, 0) > 0 for b in brokers):
                for b in brokers:
                    slots[b] = slots.get(b, 0) - 1
                picked.append(task)
        return picked

    def pop_intra_broker_tasks(
            self, slots_by_broker: Dict[int, int]) -> List[ExecutionTask]:
        picked: List[ExecutionTask] = []
        slots = dict(slots_by_broker)
        for task in self.remaining_intra_broker_tasks:
            brokers = task.intra_brokers()
            if all(slots.get(b, 0) > 0 for b in brokers):
                for b in brokers:
                    slots[b] = slots.get(b, 0) - 1
                picked.append(task)
        return picked

    def pop_leadership_tasks(self, max_tasks: int) -> List[ExecutionTask]:
        return self.remaining_leadership_tasks[:max_tasks]

    # ------------------------------------------------------------------
    def all_tasks(self) -> List[ExecutionTask]:
        return (self._inter_broker_tasks + self._intra_broker_tasks
                + self._leadership_tasks)

    def clear(self) -> None:
        self._leadership_tasks.clear()
        self._inter_broker_tasks.clear()
        self._intra_broker_tasks.clear()
