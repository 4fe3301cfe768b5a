"""Execution task manager (port of
cruise_control_tpu/executor/task_manager.py): in-flight tasks against
per-broker concurrency caps, and progress counters.  Single writer: only
the executor's runnable mutates it; state reads take the lock.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.executor.planner import ExecutionTaskPlanner
from cruise_control_tpu_torch.executor.strategy import ReplicaMovementStrategy
from cruise_control_tpu_torch.executor.task import (ExecutionTask, TaskState,
                                                    TaskType)


@dataclasses.dataclass
class ExecutionCounts:
    """Progress snapshot used by ExecutorState responses."""

    total: int = 0
    pending: int = 0
    in_progress: int = 0
    aborting: int = 0
    aborted: int = 0
    dead: int = 0
    completed: int = 0

    @property
    def finished(self) -> int:
        return self.aborted + self.dead + self.completed


class ExecutionTaskManager:
    """Owns the planner plus per-broker in-flight accounting."""

    def __init__(self,
                 concurrent_inter_broker_moves_per_broker: int = 5,
                 concurrent_intra_broker_moves_per_broker: int = 2,
                 concurrent_leader_movements: int = 1000,
                 strategy: Optional[ReplicaMovementStrategy] = None) -> None:
        self._lock = threading.RLock()
        self._planner = ExecutionTaskPlanner(strategy)
        self._inter_cap = concurrent_inter_broker_moves_per_broker
        self._intra_cap = concurrent_intra_broker_moves_per_broker
        self._leader_cap = concurrent_leader_movements
        self._in_flight_inter: Dict[int, int] = {}   # broker -> count
        self._in_flight_intra: Dict[int, int] = {}
        self._in_flight_leaders = 0
        self._inter_data_to_move = 0.0
        self._inter_data_moved = 0.0

    # ------------------------------------------------------------------
    def load_proposals(self, proposals: Sequence[ExecutionProposal],
                       brokers: Sequence[int]) -> None:
        with self._lock:
            self._planner.add_proposals(proposals)
            for b in brokers:
                self._in_flight_inter.setdefault(b, 0)
                self._in_flight_intra.setdefault(b, 0)
            self._inter_data_to_move = sum(
                t.proposal.inter_broker_data_to_move
                for t in self._planner.all_tasks()
                if t.task_type == TaskType.INTER_BROKER_REPLICA_ACTION)

    # ------------------------------------------------------------------
    # popping work (marks tasks IN_PROGRESS and reserves slots)
    # ------------------------------------------------------------------
    def next_inter_broker_tasks(self, now_ms: float) -> List[ExecutionTask]:
        with self._lock:
            slots = {b: self._inter_cap - used
                     for b, used in self._in_flight_inter.items()}
            tasks = self._planner.pop_inter_broker_tasks(slots)
            for t in tasks:
                t.in_progress(now_ms)
                for b in t.participants():
                    self._in_flight_inter[b] = (
                        self._in_flight_inter.get(b, 0) + 1)
            return tasks

    def next_intra_broker_tasks(self, now_ms: float) -> List[ExecutionTask]:
        with self._lock:
            slots = {b: self._intra_cap - used
                     for b, used in self._in_flight_intra.items()}
            tasks = self._planner.pop_intra_broker_tasks(slots)
            for t in tasks:
                t.in_progress(now_ms)
                for b in t.intra_brokers():
                    self._in_flight_intra[b] = (
                        self._in_flight_intra.get(b, 0) + 1)
            return tasks

    def next_leadership_tasks(self, now_ms: float) -> List[ExecutionTask]:
        with self._lock:
            free = self._leader_cap - self._in_flight_leaders
            tasks = self._planner.pop_leadership_tasks(max(0, free))
            for t in tasks:
                t.in_progress(now_ms)
            self._in_flight_leaders += len(tasks)
            return tasks

    # ------------------------------------------------------------------
    # finishing work (releases slots)
    # ------------------------------------------------------------------
    def finish_task(self, task: ExecutionTask, state: TaskState,
                    now_ms: float) -> None:
        with self._lock:
            if state == TaskState.COMPLETED:
                task.completed(now_ms)
            elif state == TaskState.ABORTED:
                task.aborted(now_ms)
            elif state == TaskState.DEAD:
                task.kill(now_ms)
            else:
                raise ValueError(f"not a terminal state: {state}")
            if task.task_type == TaskType.INTER_BROKER_REPLICA_ACTION:
                for b in task.participants():
                    self._in_flight_inter[b] = max(
                        0, self._in_flight_inter.get(b, 0) - 1)
                if state == TaskState.COMPLETED:
                    self._inter_data_moved += (
                        task.proposal.inter_broker_data_to_move)
            elif task.task_type == TaskType.INTRA_BROKER_REPLICA_ACTION:
                for b in task.intra_brokers():
                    self._in_flight_intra[b] = max(
                        0, self._in_flight_intra.get(b, 0) - 1)
            else:
                self._in_flight_leaders = max(0, self._in_flight_leaders - 1)

    def mark_aborting(self, task: ExecutionTask, now_ms: float) -> None:
        with self._lock:
            if task.state == TaskState.IN_PROGRESS:
                task.aborting(now_ms)

    # ------------------------------------------------------------------
    # crash recovery (executor/recovery.py reconcile plans)
    # ------------------------------------------------------------------
    def apply_recovery(self, resolutions, now_ms: float):
        """Seal reconciled task states into a freshly-loaded manager.

        Terminal resolutions walk the legal state machine (PENDING →
        IN_PROGRESS → terminal) WITHOUT touching in-flight slot
        accounting — those slots were never reserved in this process.
        Adopted resolutions mark the task IN_PROGRESS (original start
        time when the journal recorded one) AND reserve its slots, so
        the resumed phase loops respect the concurrency caps and the
        eventual `finish_task` decrement balances.  Returns the adopted
        tasks by type for the phase loops to poll."""
        # imported here, not at module top: recovery.py sits above this
        # module in the executor package's layering (it imports the
        # planner), and only this method needs its verdict constants
        from cruise_control_tpu_torch.executor.recovery import ADOPT, TERMINAL
        adopted = {t: [] for t in TaskType}
        with self._lock:
            for task in self._planner.all_tasks():
                res = resolutions.get(task.stable_key)
                if res is None:
                    continue
                task.reexecution_count = res.reexecution_count
                if res.action == TERMINAL:
                    task.in_progress(now_ms)
                    state = TaskState(res.state)
                    if state is TaskState.COMPLETED:
                        task.completed(now_ms)
                        if task.task_type \
                                is TaskType.INTER_BROKER_REPLICA_ACTION:
                            self._inter_data_moved += (
                                task.proposal.inter_broker_data_to_move)
                    elif state is TaskState.ABORTED:
                        task.aborting(now_ms)
                        task.aborted(now_ms)
                    else:
                        task.kill(now_ms)
                elif res.action == ADOPT:
                    start = res.start_ms if res.start_ms > 0 else now_ms
                    task.in_progress(start)
                    if task.task_type \
                            is TaskType.INTER_BROKER_REPLICA_ACTION:
                        for b in task.participants():
                            self._in_flight_inter[b] = (
                                self._in_flight_inter.get(b, 0) + 1)
                    elif task.task_type \
                            is TaskType.INTRA_BROKER_REPLICA_ACTION:
                        for b in task.intra_brokers():
                            self._in_flight_intra[b] = (
                                self._in_flight_intra.get(b, 0) + 1)
                    else:
                        self._in_flight_leaders += 1
                    adopted[task.task_type].append(task)
                # "pending": leave the task PENDING for normal serving
        return adopted

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def counts(self, task_type: Optional[TaskType] = None) -> ExecutionCounts:
        with self._lock:
            c = ExecutionCounts()
            for t in self._planner.all_tasks():
                if task_type is not None and t.task_type != task_type:
                    continue
                c.total += 1
                attr = t.state.value.lower()
                setattr(c, attr, getattr(c, attr) + 1)
            return c

    def tasks_in_state(self, state: TaskState,
                       task_type: Optional[TaskType] = None
                       ) -> List[ExecutionTask]:
        with self._lock:
            return [t for t in self._planner.all_tasks()
                    if t.state == state
                    and (task_type is None or t.task_type == task_type)]

    @property
    def inter_broker_data_to_move(self) -> float:
        with self._lock:
            return self._inter_data_to_move

    @property
    def inter_broker_data_moved(self) -> float:
        with self._lock:
            return self._inter_data_moved

    def clear(self) -> None:
        with self._lock:
            self._planner.clear()
            self._in_flight_inter.clear()
            self._in_flight_intra.clear()
            self._in_flight_leaders = 0
            self._inter_data_to_move = self._inter_data_moved = 0.0
