"""Replica-movement ordering strategies (port of
cruise_control_tpu/executor/strategy.py): a strategy yields a sort key
over inter-broker movement tasks and may be chained with a fallback that
breaks ties; the last tie-break is always the task id (proposal order).
"""
from __future__ import annotations

import abc
from typing import Callable, List, Optional, Sequence, Set

from cruise_control_tpu_torch.cluster.types import TopicPartition
from cruise_control_tpu_torch.executor.task import ExecutionTask

#: sort key: smaller sorts first
SortKey = Callable[[ExecutionTask], tuple]


class ReplicaMovementStrategy(abc.ABC):
    """Orders inter-broker replica movement tasks for execution."""

    def __init__(self) -> None:
        self._next: Optional[ReplicaMovementStrategy] = None

    def chain(self, nxt: "ReplicaMovementStrategy") -> "ReplicaMovementStrategy":
        """Append a tie-breaking strategy (reference
        AbstractReplicaMovementStrategy.chain)."""
        tail = self
        while tail._next is not None:
            tail = tail._next
        tail._next = nxt
        return self

    @abc.abstractmethod
    def _key(self, task: ExecutionTask) -> float:
        """Per-task priority scalar; smaller executes earlier."""

    def sort_key(self) -> SortKey:
        chain: List[ReplicaMovementStrategy] = []
        node: Optional[ReplicaMovementStrategy] = self
        while node is not None:
            chain.append(node)
            node = node._next

        def key(task: ExecutionTask) -> tuple:
            return tuple(s._key(task) for s in chain) + (task.task_id,)
        return key

    def sorted_tasks(self, tasks: Sequence[ExecutionTask]
                     ) -> List[ExecutionTask]:
        return sorted(tasks, key=self.sort_key())

    def name(self) -> str:
        return type(self).__name__

    def chain_names(self) -> List[str]:
        """Every strategy name in chain order — the round-trippable
        form the executor journal records so a resumed execution
        rebuilds the SAME ordering via `strategy_from_names`."""
        out: List[str] = []
        node: Optional[ReplicaMovementStrategy] = self
        while node is not None:
            out.append(node.name())
            node = node._next
        return out


class BaseReplicaMovementStrategy(ReplicaMovementStrategy):
    """Proposal order (task-id ascending) — the default."""

    def _key(self, task: ExecutionTask) -> float:
        return task.task_id


class PrioritizeSmallReplicaMovementStrategy(ReplicaMovementStrategy):
    """Smallest partitions first — drains many cheap moves early."""

    def _key(self, task: ExecutionTask) -> float:
        return task.proposal.partition_size


class PrioritizeLargeReplicaMovementStrategy(ReplicaMovementStrategy):
    """Largest partitions first — starts long transfers immediately."""

    def _key(self, task: ExecutionTask) -> float:
        return -task.proposal.partition_size


class PostponeUrpReplicaMovementStrategy(ReplicaMovementStrategy):
    """Partitions with no under-replicated/offline replicas move first
    (reference PostponeUrpReplicaMovementStrategy)."""

    def __init__(self, urp_partitions: Optional[Set[TopicPartition]] = None):
        super().__init__()
        self._urp = urp_partitions or set()

    def set_urp(self, urp_partitions: Set[TopicPartition]) -> None:
        self._urp = set(urp_partitions)

    def _key(self, task: ExecutionTask) -> float:
        p = task.proposal.partition
        tp = TopicPartition(p.topic, p.partition)
        return 1.0 if tp in self._urp else 0.0


STRATEGIES = {
    "BaseReplicaMovementStrategy": BaseReplicaMovementStrategy,
    "PrioritizeSmallReplicaMovementStrategy":
        PrioritizeSmallReplicaMovementStrategy,
    "PrioritizeLargeReplicaMovementStrategy":
        PrioritizeLargeReplicaMovementStrategy,
    "PostponeUrpReplicaMovementStrategy": PostponeUrpReplicaMovementStrategy,
}


def strategy_from_names(names: Sequence[str]) -> ReplicaMovementStrategy:
    """Build a chained strategy from config names; always terminates with
    the base strategy so ordering is total."""
    root: Optional[ReplicaMovementStrategy] = None
    for n in names:
        cls = STRATEGIES.get(n)
        if cls is None:
            raise ValueError(f"unknown replica movement strategy {n!r}")
        s = cls()
        root = s if root is None else root.chain(s)
    base = BaseReplicaMovementStrategy()
    return base if root is None else root.chain(base)
