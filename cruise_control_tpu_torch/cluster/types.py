"""Value types describing the managed cluster (port of
cruise_control_tpu/cluster/types.py).

The metadata a model build and the executor read: brokers with their
racks, hosts and logdirs, partitions with their replica lists, leaders,
offline replicas and per-replica logdirs, and in-flight reassignments.
A snapshot answers `broker(id)` and `partition(tp)` from an index built
once per snapshot, with the JAX package's answers (the first match,
None for an unknown id).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True, order=True)
class TopicPartition:
    """(topic, partition) id, Kafka's TopicPartition."""

    topic: str
    partition: int

    def __str__(self) -> str:
        return f"{self.topic}-{self.partition}"


@dataclasses.dataclass(frozen=True)
class LogDirInfo:
    """One logdir on a broker (a JBOD disk)."""

    path: str
    capacity_bytes: float = 0.0
    used_bytes: float = 0.0
    offline: bool = False


@dataclasses.dataclass(frozen=True)
class BrokerInfo:
    """Broker endpoint and placement."""

    broker_id: int
    host: str = "localhost"
    rack: Optional[str] = None
    alive: bool = True
    logdirs: Tuple[LogDirInfo, ...] = ()


@dataclasses.dataclass(frozen=True)
class PartitionInfo:
    """Replica list (the leader is explicit, not the first position),
    in-sync set and per-replica logdir placement."""

    tp: TopicPartition
    leader: Optional[int]
    replicas: Tuple[int, ...]
    in_sync: Tuple[int, ...] = ()
    offline_replicas: Tuple[int, ...] = ()
    #: broker id -> logdir path of that broker's replica
    logdir_by_broker: Mapping[int, str] = dataclasses.field(
        default_factory=dict)

    @property
    def size_bytes(self) -> float:
        return 0.0


@dataclasses.dataclass(frozen=True)
class ReassignmentState:
    """An in-flight partition reassignment."""

    tp: TopicPartition
    adding_replicas: Tuple[int, ...]
    removing_replicas: Tuple[int, ...]
    target_replicas: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class ClusterSnapshot:
    """Point-in-time cluster metadata with a monotonically increasing
    generation."""

    generation: int
    brokers: Tuple[BrokerInfo, ...]
    partitions: Tuple[PartitionInfo, ...]
    controller_id: Optional[int] = None

    @functools.cached_property
    def _broker_index(self) -> Dict[int, BrokerInfo]:
        index: Dict[int, BrokerInfo] = {}
        for b in self.brokers:
            index.setdefault(b.broker_id, b)
        return index

    @functools.cached_property
    def _partition_index(self) -> Dict[TopicPartition, PartitionInfo]:
        index: Dict[TopicPartition, PartitionInfo] = {}
        for p in self.partitions:
            index.setdefault(p.tp, p)
        return index

    def broker(self, broker_id: int) -> Optional[BrokerInfo]:
        return self._broker_index.get(broker_id)

    def partition(self, tp: TopicPartition) -> Optional[PartitionInfo]:
        return self._partition_index.get(tp)

    @property
    def alive_broker_ids(self) -> FrozenSet[int]:
        return frozenset(b.broker_id for b in self.brokers if b.alive)

    @property
    def all_broker_ids(self) -> FrozenSet[int]:
        return frozenset(b.broker_id for b in self.brokers)

    def partitions_of(self, topic: str) -> List[PartitionInfo]:
        return [p for p in self.partitions if p.tp.topic == topic]

    @property
    def topics(self) -> FrozenSet[str]:
        return frozenset(p.tp.topic for p in self.partitions)

    def partitions_with_offline_replicas(self) -> List[PartitionInfo]:
        return [p for p in self.partitions if p.offline_replicas]

    def replica_count(self) -> int:
        return sum(len(p.replicas) for p in self.partitions)


def partitions_by_index(partitions: Sequence[PartitionInfo]
                        ) -> Dict[TopicPartition, PartitionInfo]:
    return {p.tp: p for p in partitions}


def indexed_snapshot(generation: int, brokers: Tuple[BrokerInfo, ...],
                     partitions: Tuple[PartitionInfo, ...],
                     controller_id: Optional[int],
                     partition_index: Dict[TopicPartition, PartitionInfo]
                     ) -> ClusterSnapshot:
    """A snapshot given its partition index (each partition by its
    `tp`, which must be unique) instead of building it on first use: a
    source that keeps the index across snapshots pays a dict copy, not a
    pass over every partition."""
    snap = ClusterSnapshot(generation, brokers, partitions, controller_id)
    snap.__dict__["_partition_index"] = partition_index
    return snap
