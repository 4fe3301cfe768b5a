"""Value types describing the managed cluster (port of the records of
cruise_control_tpu/cluster/types.py).

The metadata a model build reads: brokers with their racks, hosts and
logdirs, and partitions with their replica lists, leaders, offline
replicas and per-replica logdirs.
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, List, Mapping, Optional, Tuple


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


@dataclasses.dataclass(frozen=True)
class ClusterSnapshot:
    """Point-in-time cluster metadata with a monotonically increasing
    generation."""

    generation: int
    brokers: Tuple[BrokerInfo, ...]
    partitions: Tuple[PartitionInfo, ...]
    controller_id: Optional[int] = None

    @property
    def alive_broker_ids(self) -> FrozenSet[int]:
        return frozenset(b.broker_id for b in self.brokers if b.alive)

    @property
    def all_broker_ids(self) -> FrozenSet[int]:
        return frozenset(b.broker_id for b in self.brokers)

    def partitions_of(self, topic: str) -> List[PartitionInfo]:
        return [p for p in self.partitions if p.tp.topic == topic]
