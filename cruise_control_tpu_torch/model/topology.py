"""Host-side name <-> index mappings (port of the PartitionId and
ClusterTopology records of cruise_control_tpu/model/builder.py)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class PartitionId:
    """(topic, partition) — Kafka's TopicPartition key."""
    topic: str
    partition: int

    def __str__(self) -> str:  # pragma: no cover - trivial
        return f"{self.topic}-{self.partition}"


@dataclasses.dataclass
class ClusterTopology:
    """Host-side name <-> index mappings accompanying a ClusterState."""
    broker_ids: List[int]
    rack_ids: List[str]
    host_names: List[str]
    topics: List[str]
    partitions: List[PartitionId]
    disk_names: List[Tuple[int, str]]   # (broker index, logdir)

    @property
    def broker_index(self) -> Dict[int, int]:
        return {b: i for i, b in enumerate(self.broker_ids)}

    @property
    def partition_index(self) -> Dict[PartitionId, int]:
        return {p: i for i, p in enumerate(self.partitions)}
