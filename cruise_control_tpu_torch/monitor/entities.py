"""Aggregation entities: partition (grouped by topic) and broker (port of
cruise_control_tpu/monitor/entities.py).

The keys the two metric-sample aggregators aggregate by (Cruise Control's
PartitionEntity.java and BrokerEntity.java); the partition entity's group
is its topic, which powers ENTITY_GROUP completeness (a topic is valid
only if all its partitions are).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PartitionEntity:
    topic: str
    partition: int

    @property
    def group(self) -> str:
        return self.topic

    def __str__(self) -> str:
        return f"{self.topic}-{self.partition}"


@dataclasses.dataclass(frozen=True)
class BrokerEntity:
    broker_id: int

    @property
    def group(self) -> None:
        return None

    def __str__(self) -> str:
        return f"broker-{self.broker_id}"
