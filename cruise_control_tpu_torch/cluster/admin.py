"""Cluster admin SPI (port of cruise_control_tpu/cluster/admin.py).

One abstract surface over the act plane of a Kafka cluster: partition
reassignment (AdminClient alterPartitionReassignments), preferred-leader
election, intra-broker logdir moves, replication throttles, logdir
description, topic configs and liveness watching.
"""
from __future__ import annotations

import abc
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Set

from cruise_control_tpu_torch.cluster.types import (ClusterSnapshot,
                                                    LogDirInfo,
                                                    ReassignmentState,
                                                    TopicPartition)

#: liveness-watch callback: called with the new set of alive broker ids
LivenessListener = Callable[[Set[int]], None]


class ClusterAdminClient(abc.ABC):
    """Asynchronous-cluster admin operations.

    All mutating calls are *requests*: the cluster (simulated or real) acts
    on them over time; callers observe progress through `describe_cluster`
    and `list_partition_reassignments` polling, exactly as the reference's
    executor polls metadata (CC/executor/Executor.java:1169-1334).
    """

    # ---- observe ----
    @abc.abstractmethod
    def describe_cluster(self) -> ClusterSnapshot:
        """Current metadata snapshot."""

    @abc.abstractmethod
    def describe_log_dirs(self, broker_ids: Sequence[int]
                          ) -> Dict[int, List[LogDirInfo]]:
        """Per-broker logdir states (offline detection + JBOD capacity)."""

    @abc.abstractmethod
    def list_partition_reassignments(self) -> List[ReassignmentState]:
        """In-flight reassignments."""

    @abc.abstractmethod
    def topic_configs(self, topic: str) -> Mapping[str, str]:
        """Per-topic config map (e.g. min.insync.replicas)."""

    # ---- act ----
    @abc.abstractmethod
    def alter_partition_reassignments(
            self, targets: Mapping[TopicPartition,
                                   Optional[Sequence[int]]]) -> None:
        """Start (or, with value None, cancel) reassignments. Target lists
        are full desired replica orderings (leader candidate first)."""

    @abc.abstractmethod
    def elect_preferred_leaders(self, tps: Sequence[TopicPartition]) -> None:
        """Trigger preferred-leader election for the given partitions."""

    @abc.abstractmethod
    def alter_replica_log_dirs(
            self, moves: Mapping[TopicPartition, Mapping[int, str]]) -> None:
        """Move replicas between logdirs on the same broker (JBOD)."""

    @abc.abstractmethod
    def set_replication_throttle(self, broker_ids: Sequence[int],
                                 rate_bytes_per_s: float) -> None:
        """Apply leader+follower replication throttle to brokers."""

    @abc.abstractmethod
    def clear_replication_throttle(self, broker_ids: Sequence[int]) -> None:
        """Remove replication throttles set by this client."""

    # ---- watch ----
    @abc.abstractmethod
    def add_liveness_listener(self, listener: LivenessListener) -> None:
        """Subscribe to broker up/down transitions (reference ZK child watch
        on /brokers/ids)."""

    @abc.abstractmethod
    def remove_liveness_listener(self, listener: LivenessListener) -> None:
        """Unsubscribe."""

    def close(self) -> None:  # pragma: no cover - default no-op
        """Release resources."""


class TopicConfigProvider(abc.ABC):
    """SPI over per-topic config lookup (reference
    config/TopicConfigProvider.java, wired by
    `topic.config.provider.class`; the reference default reads configs
    from ZooKeeper — modernized here to the admin client)."""

    def configure(self, props) -> None:  # pragma: no cover - plugin hook
        """Config hook for get_configured_instance."""

    @abc.abstractmethod
    def topic_configs(self, topic: str) -> Mapping[str, str]:
        """Per-topic config map (e.g. min.insync.replicas)."""


class AdminTopicConfigProvider(TopicConfigProvider):
    """Default provider: delegates to the cluster admin client
    (reference KafkaTopicConfigProvider.java:1-105 behavioral
    equivalent)."""

    def __init__(self, admin: Optional[ClusterAdminClient] = None) -> None:
        self._admin = admin

    def bind(self, admin: ClusterAdminClient) -> None:
        """Late-bind the admin client (config-instantiated providers are
        constructed before the cluster connection exists)."""
        self._admin = admin

    def topic_configs(self, topic: str) -> Mapping[str, str]:
        if self._admin is None:
            raise RuntimeError("AdminTopicConfigProvider not bound to a "
                               "cluster admin client")
        return self._admin.topic_configs(topic)
