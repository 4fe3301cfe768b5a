"""Goal registry and default priority order (port of cruise_control_tpu/
analyzer/goals/registry.py).

The default order, the hard-goal list and the kafka-assigner order are
the reference's, and every goal of the reference's GOAL_CLASSES is
ported: the default order's fifteen, preferred leader election (the
demote-broker request), the two kafka-assigner goals and the two
intra-broker (JBOD) goals.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Type

from cruise_control_tpu_torch.analyzer.goals.base import Goal
from cruise_control_tpu_torch.analyzer.goals.capacity import (
    CpuCapacityGoal, DiskCapacityGoal, NetworkInboundCapacityGoal,
    NetworkOutboundCapacityGoal, ReplicaCapacityGoal)
from cruise_control_tpu_torch.analyzer.goals.count_distribution import (
    LeaderReplicaDistributionGoal, ReplicaDistributionGoal,
    TopicReplicaDistributionGoal)
from cruise_control_tpu_torch.analyzer.goals.intra_broker import (
    IntraBrokerDiskCapacityGoal, IntraBrokerDiskUsageDistributionGoal)
from cruise_control_tpu_torch.analyzer.goals.kafkaassigner import (
    KafkaAssignerDiskUsageDistributionGoal, KafkaAssignerEvenRackAwareGoal)
from cruise_control_tpu_torch.analyzer.goals.network import (
    LeaderBytesInDistributionGoal, PotentialNwOutGoal,
    PreferredLeaderElectionGoal)
from cruise_control_tpu_torch.analyzer.goals.rack_aware import RackAwareGoal
from cruise_control_tpu_torch.analyzer.goals.resource_distribution import (
    CpuUsageDistributionGoal, DiskUsageDistributionGoal,
    NetworkInboundUsageDistributionGoal,
    NetworkOutboundUsageDistributionGoal)

GOAL_CLASSES: Dict[str, Type[Goal]] = {
    "RackAwareGoal": RackAwareGoal,
    "ReplicaCapacityGoal": ReplicaCapacityGoal,
    "DiskCapacityGoal": DiskCapacityGoal,
    "NetworkInboundCapacityGoal": NetworkInboundCapacityGoal,
    "NetworkOutboundCapacityGoal": NetworkOutboundCapacityGoal,
    "CpuCapacityGoal": CpuCapacityGoal,
    "ReplicaDistributionGoal": ReplicaDistributionGoal,
    "PotentialNwOutGoal": PotentialNwOutGoal,
    "DiskUsageDistributionGoal": DiskUsageDistributionGoal,
    "NetworkInboundUsageDistributionGoal": NetworkInboundUsageDistributionGoal,
    "NetworkOutboundUsageDistributionGoal":
        NetworkOutboundUsageDistributionGoal,
    "CpuUsageDistributionGoal": CpuUsageDistributionGoal,
    "TopicReplicaDistributionGoal": TopicReplicaDistributionGoal,
    "LeaderReplicaDistributionGoal": LeaderReplicaDistributionGoal,
    "LeaderBytesInDistributionGoal": LeaderBytesInDistributionGoal,
    "PreferredLeaderElectionGoal": PreferredLeaderElectionGoal,
    "KafkaAssignerEvenRackAwareGoal": KafkaAssignerEvenRackAwareGoal,
    "KafkaAssignerDiskUsageDistributionGoal":
        KafkaAssignerDiskUsageDistributionGoal,
    "IntraBrokerDiskCapacityGoal": IntraBrokerDiskCapacityGoal,
    "IntraBrokerDiskUsageDistributionGoal":
        IntraBrokerDiskUsageDistributionGoal,
}

#: the goal list of a request with kafka_assigner=true
KAFKA_ASSIGNER_GOAL_ORDER: List[str] = [
    "KafkaAssignerEvenRackAwareGoal",
    "KafkaAssignerDiskUsageDistributionGoal",
]

#: the intra-broker (JBOD) rebalance's goals
INTRA_BROKER_GOALS: List[str] = [
    "IntraBrokerDiskCapacityGoal",
    "IntraBrokerDiskUsageDistributionGoal",
]

#: priority order of the reference's `default.goals`
DEFAULT_GOAL_ORDER: List[str] = [
    "RackAwareGoal",
    "ReplicaCapacityGoal",
    "DiskCapacityGoal",
    "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal",
    "ReplicaDistributionGoal",
    "PotentialNwOutGoal",
    "DiskUsageDistributionGoal",
    "NetworkInboundUsageDistributionGoal",
    "NetworkOutboundUsageDistributionGoal",
    "CpuUsageDistributionGoal",
    "TopicReplicaDistributionGoal",
    "LeaderReplicaDistributionGoal",
    "LeaderBytesInDistributionGoal",
]

#: the reference's `hard.goals` default
DEFAULT_HARD_GOALS: List[str] = [
    "RackAwareGoal",
    "ReplicaCapacityGoal",
    "DiskCapacityGoal",
    "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal",
]


def make_goal(name: str, **kwargs) -> Goal:
    if name not in GOAL_CLASSES:
        raise KeyError(f"unknown goal {name!r}; known: "
                       f"{sorted(GOAL_CLASSES)}")
    return GOAL_CLASSES[name](**kwargs)


def default_goals(max_rounds: Optional[int] = None,
                  names: Optional[Sequence[str]] = None) -> List[Goal]:
    """The default goal stack (or `names`) in priority order; hard goals
    get at least 1024 rounds: an unconverged hard goal aborts the solve,
    and rounds only run while they make progress."""
    out = []
    for name in (names or DEFAULT_GOAL_ORDER):
        kwargs = {}
        if max_rounds is not None:
            kwargs["max_rounds"] = max_rounds
        if name in GOAL_CLASSES and GOAL_CLASSES[name].is_hard:
            kwargs["max_rounds"] = max(kwargs.get("max_rounds", 0), 1024)
        out.append(make_goal(name, **kwargs))
    return out
