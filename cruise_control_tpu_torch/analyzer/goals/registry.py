"""Goal registry and default priority order (port of cruise_control_tpu/
analyzer/goals/registry.py).

The default order and the hard-goal list are the reference's; every goal
of the default order is ported.  The reference's other goals (preferred
leader election, the intra-broker and kafka-assigner goals) raise a
KeyError that says they are not ported yet.
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
from cruise_control_tpu_torch.analyzer.goals.network import (
    LeaderBytesInDistributionGoal, PotentialNwOutGoal)
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
}

#: the reference's goals outside the default order that the port does not
#: have yet
NOT_PORTED = ("PreferredLeaderElectionGoal", "KafkaAssignerEvenRackAwareGoal",
              "KafkaAssignerDiskUsageDistributionGoal",
              "IntraBrokerDiskCapacityGoal",
              "IntraBrokerDiskUsageDistributionGoal")

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
        if name in NOT_PORTED:
            raise KeyError(f"goal {name!r} is not ported to "
                           f"cruise_control_tpu_torch yet; ported: "
                           f"{sorted(GOAL_CLASSES)}")
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
