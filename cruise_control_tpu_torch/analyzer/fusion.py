"""Goal segment plans (port of cruise_control_tpu/analyzer/fusion.py).

The optimizer refreshes the round cache's float aggregates at the entry
of each goal segment, so the segment plan decides where those refreshes
fall and can change the last bits of a solve's float aggregates.  The
default plan is fixed-width chunking (`pipeline_segment_size` goals a
segment); the fused plan puts each maximal run of adjacent goals of one
fusion group in one segment.

Groups are defined over registered goal class names
(goals/registry.py `GOAL_CLASSES`).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

#: fusion groups over registry class names.  Adjacent goals (in the
#: configured priority order) sharing a group form one segment.  The
#: default order yields three segments: capacity sextet, distribution
#: sextet, leader trio.
GOAL_FUSION_GROUPS: Dict[str, List[str]] = {
    # hard capacity ladder: rack placement + the five capacity caps
    "capacity": [
        "RackAwareGoal",
        "ReplicaCapacityGoal",
        "DiskCapacityGoal",
        "NetworkInboundCapacityGoal",
        "NetworkOutboundCapacityGoal",
        "CpuCapacityGoal",
    ],
    # soft distribution band goals: count band, potential-nw-out cap and
    # the four resource usage bands
    "distribution": [
        "ReplicaDistributionGoal",
        "PotentialNwOutGoal",
        "DiskUsageDistributionGoal",
        "NetworkInboundUsageDistributionGoal",
        "NetworkOutboundUsageDistributionGoal",
        "CpuUsageDistributionGoal",
    ],
    # leadership-dominated tail: topic / leader count distribution and the
    # leader-bytes-in goal
    "leader": [
        "TopicReplicaDistributionGoal",
        "LeaderReplicaDistributionGoal",
        "LeaderBytesInDistributionGoal",
    ],
    # the request modes outside the default order (kafka-assigner,
    # intra-broker, preferred-leader election)
    "auxiliary": [
        "PreferredLeaderElectionGoal",
        "KafkaAssignerEvenRackAwareGoal",
        "KafkaAssignerDiskUsageDistributionGoal",
        "IntraBrokerDiskCapacityGoal",
        "IntraBrokerDiskUsageDistributionGoal",
    ],
}

#: name -> group key, derived
GROUP_OF: Dict[str, str] = {
    name: group
    for group, names in GOAL_FUSION_GROUPS.items()
    for name in names
}


def plan_segments(goal_names: Sequence[str], segment_size: int,
                  fused: bool) -> List[Tuple[int, int]]:
    """[(start, stop), ...] covering `goal_names` in order.

    `fused=False` is fixed-width chunking (`range(0, G, segment_size)`).
    `fused=True` puts each maximal run of adjacent same-group goals in one
    segment; goals without a group are chunked by width within their run.
    Goals are never reordered: acceptance stacking is order-sensitive."""
    names = list(goal_names)
    seg = max(1, int(segment_size))
    if not names:
        return []
    if not fused:
        return [(start, min(start + seg, len(names)))
                for start in range(0, len(names), seg)]
    plan: List[Tuple[int, int]] = []
    start = 0
    while start < len(names):
        group = GROUP_OF.get(names[start])
        stop = start + 1
        if group is None:
            while (stop < len(names) and stop - start < seg
                   and GROUP_OF.get(names[stop]) is None):
                stop += 1
        else:
            while (stop < len(names)
                   and GROUP_OF.get(names[stop]) == group):
                stop += 1
        plan.append((start, stop))
        start = stop
    return plan
