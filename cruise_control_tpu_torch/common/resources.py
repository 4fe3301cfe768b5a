"""Resource definitions (port of cruise_control_tpu/common/resources.py).

Four balanced resources with per-resource comparison epsilons; the
integer value is the tensor-axis index (broker_load[B, NUM_RESOURCES]).
"""
from __future__ import annotations

import enum
from typing import List


class Resource(enum.IntEnum):
    """A balanced resource; the value is the tensor-axis index."""

    CPU = 0
    NW_IN = 1
    NW_OUT = 2
    DISK = 3

    @property
    def base_epsilon(self) -> float:
        return _BASE_EPSILON[int(self)]

    def epsilon(self, value1: float, value2: float) -> float:
        """Comparison epsilon for two utilization values:
        max(base, EPSILON_PERCENT * (v1 + v2))."""
        return max(self.base_epsilon, EPSILON_PERCENT * (value1 + value2))

    @classmethod
    def cached_values(cls) -> List["Resource"]:
        return _CACHED_VALUES


#: acceptable relative nuance from float summation over large replica counts
EPSILON_PERCENT = 0.0008

_BASE_EPSILON = (0.001, 10.0, 10.0, 100.0)

_CACHED_VALUES = [Resource.CPU, Resource.NW_IN, Resource.NW_OUT, Resource.DISK]

NUM_RESOURCES = 4

#: goal-name prefixes per resource id (CpuUsageDistributionGoal, ...)
RESOURCE_GOAL_NAMES = {
    0: "Cpu", 1: "NetworkInbound", 2: "NetworkOutbound", 3: "Disk",
}
