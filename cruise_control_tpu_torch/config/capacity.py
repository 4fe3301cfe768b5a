"""Broker capacity record (port of `BrokerCapacity` of
cruise_control_tpu/config/capacity.py; the resolvers that read a
capacity file are not ported).

Units follow Cruise Control: DISK in MiB, NW_IN / NW_OUT in KiB/s, CPU in
percent (cores x 100).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BrokerCapacity:
    """Per-broker capacity: the four resources in `Resource` order, and
    for a JBOD broker the DISK capacity of each logdir."""

    capacity: Tuple[float, float, float, float]
    disk_capacity_by_logdir: Optional[Mapping[str, float]] = None
    num_cpu_cores: float = 1.0
    is_estimated: bool = False
    estimation_info: str = ""
