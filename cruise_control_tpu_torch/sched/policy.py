"""Request classes of the solve scheduler (port of `SchedulerClass` of
cruise_control_tpu/sched/policy.py; the scheduler is not ported, so the
port's facade runs every solve inline and reads the class only to decide
whether a request may take the dirty-region path)."""
from __future__ import annotations

import enum


class SchedulerClass(enum.IntEnum):
    """Base dispatch priority (lower value = more urgent)."""

    ANOMALY_HEAL = 0
    USER_INTERACTIVE = 1
    PRECOMPUTE = 2
    SCENARIO_SWEEP = 3
