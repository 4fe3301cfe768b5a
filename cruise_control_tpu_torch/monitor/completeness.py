"""Model completeness requirements (port of
cruise_control_tpu/monitor/completeness.py).

Every operation declares how much metric history it needs before a
cluster model may be built from the aggregated samples (Cruise Control's
ModelCompletenessRequirements.java); requirements combine by taking the
strictest value per field (`combine`) or the loosest (`weaker`).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional


@dataclasses.dataclass(frozen=True)
class ModelCompletenessRequirements:
    min_required_num_windows: int = 1
    min_monitored_partitions_percentage: float = 0.0
    include_all_topics: bool = False

    def __post_init__(self):
        if self.min_required_num_windows < 1:
            raise ValueError("need at least one required window")
        if not 0.0 <= self.min_monitored_partitions_percentage <= 1.0:
            raise ValueError("partition percentage must be in [0, 1]")

    def combine(self, other: Optional["ModelCompletenessRequirements"]
                ) -> "ModelCompletenessRequirements":
        """Strictest-of-both (reference
        ModelCompletenessRequirements.stronger)."""
        if other is None:
            return self
        return ModelCompletenessRequirements(
            max(self.min_required_num_windows,
                other.min_required_num_windows),
            max(self.min_monitored_partitions_percentage,
                other.min_monitored_partitions_percentage),
            self.include_all_topics or other.include_all_topics)

    def weaker(self, other: Optional["ModelCompletenessRequirements"]
               ) -> "ModelCompletenessRequirements":
        """Loosest-of-both (reference weaker), used when any one of several
        goals being optimized would suffice."""
        if other is None:
            return self
        return ModelCompletenessRequirements(
            min(self.min_required_num_windows,
                other.min_required_num_windows),
            min(self.min_monitored_partitions_percentage,
                other.min_monitored_partitions_percentage),
            self.include_all_topics and other.include_all_topics)


def combined(requirements: Iterable[Optional[ModelCompletenessRequirements]]
             ) -> ModelCompletenessRequirements:
    out = ModelCompletenessRequirements()
    for r in requirements:
        if r is not None:
            out = out.combine(r)
    return out
