"""OptimizationOptions generators (port of cruise_control_tpu/analyzer/
options_generator.py).

Every request's options pass through the configured generator before
they reach the optimizer; that is where deployment-wide policies, such as
the `topics.excluded.from.partition.movement` pattern, are applied.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

from cruise_control_tpu_torch.analyzer.context import OptimizationOptions


class OptimizationOptionsGenerator:
    """Transforms per-request options before optimization (identity)."""

    def generate(self, options: OptimizationOptions,
                 topology=None) -> OptimizationOptions:
        return options


class DefaultOptimizationOptionsGenerator(OptimizationOptionsGenerator):
    """Merges the deployment-wide excluded-topics pattern
    (`topics.excluded.from.partition.movement`) into every request: each
    topic of the topology that the pattern matches whole (`fullmatch`)."""

    def __init__(self, excluded_topics_pattern: str = "") -> None:
        self._pattern: Optional[re.Pattern] = (
            re.compile(excluded_topics_pattern)
            if excluded_topics_pattern else None)

    def generate(self, options: OptimizationOptions,
                 topology=None) -> OptimizationOptions:
        if self._pattern is None or topology is None:
            return options
        matched = {t for t in topology.topics
                   if self._pattern.fullmatch(t)}
        if not matched:
            return options
        return dataclasses.replace(
            options,
            excluded_topics=frozenset(options.excluded_topics) | matched)
