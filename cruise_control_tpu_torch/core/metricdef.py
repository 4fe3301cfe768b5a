"""Metric definition registry (port of cruise_control_tpu/core/metricdef.py).

A registry assigning dense integer ids to named metrics, each with a
window-aggregation function (AVG / MAX / LATEST) and an optional group
used for "in-all-groups" semantics (Cruise Control's MetricDef.java and
MetricInfo.java).  The dense ids are the metric axis of the aggregator's
value arrays, so the registry freezes before arrays are allocated; the
ids equal the JAX package's, since samples and stored bytes carry them.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence


class AggregationFunction(enum.Enum):
    """How samples within one time window collapse to one value
    (reference metricdef/AggregationFunction.java)."""

    AVG = "avg"
    MAX = "max"
    LATEST = "latest"


@dataclasses.dataclass(frozen=True)
class MetricInfo:
    """A single defined metric (reference metricdef/MetricInfo.java)."""

    name: str
    metric_id: int
    aggregation_function: AggregationFunction
    group: Optional[str] = None


class MetricDef:
    """Dense-id metric registry (reference metricdef/MetricDef.java:1-160).

    ``define`` may only be called before the first lookup by id — mirroring
    the reference's doneDefinition latch — so array layouts derived from
    ``size()`` can never go stale.
    """

    def __init__(self) -> None:
        self._by_name: Dict[str, MetricInfo] = {}
        self._by_id: List[MetricInfo] = []
        self._metrics_to_predict: List[MetricInfo] = []
        self._frozen = False

    def define(self, name: str,
               function: AggregationFunction = AggregationFunction.AVG,
               group: Optional[str] = None,
               to_predict: bool = False) -> MetricInfo:
        if self._frozen:
            raise RuntimeError(
                f"MetricDef is frozen; cannot define metric {name!r}")
        if name in self._by_name:
            raise ValueError(f"metric {name!r} already defined")
        info = MetricInfo(name=name, metric_id=len(self._by_id),
                          aggregation_function=function, group=group)
        self._by_name[name] = info
        self._by_id.append(info)
        if to_predict:
            self._metrics_to_predict.append(info)
        return info

    def freeze(self) -> "MetricDef":
        self._frozen = True
        return self

    def metric_info(self, name_or_id) -> MetricInfo:
        if isinstance(name_or_id, str):
            try:
                return self._by_name[name_or_id]
            except KeyError:
                raise KeyError(f"unknown metric name {name_or_id!r}") from None
        self._frozen = True
        try:
            return self._by_id[int(name_or_id)]
        except IndexError:
            raise KeyError(f"unknown metric id {name_or_id}") from None

    def metric_id(self, name: str) -> int:
        return self.metric_info(name).metric_id

    def all_metric_infos(self) -> Sequence[MetricInfo]:
        self._frozen = True
        return tuple(self._by_id)

    def metric_infos_in_group(self, group: str) -> Sequence[MetricInfo]:
        return tuple(m for m in self.all_metric_infos() if m.group == group)

    def size(self) -> int:
        self._frozen = True
        return len(self._by_id)

    def __len__(self) -> int:
        return self.size()

    def __contains__(self, name: str) -> bool:
        return name in self._by_name
