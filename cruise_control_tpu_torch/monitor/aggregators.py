"""The partition and broker metric-sample aggregators (port of
cruise_control_tpu/monitor/aggregators.py).

Thin specializations of the core windowed aggregator (Cruise Control's
KafkaPartitionMetricSampleAggregator.java, entity = partition, group =
topic; KafkaBrokerMetricSampleAggregator.java, entity = broker) that add
the typed sample ingest and the completeness-requirement translation.
"""
from __future__ import annotations

from typing import Iterable

from cruise_control_tpu_torch.core.aggregator import (
    AggregationOptions, Granularity, MetricSampleAggregationResult,
    MetricSampleAggregator)
from cruise_control_tpu_torch.monitor.completeness import (
    ModelCompletenessRequirements)
from cruise_control_tpu_torch.monitor.metricdef import (broker_metric_def,
                                                        common_metric_def)
from cruise_control_tpu_torch.monitor.sampling.holder import (
    BrokerMetricSample, PartitionMetricSample)


class PartitionMetricSampleAggregator(MetricSampleAggregator):
    """Windowed aggregation over partition entities
    (reference KafkaPartitionMetricSampleAggregator.java:1-301)."""

    def __init__(self, num_windows: int, window_ms: int,
                 min_samples_per_window: int,
                 completeness_cache_size: int = 5):
        super().__init__(num_windows, window_ms, min_samples_per_window,
                         common_metric_def(), completeness_cache_size)

    def add_partition_sample(self, sample: PartitionMetricSample) -> bool:
        return self.add_sample(sample.to_metric_sample())

    def add_partition_samples(self,
                              samples: Iterable[PartitionMetricSample]) -> int:
        return sum(1 for s in samples if self.add_partition_sample(s))

    def aggregate_with_requirements(
            self, now_ms: float, req: ModelCompletenessRequirements,
            interested_entities=None,
            max_allowed_extrapolations: int = 5
            ) -> MetricSampleAggregationResult:
        """Aggregate [oldest, now] under a completeness requirement
        (reference KafkaPartitionMetricSampleAggregator.aggregate)."""
        options = AggregationOptions(
            min_valid_entity_ratio=req.min_monitored_partitions_percentage,
            min_valid_entity_group_ratio=0.0,
            min_valid_windows=req.min_required_num_windows,
            max_allowed_extrapolations_per_entity=max_allowed_extrapolations,
            granularity=(Granularity.ENTITY_GROUP
                         if req.include_all_topics else Granularity.ENTITY),
            include_invalid_entities=req.include_all_topics,
            interested_entities=interested_entities)
        return self.aggregate(-1.0, now_ms, options)


class BrokerMetricSampleAggregator(MetricSampleAggregator):
    """Windowed aggregation over broker entities
    (reference KafkaBrokerMetricSampleAggregator.java)."""

    def __init__(self, num_windows: int, window_ms: int,
                 min_samples_per_window: int,
                 completeness_cache_size: int = 5):
        super().__init__(num_windows, window_ms, min_samples_per_window,
                         broker_metric_def(), completeness_cache_size)

    def add_broker_sample(self, sample: BrokerMetricSample) -> bool:
        return self.add_sample(sample.to_metric_sample())

    def add_broker_samples(self,
                           samples: Iterable[BrokerMetricSample]) -> int:
        return sum(1 for s in samples if self.add_broker_sample(s))
