"""Metric fetching: partition assignment and parallel sampler calls (port
of cruise_control_tpu/monitor/sampling/fetcher.py).

N metric-fetcher threads each sample a disjoint partition subset through
the configured `MetricSampler` (Cruise Control's
MetricFetcherManager.java); the futures are merged in submission order,
so the aggregators see one arrival order for any number of fetchers.
Fault sites: `monitor.sampler.fetch` (one fetcher's call) and
`monitor.sampler.store` (persisting a round).
"""
from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Set

from cruise_control_tpu_torch.cluster.types import (ClusterSnapshot,
                                                    TopicPartition)
from cruise_control_tpu_torch.monitor.aggregators import (
    BrokerMetricSampleAggregator, PartitionMetricSampleAggregator)
from cruise_control_tpu_torch.monitor.sampling.holder import quarantine_invalid
from cruise_control_tpu_torch.monitor.sampling.sample_store import SampleStore
from cruise_control_tpu_torch.monitor.sampling.sampler import (MetricSampler,
                                                               Samples,
                                                               SamplingMode)
from cruise_control_tpu_torch.utils import faults

LOG = logging.getLogger(__name__)


def assign_partitions(partitions: Sequence[TopicPartition],
                      num_fetchers: int) -> List[Set[TopicPartition]]:
    """Deterministic hash assignment of partitions to fetchers
    (reference DefaultMetricSamplerPartitionAssignor)."""
    buckets: List[Set[TopicPartition]] = [set() for _ in range(num_fetchers)]
    for tp in partitions:
        buckets[hash((tp.topic, tp.partition)) % num_fetchers].add(tp)
    return buckets


class PartitionAssignor:
    """SPI: distribute partitions across fetchers (reference
    MetricSamplerPartitionAssignor, wired by
    `metric.sampler.partition.assignor.class`)."""

    def configure(self, props) -> None:  # pragma: no cover - plugin hook
        """Config hook for get_configured_instance."""

    def assign(self, partitions: Sequence[TopicPartition],
               num_fetchers: int) -> List[Set[TopicPartition]]:
        raise NotImplementedError


class DefaultPartitionAssignor(PartitionAssignor):
    """Hash-bucket assignment (the module-level assign_partitions)."""

    def assign(self, partitions: Sequence[TopicPartition],
               num_fetchers: int) -> List[Set[TopicPartition]]:
        return assign_partitions(partitions, num_fetchers)


class MetricFetcherManager:
    """Drives sampling rounds (reference MetricFetcherManager.java:1-224)."""

    def __init__(self, sampler: MetricSampler,
                 partition_aggregator: PartitionMetricSampleAggregator,
                 broker_aggregator: BrokerMetricSampleAggregator,
                 sample_store: Optional[SampleStore] = None,
                 num_fetchers: int = 1,
                 sampling_timeout_s: float = 60.0,
                 partition_assignor: "PartitionAssignor" = None):
        self._sampler = sampler
        self._partition_aggregator = partition_aggregator
        self._broker_aggregator = broker_aggregator
        self._sample_store = sample_store
        self._num_fetchers = max(1, num_fetchers)
        self._assignor = partition_assignor or DefaultPartitionAssignor()
        self._timeout_s = sampling_timeout_s
        self._pool = ThreadPoolExecutor(
            max_workers=self._num_fetchers,
            thread_name_prefix="metric-fetcher")
        # sampling stats for the REST state endpoint
        self.last_sampling_ms: float = 0.0
        self.last_sampling_duration_s: float = 0.0
        #: samples dropped by the ingest quarantine (NaN/Inf/negative
        #: values; holder.quarantine_invalid) — data loss made visible
        self.num_quarantined_samples: int = 0

    def fetch_metrics_for_model(self, cluster: ClusterSnapshot,
                                start_ms: float, end_ms: float,
                                mode: SamplingMode = SamplingMode.ALL
                                ) -> Samples:
        """One sampling round over all partitions; returns the merged
        samples after feeding aggregators + store."""
        t0 = time.time()
        partitions = [p.tp for p in cluster.partitions]
        buckets = [b for b in
                   self._assignor.assign(partitions,
                                         self._num_fetchers) if b]
        if not buckets:
            # no partitions yet — still collect broker metrics so
            # broker-level detection isn't blind on an empty cluster
            buckets = [set()]
        merged = Samples()
        futures = []
        for i, bucket in enumerate(buckets):
            # only fetcher 0 reports broker metrics to avoid duplicates
            if i == 0:
                m = mode
            elif mode == SamplingMode.BROKER_METRICS_ONLY:
                continue   # fetcher 0 already covers all broker metrics
            else:
                m = SamplingMode.PARTITION_METRICS_ONLY
            def fetch_one(bucket=bucket, m=m):
                faults.inject("monitor.sampler.fetch")
                return self._sampler.get_samples(cluster, bucket, start_ms,
                                                 end_ms, m)
            futures.append(self._pool.submit(fetch_one))
        for fut in futures:
            try:
                merged.merge(fut.result(timeout=self._timeout_s))
            except Exception:  # noqa: BLE001 - sampler is a plugin
                LOG.exception("metric sampler failed; continuing with "
                              "partial samples")
        # ingest quarantine: a NaN/Inf/negative value admitted into a
        # window poisons every model built from it — drop the sample
        # here, behind a counter, instead (holder.quarantine_invalid)
        merged.partition_samples, dropped_p = quarantine_invalid(
            merged.partition_samples)
        merged.broker_samples, dropped_b = quarantine_invalid(
            merged.broker_samples)
        if dropped_p or dropped_b:
            self.num_quarantined_samples += dropped_p + dropped_b
            LOG.warning(
                "ingest quarantine dropped %d partition and %d broker "
                "samples carrying NaN/Inf/negative values (%d total this "
                "process)", dropped_p, dropped_b,
                self.num_quarantined_samples)
        n_p = self._partition_aggregator.add_partition_samples(
            merged.partition_samples)
        n_b = self._broker_aggregator.add_broker_samples(
            merged.broker_samples)
        if self._sample_store is not None:
            try:
                faults.inject("monitor.sampler.store")
                self._sample_store.store_samples(merged)
            except Exception:  # noqa: BLE001 - store is a plugin
                LOG.exception("sample store failed to persist samples")
        self.last_sampling_ms = end_ms
        self.last_sampling_duration_s = time.time() - t0
        LOG.debug("sampling round accepted %d/%d partition and %d/%d broker "
                  "samples in %.2fs", n_p, len(merged.partition_samples),
                  n_b, len(merged.broker_samples),
                  self.last_sampling_duration_s)
        return merged

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)
        self._sampler.close()
