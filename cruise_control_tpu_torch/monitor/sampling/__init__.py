"""Sampling: the sampler interface, fetchers, sample holders and their
serde, sample stores (port of cruise_control_tpu/monitor/sampling/).
"""
from cruise_control_tpu_torch.monitor.sampling.holder import (
    BrokerMetricSample, PartitionMetricSample)
from cruise_control_tpu_torch.monitor.sampling.sampler import (
    MetricSampler, NoopSampler, Samples, SamplingMode, SimulatedClusterSampler)
from cruise_control_tpu_torch.monitor.sampling.sample_store import (
    FileSampleStore, NoopSampleStore, SampleLoader, SampleStore)

__all__ = [
    "BrokerMetricSample", "PartitionMetricSample", "MetricSampler",
    "NoopSampler", "Samples", "SamplingMode", "SimulatedClusterSampler",
    "FileSampleStore", "NoopSampleStore", "SampleLoader", "SampleStore",
]
