"""Metric sample holders, their binary serde and the ingest quarantine
(port of cruise_control_tpu/monitor/sampling/holder.py).

The typed samples (Cruise Control's PartitionMetricSample.java and
BrokerMetricSample.java) the sampler builds, the sample store persists
(a binary record with a version byte, byte for byte the JAX package's)
and the windowed aggregators take in.

The quarantine is the ingest half of the solver's invalid-input defense:
a NaN, Inf or negative metric value admitted into a window poisons every
model built from it.  Dropping the offending sample here, behind a
counter so the loss is visible, keeps the model clean at the source.
"""
from __future__ import annotations

import dataclasses
import math
import struct
from typing import Dict, Iterable, List, Mapping, Tuple

from cruise_control_tpu_torch.cluster.types import TopicPartition
from cruise_control_tpu_torch.core.aggregator import MetricSample
from cruise_control_tpu_torch.monitor.entities import (BrokerEntity,
                                                       PartitionEntity)
from cruise_control_tpu_torch.monitor.metricdef import (broker_metric_def,
                                                        common_metric_def)

_HEADER = struct.Struct("<BqiH")  # version, time_ms, broker_id, n_metrics
_METRIC = struct.Struct("<Hf")    # metric id, value


@dataclasses.dataclass(frozen=True)
class PartitionMetricSample:
    """All common metrics of one partition (on its leader broker) at one
    instant (reference holder/PartitionMetricSample.java)."""

    broker_id: int
    tp: TopicPartition
    sample_time_ms: float
    values: Mapping[int, float]  # metric id (common def) -> value

    CURRENT_VERSION = 1

    def to_metric_sample(self) -> MetricSample:
        return MetricSample(PartitionEntity(self.tp.topic, self.tp.partition),
                            self.sample_time_ms, dict(self.values))

    def to_bytes(self) -> bytes:
        topic = self.tp.topic.encode()
        out = [_HEADER.pack(self.CURRENT_VERSION, int(self.sample_time_ms),
                            self.broker_id, len(self.values)),
               struct.pack("<Hi", len(topic), self.tp.partition), topic]
        for mid, val in sorted(self.values.items()):
            out.append(_METRIC.pack(mid, float(val)))
        return b"".join(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "PartitionMetricSample":
        ver, time_ms, broker_id, n = _HEADER.unpack_from(data, 0)
        if ver > cls.CURRENT_VERSION:
            raise ValueError(f"unsupported partition-sample version {ver}")
        off = _HEADER.size
        tlen, partition = struct.unpack_from("<Hi", data, off)
        off += 6
        topic = data[off:off + tlen].decode()
        off += tlen
        values: Dict[int, float] = {}
        for _ in range(n):
            mid, val = _METRIC.unpack_from(data, off)
            off += _METRIC.size
            values[mid] = val
        return cls(broker_id, TopicPartition(topic, partition),
                   float(time_ms), values)


@dataclasses.dataclass(frozen=True)
class BrokerMetricSample:
    """All broker metrics of one broker at one instant
    (reference holder/BrokerMetricSample.java:1-359)."""

    broker_id: int
    sample_time_ms: float
    values: Mapping[int, float]  # metric id (broker def) -> value

    CURRENT_VERSION = 1

    def to_metric_sample(self) -> MetricSample:
        return MetricSample(BrokerEntity(self.broker_id),
                            self.sample_time_ms, dict(self.values))

    def metric_value(self, name: str) -> float:
        return self.values.get(broker_metric_def().metric_id(name), 0.0)

    def to_bytes(self) -> bytes:
        out = [_HEADER.pack(self.CURRENT_VERSION, int(self.sample_time_ms),
                            self.broker_id, len(self.values))]
        for mid, val in sorted(self.values.items()):
            out.append(_METRIC.pack(mid, float(val)))
        return b"".join(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "BrokerMetricSample":
        ver, time_ms, broker_id, n = _HEADER.unpack_from(data, 0)
        if ver > cls.CURRENT_VERSION:
            raise ValueError(f"unsupported broker-sample version {ver}")
        off = _HEADER.size
        values: Dict[int, float] = {}
        for _ in range(n):
            mid, val = _METRIC.unpack_from(data, off)
            off += _METRIC.size
            values[mid] = val
        return cls(broker_id, float(time_ms), values)


def sample_values_valid(values: Mapping[int, float]) -> bool:
    """True when every metric value is finite and non-negative (all the
    framework's metrics are rates/sizes/percentages — a negative value is
    as corrupt as a NaN)."""
    for v in values.values():
        if not math.isfinite(v) or v < 0.0:
            return False
    return True


def quarantine_invalid(samples: Iterable) -> Tuple[List, int]:
    """Split a batch of Partition/BrokerMetricSamples into (valid,
    dropped-count); the caller owns the counting (the fetcher keeps the
    per-process counter the facade exports as
    `sampler-quarantined-samples`)."""
    valid = []
    dropped = 0
    for s in samples:
        if sample_values_valid(s.values):
            valid.append(s)
        else:
            dropped += 1
    return valid, dropped


def complete_partition_values(partial: Mapping[int, float]
                              ) -> Dict[int, float]:
    """Fill unset common-metric ids with 0.0 (the aggregator requires a value
    for every defined metric; reference MetricSample.close())."""
    values = {i: 0.0 for i in range(common_metric_def().size())}
    values.update(partial)
    return values


def complete_broker_values(partial: Mapping[int, float]) -> Dict[int, float]:
    values = {i: 0.0 for i in range(broker_metric_def().size())}
    values.update(partial)
    return values
