"""Framework metric definitions, raw metric types to aggregation metrics
(port of cruise_control_tpu/monitor/metricdef.py).

Cruise Control maps the raw metric types its in-broker reporter emits to
aggregation metric definitions split into a "common" set (valid for
partition and broker entities) and a broker-only set (KafkaMetricDef.java,
RawMetricType.java).  `RawMetricType` is the wire enum; `MetricScope` says
which entity a raw type describes; the two `MetricDef` registries are what
the windowed aggregators are built on.  Their ids equal the JAX package's.
"""
from __future__ import annotations

import enum
from typing import Dict

from cruise_control_tpu_torch.core.metricdef import (AggregationFunction,
                                                    MetricDef)


class MetricScope(enum.Enum):
    """Which entity a raw metric describes (reference RawMetricType.Scope)."""

    BROKER = "broker"
    TOPIC = "topic"
    PARTITION = "partition"


class RawMetricType(enum.Enum):
    """Wire-level metric types produced by the node agent (subset of the
    reference's 77 covering every metric its model actually consumes;
    reference RawMetricType.java:27-183)."""

    # broker scope
    ALL_TOPIC_BYTES_IN = ("broker",)
    ALL_TOPIC_BYTES_OUT = ("broker",)
    ALL_TOPIC_REPLICATION_BYTES_IN = ("broker",)
    ALL_TOPIC_REPLICATION_BYTES_OUT = ("broker",)
    ALL_TOPIC_FETCH_REQUEST_RATE = ("broker",)
    ALL_TOPIC_PRODUCE_REQUEST_RATE = ("broker",)
    ALL_TOPIC_MESSAGES_IN_PER_SEC = ("broker",)
    BROKER_CPU_UTIL = ("broker",)
    BROKER_PRODUCE_REQUEST_RATE = ("broker",)
    BROKER_CONSUMER_FETCH_REQUEST_RATE = ("broker",)
    BROKER_FOLLOWER_FETCH_REQUEST_RATE = ("broker",)
    BROKER_REQUEST_HANDLER_AVG_IDLE_PERCENT = ("broker",)
    BROKER_REQUEST_QUEUE_SIZE = ("broker",)
    BROKER_RESPONSE_QUEUE_SIZE = ("broker",)
    BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MAX = ("broker",)
    BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MEAN = ("broker",)
    BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MAX = ("broker",)
    BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN = ("broker",)
    BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MAX = ("broker",)
    BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN = ("broker",)
    BROKER_LOG_FLUSH_RATE = ("broker",)
    BROKER_LOG_FLUSH_TIME_MS_MEAN = ("broker",)
    BROKER_LOG_FLUSH_TIME_MS_999TH = ("broker",)
    # topic scope
    TOPIC_BYTES_IN = ("topic",)
    TOPIC_BYTES_OUT = ("topic",)
    TOPIC_REPLICATION_BYTES_IN = ("topic",)
    TOPIC_REPLICATION_BYTES_OUT = ("topic",)
    TOPIC_PRODUCE_REQUEST_RATE = ("topic",)
    TOPIC_FETCH_REQUEST_RATE = ("topic",)
    TOPIC_MESSAGES_IN_PER_SEC = ("topic",)
    # partition scope
    PARTITION_SIZE = ("partition",)

    def __init__(self, scope: str):
        self.scope = MetricScope(scope)


# ---------------------------------------------------------------------------
# Aggregation metric names (reference KafkaMetricDef.CommonMetricDef /
# BrokerMetricDef enum constants)
# ---------------------------------------------------------------------------

CPU_USAGE = "CPU_USAGE"
DISK_USAGE = "DISK_USAGE"
LEADER_BYTES_IN = "LEADER_BYTES_IN"
LEADER_BYTES_OUT = "LEADER_BYTES_OUT"
REPLICATION_BYTES_IN_RATE = "REPLICATION_BYTES_IN_RATE"
REPLICATION_BYTES_OUT_RATE = "REPLICATION_BYTES_OUT_RATE"
PRODUCE_RATE = "PRODUCE_RATE"
FETCH_RATE = "FETCH_RATE"
MESSAGE_IN_RATE = "MESSAGE_IN_RATE"

BROKER_PRODUCE_REQUEST_RATE = "BROKER_PRODUCE_REQUEST_RATE"
BROKER_CONSUMER_FETCH_REQUEST_RATE = "BROKER_CONSUMER_FETCH_REQUEST_RATE"
BROKER_FOLLOWER_FETCH_REQUEST_RATE = "BROKER_FOLLOWER_FETCH_REQUEST_RATE"
BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT = (
    "BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT")
BROKER_REQUEST_QUEUE_SIZE = "BROKER_REQUEST_QUEUE_SIZE"
BROKER_RESPONSE_QUEUE_SIZE = "BROKER_RESPONSE_QUEUE_SIZE"
BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MAX = (
    "BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MAX")
BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MEAN = (
    "BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MEAN")
BROKER_LOG_FLUSH_RATE = "BROKER_LOG_FLUSH_RATE"
BROKER_LOG_FLUSH_TIME_MS_MEAN = "BROKER_LOG_FLUSH_TIME_MS_MEAN"
BROKER_LOG_FLUSH_TIME_MS_999TH = "BROKER_LOG_FLUSH_TIME_MS_999TH"

#: common metrics (partition & broker entities), with the aggregation
#: strategy the reference assigns (CPU/NW/rates = AVG, DISK = LATEST;
#: KafkaMetricDef.java:48-90) and whether the metric participates in the
#: `toFollower` load transfer on leadership change.
_COMMON = [
    (CPU_USAGE, AggregationFunction.AVG, True),
    (LEADER_BYTES_IN, AggregationFunction.AVG, True),
    (LEADER_BYTES_OUT, AggregationFunction.AVG, True),
    (DISK_USAGE, AggregationFunction.LATEST, False),
    (PRODUCE_RATE, AggregationFunction.AVG, False),
    (FETCH_RATE, AggregationFunction.AVG, False),
    (MESSAGE_IN_RATE, AggregationFunction.AVG, False),
    (REPLICATION_BYTES_IN_RATE, AggregationFunction.AVG, False),
    (REPLICATION_BYTES_OUT_RATE, AggregationFunction.AVG, False),
]

_BROKER_ONLY = [
    (BROKER_PRODUCE_REQUEST_RATE, AggregationFunction.AVG),
    (BROKER_CONSUMER_FETCH_REQUEST_RATE, AggregationFunction.AVG),
    (BROKER_FOLLOWER_FETCH_REQUEST_RATE, AggregationFunction.AVG),
    (BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT, AggregationFunction.AVG),
    (BROKER_REQUEST_QUEUE_SIZE, AggregationFunction.AVG),
    (BROKER_RESPONSE_QUEUE_SIZE, AggregationFunction.AVG),
    (BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MAX, AggregationFunction.MAX),
    (BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MEAN, AggregationFunction.AVG),
    (BROKER_LOG_FLUSH_RATE, AggregationFunction.AVG),
    (BROKER_LOG_FLUSH_TIME_MS_MEAN, AggregationFunction.AVG),
    (BROKER_LOG_FLUSH_TIME_MS_999TH, AggregationFunction.MAX),
]


#: group name marking metrics whose load follows leadership transfers
#: (reference KafkaMetricDef constructor's `toFollower` flag)
TO_FOLLOWER_GROUP = "toFollower"


def _build_common() -> MetricDef:
    md = MetricDef()
    for name, func, to_follower in _COMMON:
        md.define(name, func,
                  group=TO_FOLLOWER_GROUP if to_follower else None)
    return md


def _build_broker() -> MetricDef:
    md = _build_common()
    for name, func in _BROKER_ONLY:
        md.define(name, func)
    return md


_COMMON_METRIC_DEF = _build_common()
_BROKER_METRIC_DEF = _build_broker()


def common_metric_def() -> MetricDef:
    """MetricDef for partition entities (reference
    KafkaMetricDef.commonMetricDef)."""
    return _COMMON_METRIC_DEF


def broker_metric_def() -> MetricDef:
    """MetricDef for broker entities (common + broker-only metrics;
    reference KafkaMetricDef.brokerMetricDef)."""
    return _BROKER_METRIC_DEF


#: raw broker metric type → broker MetricDef name
RAW_TO_BROKER_METRIC: Dict[RawMetricType, str] = {
    RawMetricType.BROKER_CPU_UTIL: CPU_USAGE,
    RawMetricType.ALL_TOPIC_BYTES_IN: LEADER_BYTES_IN,
    RawMetricType.ALL_TOPIC_BYTES_OUT: LEADER_BYTES_OUT,
    RawMetricType.ALL_TOPIC_REPLICATION_BYTES_IN: REPLICATION_BYTES_IN_RATE,
    RawMetricType.ALL_TOPIC_REPLICATION_BYTES_OUT: REPLICATION_BYTES_OUT_RATE,
    RawMetricType.ALL_TOPIC_PRODUCE_REQUEST_RATE: PRODUCE_RATE,
    RawMetricType.ALL_TOPIC_FETCH_REQUEST_RATE: FETCH_RATE,
    RawMetricType.ALL_TOPIC_MESSAGES_IN_PER_SEC: MESSAGE_IN_RATE,
    RawMetricType.BROKER_PRODUCE_REQUEST_RATE: BROKER_PRODUCE_REQUEST_RATE,
    RawMetricType.BROKER_CONSUMER_FETCH_REQUEST_RATE:
        BROKER_CONSUMER_FETCH_REQUEST_RATE,
    RawMetricType.BROKER_FOLLOWER_FETCH_REQUEST_RATE:
        BROKER_FOLLOWER_FETCH_REQUEST_RATE,
    RawMetricType.BROKER_REQUEST_HANDLER_AVG_IDLE_PERCENT:
        BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT,
    RawMetricType.BROKER_REQUEST_QUEUE_SIZE: BROKER_REQUEST_QUEUE_SIZE,
    RawMetricType.BROKER_RESPONSE_QUEUE_SIZE: BROKER_RESPONSE_QUEUE_SIZE,
    RawMetricType.BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MAX:
        BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MAX,
    RawMetricType.BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MEAN:
        BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MEAN,
    RawMetricType.BROKER_LOG_FLUSH_RATE: BROKER_LOG_FLUSH_RATE,
    RawMetricType.BROKER_LOG_FLUSH_TIME_MS_MEAN: BROKER_LOG_FLUSH_TIME_MS_MEAN,
    RawMetricType.BROKER_LOG_FLUSH_TIME_MS_999TH:
        BROKER_LOG_FLUSH_TIME_MS_999TH,
}
