"""The MetricSampler interface and the simulated-cluster sampler (port of
cruise_control_tpu/monitor/sampling/sampler.py).

A sampler is the pluggable source of partition and broker metric samples
(Cruise Control's MetricSampler.java), called by the fetcher threads with
an assigned partition set and a time range.  `SimulatedClusterSampler`
samples the in-process simulated cluster (cluster/simulated.py)
directly: each partition's leader load, and each broker's totals summed
in the snapshot's partition order.
"""
from __future__ import annotations

import abc
import dataclasses
import enum
from typing import List, Set

from cruise_control_tpu_torch.cluster.simulated import SimulatedCluster
from cruise_control_tpu_torch.cluster.types import (ClusterSnapshot,
                                                    TopicPartition)
from cruise_control_tpu_torch.model.builder import estimate_follower_cpu
from cruise_control_tpu_torch.monitor import metricdef as MD
from cruise_control_tpu_torch.monitor.sampling.holder import (
    BrokerMetricSample, PartitionMetricSample, complete_broker_values,
    complete_partition_values)


class SamplingMode(enum.Enum):
    """reference MetricSampler.SamplingMode"""

    ALL = "all"
    BROKER_METRICS_ONLY = "broker"
    PARTITION_METRICS_ONLY = "partition"


@dataclasses.dataclass
class Samples:
    """reference MetricSampler.Samples"""

    partition_samples: List[PartitionMetricSample] = dataclasses.field(
        default_factory=list)
    broker_samples: List[BrokerMetricSample] = dataclasses.field(
        default_factory=list)

    def merge(self, other: "Samples") -> None:
        self.partition_samples.extend(other.partition_samples)
        self.broker_samples.extend(other.broker_samples)


class MetricSampler(abc.ABC):
    """Pluggable metric source (reference MetricSampler.java:1-92)."""

    def configure(self, configs) -> None:  # pragma: no cover - plugin hook
        pass

    @abc.abstractmethod
    def get_samples(self, cluster: ClusterSnapshot,
                    assigned_partitions: Set[TopicPartition],
                    start_ms: float, end_ms: float,
                    mode: SamplingMode = SamplingMode.ALL) -> Samples:
        """Return samples for `assigned_partitions` (and their brokers)
        covering [start_ms, end_ms)."""

    def close(self) -> None:  # pragma: no cover - plugin hook
        pass


class NoopSampler(MetricSampler):
    """Returns no samples (reference NoopSampler)."""

    def get_samples(self, cluster, assigned_partitions, start_ms, end_ms,
                    mode=SamplingMode.ALL) -> Samples:
        return Samples()


class SimulatedClusterSampler(MetricSampler):
    """Samples a `SimulatedCluster`'s per-partition workload directly —
    the shortest path from simulated load to the monitor plane (used by
    integration tests and demos; the agent/channel path in
    cruise_control_tpu/agent is the production-shaped alternative)."""

    def __init__(self, cluster: SimulatedCluster,
                 cores_per_broker: float = 1.0):
        self._cluster = cluster
        self._cores = cores_per_broker
        cdef = MD.common_metric_def()
        self._cid = {name: cdef.metric_id(name) for name in
                     (MD.CPU_USAGE, MD.DISK_USAGE, MD.LEADER_BYTES_IN,
                      MD.LEADER_BYTES_OUT, MD.PRODUCE_RATE, MD.FETCH_RATE,
                      MD.MESSAGE_IN_RATE)}
        bdef = MD.broker_metric_def()
        self._bid = {name: bdef.metric_id(name) for name in
                     (MD.CPU_USAGE, MD.DISK_USAGE, MD.LEADER_BYTES_IN,
                      MD.LEADER_BYTES_OUT, MD.REPLICATION_BYTES_IN_RATE,
                      MD.REPLICATION_BYTES_OUT_RATE,
                      MD.BROKER_LOG_FLUSH_TIME_MS_999TH,
                      MD.BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT)}

    def get_samples(self, cluster: ClusterSnapshot,
                    assigned_partitions: Set[TopicPartition],
                    start_ms: float, end_ms: float,
                    mode: SamplingMode = SamplingMode.ALL) -> Samples:
        sim = self._cluster
        out = Samples()
        t = end_ms
        broker_cpu: dict = {}
        broker_bytes_in: dict = {}
        broker_bytes_out: dict = {}
        broker_repl_in: dict = {}
        broker_repl_out: dict = {}
        broker_disk: dict = {}

        # snapshot per-partition loads under the sim lock: sampling runs on
        # the load-monitor thread while tests/demos mutate the cluster
        with sim._lock:  # test-harness internal access
            loads = {tp: (part.leader_cpu, part.nw_in, part.nw_out,
                          part.size_bytes)
                     for tp, part in sim._partitions.items()}

        for pinfo in cluster.partitions:
            tp = pinfo.tp
            part_load = loads.get(tp)
            if part_load is None or pinfo.leader is None:
                continue
            leader = pinfo.leader
            leader_cpu, nw_in, nw_out, size_bytes = part_load
            n_followers = max(len(pinfo.replicas) - 1, 0)
            broker_cpu[leader] = broker_cpu.get(leader, 0.0) + leader_cpu
            broker_bytes_in[leader] = (broker_bytes_in.get(leader, 0.0)
                                       + nw_in)
            broker_bytes_out[leader] = (broker_bytes_out.get(leader, 0.0)
                                        + nw_out)
            for b in pinfo.replicas:
                broker_disk[b] = broker_disk.get(b, 0.0) + size_bytes
                if b != leader:
                    broker_repl_in[b] = (broker_repl_in.get(b, 0.0)
                                         + nw_in)
                    fcpu = estimate_follower_cpu(leader_cpu, nw_in, nw_out)
                    broker_cpu[b] = broker_cpu.get(b, 0.0) + fcpu
            broker_repl_out[leader] = (broker_repl_out.get(leader, 0.0)
                                       + nw_in * n_followers)

            if (mode != SamplingMode.BROKER_METRICS_ONLY
                    and tp in assigned_partitions):
                c = self._cid
                values = complete_partition_values({
                    c[MD.CPU_USAGE]: leader_cpu,
                    c[MD.DISK_USAGE]: size_bytes,
                    c[MD.LEADER_BYTES_IN]: nw_in,
                    c[MD.LEADER_BYTES_OUT]: nw_out,
                    c[MD.PRODUCE_RATE]: nw_in / 1024.0,
                    c[MD.FETCH_RATE]: nw_out / 1024.0,
                    c[MD.MESSAGE_IN_RATE]: nw_in / 512.0,
                })
                out.partition_samples.append(
                    PartitionMetricSample(leader, tp, t, values))

        if mode != SamplingMode.PARTITION_METRICS_ONLY:
            b = self._bid
            for binfo in cluster.brokers:
                if not binfo.alive:
                    continue
                bid = binfo.broker_id
                values = complete_broker_values({
                    b[MD.CPU_USAGE]: broker_cpu.get(bid, 0.0),
                    b[MD.DISK_USAGE]: broker_disk.get(bid, 0.0),
                    b[MD.LEADER_BYTES_IN]: broker_bytes_in.get(bid, 0.0),
                    b[MD.LEADER_BYTES_OUT]: broker_bytes_out.get(bid, 0.0),
                    b[MD.REPLICATION_BYTES_IN_RATE]:
                        broker_repl_in.get(bid, 0.0),
                    b[MD.REPLICATION_BYTES_OUT_RATE]:
                        broker_repl_out.get(bid, 0.0),
                    b[MD.BROKER_LOG_FLUSH_TIME_MS_999TH]: 1.0,
                    b[MD.BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT]: 0.9,
                })
                out.broker_samples.append(BrokerMetricSample(bid, t, values))
        return out
