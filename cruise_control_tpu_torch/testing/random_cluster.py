"""Vectorized random-cluster generator (port of cruise_control_tpu/
testing/random_cluster.py).

The arrays are built with numpy exactly as the reference builds them —
the same `RandomClusterSpec` gives bit-identical arrays — and turned into
tensors on the requested device at the end.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.model.state import (
    CPU_WEIGHT_FOLLOWER_BYTES_IN, CPU_WEIGHT_LEADER_BYTES_IN,
    CPU_WEIGHT_LEADER_BYTES_OUT, ClusterState)
from cruise_control_tpu_torch.model.topology import (ClusterTopology,
                                                     PartitionId)


@dataclasses.dataclass
class RandomClusterSpec:
    """Knobs of the generated cluster (same fields and defaults as the
    reference spec)."""
    num_brokers: int = 200
    num_partitions: int = 20_000
    replication_factor: int = 3
    num_racks: int = 10
    num_topics: int = 50
    seed: int = 0
    mean_cpu: float = 0.04
    mean_nw_in: float = 40.0
    mean_nw_out: float = 50.0
    mean_disk: float = 120.0
    load_sigma: float = 1.0
    capacity_margin: float = 2.0
    skew_fraction: float = 0.3
    skew_brokers: int = 0  # 0 -> num_brokers // 20 + 1
    dead_brokers: int = 0
    new_brokers: int = 0
    jbod_disks: int = 0
    dead_disks: int = 0


def estimate_follower_cpu(leader_cpu, leader_nw_in, leader_nw_out):
    """Follower CPU estimated from the leader's load (static model
    coefficients), array-compatible."""
    denom = (CPU_WEIGHT_LEADER_BYTES_IN * np.asarray(leader_nw_in, np.float64)
             + CPU_WEIGHT_LEADER_BYTES_OUT
             * np.asarray(leader_nw_out, np.float64))
    return np.where(denom > 0.0,
                    np.asarray(leader_cpu, np.float64)
                    * CPU_WEIGHT_FOLLOWER_BYTES_IN
                    * np.asarray(leader_nw_in, np.float64)
                    / np.maximum(denom, 1e-300),
                    0.0)


def _distinct_brokers(rng: np.random.Generator, num_p: int, rf: int,
                      num_b: int) -> np.ndarray:
    """i32[P, rf] distinct broker picks per partition."""
    if num_b <= 64:
        order = np.argsort(rng.random((num_p, num_b)), axis=1)
        return order[:, :rf].astype(np.int32)
    picks = rng.integers(0, num_b, size=(num_p, rf), dtype=np.int64)
    for _ in range(64):  # rejection-resample colliding rows (rare: rf << B)
        sorted_picks = np.sort(picks, axis=1)
        dup = (sorted_picks[:, 1:] == sorted_picks[:, :-1]).any(axis=1)
        if not dup.any():
            break
        picks[dup] = rng.integers(0, num_b, size=(int(dup.sum()), rf))
    return picks.astype(np.int32)


def random_cluster_arrays(spec: RandomClusterSpec):
    """(numpy field dict, num_racks, num_hosts, num_topics, topology)."""
    rng = np.random.default_rng(spec.seed)
    num_b = spec.num_brokers + spec.new_brokers
    num_p = spec.num_partitions
    rf = spec.replication_factor
    num_r = num_p * rf

    rack_of_broker = (np.arange(num_b) % spec.num_racks).astype(np.int32)
    host_of_broker = np.arange(num_b, dtype=np.int32)
    topic_of_p = rng.integers(0, spec.num_topics, size=num_p).astype(np.int32)

    placement = _distinct_brokers(rng, num_p, rf, spec.num_brokers)
    if spec.skew_fraction > 0:
        hot = spec.skew_brokers or (spec.num_brokers // 20 + 1)
        skewed = rng.random(num_p) < spec.skew_fraction
        hot_pick = rng.integers(0, hot, size=num_p).astype(np.int32)
        conflict = (placement[:, 1:] == hot_pick[:, None]).any(axis=1)
        take = skewed & ~conflict
        placement[take, 0] = hot_pick[take]

    def lognormal(mean: float) -> np.ndarray:
        mu = np.log(mean) - 0.5 * spec.load_sigma ** 2
        return rng.lognormal(mu, spec.load_sigma, size=num_p)

    lead_cpu = lognormal(spec.mean_cpu)
    lead_nw_in = lognormal(spec.mean_nw_in)
    lead_nw_out = lognormal(spec.mean_nw_out)
    lead_disk = lognormal(spec.mean_disk)
    follower_cpu = estimate_follower_cpu(lead_cpu, lead_nw_in, lead_nw_out)

    r_part = np.repeat(np.arange(num_p, dtype=np.int32), rf)
    r_broker = placement.reshape(-1)
    r_leader = np.zeros(num_r, dtype=bool)
    r_leader[::rf] = True

    base = np.zeros((num_r, NUM_RESOURCES), dtype=np.float32)
    base[:, Resource.CPU] = np.repeat(follower_cpu, rf)
    base[:, Resource.NW_IN] = np.repeat(lead_nw_in, rf)
    base[:, Resource.DISK] = np.repeat(lead_disk, rf)

    bonus = np.zeros((num_p, NUM_RESOURCES), dtype=np.float32)
    bonus[:, Resource.CPU] = lead_cpu - follower_cpu
    bonus[:, Resource.NW_OUT] = lead_nw_out

    per_broker_load = np.zeros(NUM_RESOURCES)
    per_broker_load[Resource.CPU] = (lead_cpu.sum()
                                     + follower_cpu.sum() * (rf - 1)
                                     ) / spec.num_brokers
    per_broker_load[Resource.NW_IN] = lead_nw_in.sum() * rf / spec.num_brokers
    # NW_OUT capacity is provisioned against the potential outbound load
    per_broker_load[Resource.NW_OUT] = (lead_nw_out.sum() * rf
                                        / spec.num_brokers)
    per_broker_load[Resource.DISK] = lead_disk.sum() * rf / spec.num_brokers
    capacity = np.tile((per_broker_load * spec.capacity_margin
                        ).astype(np.float32), (num_b, 1))

    alive = np.ones(num_b, dtype=bool)
    if spec.dead_brokers:
        dead = rng.choice(spec.num_brokers, size=spec.dead_brokers,
                          replace=False)
        alive[dead] = False
    new = np.zeros(num_b, dtype=bool)
    new[spec.num_brokers:] = True
    offline = ~alive[r_broker]

    bad_disks = np.zeros(num_b, dtype=bool)
    disk_names = []
    if spec.jbod_disks:
        jd = spec.jbod_disks
        num_d = num_b * jd
        disk_broker = np.repeat(np.arange(num_b, dtype=np.int32), jd)
        disk_capacity = np.repeat(capacity[:, Resource.DISK] / jd, jd
                                  ).astype(np.float32)
        disk_alive_arr = np.ones(num_d, dtype=bool)
        r_disk = (r_broker * jd
                  + rng.integers(0, jd, size=num_r)).astype(np.int32)
        if spec.dead_disks:
            alive_broker_disks = np.nonzero(alive[disk_broker])[0]
            broken = alive_broker_disks[:spec.dead_disks]
            disk_alive_arr[broken] = False
            offline = offline | ~disk_alive_arr[r_disk]
            bad_disks[disk_broker[broken]] = True
            np.subtract.at(capacity[:, Resource.DISK],
                           disk_broker[broken], disk_capacity[broken])
        disk_names = [(int(disk_broker[d]), f"/d{d % jd}")
                      for d in range(num_d)]
    else:
        disk_broker = np.zeros(1, dtype=np.int32)
        disk_capacity = np.zeros(1, dtype=np.float32)
        disk_alive_arr = np.ones(1, dtype=bool)
        r_disk = np.full(num_r, -1, dtype=np.int32)

    fields = dict(
        replica_valid=np.ones(num_r, dtype=bool),
        replica_partition=r_part,
        replica_broker=r_broker,
        replica_disk=r_disk,
        replica_is_leader=r_leader,
        replica_offline=offline,
        replica_original_offline=offline.copy(),
        replica_base_load=base,
        partition_topic=topic_of_p,
        partition_leader_bonus=bonus,
        broker_alive=alive,
        broker_new=new,
        broker_demoted=np.zeros(num_b, dtype=bool),
        broker_bad_disks=bad_disks,
        broker_capacity=capacity,
        broker_rack=rack_of_broker,
        broker_host=host_of_broker,
        disk_broker=disk_broker,
        disk_capacity=disk_capacity,
        disk_alive=disk_alive_arr,
    )
    topology = ClusterTopology(
        broker_ids=list(range(num_b)),
        rack_ids=[f"rack-{k}" for k in range(spec.num_racks)],
        host_names=[f"host-{b}" for b in range(num_b)],
        topics=[f"topic-{t}" for t in range(spec.num_topics)],
        partitions=[PartitionId(f"topic-{topic_of_p[p]}", p)
                    for p in range(num_p)],
        disk_names=disk_names,
    )
    return fields, spec.num_racks, num_b, spec.num_topics, topology


def random_cluster(spec: RandomClusterSpec, device=None
                   ) -> Tuple[ClusterState, ClusterTopology]:
    """Generate a random cluster per `spec` as (ClusterState, topology)
    on `device` (the card unless "cpu" is asked for)."""
    dev = resolve_device(device)
    fields, racks, hosts, topics, topology = random_cluster_arrays(spec)
    state = ClusterState(
        **{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
           for k, v in fields.items()},
        num_racks=racks, num_hosts=hosts, num_topics=topics)
    return state, topology


def served_inputs(state: ClusterState, topology: ClusterTopology,
                  generation: int = 1):
    """(ClusterSnapshot, leader loads, capacities): the description of a
    generated (or solved) cluster that the port's `LoadMonitor` takes in
    place of metadata, partition samples and a capacity resolver.  Each
    partition's replicas keep their order; its leader load is its leader
    replica's base load plus the partition's leadership bonus (float32
    values added in float64); a JBOD broker's capacity lists each of its
    logdirs, a dead logdir reported offline."""
    from cruise_control_tpu_torch.cluster.types import (BrokerInfo,
                                                        ClusterSnapshot,
                                                        LogDirInfo,
                                                        PartitionInfo,
                                                        TopicPartition)
    from cruise_control_tpu_torch.config.capacity import BrokerCapacity
    h = {f: getattr(state, f).cpu().numpy() for f in (
        "replica_valid", "replica_partition", "replica_broker",
        "replica_disk", "replica_is_leader", "replica_offline",
        "replica_base_load", "partition_leader_bonus", "broker_alive",
        "broker_capacity", "broker_rack", "broker_host", "disk_broker",
        "disk_capacity", "disk_alive")}
    ids = topology.broker_ids
    disks_of = [[] for _ in ids]
    for d, (b, name) in enumerate(topology.disk_names):
        disks_of[b].append((d, name))
    brokers, capacities = [], {}
    for b, bid in enumerate(ids):
        logdirs = tuple(LogDirInfo(name, offline=not h["disk_alive"][d])
                        for d, name in disks_of[b])
        brokers.append(BrokerInfo(
            bid, host=topology.host_names[h["broker_host"][b]],
            rack=topology.rack_ids[h["broker_rack"][b]],
            alive=bool(h["broker_alive"][b]), logdirs=logdirs))
        cap = [float(x) for x in h["broker_capacity"][b]]
        by_logdir = None
        if disks_of[b]:
            by_logdir = {name: float(h["disk_capacity"][d])
                         for d, name in disks_of[b]}
            cap[Resource.DISK] = sum(by_logdir.values())
        capacities[bid] = BrokerCapacity(tuple(cap), by_logdir)
    valid = np.nonzero(h["replica_valid"])[0]
    order = valid[np.argsort(h["replica_partition"][valid], kind="stable")]
    parts = h["replica_partition"][order]
    starts = np.searchsorted(parts, np.arange(len(topology.partitions) + 1))
    disk_names = [name for _, name in topology.disk_names]
    partitions, loads = [], {}
    for p, pid in enumerate(topology.partitions):
        rows = order[starts[p]:starts[p + 1]]
        if not rows.size:
            continue
        replicas = tuple(ids[b] for b in h["replica_broker"][rows])
        lead = rows[h["replica_is_leader"][rows]]
        leader = ids[h["replica_broker"][lead[0]]] if lead.size else None
        disk = h["replica_disk"][rows]
        partitions.append(PartitionInfo(
            TopicPartition(pid.topic, pid.partition), leader, replicas,
            offline_replicas=tuple(
                r for r, off in zip(replicas, h["replica_offline"][rows])
                if off),
            logdir_by_broker={r: disk_names[d]
                              for r, d in zip(replicas, disk) if d >= 0}))
        src = lead[0] if lead.size else rows[0]
        loads[(pid.topic, pid.partition)] = (
            h["replica_base_load"][src].astype(np.float64)
            + h["partition_leader_bonus"][p].astype(np.float64))
    snapshot = ClusterSnapshot(generation, tuple(brokers), tuple(partitions))
    return snapshot, loads, capacities
