"""Host-side cluster model builder (port of cruise_control_tpu/model/
builder.py).

Describe a cluster rack -> host -> broker -> logdir -> replica, then
`build()` the tensor `ClusterState` and its `ClusterTopology` (the name
<-> index maps).  The description and every array of the build are
numpy, in the reference's own arithmetic (the leader-load split in
float64, then float32), so the same description gives the same arrays;
only the finished arrays move to the device.
"""
from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.model.state import (
    CPU_WEIGHT_FOLLOWER_BYTES_IN, CPU_WEIGHT_LEADER_BYTES_IN,
    CPU_WEIGHT_LEADER_BYTES_OUT, ClusterState)
from cruise_control_tpu_torch.model.topology import (  # noqa: F401
    ClusterTopology, PartitionId)

LoadLike = Union[Mapping[Resource, float], Sequence[float], np.ndarray]


def _load_vector(load: LoadLike) -> np.ndarray:
    if isinstance(load, Mapping):
        vec = np.zeros(NUM_RESOURCES, dtype=np.float64)
        for res, value in load.items():
            vec[int(res)] = float(value)
        return vec
    vec = np.asarray(load, dtype=np.float64)
    if vec.shape != (NUM_RESOURCES,):
        raise ValueError(f"load must have {NUM_RESOURCES} entries, got "
                         f"{vec.shape}")
    return vec.copy()


#: the scalar types `estimate_follower_cpu` takes its float path for
_SCALARS = (float, int, np.floating, np.integer)


def estimate_follower_cpu(leader_cpu, leader_nw_in, leader_nw_out,
                          leader_in_weight: float = None,
                          leader_out_weight: float = None,
                          follower_in_weight: float = None):
    """Follower CPU estimated from the leader's load, scalar- and
    array-compatible; the weights default to the module constants.
    Scalars take a float path with the array path's operations in its
    order (IEEE double either way), so both give the same bits."""
    lw_in = (CPU_WEIGHT_LEADER_BYTES_IN if leader_in_weight is None
             else leader_in_weight)
    lw_out = (CPU_WEIGHT_LEADER_BYTES_OUT if leader_out_weight is None
              else leader_out_weight)
    fw_in = (CPU_WEIGHT_FOLLOWER_BYTES_IN if follower_in_weight is None
             else follower_in_weight)
    if all(isinstance(x, _SCALARS) for x in (leader_cpu, leader_nw_in,
                                             leader_nw_out, lw_in, lw_out,
                                             fw_in)):
        nw_in = float(leader_nw_in)
        denom = (float(lw_in) * nw_in
                 + float(lw_out) * float(leader_nw_out))
        if denom > 0.0:
            return (float(leader_cpu) * float(fw_in) * nw_in
                    / (denom if denom > 1e-300 else 1e-300))
        return 0.0
    denom = (lw_in * np.asarray(leader_nw_in, np.float64)
             + lw_out * np.asarray(leader_nw_out, np.float64))
    est = np.where(denom > 0.0,
                   np.asarray(leader_cpu, np.float64)
                   * fw_in
                   * np.asarray(leader_nw_in, np.float64)
                   / np.maximum(denom, 1e-300),
                   0.0)
    return float(est) if est.ndim == 0 else est


@dataclasses.dataclass
class _Replica:
    partition: int
    broker: int
    is_leader: bool
    offline: bool
    load: np.ndarray                  # current-role load
    disk: int = -1


@dataclasses.dataclass
class _Broker:
    broker_id: int
    rack: int
    host: int
    capacity: np.ndarray
    alive: bool = True
    new: bool = False
    demoted: bool = False
    disks: List[int] = dataclasses.field(default_factory=list)


class ClusterModelBuilder:
    """Describe a cluster, then `build()` the tensor state.

    `follower_cpu_estimator(leader_cpu, leader_nw_in, leader_nw_out)`
    splits a leader's load into follower base plus leadership bonus; the
    estimate is clamped to [0, leader_cpu] in every use."""

    def __init__(self, follower_cpu_estimator: Optional[
            Callable[[float, float, float], float]] = None):
        raw = follower_cpu_estimator or estimate_follower_cpu
        self._follower_cpu = (lambda cpu, nw_in, nw_out:
                              np.clip(raw(cpu, nw_in, nw_out), 0.0, cpu))
        self._racks: Dict[str, int] = {}
        self._hosts: Dict[str, int] = {}
        self._brokers: Dict[int, _Broker] = {}
        self._topics: Dict[str, int] = {}
        self._partitions: Dict[PartitionId, int] = {}
        self._partition_list: List[PartitionId] = []
        self._replicas: List[_Replica] = []
        self._replica_by_key: Dict[Tuple[int, int], int] = {}
        self._disk_names: List[Tuple[int, str]] = []
        self._disk_capacity: List[float] = []
        self._disk_alive: List[bool] = []
        self._disk_broker: List[int] = []

    # ---- topology ----
    def add_rack(self, rack_id: str) -> int:
        return self._racks.setdefault(rack_id, len(self._racks))

    def add_broker(self, broker_id: int, rack_id: str,
                   capacity: LoadLike, host: Optional[str] = None,
                   alive: bool = True, new: bool = False,
                   demoted: bool = False,
                   disks: Optional[Mapping[str, float]] = None) -> int:
        """A broker on `rack_id` and `host` (default ``host-<id>``);
        `disks` maps each JBOD logdir to its capacity (0 or less: a dead
        logdir)."""
        if broker_id in self._brokers:
            raise ValueError(f"broker {broker_id} already exists")
        rack = self.add_rack(rack_id)
        host_name = host if host is not None else f"host-{broker_id}"
        host_idx = self._hosts.setdefault(host_name, len(self._hosts))
        broker = _Broker(broker_id, rack, host_idx, _load_vector(capacity),
                         alive=alive, new=new, demoted=demoted)
        if disks:
            for logdir, disk_cap in disks.items():
                disk_idx = len(self._disk_names)
                self._disk_names.append((broker_id, logdir))
                self._disk_capacity.append(float(disk_cap))
                self._disk_alive.append(disk_cap > 0)
                self._disk_broker.append(broker_id)
                broker.disks.append(disk_idx)
        self._brokers[broker_id] = broker
        return broker_id

    # ---- replicas ----
    def add_replica(self, topic: str, partition: int, broker_id: int,
                    is_leader: bool, load: Optional[LoadLike] = None,
                    offline: bool = False, logdir: Optional[str] = None) -> int:
        """One replica with its current-role load; it is offline when
        asked, or on a dead broker or a dead logdir."""
        if broker_id not in self._brokers:
            raise ValueError(f"unknown broker {broker_id}")
        pid = PartitionId(topic, partition)
        if pid not in self._partitions:
            self._partitions[pid] = len(self._partition_list)
            self._partition_list.append(pid)
            self._topics.setdefault(topic, len(self._topics))
        p_idx = self._partitions[pid]
        key = (p_idx, broker_id)
        if key in self._replica_by_key:
            raise ValueError(f"replica of {pid} already on broker {broker_id}")
        disk = -1
        if logdir is not None:
            for d in self._brokers[broker_id].disks:
                if self._disk_names[d] == (broker_id, logdir):
                    disk = d
                    break
            else:
                raise ValueError(f"unknown logdir {logdir} on broker "
                                 f"{broker_id}")
        vec = (np.zeros(NUM_RESOURCES) if load is None else _load_vector(load))
        on_dead_disk = disk >= 0 and not self._disk_alive[disk]
        replica = _Replica(p_idx, broker_id, is_leader,
                           offline or not self._brokers[broker_id].alive
                           or on_dead_disk,
                           vec, disk)
        self._replica_by_key[key] = len(self._replicas)
        self._replicas.append(replica)
        return len(self._replicas) - 1

    def add_partition(self, topic: str, partition: int, leader_broker: int,
                      follower_brokers: Sequence[int],
                      leader_load: LoadLike,
                      follower_loads: Optional[Sequence[LoadLike]] = None
                      ) -> None:
        """A whole partition; follower loads default to the leader's with
        NW_OUT zero and the estimated CPU."""
        lead_vec = _load_vector(leader_load)
        self.add_replica(topic, partition, leader_broker, True, lead_vec)
        for i, fb in enumerate(follower_brokers):
            if follower_loads is not None:
                f_vec = _load_vector(follower_loads[i])
            else:
                f_vec = lead_vec.copy()
                f_vec[Resource.NW_OUT] = 0.0
                f_vec[Resource.CPU] = self._follower_cpu(
                    lead_vec[Resource.CPU], lead_vec[Resource.NW_IN],
                    lead_vec[Resource.NW_OUT])
            self.add_replica(topic, partition, fb, False, f_vec)

    def set_replica_load(self, topic: str, partition: int, broker_id: int,
                         load: LoadLike) -> None:
        pid = PartitionId(topic, partition)
        idx = self._replica_by_key[(self._partitions[pid], broker_id)]
        self._replicas[idx].load = _load_vector(load)

    # ---- build ----
    def build_arrays(self, pad_replicas_to: Optional[int] = None
                     ) -> Tuple[Dict[str, np.ndarray], Dict[str, int],
                                ClusterTopology]:
        """(numpy fields of the state, its static sizes, topology): the
        whole build on the host."""
        broker_ids = sorted(self._brokers)
        broker_index = {b: i for i, b in enumerate(broker_ids)}
        num_b = len(broker_ids)
        num_p = len(self._partition_list)
        num_r = len(self._replicas)
        pad_r = max(pad_replicas_to or num_r, num_r, 1)

        cap = np.zeros((num_b, NUM_RESOURCES), dtype=np.float32)
        alive = np.zeros(num_b, dtype=bool)
        new = np.zeros(num_b, dtype=bool)
        demoted = np.zeros(num_b, dtype=bool)
        bad_disks = np.zeros(num_b, dtype=bool)
        rack = np.zeros(num_b, dtype=np.int32)
        host = np.zeros(num_b, dtype=np.int32)
        for b_id, broker in self._brokers.items():
            i = broker_index[b_id]
            cap[i] = broker.capacity
            alive[i] = broker.alive
            new[i] = broker.new
            demoted[i] = broker.demoted
            rack[i] = broker.rack
            host[i] = broker.host
            if broker.disks:
                # JBOD: broker DISK capacity = sum of the alive logdirs'
                disk_caps = [self._disk_capacity[d] for d in broker.disks
                             if self._disk_alive[d]]
                cap[i, Resource.DISK] = float(sum(disk_caps))
                bad_disks[i] = any(not self._disk_alive[d]
                                   for d in broker.disks)

        r_valid = np.zeros(pad_r, dtype=bool)
        r_part = np.zeros(pad_r, dtype=np.int32)
        r_broker = np.zeros(pad_r, dtype=np.int32)
        r_disk = np.full(pad_r, -1, dtype=np.int32)
        r_leader = np.zeros(pad_r, dtype=bool)
        r_offline = np.zeros(pad_r, dtype=bool)
        r_base = np.zeros((pad_r, NUM_RESOURCES), dtype=np.float32)
        bonus = np.zeros((num_p, NUM_RESOURCES), dtype=np.float32)
        topic_of_p = np.zeros(num_p, dtype=np.int32)
        for pid, p_idx in self._partitions.items():
            topic_of_p[p_idx] = self._topics[pid.topic]

        for i, rep in enumerate(self._replicas):
            r_valid[i] = True
            r_part[i] = rep.partition
            r_broker[i] = broker_index[rep.broker]
            r_disk[i] = rep.disk
            r_leader[i] = rep.is_leader
            r_offline[i] = rep.offline
            if rep.is_leader:
                # the leader's current-role load split into follower
                # base + leadership bonus, in float64
                cpu_f = float(self._follower_cpu(rep.load[Resource.CPU],
                                                 rep.load[Resource.NW_IN],
                                                 rep.load[Resource.NW_OUT]))
                base = rep.load.copy()
                base[Resource.CPU] = cpu_f
                base[Resource.NW_OUT] = 0.0
                r_base[i] = base
                bonus[rep.partition, Resource.CPU] = (rep.load[Resource.CPU]
                                                      - cpu_f)
                bonus[rep.partition, Resource.NW_OUT] = \
                    rep.load[Resource.NW_OUT]
            else:
                r_base[i] = rep.load

        num_d = max(len(self._disk_broker), 1)
        d_broker = np.zeros(num_d, dtype=np.int32)
        d_cap = np.zeros(num_d, dtype=np.float32)
        d_alive = np.ones(num_d, dtype=bool)
        for d in range(len(self._disk_broker)):
            d_broker[d] = broker_index[self._disk_broker[d]]
            d_cap[d] = self._disk_capacity[d]
            d_alive[d] = self._disk_alive[d]

        fields = dict(
            replica_valid=r_valid, replica_partition=r_part,
            replica_broker=r_broker, replica_disk=r_disk,
            replica_is_leader=r_leader, replica_offline=r_offline,
            replica_original_offline=r_offline.copy(),
            replica_base_load=r_base, partition_topic=topic_of_p,
            partition_leader_bonus=bonus, broker_alive=alive,
            broker_new=new, broker_demoted=demoted,
            broker_bad_disks=bad_disks, broker_capacity=cap,
            broker_rack=rack, broker_host=host, disk_broker=d_broker,
            disk_capacity=d_cap, disk_alive=d_alive)
        sizes = dict(num_racks=max(len(self._racks), 1),
                     num_hosts=max(len(self._hosts), 1),
                     num_topics=max(len(self._topics), 1))
        topology = ClusterTopology(
            broker_ids=broker_ids,
            rack_ids=[r for r, _ in sorted(self._racks.items(),
                                           key=lambda kv: kv[1])],
            host_names=[h for h, _ in sorted(self._hosts.items(),
                                             key=lambda kv: kv[1])],
            topics=[t for t, _ in sorted(self._topics.items(),
                                         key=lambda kv: kv[1])],
            partitions=list(self._partition_list),
            disk_names=list(self._disk_names),
        )
        return fields, sizes, topology

    def build(self, pad_replicas_to: Optional[int] = None, device=None
              ) -> Tuple[ClusterState, ClusterTopology]:
        """(ClusterState on `device` (the card unless "cpu" is asked
        for), ClusterTopology); `pad_replicas_to` appends invalid replica
        rows up to that count."""
        dev = resolve_device(device)
        fields, sizes, topology = self.build_arrays(pad_replicas_to)
        state = ClusterState(
            **{k: torch.from_numpy(v).to(dev) for k, v in fields.items()},
            **sizes)
        return state, topology
