"""Execution proposals (port of cruise_control_tpu/analyzer/proposals.py):
the host-side numpy diff of initial vs optimized placements into
per-partition reassignment proposals."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from cruise_control_tpu_torch.model.topology import (ClusterTopology,
                                                     PartitionId)


@dataclasses.dataclass(frozen=True)
class ReplicaPlacement:
    """(broker id, optional logdir)."""
    broker_id: int
    logdir: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ExecutionProposal:
    """One partition's reassignment: old -> new replica list, leader
    first."""

    partition: PartitionId
    old_leader: int
    old_replicas: Tuple[ReplicaPlacement, ...]
    new_replicas: Tuple[ReplicaPlacement, ...]
    partition_size: float = 0.0

    @property
    def new_leader(self) -> int:
        return self.new_replicas[0].broker_id

    @property
    def has_replica_action(self) -> bool:
        return ({p.broker_id for p in self.old_replicas}
                != {p.broker_id for p in self.new_replicas})

    @property
    def has_leader_action(self) -> bool:
        return self.old_leader != self.new_leader

    @property
    def replicas_to_add(self) -> Tuple[int, ...]:
        old = {p.broker_id for p in self.old_replicas}
        return tuple(p.broker_id for p in self.new_replicas
                     if p.broker_id not in old)

    @property
    def replicas_to_remove(self) -> Tuple[int, ...]:
        new = {p.broker_id for p in self.new_replicas}
        return tuple(p.broker_id for p in self.old_replicas
                     if p.broker_id not in new)

    @property
    def inter_broker_data_to_move(self) -> float:
        return self.partition_size * len(self.replicas_to_add)

    @property
    def intra_broker_data_to_move(self) -> float:
        """Bytes moved between logdirs of one broker."""
        old_dirs = {r.broker_id: r.logdir for r in self.old_replicas}
        return self.partition_size * sum(
            1 for r in self.new_replicas
            if r.logdir is not None
            and old_dirs.get(r.broker_id) not in (None, r.logdir))

    def to_json(self) -> dict:
        return {
            "topicPartition": {"topic": self.partition.topic,
                               "partition": self.partition.partition},
            "oldLeader": self.old_leader,
            "oldReplicas": [p.broker_id for p in self.old_replicas],
            "newReplicas": [p.broker_id for p in self.new_replicas],
        }


def _ordered_placements(brokers, leaders, disks, row_valid, topology):
    """[M, RF] arrays reordered per row: leaders first, invalid slots
    last, stable within groups."""
    key = np.where(~row_valid, 2, np.where(leaders, 0, 1))
    order = np.argsort(key, axis=1, kind="stable")
    return (np.take_along_axis(brokers, order, axis=1),
            np.take_along_axis(leaders, order, axis=1),
            np.take_along_axis(disks, order, axis=1),
            np.take_along_axis(row_valid, order, axis=1))


def diff_proposals_host(init: dict, opt: dict, valid: np.ndarray,
                        base_disk: np.ndarray, part: np.ndarray,
                        topology: ClusterTopology,
                        partition_rows: np.ndarray
                        ) -> List[ExecutionProposal]:
    """Diff two placements (``replica_broker`` / ``replica_is_leader`` /
    optional ``replica_disk`` numpy arrays) into proposals: only
    partitions whose brokers, leader flags or disks changed appear."""
    if "replica_disk" not in init:
        no_disk = np.full(valid.shape[0], -1, dtype=np.int32)
        init = dict(init, replica_disk=no_disk)
        opt = dict(opt, replica_disk=no_disk)
    changed_r = valid & (
        (init["replica_broker"] != opt["replica_broker"])
        | (init["replica_is_leader"] != opt["replica_is_leader"])
        | (init["replica_disk"] != opt["replica_disk"]))
    if not changed_r.any():
        return []
    changed_p = np.unique(part[changed_r])

    rows_mat = partition_rows[changed_p]
    row_valid = rows_mat >= 0
    rows_safe = np.maximum(rows_mat, 0)

    old_b, old_l, old_d, _ = _ordered_placements(
        init["replica_broker"][rows_safe], init["replica_is_leader"][rows_safe],
        init["replica_disk"][rows_safe], row_valid, topology)
    new_b, _, new_d, _ = _ordered_placements(
        opt["replica_broker"][rows_safe], opt["replica_is_leader"][rows_safe],
        opt["replica_disk"][rows_safe], row_valid, topology)

    sizes = np.where(row_valid, base_disk[rows_safe], 0.0).max(axis=1)
    broker_ids = np.asarray(topology.broker_ids)
    old_bid = broker_ids[old_b]
    new_bid = broker_ids[new_b]
    old_leader = np.where(old_l[:, 0], old_bid[:, 0], -1)

    disk_names = topology.disk_names
    place_cache: dict = {}

    def place(b: int, d: int) -> ReplicaPlacement:
        p = place_cache.get((b, d))
        if p is None:
            p = ReplicaPlacement(b, disk_names[d][1] if d >= 0 else None)
            place_cache[(b, d)] = p
        return p

    n_valid = row_valid.sum(axis=1).tolist()
    old_bid_l, new_bid_l = old_bid.tolist(), new_bid.tolist()
    old_d_l, new_d_l = old_d.tolist(), new_d.tolist()
    sizes_l = sizes.tolist()
    old_leader_l = old_leader.tolist()
    partitions = topology.partitions
    proposals = []
    for m, p_idx in enumerate(changed_p.tolist()):
        n = n_valid[m]
        ob, od = old_bid_l[m], old_d_l[m]
        nb, nd = new_bid_l[m], new_d_l[m]
        proposals.append(ExecutionProposal(
            partition=partitions[p_idx],
            old_leader=old_leader_l[m],
            old_replicas=tuple(place(ob[i], od[i]) for i in range(n)),
            new_replicas=tuple(place(nb[i], nd[i]) for i in range(n)),
            partition_size=sizes_l[m],
        ))
    return proposals
