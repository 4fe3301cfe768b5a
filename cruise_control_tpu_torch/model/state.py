"""Tensorized cluster workload model (port of cruise_control_tpu/model/
state.py).

`ClusterState` is a frozen dataclass of tensors with the same fields and
dtypes as the reference pytree (int32 ids, bool flags, float32 loads)
plus the static `num_racks`, `num_hosts` and `num_topics`.  Each replica
carries its follower-role base load and each partition a leadership
bonus; the current load is ``base + is_leader * bonus``.

Segment sums go through `ops.segment_sum`: out-of-range ids land in a
spill row that is sliced off (JAX's ``mode="drop"``), and float sums add
in replica order, as the reference's scatter does.
"""
from __future__ import annotations

import dataclasses

import torch

from cruise_control_tpu_torch import ops
from cruise_control_tpu_torch.common.resources import Resource

#: CPU-attribution weights for follower load estimated from leader load
CPU_WEIGHT_LEADER_BYTES_IN = 0.7
CPU_WEIGHT_LEADER_BYTES_OUT = 0.15
CPU_WEIGHT_FOLLOWER_BYTES_IN = 0.15

#: tensor fields in declaration order (convert.py carries them across)
STATE_FIELDS = (
    "replica_valid", "replica_partition", "replica_broker", "replica_disk",
    "replica_is_leader", "replica_offline", "replica_original_offline",
    "replica_base_load", "partition_topic", "partition_leader_bonus",
    "broker_alive", "broker_new", "broker_demoted", "broker_bad_disks",
    "broker_capacity", "broker_rack", "broker_host", "disk_broker",
    "disk_capacity", "disk_alive")


@dataclasses.dataclass(frozen=True)
class ClusterState:
    """Immutable struct-of-tensors cluster model."""

    # --- replica axis (R) ---
    replica_valid: torch.Tensor          # bool[R]
    replica_partition: torch.Tensor      # i32[R]
    replica_broker: torch.Tensor         # i32[R]
    replica_disk: torch.Tensor           # i32[R], -1 if not JBOD
    replica_is_leader: torch.Tensor      # bool[R]
    replica_offline: torch.Tensor        # bool[R]
    replica_original_offline: torch.Tensor  # bool[R]
    replica_base_load: torch.Tensor      # f32[R, RES] follower-role load
    # --- partition axis (P) ---
    partition_topic: torch.Tensor        # i32[P]
    partition_leader_bonus: torch.Tensor  # f32[P, RES]
    # --- broker axis (B) ---
    broker_alive: torch.Tensor           # bool[B]
    broker_new: torch.Tensor             # bool[B]
    broker_demoted: torch.Tensor         # bool[B]
    broker_bad_disks: torch.Tensor       # bool[B]
    broker_capacity: torch.Tensor        # f32[B, RES]
    broker_rack: torch.Tensor            # i32[B]
    broker_host: torch.Tensor            # i32[B]
    # --- disk axis (D) ---
    disk_broker: torch.Tensor            # i32[D]
    disk_capacity: torch.Tensor          # f32[D]
    disk_alive: torch.Tensor             # bool[D]
    # --- static metadata ---
    num_racks: int = 1
    num_hosts: int = 1
    num_topics: int = 1

    @property
    def num_replicas(self) -> int:
        return self.replica_broker.shape[0]

    @property
    def num_partitions(self) -> int:
        return self.partition_topic.shape[0]

    @property
    def num_brokers(self) -> int:
        return self.broker_capacity.shape[0]

    @property
    def num_disks(self) -> int:
        return self.disk_broker.shape[0]

    @property
    def device(self) -> torch.device:
        return self.replica_broker.device

    def replace(self, **kwargs) -> "ClusterState":
        return dataclasses.replace(self, **kwargs)

    def to(self, device) -> "ClusterState":
        return self.replace(**{f: getattr(self, f).to(device)
                               for f in STATE_FIELDS})


# ---------------------------------------------------------------------------
# Load queries
# ---------------------------------------------------------------------------

def replica_current_load(state: ClusterState) -> torch.Tensor:
    """f32[R, RES] — each replica's load in its current role."""
    bonus = state.partition_leader_bonus[state.replica_partition]
    load = (state.replica_base_load
            + state.replica_is_leader[:, None] * bonus)
    return load * state.replica_valid[:, None]


def replica_leader_role_load(state: ClusterState) -> torch.Tensor:
    """f32[R, RES] — the load each replica would carry as leader."""
    bonus = state.partition_leader_bonus[state.replica_partition]
    return (state.replica_base_load + bonus) * state.replica_valid[:, None]


def broker_load(state: ClusterState) -> torch.Tensor:
    """f32[B, RES] — per-broker utilization."""
    return ops.segment_sum(replica_current_load(state), state.replica_broker,
                           state.num_brokers)


def host_load(state: ClusterState) -> torch.Tensor:
    return ops.segment_sum(broker_load(state), state.broker_host,
                           state.num_hosts)


def rack_load(state: ClusterState) -> torch.Tensor:
    return ops.segment_sum(broker_load(state), state.broker_rack,
                           state.num_racks)


def broker_replica_count(state: ClusterState) -> torch.Tensor:
    """i32[B] — replicas per broker."""
    return ops.segment_sum(state.replica_valid.to(torch.int32),
                           state.replica_broker, state.num_brokers)


def broker_leader_count(state: ClusterState) -> torch.Tensor:
    """i32[B] — leader replicas per broker."""
    leaders = (state.replica_valid & state.replica_is_leader).to(torch.int32)
    return ops.segment_sum(leaders, state.replica_broker, state.num_brokers)


def broker_topic_replica_count(state: ClusterState) -> torch.Tensor:
    """i32[B, T] — per-broker per-topic replica counts."""
    topic = state.partition_topic[state.replica_partition]
    flat = state.replica_broker * state.num_topics + topic
    counts = ops.segment_sum(state.replica_valid.to(torch.int32), flat,
                             state.num_brokers * state.num_topics)
    return counts.reshape(state.num_brokers, state.num_topics)


def partition_rack_count(state: ClusterState) -> torch.Tensor:
    """i32[P, K] — replicas of each partition per rack."""
    rack = state.broker_rack[state.replica_broker]
    flat = state.replica_partition * state.num_racks + rack
    counts = ops.segment_sum(state.replica_valid.to(torch.int32), flat,
                             state.num_partitions * state.num_racks)
    return counts.reshape(state.num_partitions, state.num_racks)


def partition_replication_factor(state: ClusterState) -> torch.Tensor:
    """i32[P] — replica count per partition."""
    return ops.segment_sum(state.replica_valid.to(torch.int32),
                           state.replica_partition, state.num_partitions)


def potential_leadership_load(state: ClusterState) -> torch.Tensor:
    """f32[B] — NW_OUT a broker would serve if it led every partition it
    hosts a replica of."""
    leader_nw_out = (replica_leader_role_load(state)[:, Resource.NW_OUT]
                     * state.replica_valid)
    return ops.segment_sum(leader_nw_out, state.replica_broker,
                           state.num_brokers)


def utilization_matrix(state: ClusterState) -> torch.Tensor:
    """f32[RES, B] utilization over alive brokers (0 for dead ones)."""
    load = broker_load(state)
    cap = torch.clamp_min(state.broker_capacity, 1e-9)
    return torch.where(state.broker_alive[None, :], (load / cap).T,
                       torch.zeros((), device=load.device))


# ---------------------------------------------------------------------------
# Mutation
# ---------------------------------------------------------------------------

def apply_moves(state: ClusterState, replicas: torch.Tensor,
                dest_brokers: torch.Tensor,
                valid: torch.Tensor) -> ClusterState:
    """Batched replica relocation: commit K (replica -> dest) moves at
    once.  Invalid rows (and no-op moves to the current broker) are
    routed to a spill row and dropped."""
    replicas = replicas.long()
    num_r = state.num_replicas
    tgt = dest_brokers.to(torch.int32)
    valid = valid & (state.replica_broker[replicas] != tgt)
    idx = torch.where(valid, replicas, torch.full_like(replicas, num_r))
    new_broker = ops.scatter_set(state.replica_broker, idx, tgt)
    new_disk = ops.scatter_set(state.replica_disk, idx,
                               torch.full_like(tgt, -1))
    new_offline = ops.scatter_set(state.replica_offline, idx,
                                  ~state.broker_alive[tgt.long()])
    return state.replace(replica_broker=new_broker, replica_disk=new_disk,
                         replica_offline=new_offline)


def transfer_leadership(state: ClusterState, src_replica,
                        dest_replica) -> ClusterState:
    """Move one partition's leadership from `src_replica` to
    `dest_replica`: the leader-role load follows the flag."""
    flags = state.replica_is_leader.clone()
    flags[src_replica] = False
    flags[dest_replica] = True
    return state.replace(replica_is_leader=flags)


def apply_leadership_transfers(state: ClusterState,
                               src_replicas: torch.Tensor,
                               dest_replicas: torch.Tensor,
                               valid: torch.Tensor) -> ClusterState:
    """Batched leadership transfer: K (leader -> follower) handoffs at
    once.  Invalid rows are routed to a spill row and dropped."""
    num_r = state.num_replicas
    spill = torch.full_like(src_replicas, num_r).long()
    src = torch.where(valid, src_replicas.long(), spill)
    dst = torch.where(valid, dest_replicas.long(), spill)
    flags = ops.scatter_set(state.replica_is_leader, src,
                            torch.zeros_like(valid))
    flags = ops.scatter_set(flags, dst, torch.ones_like(valid))
    return state.replace(replica_is_leader=flags)


def set_broker_state(state: ClusterState, broker: int, *,
                     alive: bool = None, new: bool = None,
                     demoted: bool = None,
                     bad_disks: bool = None) -> ClusterState:
    """Broker state change.  Killing a broker marks its replicas offline;
    reviving one keeps the replicas on its broken logdirs offline."""
    def set_at(flags: torch.Tensor, value: bool) -> torch.Tensor:
        out = flags.clone()
        out[broker] = value
        return out

    updates = {}
    if alive is not None:
        updates["broker_alive"] = set_at(state.broker_alive, alive)
        on_broker = (state.replica_broker == broker) & state.replica_valid
        on_dead_disk = ((state.replica_disk >= 0) & ~state.disk_alive[
            torch.clamp_min(state.replica_disk, 0).long()])
        now_offline = on_dead_disk if alive else torch.ones_like(on_broker)
        updates["replica_offline"] = torch.where(on_broker, now_offline,
                                                 state.replica_offline)
        if not alive:
            updates["replica_original_offline"] = (
                state.replica_original_offline | on_broker)
    if new is not None:
        updates["broker_new"] = set_at(state.broker_new, new)
    if demoted is not None:
        updates["broker_demoted"] = set_at(state.broker_demoted, demoted)
    if bad_disks is not None:
        updates["broker_bad_disks"] = set_at(state.broker_bad_disks,
                                             bad_disks)
    return state.replace(**updates)


def mark_disk_dead(state: ClusterState, disk: int) -> ClusterState:
    """Mark one logdir broken: its replicas go offline while the broker
    stays alive with bad disks."""
    disk_alive = state.disk_alive.clone()
    disk_alive[disk] = False
    on_disk = (state.replica_disk == disk) & state.replica_valid
    bad = state.broker_bad_disks.clone()
    bad[int(state.disk_broker[disk])] = True
    return state.replace(
        disk_alive=disk_alive,
        replica_offline=state.replica_offline | on_disk,
        replica_original_offline=state.replica_original_offline | on_disk,
        broker_bad_disks=bad)


def partition_leader_replica(state: ClusterState) -> torch.Tensor:
    """i32[P] — replica index of each partition's leader, -1 if none."""
    r_idx = torch.arange(state.num_replicas, dtype=torch.int32,
                         device=state.device)
    is_leader = state.replica_valid & state.replica_is_leader
    return ops.segment_max(torch.where(is_leader, r_idx,
                                       torch.full_like(r_idx, -1)),
                           state.replica_partition, state.num_partitions)


# ---------------------------------------------------------------------------
# Derived statistics helpers
# ---------------------------------------------------------------------------

def cluster_capacity(state: ClusterState) -> torch.Tensor:
    """f32[RES] — total capacity over alive brokers."""
    return ops.sum_f32(state.broker_capacity * state.broker_alive[:, None])


def cluster_load(state: ClusterState) -> torch.Tensor:
    """f32[RES] — total expected utilization."""
    return ops.sum_f32(replica_current_load(state))


def average_utilization_percentage(state: ClusterState) -> torch.Tensor:
    """f32[RES] — cluster load / cluster capacity, the pivot of the
    balance thresholds (both sums in the reference's order, so the
    thresholds are the reference's to the bit)."""
    return cluster_load(state) / torch.clamp_min(cluster_capacity(state),
                                                 1e-9)


def self_healing_eligible(state: ClusterState) -> torch.Tensor:
    """bool[R] — replicas that must move: currently offline."""
    return state.replica_valid & state.replica_offline
