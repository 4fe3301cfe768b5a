"""JSON response builders for the REST API (port of cruise_control_tpu/api/
responses.py).

Reference CC/servlet/response/ (30 classes, ~2,900 LoC): BrokerStats for
LOAD, PartitionLoadState for PARTITION_LOAD, KafkaClusterState,
OptimizationResult for PROPOSALS/rebalance-style endpoints.  Re-designed
over the tensor ClusterState: every stat is a vectorized reduction instead
of the reference's per-broker object walks.  The state's tensors may lie on
the card: each field a body reads moves to the host once (`.cpu().numpy()`),
and the per-broker load is `state.broker_load`, which on the card is one
`segment_sum` (K12) launch.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np

from cruise_control_tpu_torch.analyzer.optimizer import OptimizerResult
from cruise_control_tpu_torch.cluster.types import ClusterSnapshot
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model.state import ClusterState
from cruise_control_tpu_torch.model.topology import ClusterTopology


def _host(t) -> np.ndarray:
    """A tensor's values on the host, in one transfer."""
    return t.detach().cpu().numpy()


def broker_stats(state: ClusterState, topology: ClusterTopology) -> dict:
    """LOAD endpoint body (reference response/stats/BrokerStats.java)."""
    load = _host(S.broker_load(state))                 # [B, RES]
    cap = _host(state.broker_capacity)
    alive = _host(state.broker_alive)
    rack = _host(state.broker_rack)
    rb = _host(state.replica_broker)
    valid = _host(state.replica_valid)
    leader = _host(state.replica_is_leader) & valid
    num_b = state.num_brokers
    replica_counts = np.bincount(rb[valid], minlength=num_b)
    leader_counts = np.bincount(rb[leader], minlength=num_b)
    util_pct = np.divide(load, np.maximum(cap, 1e-9)) * 100.0

    hosts: Dict[str, dict] = {}
    brokers = []
    for i, bid in enumerate(topology.broker_ids):
        row = {
            "Broker": bid,
            "Host": topology.broker_hosts[i]
            if hasattr(topology, "broker_hosts") else f"broker-{bid}",
            "Rack": topology.rack_ids[int(rack[i])],
            "BrokerState": "ALIVE" if alive[i] else "DEAD",
            "Replicas": int(replica_counts[i]),
            "Leaders": int(leader_counts[i]),
            "CpuPct": round(float(load[i, Resource.CPU]), 3),
            "NwInRate": round(float(load[i, Resource.NW_IN]), 3),
            "NwOutRate": round(float(load[i, Resource.NW_OUT]), 3),
            "DiskMB": round(float(load[i, Resource.DISK]), 3),
            "DiskPct": round(float(util_pct[i, Resource.DISK]), 3),
        }
        brokers.append(row)
        h = hosts.setdefault(row["Host"], {
            "Host": row["Host"], "Replicas": 0, "Leaders": 0,
            "CpuPct": 0.0, "NwInRate": 0.0, "NwOutRate": 0.0, "DiskMB": 0.0})
        h["Replicas"] += row["Replicas"]
        h["Leaders"] += row["Leaders"]
        for k in ("CpuPct", "NwInRate", "NwOutRate", "DiskMB"):
            h[k] = round(h[k] + row[k], 3)
    return {"brokers": brokers, "hosts": sorted(hosts.values(),
                                                key=lambda h: h["Host"])}


def partition_load(state: ClusterState, topology: ClusterTopology,
                   resource: int = Resource.DISK,
                   entries: Optional[int] = None,
                   topic_pattern: Optional[str] = None,
                   min_load: bool = False) -> List[dict]:
    """PARTITION_LOAD body: partitions sorted by leader-replica load on
    `resource`, descending (ascending when min_load)."""
    valid = _host(state.replica_valid)
    leader = _host(state.replica_is_leader) & valid
    part_of = _host(state.replica_partition)
    base = _host(state.replica_base_load)              # [R, RES]
    rb = _host(state.replica_broker)

    pat = re.compile(topic_pattern) if topic_pattern else None
    rows = []
    leader_rows = np.nonzero(leader)[0]
    order = np.argsort(base[leader_rows, resource])
    if not min_load:
        order = order[::-1]
    # group follower rows by partition once: a per-partition full-array
    # scan would make this endpoint O(partitions x replicas)
    f_rows = np.nonzero(valid & ~leader)[0]
    f_sorted = f_rows[np.argsort(part_of[f_rows], kind="stable")]
    f_parts = part_of[f_sorted]
    starts = np.searchsorted(f_parts, np.arange(
        int(part_of.max()) + 2 if part_of.size else 1))
    for r in leader_rows[order]:
        p = int(part_of[r])
        pid = topology.partitions[p]
        if pat is not None and not pat.match(pid.topic):
            continue
        follower_rows = f_sorted[starts[p]:starts[p + 1]]
        rows.append({
            "topic": pid.topic,
            "partition": pid.partition,
            "leader": topology.broker_ids[int(rb[r])],
            "followers": [topology.broker_ids[int(rb[f])]
                          for f in follower_rows],
            "cpu": round(float(base[r, Resource.CPU]), 4),
            "networkInbound": round(float(base[r, Resource.NW_IN]), 4),
            "networkOutbound": round(float(base[r, Resource.NW_OUT]), 4),
            "disk": round(float(base[r, Resource.DISK]), 4),
        })
        if entries is not None and len(rows) >= entries:
            break
    return rows


def kafka_cluster_state(snapshot: ClusterSnapshot) -> dict:
    """KAFKA_CLUSTER_STATE body (reference response/KafkaClusterState.java):
    raw metadata view — per-broker counts + per-topic partition detail."""
    leader_count: Dict[int, int] = {}
    replica_count: Dict[int, int] = {}
    out_of_sync: Dict[int, int] = {}
    offline: Dict[int, int] = {}
    for p in snapshot.partitions:
        if p.leader is not None:
            leader_count[p.leader] = leader_count.get(p.leader, 0) + 1
        for b in p.replicas:
            replica_count[b] = replica_count.get(b, 0) + 1
            if b not in p.in_sync:
                out_of_sync[b] = out_of_sync.get(b, 0) + 1
        for b in p.offline_replicas:
            offline[b] = offline.get(b, 0) + 1

    topics: Dict[str, dict] = {}
    for p in snapshot.partitions:
        t = topics.setdefault(p.tp.topic, {})
        t[str(p.tp.partition)] = {
            "leader": p.leader, "replicas": list(p.replicas),
            "in-sync": list(p.in_sync),
            "out-of-sync": [b for b in p.replicas if b not in p.in_sync],
            "offline": list(p.offline_replicas),
        }
    return {
        "KafkaBrokerState": {
            "LeaderCountByBrokerId":
                {str(b.broker_id): leader_count.get(b.broker_id, 0)
                 for b in snapshot.brokers},
            "ReplicaCountByBrokerId":
                {str(b.broker_id): replica_count.get(b.broker_id, 0)
                 for b in snapshot.brokers},
            "OutOfSyncCountByBrokerId":
                {str(b.broker_id): out_of_sync.get(b.broker_id, 0)
                 for b in snapshot.brokers if out_of_sync.get(b.broker_id)},
            "OfflineReplicaCountByBrokerId":
                {str(b.broker_id): offline.get(b.broker_id, 0)
                 for b in snapshot.brokers if offline.get(b.broker_id)},
            "IsController":
                {str(b.broker_id): b.broker_id == snapshot.controller_id
                 for b in snapshot.brokers},
        },
        "KafkaPartitionState": topics,
    }


def optimization_result(result: OptimizerResult,
                        verbose: bool = False) -> dict:
    """PROPOSALS / rebalance-style body (reference
    response/OptimizationResult.java)."""
    out = {
        "summary": {
            "numReplicaMovements": result.num_replica_movements,
            "numLeaderMovements": result.num_leadership_movements,
            "dataToMoveMB": round(result.data_to_move / 1e6, 3),
            "numProposals": len(result.proposals),
            "excludedTopics": [],
            "onDemandBalancednessScoreBefore": None,
            "onDemandBalancednessScoreAfter":
                round(result.balancedness_score(), 3),
            "provisionStatus": "UNDECIDED",
        },
        "goalSummary": [
            {"goal": name,
             "status": ("VIOLATED" if name in result.violated_goals_after
                        else "NO-ACTION" if name
                        in result.violated_goals_before else "FIXED")}
            for name in result.stats_by_goal],
        "violatedGoalsBefore": result.violated_goals_before,
        "violatedGoalsAfter": result.violated_goals_after,
    }
    if result.solver_provenance is not None:
        # which solver produced this answer (the reference's portfolio/):
        # absent for a plain greedy solve, which is every solve the port
        # makes until portfolio search is ported
        out["solverProvenance"] = dict(result.solver_provenance)
    if verbose:
        out["proposals"] = [p.to_json() for p in result.proposals]
    return out
