"""Cluster model invariant checker (port of cruise_control_tpu/model/
sanity.py).  Runs on host numpy copies and raises AssertionError naming
the violated invariant."""
from __future__ import annotations

import numpy as np

from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model.state import ClusterState


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def sanity_check(state: ClusterState, allow_offline: bool = True) -> None:
    """Structural and load-accounting invariants: indices in range, one
    leader per partition, no two replicas of a partition on one broker,
    offline flags consistent with liveness, disks on their brokers, and
    broker/host/rack load sums equal to the cluster load."""
    valid = _np(state.replica_valid)
    part = _np(state.replica_partition)[valid]
    broker = _np(state.replica_broker)[valid]
    leader = _np(state.replica_is_leader)[valid]
    offline = _np(state.replica_offline)[valid]
    disk = _np(state.replica_disk)[valid]
    alive = _np(state.broker_alive)
    num_b = state.num_brokers
    num_p = state.num_partitions

    if valid.sum() == 0:
        return
    if broker.min() < 0 or broker.max() >= num_b:
        raise AssertionError("replica assigned to nonexistent broker")
    if part.min() < 0 or part.max() >= num_p:
        raise AssertionError("replica assigned to nonexistent partition")

    leaders_per_p = np.bincount(part[leader], minlength=num_p)
    present = np.bincount(part, minlength=num_p) > 0
    if np.any(present & (leaders_per_p != 1)):
        bad = np.nonzero(present & (leaders_per_p != 1))[0][:5]
        raise AssertionError(f"partitions without exactly one leader: {bad}")

    pairs = part.astype(np.int64) * num_b + broker
    if len(np.unique(pairs)) != len(pairs):
        raise AssertionError("broker holds multiple replicas of one partition")

    on_dead = ~alive[broker]
    if np.any(on_dead & ~offline):
        raise AssertionError("replica on dead broker not marked offline")
    if not allow_offline and np.any(offline):
        raise AssertionError("offline replicas remain after self-healing")

    has_disk = disk >= 0
    if np.any(has_disk):
        disk_broker = _np(state.disk_broker)
        if np.any(disk_broker[disk[has_disk]] != broker[has_disk]):
            raise AssertionError("replica disk not on its broker")

    b_load = _np(S.broker_load(state))
    h_load = _np(S.host_load(state))
    k_load = _np(S.rack_load(state))
    r_load = _np(S.replica_current_load(state))[valid]
    total = r_load.sum(axis=0)
    for agg, name in ((b_load, "broker"), (h_load, "host"), (k_load, "rack")):
        agg_total = agg.sum(axis=0)
        for res in Resource.cached_values():
            eps = res.epsilon(float(total[res]), float(agg_total[res]))
            if abs(float(total[res]) - float(agg_total[res])) > eps:
                raise AssertionError(
                    f"{name} load sum {agg_total[res]} != cluster load "
                    f"{total[res]} for {res.name}")

    follower_nw_out = r_load[~leader][:, Resource.NW_OUT]
    if follower_nw_out.size and follower_nw_out.max() > 1e-4:
        raise AssertionError("follower replica carries NW_OUT load")
