"""Cluster model statistics (port of cruise_control_tpu/model/stats.py):
avg/max/min/st.dev of utilization and count distributions over alive
brokers, in one pass of tensor reductions."""
from __future__ import annotations

import dataclasses

import torch

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES
from cruise_control_tpu_torch.ops import sum_f32
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model.state import ClusterState


@dataclasses.dataclass(frozen=True)
class ClusterModelStats:
    """Comparable optimization statistics (0-d / [RES] tensors)."""

    util_avg: torch.Tensor
    util_max: torch.Tensor
    util_min: torch.Tensor
    util_std: torch.Tensor
    replica_count_avg: torch.Tensor
    replica_count_max: torch.Tensor
    replica_count_min: torch.Tensor
    replica_count_std: torch.Tensor
    leader_count_std: torch.Tensor
    topic_replica_count_std: torch.Tensor
    potential_nw_out_max: torch.Tensor
    potential_nw_out_total: torch.Tensor
    num_alive_brokers: torch.Tensor
    num_replicas: torch.Tensor
    num_offline_replicas: torch.Tensor

    def cpu(self) -> "ClusterModelStats":
        return ClusterModelStats(**{f.name: getattr(self, f.name).cpu()
                                    for f in dataclasses.fields(self)})


def _masked_stats(values: torch.Tensor, mask: torch.Tensor):
    count = torch.clamp_min(torch.sum(mask), 1)
    total = sum_f32(values * mask)
    avg = total / count
    inf = torch.full((), float("inf"), device=values.device)
    vmax = torch.max(torch.where(mask, values, -inf))
    vmin = torch.min(torch.where(mask, values, inf))
    var = sum_f32(torch.where(mask, (values - avg) ** 2,
                              torch.zeros((), device=values.device))
                  ) / count
    return avg, vmax, vmin, torch.sqrt(var)


def compute_stats(state: ClusterState) -> ClusterModelStats:
    """Everything ClusterModelStats exposes, from the state alone."""
    load = S.broker_load(state)
    cap = torch.clamp_min(state.broker_capacity, 1e-9)
    return _stats_from(
        state, load / cap,
        S.broker_replica_count(state).float(),
        S.broker_leader_count(state).float(),
        S.broker_topic_replica_count(state).float(),
        S.potential_leadership_load(state))


def compute_stats_fresh_loads(state: ClusterState,
                              cache) -> ClusterModelStats:
    """compute_stats with the float aggregates (utilization, potential
    NW_OUT) recomputed from state and the exact integer counts taken
    from the maintained RoundCache."""
    load = S.broker_load(state)
    cap = torch.clamp_min(state.broker_capacity, 1e-9)
    return _stats_from(
        state, load / cap,
        cache.replica_count.float(),
        cache.leader_count.float(),
        cache.broker_topic_count.float(),
        S.potential_leadership_load(state))


def _stats_from(state: ClusterState, util, replica_counts, leader_counts,
                topic_counts, pot_nw) -> ClusterModelStats:
    alive = state.broker_alive
    parts = [_masked_stats(util[:, res], alive)
             for res in range(NUM_RESOURCES)]
    avg, vmax, vmin, vstd = (torch.stack([p[i] for p in parts])
                             for i in range(4))
    rc_avg, rc_max, rc_min, rc_std = _masked_stats(replica_counts, alive)
    _, _, _, lc_std = _masked_stats(leader_counts, alive)

    # st.dev of per-broker replica count within each topic, averaged
    t_count = torch.clamp_min(torch.sum(alive), 1)
    t_avg = sum_f32(topic_counts * alive[:, None]) / t_count
    t_var = sum_f32(torch.where(alive[:, None],
                                (topic_counts - t_avg[None, :]) ** 2,
                                torch.zeros((), device=util.device))
                    ) / t_count
    t_std = torch.sqrt(t_var)
    topic_std = sum_f32(t_std) / t_std.shape[0]

    inf = torch.full((), float("inf"), device=util.device)
    pot_max = torch.max(torch.where(alive, pot_nw, -inf))
    pot_total = sum_f32(pot_nw * alive)
    return ClusterModelStats(
        util_avg=avg, util_max=vmax, util_min=vmin, util_std=vstd,
        replica_count_avg=rc_avg, replica_count_max=rc_max,
        replica_count_min=rc_min, replica_count_std=rc_std,
        leader_count_std=lc_std, topic_replica_count_std=topic_std,
        potential_nw_out_max=pot_max, potential_nw_out_total=pot_total,
        num_alive_brokers=torch.sum(alive).to(torch.int32),
        num_replicas=torch.sum(state.replica_valid).to(torch.int32),
        num_offline_replicas=torch.sum(
            state.replica_valid & state.replica_offline).to(torch.int32),
    )
