"""Cluster model statistics (port of cruise_control_tpu/model/stats.py):
avg/max/min/st.dev of utilization and count distributions over alive
brokers, in one pass of tensor reductions."""
from __future__ import annotations

import dataclasses

import torch

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES
from cruise_control_tpu_torch import ops
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
    """The reference's `_stats_from`: per column, the alive-broker total,
    average, max, min and population st.dev (the topics' st.devs then
    averaged).  Each column's sums are the reference's 1-d or axis-0
    `jnp.sum` in XLA:CPU's order (`ops.sum_f32`), so one sum over the
    stacked [B, RES + 3 + T] columns gives the same bits as one per
    column, in three launches on the card."""
    alive = state.broker_alive
    alive_col = alive[:, None]
    num_t = topic_counts.shape[1]
    cols = torch.cat([util, replica_counts[:, None], leader_counts[:, None],
                      topic_counts, pot_nw[:, None]], 1)
    count = torch.clamp_min(torch.sum(alive), 1)
    totals = ops.sum_f32(cols * alive_col)
    avg = totals[:-1] / count
    zero = torch.zeros((), device=util.device)
    var = ops.sum_f32(torch.where(alive_col, (cols[:, :-1] - avg) ** 2,
                                  zero)) / count
    # correctly rounded, as XLA and the card round it: torch's CPU sqrt
    # can miss the nearest float32 by an ulp; a float64 root rounded to
    # float32 cannot (53 >= 2 * 24 + 2 bits)
    std = torch.sqrt(var.double()).float()
    inf = torch.full((), float("inf"), device=util.device)
    vmax = torch.amax(torch.where(alive_col, cols, -inf), 0)
    vmin = torch.amin(torch.where(alive_col, cols[:, :-1], inf), 0)

    res = slice(0, NUM_RESOURCES)
    rc, lc = NUM_RESOURCES, NUM_RESOURCES + 1
    t_std = std[NUM_RESOURCES + 2:]
    # the mean divides by a tensor: the card divides a tensor by a Python
    # number as a product with its reciprocal, which rounds differently
    num_t = torch.full((), float(num_t), device=util.device)
    return ClusterModelStats(
        util_avg=avg[res], util_max=vmax[res], util_min=vmin[res],
        util_std=std[res],
        replica_count_avg=avg[rc], replica_count_max=vmax[rc],
        replica_count_min=vmin[rc], replica_count_std=std[rc],
        leader_count_std=std[lc],
        topic_replica_count_std=ops.sum_f32(t_std) / num_t,
        potential_nw_out_max=vmax[-1], potential_nw_out_total=totals[-1],
        num_alive_brokers=torch.sum(alive).to(torch.int32),
        num_replicas=torch.sum(state.replica_valid).to(torch.int32),
        num_offline_replicas=torch.sum(
            state.replica_valid & state.replica_offline).to(torch.int32),
    )
