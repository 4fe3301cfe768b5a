"""Joint multi-resource pre-balance (port of cruise_control_tpu/analyzer/
prebalance.py).

Runs once before the first goal: every over-band broker sheds its
most-violated dimension per round, and every arrival is gated against
all four resource bands, the capacity thresholds, the replica-count band
and rack awareness at once.  It runs exactly the kernels the goals use
(K1 candidate selection, K2 assignment passes, K3 commit).
"""
from __future__ import annotations

from typing import Tuple

import torch

from cruise_control_tpu_torch.analyzer import kernels
from cruise_control_tpu_torch.analyzer.context import (OptimizationContext,
                                                       RoundCache,
                                                       ensure_full_cache)
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES
from cruise_control_tpu_torch.model.state import ClusterState

#: candidates per over-band source broker per round
PER_SRC_K = 8


def _bands(state: ClusterState, ctx: OptimizationContext):
    """(upper, lower, mid) f32[B, RES] absolute load bounds: the balance
    band capped by the capacity threshold."""
    cap = state.broker_capacity
    upper_pct = torch.minimum(ctx.balance_upper_pct, ctx.capacity_threshold)
    upper = upper_pct[None, :] * cap
    lower = ctx.balance_lower_pct[None, :] * cap
    return upper, lower, (upper + lower) * 0.5


def _count_bounds(state: ClusterState, counts: torch.Tensor,
                  count_margin: float, max_per_broker: int):
    """Replica-count band (the count goal's limit math) with the upper
    bound capped by the per-broker replica limit."""
    from cruise_control_tpu_torch.analyzer.goals.count_distribution import \
        _count_bounds as goal_count_bounds
    alive = state.broker_alive
    avg = torch.sum(counts * alive) / torch.clamp_min(torch.sum(alive), 1)
    lower, upper = goal_count_bounds(avg, count_margin)
    return lower, torch.clamp_max(upper, float(max_per_broker))


def prebalance(state: ClusterState, ctx: OptimizationContext,
               count_margin: float = 0.09, max_rounds: int = 48,
               active_resources: Tuple[bool, ...] = (True,) * NUM_RESOURCES,
               balance_counts: bool = True,
               cache: RoundCache | None = None):
    """Run the joint pre-balance rounds; returns (state, rounds_used,
    final RoundCache).  `active_resources` / `balance_counts` restrict
    which dimensions are SHED; arrivals are gated by every dimension."""
    from cruise_control_tpu_torch.analyzer.goals.base import (
        new_broker_dest_mask, shed_rows)

    cache = ensure_full_cache(state, ctx, cache)
    if ctx.table_slots == 0:
        return state, 0, cache

    num_b = state.num_brokers
    res_ax = NUM_RESOURCES
    dev = state.device
    active = torch.tensor(active_resources, device=dev)
    inf = torch.full((), float("inf"), device=dev)

    def round_body(st: ClusterState, cache: RoundCache):
        cap = torch.clamp_min(st.broker_capacity, 1e-9)
        W = cache.broker_load
        upper, lower, mid = _bands(st, ctx)
        counts = cache.replica_count.float()
        c_lower, c_upper = _count_bounds(st, counts, count_margin,
                                         ctx.max_replicas_per_broker)

        rel_excess = torch.where(active[None, :], (W - upper) / cap, -inf)
        count_excess = ((counts - c_upper)
                        / torch.clamp_min(c_upper, 1.0))[:, None]
        if not balance_counts:
            count_excess = torch.full_like(count_excess, -float("inf"))
        rel_all = torch.cat([rel_excess, count_excess], 1)
        mx_all, primary = torch.max(rel_all, 1)
        src_ok = st.broker_alive & (mx_all > 0.0)
        excess_all = torch.cat([W - upper, (counts - c_upper)[:, None]], 1)
        excess_b = torch.gather(excess_all, 1, primary[:, None])[:, 0]

        # --- candidate selection: shed the primary dimension per row ---
        prim_onehot = torch.nn.functional.one_hot(
            primary, res_ax + 1).to(cache.table_load.dtype)
        w_rows = (torch.sum(cache.table_load
                            * prim_onehot[:, None, :res_ax], 2)
                  + prim_onehot[:, None, res_ax])
        sc = shed_rows(cache, w_rows, src_ok, excess_b)
        kk = min(PER_SRC_K, max(cache.broker_table.shape[1], 1))
        cand_r, cand_has, _ = kernels.rows_pick_topk(cache, sc, kk)
        cand_r_safe = torch.clamp_min(cand_r, 0).long()
        load_c = cache.replica_load[cand_r_safe]
        src_b = torch.arange(num_b, device=dev).repeat_interleave(kk)
        prim_c = primary[src_b]
        load_c_ext = torch.cat(
            [load_c, torch.ones((load_c.shape[0], 1), device=dev)], 1)
        cand_w = torch.gather(load_c_ext, 1, prim_c[:, None])[:, 0]

        # --- source-side prefix gating (pessimistic): the primary excess,
        # every resource's lower-band floor, then the count floor (weights
        # 1.0) ---
        room = W - lower
        cand_has = kernels.prefix_gate(
            cand_has, cand_w, excess_b, cand_r,
            [(cache.replica_load[:, res], room[:, res])
             for res in range(res_ax)] + [(None, counts - c_lower)], kk)

        # --- destination side ---
        dest_ok = new_broker_dest_mask(st, ctx.broker_dest_ok
                                       & st.broker_alive)
        dest_ok = dest_ok & (cache.table_fill < cache.broker_table.shape[1])
        dest_cap = (cache.broker_table.shape[1]
                    - cache.table_fill).to(torch.int32)
        dest_pref = -torch.max(W / torch.clamp_min(upper, 1e-9), 1).values
        cap_c = cap[src_b]
        cap_c_ext = torch.cat(
            [cap_c, torch.clamp_min(c_upper, 1.0).expand(cap_c.shape[0], 1)],
            1)
        gain = cand_w / torch.gather(cap_c_ext, 1, prim_c[:, None])[:, 0]

        prc = cache.partition_rack_count
        (_, gain, cand_has, cand_r, cand_r_safe, cand_w,
         load_c) = kernels.compact_candidates(
            kernels.CAND_COMPACT, gain, cand_has, cand_r, cand_r_safe,
            cand_w, load_c)
        part_c = st.replica_partition[cand_r_safe].long()
        rack_free_c = (prc[part_c] == 0).float()

        def accept(r, d):
            """bool[C, K]: every resource fits under the destination's
            upper bound, the count band holds, and the destination's
            rack holds no copy of the partition (an exact 0/1 matmul)."""
            d_ids = d[0]
            fits = torch.all(load_c[:, None, :] <= (upper - W)[d_ids][None],
                             -1)
            fits &= (counts[d_ids] + 1 <= c_upper)[None, :]
            rack_oh = torch.nn.functional.one_hot(
                st.broker_rack[d_ids].long(), prc.shape[1]).float()
            fits &= torch.matmul(rack_free_c, rack_oh.T) > 0.5
            return fits

        def assign_with(dest_ids):
            pref = kernels.assign_pref(st, cand_r_safe, dest_ids, dest_ok,
                                       dest_pref, accept,
                                       ctx.partition_replicas, cand_has)
            d_terms = [(load_c[:, res], (mid - W)[:, res])
                       for res in range(res_ax)]
            d_terms.append((torch.ones_like(cand_w), c_upper - counts))
            return kernels.assign_destinations(
                pref, gain, cand_has, num_b, dest_ids,
                dest_terms=d_terms, dest_cap=dest_cap)

        cand_dest, cand_valid = kernels._assign_with_escalation(
            assign_with, dest_ok, dest_pref, cand_has, num_b)
        cand_valid = kernels.resolve_dest_conflicts(
            part_c, gain, cand_valid, st.num_partitions)
        st, cache = kernels.commit_moves_cached(st, cache, cand_r,
                                                cand_dest, cand_valid)
        return st, cache, torch.any(cand_valid)

    def work(st: ClusterState, cache: RoundCache) -> bool:
        upper, _, _ = _bands(st, ctx)
        over = torch.any((cache.broker_load > upper) & active[None, :], 1)
        if balance_counts:
            counts = cache.replica_count.float()
            _, c_upper = _count_bounds(st, counts, count_margin,
                                       ctx.max_replicas_per_broker)
            over = over | (counts > c_upper)
        return bool(torch.any(st.broker_alive & over))

    rounds = 0
    progressed = True
    while progressed and rounds < max_rounds and work(state, cache):
        state, cache, committed = round_body(state, cache)
        progressed = bool(committed)
        rounds += 1
    return state, rounds, cache
