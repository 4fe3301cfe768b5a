"""Resource utilization distribution goals (port of cruise_control_tpu/
analyzer/goals/resource_distribution.py): keep every alive broker's
utilization of one resource within the balance band around the average.

This slice of the port covers the resources that do not travel with
leadership (DISK, NW_IN): their search runs the move phases (b: shed
over-limit, c: fill under-limit) and the two swap phases.  CPU and NW_OUT
also need the leadership search, which a later slice ports.
"""
from __future__ import annotations

from typing import Sequence

import torch

from cruise_control_tpu_torch.analyzer import kernels
from cruise_control_tpu_torch.analyzer.context import (OptimizationContext,
                                                       ensure_full_cache,
                                                       replica_static_ok)
from cruise_control_tpu_torch.analyzer.goals.base import (
    Goal, compose_move_acceptance, compose_swap_acceptance, dest_side_only,
    move_commit_terms, new_broker_dest_mask, run_phase_sweeps, shed_rows)
from cruise_control_tpu_torch.common.resources import (RESOURCE_GOAL_NAMES,
                                                       Resource)
from cruise_control_tpu_torch.model.state import ClusterState


class ResourceDistributionGoal(Goal):
    """Balance one resource's utilization across alive brokers."""

    resource: Resource = Resource.DISK
    is_hard = False

    def __init__(self, max_rounds: int = 64, max_swap_rounds: int = 16):
        if self._leadership_applicable():
            raise NotImplementedError(
                f"{RESOURCE_GOAL_NAMES[int(self.resource)]}"
                "UsageDistributionGoal needs the leadership search "
                "(leadership_round, global_leadership_sweep), which the "
                "next slice of the port brings")
        self.max_rounds = max_rounds
        self.max_swap_rounds = max_swap_rounds
        self.name = (RESOURCE_GOAL_NAMES[int(self.resource)]
                     + "UsageDistributionGoal")

    def _bounds(self, state: ClusterState, ctx: OptimizationContext):
        """Absolute per-broker [lower, upper] load bounds."""
        res = int(self.resource)
        cap = state.broker_capacity[:, res]
        return ctx.balance_lower_pct[res] * cap, ctx.balance_upper_pct[res] * cap

    def _leadership_applicable(self) -> bool:
        return self.resource in (Resource.NW_OUT, Resource.CPU)

    @staticmethod
    def _dest_mask(st: ClusterState, ctx: OptimizationContext):
        return new_broker_dest_mask(st, ctx.broker_dest_ok & st.broker_alive)

    def optimize_cached(self, state: ClusterState, ctx: OptimizationContext,
                        prev_goals: Sequence[Goal], cache=None):
        """Shed replicas of over-limit brokers, then fill under-limit
        ones, then swap, as progress-gated sub-loops of a sweep loop."""
        res = int(self.resource)
        lower, upper = self._bounds(state, ctx)
        base_movable = replica_static_ok(state, ctx)
        cap_res = torch.clamp_min(state.broker_capacity[:, res], 1e-9)

        def phase_b(st, cache):
            W = cache.broker_load[:, res]
            w = cache.replica_load[:, res]
            movable = base_movable & (w > 0.0)
            accept = compose_move_acceptance(prev_goals, st, ctx, cache)
            mt_d, mt_s = move_commit_terms(prev_goals, st, ctx, cache)
            cand_r, cand_d, cand_v = kernels.move_round(
                st, w, W > upper, W - upper, movable,
                self._dest_mask(st, ctx), upper - W, accept,
                -W / cap_res, ctx.partition_replicas, cache=cache,
                sc_rows=shed_rows(cache, cache.table_load[:, :, res],
                                  W > upper, W - upper),
                per_src_k=4 if (mt_d is not None
                                or dest_side_only(prev_goals)) else 1,
                dest_terms=mt_d, src_terms=mt_s,
                dest_stack_headroom=(upper + lower) / 2.0 - W)
            st, cache = kernels.commit_moves_cached(st, cache, cand_r,
                                                    cand_d, cand_v)
            return st, cache, torch.any(cand_v)

        def phase_c(st, cache):
            W = cache.broker_load[:, res]
            w = cache.replica_load[:, res]
            avg_w = ((ctx.balance_upper_pct[res] + ctx.balance_lower_pct[res])
                     / 2.0 * st.broker_capacity[:, res])
            movable = base_movable & (w > 0.0)
            accept = compose_move_acceptance(prev_goals, st, ctx, cache)
            under = (W < lower) & self._dest_mask(st, ctx)
            mt_d, mt_s = move_commit_terms(prev_goals, st, ctx, cache)
            cand_r, cand_d, cand_v = kernels.move_round(
                st, w, W > avg_w, W - lower, movable, under, upper - W,
                accept, -W / cap_res, ctx.partition_replicas,
                strict_allowance=True, cache=cache,
                sc_rows=shed_rows(cache, cache.table_load[:, :, res],
                                  W > avg_w, W - lower, strict=True),
                per_src_k=4 if mt_d is not None else 1,
                dest_terms=mt_d, src_terms=mt_s,
                dest_stack_headroom=(upper + lower) / 2.0 - W)
            st, cache = kernels.commit_moves_cached(st, cache, cand_r,
                                                    cand_d, cand_v)
            return st, cache, torch.any(cand_v)

        def swap_phase(hot_of, cold_of):
            def phase(st, cache):
                W = cache.broker_load[:, res]
                w = cache.replica_load[:, res]
                movable = base_movable & (w > 0.0)
                accept = compose_swap_acceptance(prev_goals, st, ctx, cache)
                target = (upper + lower) / 2.0
                out_r, in_r, cold_idx, valid = kernels.swap_round(
                    st, w, movable, hot_of(st, W, target),
                    cold_of(st, W, target), W, target, accept,
                    ctx.partition_replicas, cache=cache,
                    w_rows=cache.table_load[:, :, res],
                    lower=lower, upper=upper)
                st, cache = kernels.commit_swaps_cached(
                    st, cache, out_r, in_r, cold_idx, valid)
                return st, cache, torch.any(valid)
            return phase

        # swap: over-limit brokers trade with below-target ones;
        # swap-under: below-lower brokers trade with above-target ones
        phase_swap = swap_phase(
            lambda st, W, t: st.broker_alive & (W > upper),
            lambda st, W, t: self._dest_mask(st, ctx) & (W < t))
        phase_swap_under = swap_phase(
            lambda st, W, t: st.broker_alive & (W > t),
            lambda st, W, t: self._dest_mask(st, ctx) & (W < lower))

        def over_exists(st, cache):
            return torch.any(st.broker_alive
                             & (cache.broker_load[:, res] > upper))

        def under_exists(st, cache):
            return torch.any(self._dest_mask(st, ctx)
                             & (cache.broker_load[:, res] < lower))

        def swap_work_exists(st, cache):
            W = cache.broker_load[:, res]
            target = (upper + lower) / 2.0
            return (torch.any(st.broker_alive & (W > upper))
                    & torch.any(self._dest_mask(st, ctx) & (W < target)))

        def swap_under_work_exists(st, cache):
            W = cache.broker_load[:, res]
            target = (upper + lower) / 2.0
            return (torch.any(self._dest_mask(st, ctx) & (W < lower))
                    & torch.any(st.broker_alive & (W > target)))

        phases = [(phase_b, over_exists), (phase_c, under_exists)]
        if self.max_swap_rounds and not ctx.fast_mode:
            phases.append((phase_swap, swap_work_exists,
                           self.max_swap_rounds))
            phases.append((phase_swap_under, swap_under_work_exists,
                           self.max_swap_rounds))
        return run_phase_sweeps(state, phases, self.rounds_for(ctx),
                                table_slots=ctx.table_slots, ctx=ctx,
                                cache=ensure_full_cache(state, ctx, cache))

    def no_work(self, state, ctx, cache):
        """Zero violated brokers makes the goal an identity."""
        return ~torch.any(self.violated_brokers(state, ctx, cache))

    def accept_move(self, state, ctx, cache, replica, dest_broker):
        """Strict branch when source and destination are within limits
        (both must stay so), else the destination must not end up above
        the source's pre-move utilization."""
        res = int(self.resource)
        w = cache.replica_load[:, res][replica]
        src = state.replica_broker[replica].long()
        W = cache.broker_load[:, res]
        cap = torch.clamp_min(state.broker_capacity[:, res], 1e-9)
        lower = ctx.balance_lower_pct[res] * cap
        upper = ctx.balance_upper_pct[res] * cap
        src_ok_before = W[src] >= lower[src]
        dest_ok_before = W[dest_broker] <= upper[dest_broker]
        strict = ((W[dest_broker] + w <= upper[dest_broker])
                  & (W[src] - w >= lower[src]))
        relaxed = (W[dest_broker] + w) / cap[dest_broker] <= W[src] / cap[src]
        return torch.where(src_ok_before & dest_ok_before, strict, relaxed)

    def accept_swap(self, state, ctx, cache, out_replica, in_replica):
        """Exact two-branch swap acceptance: strict limits when both
        brokers are within them before the swap, else the swap must
        strictly shrink their utilization difference; zero-delta swaps
        are always accepted."""
        res = int(self.resource)
        W = cache.broker_load[:, res]
        cap = torch.clamp_min(state.broker_capacity[:, res], 1e-9)
        lower = ctx.balance_lower_pct[res] * cap
        upper = ctx.balance_upper_pct[res] * cap
        w_out = cache.replica_load[:, res][out_replica]
        w_in = cache.replica_load[:, res][in_replica]
        b_out = state.replica_broker[out_replica].long()
        b_in = state.replica_broker[in_replica].long()
        d = w_in - w_out
        gain_b = torch.where(d > 0, b_out, b_in)
        lose_b = torch.where(d > 0, b_in, b_out)
        mag = torch.abs(d)
        both_within = ((W[lose_b] >= lower[lose_b])
                       & (W[gain_b] <= upper[gain_b]))
        strict = ((W[gain_b] + mag <= upper[gain_b])
                  & (W[lose_b] - mag >= lower[lose_b]))
        prev_diff = W[b_out] / cap[b_out] - W[b_in] / cap[b_in]
        next_diff = prev_diff + d / cap[b_out] + d / cap[b_in]
        relaxed = torch.abs(next_diff) < torch.abs(prev_diff)
        return (d == 0) | torch.where(both_within, strict, relaxed)

    def move_headroom_terms(self, state, ctx, cache):
        """Strict-branch quantities of accept_move: arrivals bounded by
        upper[d] - load[d], departures by load[b] - lower[b]."""
        res = int(self.resource)
        cap = state.broker_capacity[:, res]
        W = cache.broker_load[:, res]
        return [(f"load{res}", cache.replica_load[:, res],
                 ctx.balance_upper_pct[res] * cap - W,
                 W - ctx.balance_lower_pct[res] * cap)]

    def violated_brokers(self, state, ctx, cache):
        res = int(self.resource)
        W = cache.broker_load[:, res]
        cap = torch.clamp_min(state.broker_capacity[:, res], 1e-9)
        lower = ctx.balance_lower_pct[res] * cap
        upper = ctx.balance_upper_pct[res] * cap
        return state.broker_alive & ((W > upper) | (W < lower))

    def stats_not_worse(self, before, after):
        """The resource's utilization st.dev must not regress."""
        res = int(self.resource)
        return after.util_std[res] <= before.util_std[res] + 1e-6


class DiskUsageDistributionGoal(ResourceDistributionGoal):
    resource = Resource.DISK


class NetworkInboundUsageDistributionGoal(ResourceDistributionGoal):
    resource = Resource.NW_IN
