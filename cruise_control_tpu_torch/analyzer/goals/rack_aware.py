"""Rack awareness goal, hard (port of cruise_control_tpu/analyzer/goals/
rack_aware.py): at most one replica of each partition per rack.

A replica is rack-redundant when its (partition, rack) cell of
`partition_rack_count` exceeds 1.  Each round moves redundant followers,
found by a global forced-candidate search (`forced_move_round`, table
branch), to racks holding no replica of their partition; at most one
mover per partition lands per round, so a committed batch never
re-creates a violation.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from cruise_control_tpu_torch import ops
from cruise_control_tpu_torch.analyzer import kernels
from cruise_control_tpu_torch.analyzer.context import (OptimizationContext,
                                                       ensure_full_cache)
from cruise_control_tpu_torch.analyzer.goals.base import (
    Goal, compose_move_acceptance, move_commit_terms, run_rounds)
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model.state import ClusterState


class RackAwareGoal(Goal):
    is_hard = True
    name = "RackAwareGoal"
    source_side_acceptance = False   # acceptance checks the destination rack

    def __init__(self, max_rounds: int = 128):
        self.max_rounds = max_rounds

    def _dest_pref(self, st: ClusterState, cache) -> torch.Tensor:
        """f32[B] destination preference: lowest disk utilization."""
        return -cache.broker_util[:, Resource.DISK]

    @staticmethod
    def _redundant_mask(state: ClusterState, prc) -> torch.Tensor:
        """bool[R] — replicas in a rack that holds more than one replica
        of their partition."""
        rack = state.broker_rack[state.replica_broker.long()].long()
        return (state.replica_valid
                & (prc[state.replica_partition.long(), rack] > 1))

    def optimize_cached(self, state: ClusterState, ctx: OptimizationContext,
                        prev_goals: Sequence[Goal], cache=None):
        disk = int(Resource.DISK)

        def round_body(st: ClusterState, cache):
            prc = cache.partition_rack_count
            # followers only: one leader per partition, so a redundant
            # pair always has a follower to move
            movable = (self._redundant_mask(st, prc) & ~ctx.replica_excluded
                       & ctx.replica_movable & ~st.replica_offline
                       & ~st.replica_is_leader)
            # a mover is a candidate only if some rack with an eligible
            # destination holds no replica of its partition
            dest_ok_b = ctx.broker_dest_ok & st.broker_alive
            rack_has_dest = ops.segment_sum(dest_ok_b.to(torch.int32),
                                            st.broker_rack,
                                            st.num_racks) > 0
            empty_rack = (prc == 0) & rack_has_dest[None, :]
            movable = movable & torch.any(empty_rack, 1)[
                st.replica_partition.long()]
            accept = compose_move_acceptance(prev_goals, st, ctx, cache)
            rack_of_b = st.broker_rack.long()

            def accept_all(r, d):
                # the destination rack must hold no replica of the
                # partition
                p = st.replica_partition[r].long()
                return (prc[p, rack_of_b[d]] == 0) & accept(r, d)

            mt_d, _ = move_commit_terms(prev_goals, st, ctx, cache)
            mid_disk = ((ctx.balance_upper_pct[disk]
                         + ctx.balance_lower_pct[disk]) / 2.0
                        * st.broker_capacity[:, disk])
            cand_r, cand_d, cand_v = kernels.forced_move_round(
                st, movable, cache.replica_load[:, disk], dest_ok_b,
                accept_all, self._dest_pref(st, cache),
                ctx.partition_replicas,
                cap_alive_sources=any(g.source_side_acceptance
                                      for g in prev_goals),
                cache=cache, dest_terms=mt_d,
                dest_stack_headroom=mid_disk - cache.broker_load[:, disk])
            st, cache = kernels.commit_moves_cached(st, cache, cand_r,
                                                    cand_d, cand_v)
            return st, cache, bool(torch.any(cand_v))

        def redundant_exists(st, cache):
            return torch.any(self._redundant_mask(
                st, cache.partition_rack_count))

        return run_rounds(state, ensure_full_cache(state, ctx, cache),
                          round_body, redundant_exists, self.rounds_for(ctx))

    def no_work(self, state, ctx, cache):
        """No rack-redundant replica: the loop body never runs."""
        return ~torch.any(self._redundant_mask(state,
                                               cache.partition_rack_count))

    def accept_move(self, state, ctx, cache, replica, dest_broker):
        """A move may not place a second replica of the partition in the
        destination rack; the mover's own count is subtracted when it
        stays in its rack."""
        p = state.replica_partition[replica].long()
        src_rack = state.broker_rack[state.replica_broker[replica].long()]
        dst_rack = state.broker_rack[dest_broker.long()]
        cnt = cache.partition_rack_count[p, dst_rack.long()]
        return cnt - (src_rack == dst_rack).to(cnt.dtype) == 0

    def move_headroom_terms(self, state, ctx, cache):
        """Rack acceptance never accumulates across partitions, and the
        kernels cap each partition at one move per round."""
        return []

    def leadership_headroom_terms(self, state, ctx, cache):
        return []                # leadership-invariant

    def violated_brokers(self, state, ctx, cache):
        redundant = self._redundant_mask(state, cache.partition_rack_count)
        return (ops.segment_sum(redundant.to(torch.int32),
                                state.replica_broker, state.num_brokers) > 0
                ) & state.broker_alive

    def is_satisfiable(self, state: ClusterState) -> bool:
        """Host-side check: unsatisfiable when some partition has more
        replicas than there are racks with alive brokers."""
        alive_racks = np.unique(state.broker_rack.cpu().numpy()[
            state.broker_alive.cpu().numpy()])
        rf = S.partition_replication_factor(state).cpu().numpy()
        return bool((rf <= len(alive_racks)).all())
