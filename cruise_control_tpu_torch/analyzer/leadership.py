"""Global leadership re-election sweep (port of cruise_control_tpu/
analyzer/leadership.py).

A partition's leadership can only move between its own replicas, so the
whole cluster's transfer candidates form a [P, RF] plane.  Every round,
each partition whose leader sits on a broker above `shed_to` proposes its
best sibling broker; a window of SWEEP_COMPACT proposals (salted rotation
across rounds) is scored on its [W, RF] sibling plane — kernel K6
`sweep_pick` (csrc/sweep_pick.cu) on the card, `sweep_pick_plain` on the
CPU — then gain-ranked per source and per destination broker and
accepted as prefixes under cumulative headrooms (kernels.rank_accept),
and committed in one batch (kernel K5 through
context.update_cache_for_leadership).

Mean mode (`improve_gate=True`) pulls both ends toward the cluster
average with a strict-improvement gate; limit mode sheds sources to the
goal's bound and fills destinations toward `fill_to`.  The sweep runs
table-less; `run_sweep_threaded` detaches and reattaches a carried
table.  The reference's `lax.while_loop` is a host loop here with the
same condition.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from cruise_control_tpu_torch import ops
from cruise_control_tpu_torch.analyzer import kernels
from cruise_control_tpu_torch.analyzer.context import (
    OptimizationContext, RoundCache, make_round_cache, reattach_table,
    replica_static_ok, strip_table, update_cache_for_leadership)
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model.state import ClusterState

#: per-round cap on sweep transfers: the [P]-wide proposal planes compact
#: to this many live candidates before the sibling planes and rank_accept
SWEEP_COMPACT = 4096

#: greedy-bias factor for value-weighted sweeps' window selection
VALUE_WEIGHTED_SELECT_JITTER = 0.35


def sweep_pick_plain(sel, has_in, cur_safe, rows, jit_plane, replica_broker,
                     value_r, static_ok, alive, leader_ok, W, fill_to,
                     hard_cap, tb_norm, salt, improve_gate: bool):
    """Plain version of K6: the sweep's window sibling plane.  For window
    member w (partition sel[w], current leader cur_safe[w]) and each
    sibling option j: feasibility (a live sibling on an alive,
    leader-eligible broker whose load plus the arriving value stays
    within hard_cap; in mean mode the value below twice the deficit),
    the score fma(0.1 * spread, (jitter + salt) mod 1, deficit) (then
    fma(0.5 * spread, tb_norm[broker], score) with a tiebreak), spread =
    max(|deficit| over the whole [W, RF] plane, 1e-6); the first-max
    feasible option.
    Returns (dst_r i32[W] promoted replica, has bool[W])."""
    sel = sel.long()
    rows_w = rows[sel]
    rows_w_safe = torch.clamp_min(rows_w, 0).long()
    cand_b = replica_broker[rows_w_safe].long()
    value_arrive = value_r[rows_w_safe]
    ok = ((rows_w >= 0) & (rows_w != cur_safe[:, None])
          & static_ok[rows_w_safe] & alive[cand_b] & leader_ok[cand_b]
          & (W[cand_b] + value_arrive <= hard_cap[cand_b]))
    deficit = (fill_to - W)[cand_b]
    if improve_gate:
        ok &= value_arrive < 2.0 * deficit
    spread = torch.clamp_min(torch.max(torch.abs(deficit)), 1e-6)
    # a float32 value: the scalar add rounds as a float32 tensor add would;
    # each product and the sum after it are one FMA in the reference's
    # compiled sweep
    score = ops.fma_f32(0.1 * spread, ops.remainder_f(
        jit_plane[sel] + float(np.float32(salt)), 1.0), deficit)
    if tb_norm is not None:
        score = ops.fma_f32(0.5 * spread, tb_norm[cand_b], score)
    score = torch.where(ok, score, torch.full((), -float("inf"),
                                              device=score.device))
    best = torch.argmax(score, 1)
    dst_r = torch.gather(rows_w_safe, 1, best[:, None])[:, 0]
    return dst_r.to(torch.int32), has_in & torch.any(ok, 1)


def sweep_pick(sel, has_in, cur_safe, rows, jit_plane, replica_broker,
               value_r, static_ok, alive, leader_ok, W, fill_to, hard_cap,
               tb_norm, salt, improve_gate: bool):
    """K6 dispatch: the plain version on the CPU, csrc/sweep_pick.cu on
    the card.  `salt` is a float32 value (a float the host holds)."""
    if not rows.is_cuda:
        return sweep_pick_plain(sel, has_in, cur_safe, rows, jit_plane,
                                replica_broker, value_r, static_ok, alive,
                                leader_ok, W, fill_to, hard_cap, tb_norm,
                                salt, improve_gate)
    from cruise_control_tpu_torch import cuda_kernels
    return cuda_kernels.sweep_pick(sel, has_in, cur_safe, rows, jit_plane,
                                   replica_broker, value_r, static_ok, alive,
                                   leader_ok, W, fill_to, hard_cap, tb_norm,
                                   salt, improve_gate)


def sweep_window_gain(gain0, live, failed, salt, select_jitter: float):
    """f32[P] window selection score of a sweep round: the gain plus a
    salted rotation of `select_jitter` x the live gains' spread, less the
    spread and the amplitude for the members of a failed window.  The
    jitter's product and sum are rounded once (the reference's compiled
    sweep contracts them into one FMA); `failed` is 0 or 1, so its
    product is exact."""
    dev = gain0.device
    inf = torch.full((), float("inf"), device=dev)
    g_lo = torch.min(torch.where(live, gain0, inf))
    g_hi = torch.max(torch.where(live, gain0, -inf))
    spread0 = torch.where(g_hi > g_lo, g_hi - g_lo,
                          torch.ones((), device=dev))
    amp = spread0 * select_jitter
    salt_i = int(np.float32(salt) * np.float32(100.0))
    jitter = kernels.salted_jitter(gain0.shape[0], salt_i, device=dev)
    return ops.fma_f32(amp, jitter, gain0) - failed * (spread0 + amp)


def global_leadership_sweep(
        state: ClusterState, ctx: OptimizationContext, prev_goals: Sequence,
        measure: Callable[[RoundCache], torch.Tensor],
        value_r: torch.Tensor, bounds: Callable, improve_gate: bool,
        max_rounds: int = 24,
        dest_tiebreak: Optional[Callable[[RoundCache], torch.Tensor]] = None,
        select_jitter: float = 1.0, cache0: Optional[RoundCache] = None,
        regress_guard: Optional[Callable] = None):
    """Run whole-cluster leadership re-election rounds (see the
    reference's docstring for the arguments).  Returns (state,
    rounds_used, final cache, converged_at): converged_at is the 1-based
    index of the last round that committed work (0 when none did)."""
    from cruise_control_tpu_torch.analyzer.goals.base import (
        compose_leadership_acceptance, leadership_commit_terms)
    num_b = state.num_brokers
    rows = ctx.partition_replicas
    num_p = rows.shape[0]
    dev = state.device
    static_ok = replica_static_ok(state, ctx)
    big_cap = torch.full((num_b,), ops.INT32_MAX // 2, dtype=torch.int32,
                         device=dev)
    no_taken = torch.zeros((num_b,), dtype=torch.int32, device=dev)
    zero_b = torch.zeros((num_b,), device=dev)
    # the loop-invariant [P, RF] jitter plane; rounds read their window
    jit_plane = kernels._pairwise_jitter(num_p, rows.shape[1], salt=0,
                                         device=dev)
    # a commit may update the cache in place unless a rejected round must
    # be reverted
    donate = regress_guard is None

    def round_body(st, cache, cur, failed, salt):
        W = measure(cache)
        shed_to, fill_to, hard_cap = bounds(st, W)
        cur_safe0 = torch.clamp_min(cur, 0).long()
        src_b0 = st.replica_broker[cur_safe0]
        sb = src_b0.long()
        value_leave0 = value_r[cur_safe0]
        live = ((cur >= 0) & static_ok[cur_safe0] & (W[sb] > shed_to[sb])
                & (value_leave0 > 0.0))
        if improve_gate:
            live &= value_leave0 < 2.0 * (W[sb] - shed_to[sb])
        gain0 = value_leave0

        gain_sel = sweep_window_gain(gain0, live, failed, salt,
                                     select_jitter)
        (sel, _, has, cur_safe, src_b, value_leave,
         gain) = kernels.compact_candidates(
            SWEEP_COMPACT, gain_sel, live, cur_safe0, src_b0, value_leave0,
            gain0)
        if sel is None:
            sel = torch.arange(num_p, dtype=torch.int64, device=dev)
        live_w = has

        tb_norm = None
        if dest_tiebreak is not None:
            tb = dest_tiebreak(cache)
            tb_lo = torch.min(tb)
            tb_norm = (tb - tb_lo) / torch.clamp_min(torch.max(tb) - tb_lo,
                                                     1e-9)
        dst_r, has = sweep_pick(
            sel.to(torch.int32).contiguous(), has.contiguous(),
            cur_safe.to(torch.int32).contiguous(), rows, jit_plane,
            st.replica_broker, value_r, static_ok, st.broker_alive,
            ctx.broker_leader_ok, W.contiguous(), fill_to.contiguous(),
            hard_cap.contiguous(), tb_norm, salt, improve_gate)
        dst_rl = dst_r.long()
        dst_b = st.replica_broker[dst_rl]

        # prior goals' boolean acceptance of the chosen transfer
        accept = compose_leadership_acceptance(prev_goals, st, ctx, cache)
        has = has & accept(cur_safe, dst_rl)
        lt_d, lt_s = leadership_commit_terms(prev_goals, st, ctx, cache)
        one_cap = torch.ones((num_b,), dtype=torch.int32, device=dev)
        src_cap = big_cap if lt_s is not None else one_cap
        dst_cap = big_cap if lt_d is not None else one_cap

        # source side: shed down to shed_to, prefix-gated
        src_w = [value_leave] + [t_w[cur_safe] for t_w, _ in (lt_s or ())]
        src_hr = [W - shed_to] + [hr for _, hr in (lt_s or ())]
        has = kernels.rank_accept(
            torch.where(has, src_b, torch.full_like(src_b, num_b)), gain,
            has, num_b, no_taken, src_cap, [zero_b] * len(src_w), src_w,
            src_hr)
        # destination side: fill toward fill_to (weights of the promoted
        # replica)
        dst_w = ([value_r[dst_rl]]
                 + [t_w[dst_rl] for t_w, _ in (lt_d or ())])
        dst_hr = [fill_to - W] + [hr for _, hr in (lt_d or ())]
        valid = kernels.rank_accept(
            torch.where(has, dst_b, torch.full_like(dst_b, num_b)), gain,
            has, num_b, no_taken, dst_cap, [zero_b] * len(dst_w), dst_w,
            dst_hr)

        new_st = S.apply_leadership_transfers(st, cur_safe, dst_r, valid)
        cache = update_cache_for_leadership(st, cache, cur_safe, dst_r,
                                            valid, donate=donate)
        # carried leader index: committed partitions point at the promoted
        # replica
        p_w = st.replica_partition[cur_safe].long()
        cur = ops.scatter_set(cur, torch.where(valid, p_w,
                                               torch.full_like(p_w, num_p)),
                              dst_r)
        # window-failure marks: committed members clear, failed ones set
        failed = failed.clone()
        failed[sel] = torch.where(
            valid, torch.zeros((), device=dev),
            torch.where(live_w & ~valid, torch.ones((), device=dev),
                        failed[sel]))
        return new_st, cache, cur, failed, bool(torch.any(valid))

    cache = cache0 if cache0 is not None else make_round_cache(state, 0, ctx)
    st = state
    cur = S.partition_leader_replica(state)
    failed = torch.zeros((num_p,), device=dev)
    vprev = int(regress_guard(state, cache)) if regress_guard else 0
    rounds = dry = last_commit = 0
    while dry < 3 and rounds < max_rounds:
        W = measure(cache)
        shed_to, _, _ = bounds(st, W)
        if not bool(torch.any(st.broker_alive & (W > shed_to))):
            break
        salt = np.float32(rounds) * np.float32(0.37)
        st2, cache2, cur2, failed2, committed = round_body(
            st, cache, cur, failed, salt)
        if regress_guard is not None:
            v_new = int(regress_guard(st2, cache2))
            ok = v_new <= vprev
            if ok:
                st, cache, cur, failed = st2, cache2, cur2, failed2
                vprev = v_new
            committed = committed and ok
            # a rejected round forces the dry exit
            dry = 0 if committed else (dry + 1 if ok else 3)
        else:
            st, cache, cur, failed = st2, cache2, cur2, failed2
            dry = 0 if committed else dry + 1
        if committed:
            last_commit = rounds + 1
        rounds += 1
    return st, rounds, cache, last_commit


def run_sweep_threaded(state: ClusterState, ctx: OptimizationContext,
                       prev_goals: Sequence, cache: Optional[RoundCache],
                       **sweep_kwargs):
    """(state, rounds, cache', converged_at): the sweep with RoundCache
    threading — a carried table is detached for the sweep and reattached
    afterwards with the role-dependent planes re-gathered."""
    if cache is not None and cache.broker_table.shape[1]:
        tbl, fill = cache.broker_table, cache.table_fill
        t_bonus, t_ok = cache.table_bonus, cache.table_ok
        r_ok = cache.replica_ok
        state, rounds, nt, conv = global_leadership_sweep(
            state, ctx, prev_goals, cache0=strip_table(cache),
            **sweep_kwargs)
        return state, rounds, reattach_table(state, nt, tbl, fill, t_bonus,
                                             t_ok, r_ok), conv
    return global_leadership_sweep(state, ctx, prev_goals, cache0=cache,
                                   **sweep_kwargs)


def mean_bounds(upper_of: Callable):
    """bounds() for mean mode: both ends target the alive-broker average;
    `upper_of(state, W)` supplies the goal's own hard ceiling."""
    def fn(st: ClusterState, W: torch.Tensor):
        alive = st.broker_alive
        avg = ops.sum_f32(W * alive) / torch.clamp_min(torch.sum(alive), 1)
        avg_b = avg.reshape(1).expand(st.num_brokers)
        up = upper_of(st, W)
        return avg_b, torch.minimum(avg_b, up), up
    return fn


def limit_bounds(limit: torch.Tensor, fill_to: torch.Tensor):
    """bounds() for limit mode: shed while over `limit`, stack arrivals
    toward `fill_to`, never cross `limit`."""
    def fn(st: ClusterState, W: torch.Tensor):
        return limit, fill_to, limit
    return fn
