"""Global leadership re-election sweep (port of cruise_control_tpu/
analyzer/leadership.py).

A partition's leadership can only move between its own replicas, so the
whole cluster's transfer candidates form a [P, RF] plane.  Every round,
each partition whose leader sits on a broker above `shed_to` proposes its
best sibling broker; a window of SWEEP_COMPACT proposals (salted rotation
across rounds) is scored on its [W, RF] sibling plane, then gain-ranked
per source and per destination broker and accepted as prefixes under
cumulative headrooms (kernels.rank_accept), and committed in one batch
(kernel K5 through context.update_cache_for_leadership).  A round's
window -- the source terms, the window's selection score and top-k, the
sibling plane and its pick, with the fold of the round before it into
the carried leader index and failure marks -- is one launch of kernel K6
`sweep_pick` (csrc/sweep_pick.cu) on the card and `sweep_window_plain`
on the CPU.

Mean mode (`improve_gate=True`) pulls both ends toward the cluster
average with a strict-improvement gate; limit mode sheds sources to the
goal's bound and fills destinations toward `fill_to`.  The sweep runs
table-less; `run_sweep_threaded` detaches and reattaches a carried
table.  The reference's `lax.while_loop` is a host loop here with the
same condition.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

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
    """The pick of K6's plain version: the window's sibling plane.  For window
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


class SweepWindow(NamedTuple):
    """One sweep round's window: sel i64[Wn] (its partitions), has bool
    (a feasible sibling was picked), live_w bool (has before the pick),
    cur_safe i64 (the current leader replica), src_b i32 (its broker),
    value_leave f32 (the leader's value, also the commit ranking's gain),
    dst_r i64 (the promoted replica), dst_b i32 (its broker)."""
    sel: torch.Tensor
    has: torch.Tensor
    live_w: torch.Tensor
    cur_safe: torch.Tensor
    src_b: torch.Tensor
    value_leave: torch.Tensor
    dst_r: torch.Tensor
    dst_b: torch.Tensor


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


def fold_window(cur, failed, replica_partition, prev) -> None:
    """The fold of a kept round into the carried leader index and the
    window-failure marks, in place: committed partitions point at the
    promoted replica; window members clear their mark where they
    committed and set it where they were live but did not."""
    win, valid = prev
    num_p = cur.shape[0]
    p_w = replica_partition[win.cur_safe].long()
    cur.copy_(ops.scatter_set(cur, torch.where(
        valid, p_w, torch.full_like(p_w, num_p)), win.dst_r.to(cur.dtype)))
    one = torch.ones((), device=failed.device)
    failed[win.sel] = torch.where(
        valid, torch.zeros((), device=failed.device),
        torch.where(win.live_w & ~valid, one, failed[win.sel]))


def sweep_window_plain(cur, failed, prev, rows, jit_plane, replica_broker,
                       replica_partition, value_r, static_ok, alive,
                       leader_ok, W, shed_to, fill_to, hard_cap, tb, salt,
                       improve_gate: bool,
                       select_jitter: float) -> SweepWindow:
    """Plain version of K6: one sweep round's window.  Folds `prev` (the
    previous round's SweepWindow and its acceptance `valid`, or None)
    into `cur` and `failed` in place (fold_window); then the source terms
    of every partition (its leader, broker, value and liveness), the
    window's selection score (sweep_window_gain), its top SWEEP_COMPACT
    partitions (kernels.compact_candidates: every partition when P is not
    larger), the tiebreak's normalisation and the window's sibling pick
    (sweep_pick_plain)."""
    if prev is not None:
        fold_window(cur, failed, replica_partition, prev)
    num_p = rows.shape[0]
    cur_safe0 = torch.clamp_min(cur, 0).long()
    src_b0 = replica_broker[cur_safe0]
    sb = src_b0.long()
    value_leave0 = value_r[cur_safe0]
    live = ((cur >= 0) & static_ok[cur_safe0] & (W[sb] > shed_to[sb])
            & (value_leave0 > 0.0))
    if improve_gate:
        live &= value_leave0 < 2.0 * (W[sb] - shed_to[sb])
    gain_sel = sweep_window_gain(value_leave0, live, failed, salt,
                                 select_jitter)
    (sel, _, has, cur_safe, src_b,
     value_leave) = kernels.compact_candidates(
        SWEEP_COMPACT, gain_sel, live, cur_safe0, src_b0, value_leave0)
    if sel is None:
        sel = torch.arange(num_p, dtype=torch.int64, device=cur.device)
    tb_norm = None
    if tb is not None:
        tb_lo = torch.min(tb)
        tb_norm = (tb - tb_lo) / torch.clamp_min(torch.max(tb) - tb_lo, 1e-9)
    dst_r, has_pick = sweep_pick_plain(
        sel, has, cur_safe, rows, jit_plane, replica_broker, value_r,
        static_ok, alive, leader_ok, W, fill_to, hard_cap, tb_norm, salt,
        improve_gate)
    dst_r = dst_r.long()
    return SweepWindow(sel, has_pick, has, cur_safe, src_b, value_leave,
                       dst_r, replica_broker[dst_r])


def sweep_window(cur, failed, prev, rows, jit_plane, replica_broker,
                 replica_partition, value_r, static_ok, alive, leader_ok, W,
                 shed_to, fill_to, hard_cap, tb, salt, improve_gate: bool,
                 select_jitter: float) -> SweepWindow:
    """K6 dispatch: the plain version on the CPU, one launch of
    csrc/sweep_pick.cu on the card.  `salt` is a float32 value (a float
    the host holds)."""
    args = (cur, failed, prev, rows, jit_plane, replica_broker,
            replica_partition, value_r, static_ok, alive, leader_ok, W,
            shed_to, fill_to, hard_cap, tb, salt, improve_gate,
            select_jitter)
    if not rows.is_cuda:
        return sweep_window_plain(*args)
    from cruise_control_tpu_torch import cuda_kernels
    return SweepWindow(*cuda_kernels.sweep_window(*args))


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
    value_r = value_r.contiguous()
    # the carried leader index and window-failure marks, folded in place
    # by each round's window
    cur = S.partition_leader_replica(state)
    failed = torch.zeros((num_p,), device=dev)

    def round_body(st, cache, prev, salt):
        W = measure(cache)
        tb = dest_tiebreak(cache) if dest_tiebreak is not None else None
        # prior goals' boolean acceptance of the chosen transfer
        accept = compose_leadership_acceptance(prev_goals, st, ctx, cache)
        shed_to, fill_to, hard_cap = bounds(st, W)
        win = sweep_window(cur, failed, prev, rows, jit_plane,
                           st.replica_broker, st.replica_partition, value_r,
                           static_ok, st.broker_alive, ctx.broker_leader_ok,
                           W, shed_to, fill_to, hard_cap, tb, salt,
                           improve_gate, select_jitter)
        cur_safe, dst_r = win.cur_safe, win.dst_r
        has = win.has & accept(cur_safe, dst_r)
        lt_d, lt_s = leadership_commit_terms(prev_goals, st, ctx, cache)
        one_cap = torch.ones((num_b,), dtype=torch.int32, device=dev)
        src_cap = big_cap if lt_s is not None else one_cap
        dst_cap = big_cap if lt_d is not None else one_cap

        # source side: shed down to shed_to, prefix-gated
        src_w = ([win.value_leave]
                 + [t_w[cur_safe] for t_w, _ in (lt_s or ())])
        src_hr = [W - shed_to] + [hr for _, hr in (lt_s or ())]
        has = kernels.rank_accept(
            torch.where(has, win.src_b, torch.full_like(win.src_b, num_b)),
            win.value_leave, has, num_b, no_taken, src_cap,
            [zero_b] * len(src_w), src_w, src_hr)
        # destination side: fill toward fill_to (weights of the promoted
        # replica)
        dst_w = ([value_r[dst_r]]
                 + [t_w[dst_r] for t_w, _ in (lt_d or ())])
        dst_hr = [fill_to - W] + [hr for _, hr in (lt_d or ())]
        valid = kernels.rank_accept(
            torch.where(has, win.dst_b, torch.full_like(win.dst_b, num_b)),
            win.value_leave, has, num_b, no_taken, dst_cap,
            [zero_b] * len(dst_w), dst_w, dst_hr)

        new_st = S.apply_leadership_transfers(st, cur_safe, dst_r, valid)
        cache = update_cache_for_leadership(st, cache, cur_safe, dst_r,
                                            valid, donate=donate)
        # the carried leader index and window-failure marks take this
        # round in the next round's window (a rejected round ends the
        # sweep, and the last round's fold is never read)
        return new_st, cache, (win, valid), bool(torch.any(valid))

    cache = cache0 if cache0 is not None else make_round_cache(state, 0, ctx)
    st = state
    prev = None
    vprev = int(regress_guard(state, cache)) if regress_guard else 0
    rounds = dry = last_commit = 0
    while dry < 3 and rounds < max_rounds:
        W = measure(cache)
        shed_to, _, _ = bounds(st, W)
        if not bool(torch.any(st.broker_alive & (W > shed_to))):
            break
        salt = np.float32(rounds) * np.float32(0.37)
        st2, cache2, prev2, committed = round_body(st, cache, prev, salt)
        if regress_guard is not None:
            v_new = int(regress_guard(st2, cache2))
            ok = v_new <= vprev
            if ok:
                st, cache, prev = st2, cache2, prev2
                vprev = v_new
            committed = committed and ok
            # a rejected round forces the dry exit
            dry = 0 if committed else (dry + 1 if ok else 3)
        else:
            st, cache, prev = st2, cache2, prev2
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
