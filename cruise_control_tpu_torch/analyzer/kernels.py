"""Batched balancing-action search: the move and swap path (port of
cruise_control_tpu/analyzer/kernels.py).

Each round scores candidate (replica, destination) pairs in parallel,
picks candidates per source broker, assigns destinations in a few
passes and commits the non-conflicting batch.  Two of the round's hot
functions are hand-written CUDA kernels on the card:

* K1 `row_topk` (csrc/row_topk.cu) behind `rows_pick_topk` /
  `rows_pick_best`;
* K2 `assign_pass` (csrc/assign_pass.cu), one pass of
  `assign_destinations`.

Their plain versions (`row_topk_plain`, `assign_pass_plain`) live here;
a CPU tensor runs them.  The reference's `lax.cond` branches are host
`if`s on a 0-d tensor (one sync each).
"""
from __future__ import annotations

from typing import Optional

import torch

from cruise_control_tpu_torch import ops
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model.state import ClusterState

NEG = -1e30

ASSIGN_PASSES = 8
MULTI_ASSIGN_PASSES = 8
#: candidate-compaction width of the [C, K] planes
CAND_COMPACT = 2048
#: swap search evaluates the worst SWAP_SHORTLIST brokers per side
SWAP_SHORTLIST = 128
#: per-round arrival ceiling per destination in multi-commit mode
MAX_ARRIVALS_PER_ROUND = 64
#: destination-shortlist width of the candidate x destination planes
DEST_SHORTLIST = 256


def _arange(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=dev)


def per_segment_argmax(score: torch.Tensor, segment: torch.Tensor,
                       num_segments: int, valid: torch.Tensor):
    """For each segment the index of the max-score valid element: (arg
    i32[n] (-1 if none), max_score f32[n], has bool[n]); ties go to the
    lowest index."""
    neg = torch.full((), NEG, dtype=score.dtype, device=score.device)
    masked = torch.where(valid, score, neg)
    seg_max = ops.segment_max(masked, segment, num_segments)
    has = seg_max > NEG / 2
    idx = _arange(score.shape[0], score.device)
    seg_l = segment.long()
    is_max = valid & (masked >= seg_max[seg_l.clamp(0, num_segments - 1)])
    big = torch.full_like(idx, ops.INT32_MAX)
    arg = ops.segment_min(torch.where(is_max, idx, big), segment,
                          num_segments)
    arg = torch.where(has, arg, torch.full_like(arg, -1)).to(torch.int32)
    return arg, seg_max, has


def _has_table(cache) -> bool:
    return cache is not None and cache.broker_table.shape[1] > 0


def _table_rows(cache, score: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """[B, S] per-slot scores gathered from per-replica arrays (pad slots
    gather an appended NEG sentinel)."""
    combined = torch.where(valid, score,
                           torch.full((), NEG, device=score.device))
    combined_p = torch.cat([combined,
                            torch.full((1,), NEG, device=score.device)])
    return combined_p[cache.broker_table.long()]


# ---------------------------------------------------------------------------
# K1: per-row top-k
# ---------------------------------------------------------------------------

def row_topk_plain(sc_rows: torch.Tensor, table: torch.Tensor, k: int):
    """Plain version of K1: per-row top-k of a NEG-masked [B, S] plane,
    score descending then slot ascending (jax.lax.top_k's tie rule).
    Returns (cand i32[B*k] replica id or -1, has bool[B*k], top f32[B, k])."""
    top, slots = ops.topk_stable(sc_rows, k)
    cand = torch.gather(table, 1, slots)
    has = top > NEG / 2
    cand = torch.where(has, cand, torch.full_like(cand, -1))
    return cand.reshape(-1).to(torch.int32), has.reshape(-1), top


def row_topk(sc_rows: torch.Tensor, table: torch.Tensor, k: int):
    """K1 dispatch: the plain version on the CPU, csrc/row_topk.cu on the
    card."""
    if not sc_rows.is_cuda:
        return row_topk_plain(sc_rows, table, k)
    from cruise_control_tpu_torch import cuda_kernels
    return cuda_kernels.row_topk(sc_rows, table, k)


def rows_pick_best(cache, sc_rows: torch.Tensor):
    """Per-broker argmax over a [B, S] score plane (NEG = ineligible):
    (cand i32[B] replica id or -1, has bool[B])."""
    cand, has, _ = row_topk(sc_rows, cache.broker_table, 1)
    return cand, has


def rows_pick_topk(cache, sc_rows: torch.Tensor, k: int):
    """Per-broker top-k over a [B, S] plane, flattened row-major:
    (cand i32[B*k], has bool[B*k], top_scores f32[B, k])."""
    k = min(k, max(cache.broker_table.shape[1], 1))
    return row_topk(sc_rows, cache.broker_table, k)


def table_pick_best(cache, score: torch.Tensor, valid: torch.Tensor):
    """Per-broker argmax over the table from per-replica score/valid."""
    return rows_pick_best(cache, _table_rows(cache, score, valid))


# ---------------------------------------------------------------------------
# Ranking and conflict resolution
# ---------------------------------------------------------------------------

def segment_rank(seg: torch.Tensor, num_segments: int,
                 order: Optional[torch.Tensor] = None):
    """(order, seg_sorted, start, pos) — stable grouping of elements by
    segment id with each element's rank within its segment; `order`
    overrides the default stable-by-id sort."""
    c = seg.shape[0]
    seg = seg.long()
    if order is None:
        order = ops.argsort_stable(seg)
    seg_s = seg[order]
    counts = ops.segment_sum(torch.ones_like(seg), seg, num_segments)
    start = torch.cat([torch.zeros(1, dtype=torch.int64, device=seg.device),
                       torch.cumsum(counts, 0)[:-1]])
    pos = _arange(c, seg.device) - start[seg_s.clamp(0, num_segments - 1)]
    return order, seg_s, start, pos


def _lexsort_dest_gain(seg: torch.Tensor, gain: torch.Tensor):
    """`jnp.lexsort((arange, -gain, seg))`: by seg, then gain descending,
    then index."""
    o1 = ops.argsort_stable(-gain)
    return o1[ops.argsort_stable(seg[o1])]


def rank_accept(dest, gain, has, num_b: int, taken_cnt, cap, cum_d, d_w,
                hr_d) -> torch.Tensor:
    """bool[C] — multi-arrival acceptance for one assignment pass: per
    destination, candidates ranked by gain (ties by index) are accepted
    as a prefix while the arrival count stays under `cap` and every
    cumulative term stays within its headroom; the first arrival at a
    still-virgin destination bypasses the terms."""
    c = dest.shape[0]
    dev = dest.device
    seg = torch.where(has, dest.long(), torch.full_like(dest, num_b).long())
    order = _lexsort_dest_gain(seg, gain)
    order, seg_s, start, pos = segment_rank(seg, num_b + 1, order=order)
    seg_valid = seg_s < num_b
    segc = torch.clamp_max(seg_s, num_b - 1)
    taken_s = taken_cnt[segc]
    ok = seg_valid & (pos + taken_s < cap[segc])
    first_free = (pos == 0) & (taken_s == 0)
    fits = torch.ones((c,), dtype=torch.bool, device=dev)
    if len(d_w):
        # all terms at once: one [terms, C] cumsum, the same per-row sums
        zero = torch.zeros((), device=dev)
        w_s = torch.where(seg_valid[None, :],
                          torch.stack(list(d_w))[:, order], zero)
        excl = ops.cumsum_f32(w_s, 1) - w_s
        within_before = excl - excl[:, start[segc]]
        fits = torch.all(torch.stack(list(cum_d))[:, segc] + within_before
                         + w_s <= torch.stack(list(hr_d))[:, segc], 0)
    ok &= first_free | fits
    bad_rank = torch.where(ok | ~seg_valid,
                           torch.full_like(pos, ops.INT32_MAX), pos)
    first_bad = ops.segment_min(bad_rank, seg_s, num_b + 1)
    ok &= pos < first_bad[torch.clamp_max(seg_s, num_b)]
    out = torch.zeros((c,), dtype=torch.bool, device=dev)
    out[order] = ok & has[order]
    return out


def resolve_dest_conflicts(dest, gain, valid, num_brokers: int):
    """Keep at most one winning candidate per destination segment."""
    seg = torch.where(valid, dest.long(), torch.zeros_like(dest).long())
    arg, _, _ = per_segment_argmax(gain, seg, num_brokers, valid)
    idx = _arange(dest.shape[0], dest.device)
    return valid & (arg.long()[seg] == idx)


# ---------------------------------------------------------------------------
# Feasibility
# ---------------------------------------------------------------------------

def _dest_feasibility(state: ClusterState, cand_r, dest_ok,
                      accept_matrix_fn, partition_replicas=None,
                      dest_ids=None) -> torch.Tensor:
    """bool[C, K] structural destination feasibility: eligible broker,
    not the current broker, no second replica of the partition, and the
    composed acceptance stack."""
    num_b = state.num_brokers
    rb = state.replica_broker
    if dest_ids is None:
        dest_ids = _arange(num_b, rb.device)
    dest_ids = dest_ids.long()
    cand_r = cand_r.long()
    feasible = dest_ok[dest_ids][None, :].expand(
        cand_r.shape[0], dest_ids.shape[0]).clone()
    feasible &= dest_ids[None, :] != rb[cand_r][:, None]
    if partition_replicas is not None:
        siblings = partition_replicas[state.replica_partition[cand_r].long()]
        sib_valid = siblings >= 0
        sib_broker = rb[torch.clamp_min(siblings, 0).long()]
        dup = torch.any(sib_valid[:, :, None]
                        & (sib_broker[:, :, None] == dest_ids[None, None, :]),
                        dim=1)
        feasible &= ~dup
    feasible &= accept_matrix_fn(cand_r[:, None], dest_ids[None, :])
    return feasible


def _blocked_best(state, sib_rows, dest_ok, dest_headroom,
                  partition_replicas):
    rf = partition_replicas.shape[1]
    k = min(rf + 2, state.num_brokers)
    inf = torch.full((), float("inf"), device=dest_headroom.device)
    ok_headroom = torch.where(dest_ok, dest_headroom, -inf)
    top_h, top_b = ops.topk_stable(ok_headroom, k)
    sib = partition_replicas[sib_rows]
    sib_broker = torch.where(
        sib >= 0, state.replica_broker[torch.clamp_min(sib, 0).long()],
        torch.full_like(sib, -1))
    blocked = torch.any(sib_broker[:, :, None] == top_b[None, None, :], 1)
    return torch.max(torch.where(blocked, -inf, top_h[None, :]), 1).values


def cand_has_dest(state, cand_r, w_c, dest_ok, dest_headroom,
                  partition_replicas) -> torch.Tensor:
    """bool[C] — does some destination fit each candidate (top RF+2
    headroom argument)?"""
    rows = state.replica_partition[cand_r.long()].long()
    return _blocked_best(state, rows, dest_ok, dest_headroom,
                         partition_replicas) >= w_c


def feasible_dest_exists(state, w, dest_ok, dest_headroom,
                         partition_replicas) -> torch.Tensor:
    """bool[R] — replica-level form of cand_has_dest."""
    rows = state.replica_partition.long()
    return _blocked_best(state, rows, dest_ok, dest_headroom,
                         partition_replicas) >= w


def shed_score(w: torch.Tensor, excess_r: torch.Tensor) -> torch.Tensor:
    """Replicas fitting the excess beat overshooting ones; largest
    fitting first, smallest overshooting first."""
    return torch.where(w <= excess_r, w, -w)


# ---------------------------------------------------------------------------
# Move round
# ---------------------------------------------------------------------------

def move_round(state: ClusterState, w, src_ok, src_excess, movable, dest_ok,
               dest_headroom, accept_matrix_fn, dest_pref,
               partition_replicas, forced=None, strict_allowance=False,
               cache=None, sc_rows=None, per_src_k: int = 1,
               dest_terms=None, src_terms=None, dest_stack_headroom=None,
               assign_fallback: bool = False):
    """One round of batched replica-move search (see the reference's
    docstring for the arguments).  Returns (cand_replica i32[C],
    cand_dest i32[C], cand_valid bool[C]) with C = num_brokers *
    per_src_k, broker-major."""
    num_b = state.num_brokers
    rb = state.replica_broker.long()
    dev = w.device
    zero = torch.zeros((), device=dev)
    multi = dest_terms is not None
    dest_cap = None
    if _has_table(cache):
        dest_ok = dest_ok & (cache.table_fill < cache.broker_table.shape[1])
        if multi:
            dest_cap = (cache.broker_table.shape[1]
                        - cache.table_fill).to(torch.int32)

    if sc_rows is not None and _has_table(cache) and forced is None:
        kk = min(per_src_k, max(cache.broker_table.shape[1], 1))
        cand_r, cand_struct, _ = rows_pick_topk(cache, sc_rows, kk)
        cand_r_safe = torch.clamp_min(cand_r, 0).long()
        cand_w = w[cand_r_safe]
        hd = cand_has_dest(state, cand_r_safe, cand_w, dest_ok,
                           dest_headroom, partition_replicas)
        cand_has = cand_struct & hd
        if kk > 1:
            # cumulative-excess gate, prefix-pessimistic (rank 0 free for
            # the source-side terms)
            w_bk = torch.where(cand_has, cand_w, zero).reshape(num_b, kk)
            cum_before = ops.cumsum_f32(w_bk, 1) - w_bk
            cand_has &= (cum_before < src_excess[:, None]).reshape(-1)
            if multi:
                rank = _arange(kk, dev)[None, :]
                for t_w, t_hr in (src_terms or ()):
                    tw_bk = torch.where(cand_has, t_w[cand_r_safe],
                                        zero).reshape(num_b, kk)
                    cum_incl = ops.cumsum_f32(tw_bk, 1)
                    ok = (rank == 0) | (cum_incl <= t_hr[:, None])
                    cand_has &= ok.reshape(-1)

        # starvation escalation, thin-progress form
        struct_any = torch.any(sc_rows > NEG / 2, 1)
        got = torch.any(cand_has.reshape(num_b, kk), 1)
        thin = torch.sum(got) * 8 < torch.sum(struct_any)
        if bool(torch.any(struct_any & ~got) & thin):
            has_dest = feasible_dest_exists(state, w, dest_ok,
                                            dest_headroom,
                                            partition_replicas)
            eligible = movable & src_ok[rb] & has_dest
            if strict_allowance:
                eligible = eligible & (w <= src_excess[rb])
            score = shed_score(w, src_excess[rb])
            f_cand, f_has = table_pick_best(cache, score, eligible)
            cr = cand_r.reshape(num_b, kk).clone()
            ch = cand_has.reshape(num_b, kk).clone()
            take = struct_any & ~got & f_has
            cr[:, 0] = torch.where(take, f_cand, cr[:, 0])
            ch[:, 0] = torch.where(take, torch.ones_like(take), ch[:, 0])
            cand_r, cand_has = cr.reshape(-1), ch.reshape(-1)
        cand_r_safe = torch.clamp_min(cand_r, 0).long()
        cand_w = w[cand_r_safe]
        gain = cand_w
    else:
        has_dest = feasible_dest_exists(state, w, dest_ok, dest_headroom,
                                        partition_replicas)
        eligible = movable & src_ok[rb] & has_dest
        if strict_allowance:
            eligible = eligible & (w <= src_excess[rb])
        if forced is not None:
            eligible = eligible | (movable & forced & has_dest)
            score = torch.where(forced, w + 1e12,
                                shed_score(w, src_excess[rb]))
        else:
            score = shed_score(w, src_excess[rb])
        if _has_table(cache):
            cand_r, cand_has = table_pick_best(cache, score, eligible)
        else:
            cand_r, _, cand_has = per_segment_argmax(score, rb, num_b,
                                                     eligible)
        cand_r_safe = torch.clamp_min(cand_r, 0).long()
        cand_w = w[cand_r_safe]
        gain = cand_w
        if forced is not None:
            gain = gain + torch.where(forced[cand_r_safe],
                                      torch.full((), 1e12, device=dev), zero)

    full = (gain, cand_has, cand_r, cand_r_safe, cand_w)
    sel, gain, cand_has, cand_r, cand_r_safe, cand_w = compact_candidates(
        CAND_COMPACT, gain, cand_has, cand_r, cand_r_safe, cand_w)

    def run_assign(gn, ch, crs, cw):
        if multi:
            own_hr = (torch.minimum(dest_headroom, dest_stack_headroom)
                      if dest_stack_headroom is not None else dest_headroom)
            dt = ([(cw, own_hr)]
                  + [(t_w[crs], t_hr) for t_w, t_hr in dest_terms])
        else:
            dt = None

        def assign_with(dest_ids):
            fits = cw[:, None] <= dest_headroom[dest_ids][None, :]
            feasible = (fits & ch[:, None]
                        & _dest_feasibility(state, crs, dest_ok,
                                            accept_matrix_fn,
                                            partition_replicas, dest_ids))
            pref = torch.where(feasible, dest_pref[dest_ids][None, :],
                               torch.full((), NEG, device=dev))
            return assign_destinations(pref, gn, ch, num_b, dest_ids,
                                       dest_terms=dt, dest_cap=dest_cap)

        dest, valid = _assign_with_escalation(assign_with, dest_ok,
                                              dest_pref, ch, num_b)
        valid = resolve_dest_conflicts(state.replica_partition[crs], gn,
                                       valid, state.num_partitions)
        return dest, valid

    cand_dest, cand_valid = run_assign(gain, cand_has, cand_r_safe, cand_w)
    if sel is not None:
        g_f, h_f, r_f, rs_f, w_f = full
        c_pre = r_f.shape[0]
        dest_full = torch.zeros((c_pre,), dtype=torch.int32, device=dev)
        dest_full[sel] = cand_dest
        valid_full = torch.zeros((c_pre,), dtype=torch.bool, device=dev)
        valid_full[sel] = cand_valid
        if (assign_fallback and bool(torch.any(h_f))
                and not bool(torch.any(cand_valid))):
            dest_full, valid_full = run_assign(g_f, h_f, rs_f, w_f)
        cand_dest, cand_valid, cand_r = dest_full, valid_full, r_f
    return cand_r, cand_dest, cand_valid


def compact_candidates(width: int, gain, cand_has, *arrays):
    """Keep the top `width` candidates by gain (invalid rows last):
    (sel, gain, cand_has, *arrays), sel None when nothing was cut."""
    c = gain.shape[0]
    if c <= width:
        return (None, gain, cand_has) + tuple(arrays)
    inf = torch.full((), float("inf"), device=gain.device)
    _, sel = ops.topk_stable(torch.where(cand_has, gain, -inf), width)
    return ((sel, gain[sel], cand_has[sel])
            + tuple(a[sel] for a in arrays))


def _dest_shortlist(dest_ok, dest_pref) -> torch.Tensor:
    """int64[K] — the top-K eligible destinations by preference."""
    k = min(DEST_SHORTLIST, dest_ok.shape[0])
    inf = torch.full((), float("inf"), device=dest_pref.device)
    _, idx = ops.topk_stable(torch.where(dest_ok, dest_pref, -inf), k)
    return idx


def _assign_with_escalation(assign_with, dest_ok, dest_pref, cand_has,
                            num_b: int):
    """Assign on the destination shortlist; if candidates exist but none
    could be assigned, rerun on every broker."""
    dest_ids = _dest_shortlist(dest_ok, dest_pref)
    cand_dest, cand_valid = assign_with(dest_ids)
    if dest_ids.shape[0] >= num_b:
        return cand_dest, cand_valid
    if bool(torch.any(cand_has) & ~torch.any(cand_valid)):
        return assign_with(_arange(num_b, dest_ok.device))
    return cand_dest, cand_valid


# ---------------------------------------------------------------------------
# K2: one destination-assignment pass
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for int64 x in [0, 2**32), without int64
    overflow (the constant is split into 16-bit halves)."""
    lo = (x * (m & 0xFFFF)) & _U32
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _pairwise_jitter(num_c: int, num_b: int, salt: int = 0,
                     device=None) -> torch.Tensor:
    """f32[C, B] deterministic pseudo-random values in [0, 1): the
    reference's uint32 hash, emulated in int64."""
    c = torch.arange(num_c, dtype=torch.int64, device=device)[:, None]
    d = torch.arange(num_b, dtype=torch.int64, device=device)[None, :]
    x = (_mul_u32(c, 2654435761) + _mul_u32(d, 40503)
         + ((salt & _U32) * 97919 & _U32)) & _U32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 2246822519)
    x = x ^ (x >> 13)
    return (x & 0xFFFFFF).to(torch.float32) / float(1 << 24)


def assign_pass_plain(pref, dest_open, assigned, cand_has, k: int, amp):
    """Plain version of K2: one pass of assign_destinations — per
    candidate row, the first-max slot of the (jittered, for k > 0)
    preference over open destinations, and whether it is usable.
    Returns (best_slot i32[C], has bool[C])."""
    c, kk = pref.shape
    neg = torch.full((), NEG, dtype=pref.dtype, device=pref.device)
    if k == 0:
        pass_pref = pref
    else:
        finite = pref > NEG / 2
        jit = _pairwise_jitter(c, kk, salt=k, device=pref.device)
        pass_pref = torch.where(finite, pref + amp * jit, neg)
    open_pref = torch.where(dest_open[None, :], pass_pref, neg)
    open_pref = torch.where(assigned[:, None], neg, open_pref)
    mx, best_slot = torch.max(open_pref, 1)
    return best_slot.to(torch.int32), cand_has & (mx > NEG / 2)


def assign_pass(pref, dest_open, assigned, cand_has, k: int, amp):
    """K2 dispatch: the plain version on the CPU, csrc/assign_pass.cu on
    the card."""
    if not pref.is_cuda:
        return assign_pass_plain(pref, dest_open, assigned, cand_has, k, amp)
    from cruise_control_tpu_torch import cuda_kernels
    return cuda_kernels.assign_pass(pref, dest_open, assigned, cand_has, k,
                                    amp)


def assign_destinations(pref, gain, cand_has, num_b: int, dest_ids=None,
                        dest_terms=None, dest_cap=None):
    """Assign candidates to destination brokers over ASSIGN_PASSES passes
    (pass 0 un-jittered, later passes jittered per pass).  Single-commit
    (`dest_terms` None): one arrival per destination per round.
    Multi-commit: each destination accepts a gain-ranked prefix
    (rank_accept).  Returns (dest i32[C], valid bool[C])."""
    c, kk = pref.shape
    dev = pref.device
    if dest_ids is None:
        dest_ids = _arange(kk, dev)
    dest_ids = dest_ids.long()
    multi = dest_terms is not None
    finite = pref > NEG / 2
    inf = torch.full((), float("inf"), device=dev)
    pmax = torch.max(torch.where(finite, pref, -inf))
    pmin = torch.min(torch.where(finite, pref, inf))
    spread = torch.where(torch.isfinite(pmax - pmin), pmax - pmin,
                         torch.zeros((), device=dev))
    amp = 0.35 * spread + 1e-6

    taken_cnt = torch.zeros(num_b, dtype=torch.int32, device=dev)
    n_terms = len(dest_terms or ())
    # the terms' cumulants as the columns of one [B, terms] tensor: one
    # ordered scatter per pass updates them all
    cum = torch.zeros((num_b, n_terms), device=dev)
    assigned = torch.zeros(c, dtype=torch.bool, device=dev)
    dest = torch.zeros(c, dtype=torch.int32, device=dev)
    if multi:
        cap_b = (dest_cap if dest_cap is not None
                 else torch.full((num_b,), MAX_ARRIVALS_PER_ROUND,
                                 dtype=torch.int32, device=dev))
        d_w = [w_c for w_c, _ in dest_terms]
        hr = [hr_d for _, hr_d in dest_terms]
        if n_terms:
            w_all = torch.stack(d_w, 1)
            zero = torch.zeros((), device=dev)
    for k in range(MULTI_ASSIGN_PASSES if multi else ASSIGN_PASSES):
        if not multi:
            open_d = taken_cnt[dest_ids] == 0
        else:
            open_d = taken_cnt[dest_ids] < cap_b[dest_ids]
        best_slot, has = assign_pass(pref, open_d, assigned, cand_has, k,
                                     amp)
        best = dest_ids[best_slot.long()].to(torch.int32)
        if not multi:
            keep = resolve_dest_conflicts(best, gain, has, num_b)
        else:
            keep = rank_accept(best, gain, has, num_b, taken_cnt, cap_b,
                               list(cum.unbind(1)), d_w, hr)
        dest = torch.where(keep, best, dest)
        assigned = assigned | keep
        kept_d = torch.where(keep, best, torch.full_like(best, num_b))
        taken_cnt = taken_cnt + ops.segment_sum(
            torch.ones_like(kept_d), kept_d, num_b)
        if multi and n_terms:
            cum = ops.scatter_add_seq(
                cum, kept_d, torch.where(keep[:, None], w_all, zero))
    return dest, assigned


# ---------------------------------------------------------------------------
# Swap round
# ---------------------------------------------------------------------------

def swap_round(state: ClusterState, w, movable, hot_b, cold_b, util,
               target_util, accept_pair_fn, partition_replicas, cache=None,
               w_rows=None, lower=None, upper=None):
    """One round of batched replica-swap search: each hot broker
    nominates its largest movable replica, each cold broker its smallest;
    the worst SWAP_SHORTLIST brokers per side are paired on an [H, C]
    plane scored by squared-deviation improvement.  Returns (out_r
    i32[B], in_r i32[B], cold i32[B], valid bool[B])."""
    num_b = state.num_brokers
    rb = state.replica_broker.long()
    dev = w.device
    neg = torch.full((), NEG, device=dev)
    inf = torch.full((), float("inf"), device=dev)
    shortlist = min(SWAP_SHORTLIST, num_b)
    if _has_table(cache) and w_rows is not None:
        room = cache.table_fill < cache.broker_table.shape[1]
        hot_b = hot_b & room
        cold_b = cold_b & room
        ok = cache.table_ok & (w_rows > 0.0)
        out_r, out_has = rows_pick_best(
            cache, torch.where(ok & hot_b[:, None], w_rows, neg))
        in_r, in_has = rows_pick_best(
            cache, torch.where(ok & cold_b[:, None], -w_rows, neg))
    elif _has_table(cache):
        room = cache.table_fill < cache.broker_table.shape[1]
        hot_b = hot_b & room
        cold_b = cold_b & room
        out_r, out_has = table_pick_best(cache, w, movable & hot_b[rb])
        in_r, in_has = table_pick_best(cache, -w, movable & cold_b[rb])
    else:
        out_r, _, out_has = per_segment_argmax(w, rb, num_b,
                                               movable & hot_b[rb])
        in_r, _, in_has = per_segment_argmax(-w, rb, num_b,
                                             movable & cold_b[rb])
    out_safe = torch.clamp_min(out_r, 0).long()
    in_safe = torch.clamp_min(in_r, 0).long()
    w_out = w[out_safe]
    w_in = w[in_safe]

    dev_u = util - target_util
    hot_rank = torch.where(hot_b & out_has, dev_u, -inf)
    cold_rank = torch.where(cold_b & in_has, -dev_u, -inf)
    _, h_ids = ops.topk_stable(hot_rank, shortlist)
    _, c_ids = ops.topk_stable(cold_rank, shortlist)
    out_h = out_safe[h_ids]
    in_c = in_safe[c_ids]
    w_out_h = w_out[h_ids]
    w_in_c = w_in[c_ids]

    delta = w_out_h[:, None] - w_in_c[None, :]
    dev_h = dev_u[h_ids]
    dev_c = dev_u[c_ids]
    dev_before = (dev_h ** 2)[:, None] + (dev_c ** 2)[None, :]
    dev_after = ((dev_h[:, None] - delta) ** 2
                 + (dev_c[None, :] + delta) ** 2)
    imp = dev_before - dev_after

    def sibling_on(cand_rows, dest_ids):
        sib = partition_replicas[state.replica_partition[cand_rows].long()]
        sib_b = torch.where(sib >= 0, rb[torch.clamp_min(sib, 0).long()],
                            torch.full_like(sib, -1).long())
        return torch.any(sib_b[:, :, None] == dest_ids[None, None, :], 1)

    dup_out = sibling_on(out_h, c_ids)
    dup_in = sibling_on(in_c, h_ids)
    feasible = (out_has[h_ids][:, None] & in_has[c_ids][None, :]
                & hot_b[h_ids][:, None] & cold_b[c_ids][None, :]
                & (delta > 0) & (imp > 0)
                & ~dup_out & ~dup_in.T
                & accept_pair_fn(out_h[:, None], in_c[None, :]))
    if lower is not None:
        feasible &= util[h_ids][:, None] - delta >= lower[h_ids][:, None]
    if upper is not None:
        feasible &= util[c_ids][None, :] + delta <= upper[c_ids][None, :]

    score = torch.where(feasible, imp, neg)
    sel_h, cold_slot = torch.max(score, 1)
    valid_h = sel_h > NEG / 2
    cold_h = c_ids[cold_slot]
    valid_h = resolve_dest_conflicts(cold_h, sel_h, valid_h, num_b)
    p_out = state.replica_partition[out_h]
    p_in = state.replica_partition[torch.clamp_min(in_r[cold_h], 0).long()]
    valid_h = resolve_dest_conflicts(p_out, sel_h, valid_h,
                                     state.num_partitions)
    valid_h = resolve_dest_conflicts(p_in, sel_h, valid_h,
                                     state.num_partitions)
    cold = torch.zeros((num_b,), dtype=torch.int32, device=dev)
    cold[h_ids] = cold_h.to(torch.int32)
    valid = torch.zeros((num_b,), dtype=torch.bool, device=dev)
    valid[h_ids] = valid_h
    return out_r, in_r, cold, valid


def _swap_moves(state: ClusterState, out_r, in_r, cold, valid):
    """Flatten a swap round into one (replicas, dests, ok) move batch."""
    hot = torch.arange(state.num_brokers, dtype=torch.int32,
                       device=out_r.device)
    in_of_pair = in_r[cold.long()]
    replicas = torch.cat([torch.clamp_min(out_r, 0),
                          torch.clamp_min(in_of_pair, 0)])
    dests = torch.cat([cold, hot])
    ok = torch.cat([valid & (out_r >= 0), valid & (in_of_pair >= 0)])
    return replicas, dests, ok


def commit_moves_cached(state: ClusterState, cache, cand_r, cand_dest,
                        cand_valid):
    from cruise_control_tpu_torch.analyzer.context import \
        update_cache_for_moves
    r = torch.clamp_min(cand_r, 0)
    v = cand_valid & (cand_r >= 0)
    new_cache = update_cache_for_moves(state, cache, r, cand_dest, v)
    return S.apply_moves(state, r, cand_dest, v), new_cache


def commit_swaps_cached(state: ClusterState, cache, out_r, in_r, cold,
                        valid):
    from cruise_control_tpu_torch.analyzer.context import \
        update_cache_for_moves
    replicas, dests, ok = _swap_moves(state, out_r, in_r, cold, valid)
    new_cache = update_cache_for_moves(state, cache, replicas, dests, ok)
    return S.apply_moves(state, replicas, dests, ok), new_cache
