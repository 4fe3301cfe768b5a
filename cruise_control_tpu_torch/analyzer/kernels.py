"""Batched balancing-action search: the move and swap path (port of
cruise_control_tpu/analyzer/kernels.py).

Each round scores candidate (replica, destination) pairs in parallel,
picks candidates per source broker, assigns destinations in a few
passes and commits the non-conflicting batch.  The round's hot
functions are hand-written CUDA kernels on the card:

* K1 `row_topk` (csrc/row_topk.cu) behind `rows_pick_topk` /
  `rows_pick_best` and, reading per-replica scores through the broker
  table (`table_topk`), `table_pick_topk` / `table_pick_best`;
* K2 `assign_pass` (csrc/assign_pass.cu), one pass of
  `assign_destinations` with its open mask, broker ids, the fold of the
  pass before it and, in pass 0, the jitter amplitude;
* K4 `leader_assign_pass` (csrc/leader_assign.cu), one pass of
  `leadership_round`'s follower assignment with its option plane and
  amplitude (pass 0) and the fold of the pass before it;
* K7 `forced_select` (csrc/forced_select.cu), the candidate selection of
  a table-less `forced_move_round`;
* K8 `rank_accept` (csrc/rank_accept.cu), the multi-commit acceptance of
  every assignment pass (`rank_accept_commit`: with its lexsort and the
  pass's commit of arrival counts and cumulants, one launch up to 4,096
  candidates) and of the leadership sweep (`rank_accept`);
* K9 `segment_argmax` (csrc/segment_argmax.cu) behind
  `per_segment_argmax`, and its keep entry behind
  `resolve_dest_conflicts`;
* K10 `swap_pair` (csrc/swap_pair.cu), the swap round after its picks:
  the shortlists (`swap_shortlist`), then after the acceptance plane the
  pair plane, its conflict resolutions and the scatter (`swap_pair`);
* K11 `dest_feasibility` (csrc/dest_feasibility.cu), an assignment's
  whole preference plane (`assign_pref`: `_dest_feasibility`'s terms
  with the fit test and the preferences) and the guard of `cand_has_dest`
  / `feasible_dest_exists` with its top-broker selection;
* K14 `cumsum_blocks` (csrc/cumsum_blocks.cu), the source-side prefix
  gate of the move, leadership and pre-balance rounds (`prefix_gate`).

Their plain versions (`row_topk_plain`, `table_topk_plain`,
`assign_pass_plain`, `leader_assign_pass_plain`,
`forced_select_plain`, `rank_accept_plain`, `rank_accept_commit_plain`,
`per_segment_argmax_plain`, `resolve_dest_conflicts_plain`,
`swap_shortlist_plain`, `swap_pair_plain`, `dest_struct_plain`,
`dest_pref_plain`, `dest_has_plain`, `prefix_gate_plain`) live here; a
CPU tensor runs them.  The reference's `lax.cond` branches are host
`if`s on a 0-d tensor (one sync each).
"""
from __future__ import annotations

import dataclasses
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


def per_segment_argmax_plain(score: torch.Tensor, segment: torch.Tensor,
                             num_segments: int, valid: torch.Tensor):
    """Plain version of K9: for each segment the index of the max-score
    valid element: (arg i32[S] (-1 if none), max_score f32[S], has
    bool[S]); ties go to the lowest index, ids outside [0, S) are
    dropped."""
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


def _int_ids(ids: torch.Tensor) -> torch.Tensor:
    """Ids as K9 and K11 read them: int32 or int64, contiguous."""
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.to(torch.int32)
    return ids.contiguous()


def per_segment_argmax(score: torch.Tensor, segment: torch.Tensor,
                       num_segments: int, valid: torch.Tensor):
    """K9 dispatch: the plain version on the CPU, csrc/segment_argmax.cu
    on the card (one launch).  (arg i32[S], max_score f32[S], has
    bool[S])."""
    if not score.is_cuda:
        return per_segment_argmax_plain(score, segment, num_segments, valid)
    from cruise_control_tpu_torch import cuda_kernels
    return cuda_kernels.segment_argmax(score.contiguous(),
                                       _int_ids(segment),
                                       valid.contiguous(), num_segments)


def _has_table(cache) -> bool:
    return cache is not None and cache.broker_table.shape[1] > 0


def _table_rows(table: torch.Tensor, score: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """[B, S] per-slot scores gathered from per-replica arrays (pad slots
    gather an appended NEG sentinel)."""
    combined = torch.where(valid, score,
                           torch.full((), NEG, device=score.device))
    combined_p = torch.cat([combined,
                            torch.full((1,), NEG, device=score.device)])
    return combined_p[table.long()]


# ---------------------------------------------------------------------------
# K1: per-row top-k
# ---------------------------------------------------------------------------

def row_topk_plain(sc_rows: torch.Tensor, table: torch.Tensor, k: int):
    """Plain version of K1: per-row top-k of a NEG-masked [B, S] plane,
    score descending (XLA's total order: -0.0 below +0.0) then slot
    ascending, as jax.lax.top_k orders them.
    Returns (cand i32[B*k] replica id or -1, has bool[B*k], top f32[B, k],
    slot i32[B, k], any bool[B]: the row holds a score > NEG / 2)."""
    top, slots = ops.topk_total(sc_rows, k)
    cand = torch.gather(table, 1, slots)
    has = top > NEG / 2
    cand = torch.where(has, cand, torch.full_like(cand, -1))
    return (cand.reshape(-1).to(torch.int32), has.reshape(-1), top,
            slots.to(torch.int32), torch.any(sc_rows > NEG / 2, 1))


def row_topk(sc_rows: torch.Tensor, table: torch.Tensor, k: int):
    """K1 dispatch: the plain version on the CPU, one launch of
    csrc/row_topk.cu on the card."""
    if not sc_rows.is_cuda:
        return row_topk_plain(sc_rows, table, k)
    from cruise_control_tpu_torch import cuda_kernels
    return cuda_kernels.row_topk(sc_rows, table, k)


def table_topk_plain(table: torch.Tensor, score: torch.Tensor,
                     valid: torch.Tensor, k: int):
    """Plain version of K1's table source: `row_topk_plain` of the [B, S]
    plane valid[id] ? score[id] : NEG over the table's ids (the pad id R
    NEG)."""
    return row_topk_plain(_table_rows(table, score, valid), table, k)


def table_topk(table: torch.Tensor, score: torch.Tensor, valid: torch.Tensor,
               k: int):
    """K1 dispatch, table source: the plain version on the CPU, one launch
    of csrc/row_topk.cu on the card that reads the per-replica `score` and
    `valid` through the table (no [B, S] plane)."""
    if not table.is_cuda:
        return table_topk_plain(table, score, valid, k)
    from cruise_control_tpu_torch import cuda_kernels
    return cuda_kernels.table_topk(table, score, valid.contiguous(), k)


def rows_pick_best(cache, sc_rows: torch.Tensor):
    """Per-broker argmax over a [B, S] score plane (NEG = ineligible):
    (cand i32[B] replica id or -1, has bool[B])."""
    cand, has = row_topk(sc_rows, cache.broker_table, 1)[:2]
    return cand, has


def rows_pick_topk(cache, sc_rows: torch.Tensor, k: int):
    """Per-broker top-k over a [B, S] plane, flattened row-major:
    (cand i32[B*k], has bool[B*k], top_scores f32[B, k])."""
    k = min(k, max(cache.broker_table.shape[1], 1))
    return row_topk(sc_rows, cache.broker_table, k)[:3]


def table_pick_best(cache, score: torch.Tensor, valid: torch.Tensor):
    """Per-broker argmax over the table from per-replica score/valid (one
    K1 launch on the card)."""
    cand, has = table_topk(cache.broker_table, score, valid, 1)[:2]
    return cand, has


def table_pick_topk(cache, score: torch.Tensor, valid: torch.Tensor,
                    k: int):
    """Per-broker top-k over the table from per-replica score/valid,
    flattened to a candidate list: (cand i32[B*k], has bool[B*k])."""
    k = min(k, max(cache.broker_table.shape[1], 1))
    cand, has = table_topk(cache.broker_table, score, valid, k)[:2]
    return cand, has


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
    then index.  -0.0 is made +0.0 first (`gain + 0.0`): jnp.lexsort ties
    them, and a radix sort on the bits would not."""
    o1 = ops.argsort_stable(-(gain + 0.0))
    return o1[ops.argsort_stable(seg[o1])]


def rank_accept_plain(dest, gain, has, num_b: int, taken_cnt, cap, cum_d,
                      d_w, hr_d) -> torch.Tensor:
    """Plain version of K8: bool[C] multi-arrival acceptance for one
    assignment pass.  Per destination, candidates ranked by gain (ties by
    index) are accepted as a prefix while the arrival count stays under
    `cap` and every cumulative term stays within its headroom; the first
    arrival at a still-virgin destination bypasses the terms."""
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
        excl = ops.cumsum_f32_plain(w_s, 1) - w_s
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


def rank_accept(dest, gain, has, num_b: int, taken_cnt, cap, cum_d, d_w,
                hr_d) -> torch.Tensor:
    """K8 dispatch without the commit: the plain version on the CPU,
    csrc/rank_accept.cu on the card (up to C = 4096 one launch that sorts
    too; above, the torch lexsort first)."""
    if not dest.is_cuda:
        return rank_accept_plain(dest, gain, has, num_b, taken_cnt, cap,
                                 cum_d, d_w, hr_d)
    from cruise_control_tpu_torch import cuda_kernels
    dest32 = dest.to(torch.int32).contiguous()
    return cuda_kernels.rank_accept(
        dest32, gain.contiguous(), has.contiguous(), num_b,
        taken_cnt.to(torch.int32).contiguous(),
        cap.to(torch.int32).contiguous(), cum_d, d_w, hr_d,
        order=_order_above_one_block(dest32, gain, has, num_b))


def _order_above_one_block(dest, gain, has, num_b: int):
    """The torch lexsort K8 takes above its one-block width (None below:
    the kernel sorts)."""
    from cruise_control_tpu_torch.cuda_kernels import RANK_ONE_BLOCK_MAX
    if dest.shape[0] <= RANK_ONE_BLOCK_MAX:
        return None
    seg = torch.where(has, dest.long(), torch.full_like(dest, num_b).long())
    return _lexsort_dest_gain(seg, gain)


def rank_key(dest, gain, has, num_b: int) -> torch.Tensor:
    """K8's 64-bit sort key (csrc/rank_accept.cu `rank_key`), for C <=
    65,536 candidates and B <= 65,534: the segment (has ? dest : B) in
    bits 48-63, the complemented order-preserving bits of the gain (-0.0
    made +0.0) in bits 16-47, the index in bits 0-15.  Unique, and
    ascending keys are `jnp.lexsort((arange, -gain, seg))`.  Returned as
    int64 less 2**63, so that a signed sort gives the unsigned order."""
    c = dest.shape[0]
    seg = torch.where(has, dest.long(), torch.full_like(dest.long(), num_b))
    g = torch.where(gain == 0, torch.zeros_like(gain), gain)
    u = g.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    bits = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    low = ((bits ^ 0xFFFFFFFF) << 16) | _arange(c, dest.device)
    return (seg - (1 << 15)) * (1 << 48) + low


def rank_accept_commit_plain(dest, gain, has, num_b: int, taken_cnt, cap,
                             cum, d_w, hr) -> torch.Tensor:
    """Plain version of K8 with the pass commit: `rank_accept_plain`, then
    the reference's `taken_cnt.at[kept_d].add(1)` and, for each term t,
    `cum[t].at[kept_d].add(where(keep, d_w[t], 0))` in candidate order.
    `cum` f32[T, B], `d_w` f32[T, C], `hr` f32[T, B]; `taken_cnt` and
    `cum` are updated in place.  Returns keep bool[C]."""
    keep = rank_accept_plain(dest, gain, has, num_b, taken_cnt, cap,
                             list(cum), list(d_w), list(hr))
    kept_d = torch.where(keep, dest, torch.full_like(dest, num_b))
    taken_cnt += ops.segment_sum_plain(torch.ones_like(kept_d), kept_d,
                                       num_b)
    if cum.shape[0]:
        cum.T.copy_(ops.scatter_add_seq_plain(
            cum.T, kept_d, torch.where(keep[:, None], d_w.T,
                                       torch.zeros((), device=cum.device))))
    return keep


def rank_accept_commit(dest, gain, has, num_b: int, taken_cnt, cap, cum,
                       d_w, hr) -> torch.Tensor:
    """K8 dispatch with the pass commit: keep bool[C], and `taken_cnt`
    (i32[B]) and `cum` (f32[T, B]) updated in place.  The plain version on
    the CPU; on the card csrc/rank_accept.cu, one launch up to C = 4096
    (sort, acceptance and commit), above it the torch lexsort and the
    kernel's separate launches."""
    if not dest.is_cuda:
        return rank_accept_commit_plain(dest, gain, has, num_b, taken_cnt,
                                        cap, cum, d_w, hr)
    from cruise_control_tpu_torch import cuda_kernels
    dest32 = dest.to(torch.int32).contiguous()
    return cuda_kernels.rank_accept(
        dest32, gain.contiguous(), has.contiguous(), num_b, taken_cnt,
        cap.to(torch.int32).contiguous(), cum, d_w.contiguous(),
        hr.contiguous(), order=_order_above_one_block(dest32, gain, has,
                                                      num_b),
        commit=True)


def resolve_dest_conflicts_plain(dest, gain, valid,
                                 num_segments: int) -> torch.Tensor:
    """Plain version of K9's keep entry: bool[C], at most one winning
    candidate per destination segment (the max gain, ties to the lowest
    index) among the valid ones."""
    seg = torch.where(valid, dest.long(), torch.zeros_like(dest).long())
    arg, _, _ = per_segment_argmax_plain(gain, seg, num_segments, valid)
    idx = _arange(dest.shape[0], dest.device)
    return valid & (arg.long()[seg] == idx)


def resolve_dest_conflicts(dest, gain, valid, num_brokers: int):
    """Keep at most one winning candidate per destination segment.  The
    plain version on the CPU; on the card one launch of K9's keep entry
    (csrc/segment_argmax.cu cc_segment_keep)."""
    if not gain.is_cuda:
        return resolve_dest_conflicts_plain(dest, gain, valid, num_brokers)
    from cruise_control_tpu_torch import cuda_kernels
    return cuda_kernels.segment_keep(gain.contiguous(), _int_ids(dest),
                                     valid.contiguous(), num_brokers)


# ---------------------------------------------------------------------------
# Feasibility
# ---------------------------------------------------------------------------

def dest_struct_plain(cand_r, dest_ids, dest_ok, replica_broker,
                      replica_partition, partition_replicas) -> torch.Tensor:
    """The structural terms of K11's preference plane (plain): bool[C, K]
    feasibility of moving cand_r[c] to dest_ids[k] -- an eligible broker,
    not the current one, and (with partition_replicas) no second replica
    of the partition there."""
    dest_ids = dest_ids.long()
    cand_r = cand_r.long()
    rb = replica_broker
    feasible = dest_ok[dest_ids][None, :].expand(
        cand_r.shape[0], dest_ids.shape[0]).clone()
    feasible &= dest_ids[None, :] != rb[cand_r][:, None]
    if partition_replicas is not None:
        siblings = partition_replicas[replica_partition[cand_r].long()]
        sib_valid = siblings >= 0
        sib_broker = rb[torch.clamp_min(siblings, 0).long()]
        dup = torch.any(sib_valid[:, :, None]
                        & (sib_broker[:, :, None] == dest_ids[None, None, :]),
                        dim=1)
        feasible &= ~dup
    return feasible


def _dest_feasibility(state: ClusterState, cand_r, dest_ok,
                      accept_matrix_fn, partition_replicas=None,
                      dest_ids=None) -> torch.Tensor:
    """bool[C, K] structural destination feasibility: eligible broker,
    not the current broker, no second replica of the partition, and the
    composed acceptance stack -- the plain composite of torch ops that
    the tests hold to the reference (the rounds build the whole
    preference plane, these terms inside, with `assign_pref`: one K11
    launch on the card)."""
    if dest_ids is None:
        dest_ids = _arange(state.num_brokers, state.device)
    feasible = dest_struct_plain(cand_r, dest_ids, dest_ok,
                                 state.replica_broker,
                                 state.replica_partition, partition_replicas)
    return feasible & accept_matrix_fn(cand_r.long()[:, None],
                                       dest_ids.long()[None, :])


def dest_pref_plain(state: ClusterState, cand_r, dest_ids, dest_ok,
                    dest_pref, accept, partition_replicas, cand_has=None,
                    w_c=None, dest_headroom=None) -> torch.Tensor:
    """Plain version of K11's preference entry: f32[C, K] preference
    plane of an assignment, dest_pref[d] (d = dest_ids[k]) where the
    candidate has a pick (cand_has), the move is structurally feasible,
    it fits (w_c <= dest_headroom[d], when given) and the acceptance
    plane `accept` (any shape that broadcasts to [C, K]) allows it; NEG
    elsewhere."""
    dest_ids = dest_ids.long()
    feasible = dest_struct_plain(cand_r, dest_ids, dest_ok,
                                 state.replica_broker,
                                 state.replica_partition,
                                 partition_replicas) & accept
    if w_c is not None:
        feasible = (w_c[:, None] <= dest_headroom[dest_ids][None, :]) \
            & feasible
    if cand_has is not None:
        feasible = cand_has[:, None] & feasible
    return torch.where(feasible, dest_pref[dest_ids][None, :],
                       torch.full((), NEG, device=dest_pref.device))


def assign_pref(state: ClusterState, cand_r, dest_ids, dest_ok, dest_pref,
                accept_matrix_fn, partition_replicas, cand_has=None,
                w_c=None, dest_headroom=None) -> torch.Tensor:
    """K11 dispatch (preference entry): the preference plane of an
    assignment over the shortlist `dest_ids`, the acceptance stack's own
    torch ops beside it.  The plain version on the CPU, one launch of
    csrc/dest_feasibility.cu cc_dest_pref on the card."""
    accept = accept_matrix_fn(cand_r.long()[:, None],
                              dest_ids.long()[None, :])
    if not cand_r.is_cuda:
        return dest_pref_plain(state, cand_r, dest_ids, dest_ok, dest_pref,
                               accept, partition_replicas, cand_has, w_c,
                               dest_headroom)
    from cruise_control_tpu_torch import cuda_kernels
    return cuda_kernels.dest_pref(
        _int_ids(cand_r), _int_ids(dest_ids), dest_ok.contiguous(),
        state.replica_broker, state.replica_partition, partition_replicas,
        None if cand_has is None else cand_has.contiguous(), w_c,
        dest_headroom, accept, dest_pref)


def top_headroom(dest_ok, dest_headroom, rf: int):
    """(top_b int64[k], top_h f32[k]) — the min(RF+2, B) eligible brokers
    with the most headroom (ineligible ones at -inf), ties to the lower
    broker id: a replica's blocked set (its own and its siblings'
    brokers) has at most RF members, so one of them is unblocked unless
    too few brokers are eligible."""
    k = min(rf + 2, dest_ok.shape[0])
    inf = torch.full((), float("inf"), device=dest_headroom.device)
    top_h, top_b = ops.topk_total(torch.where(dest_ok, dest_headroom, -inf),
                                  k)
    return top_b, top_h


def dest_has_plain(cand_r, w_c, dest_ok, dest_headroom, replica_broker,
                   replica_partition, partition_replicas) -> torch.Tensor:
    """Plain version of K11's guard entry: bool[C], best[c] >= w_c[c]
    where best is the most headroom among the top min(RF + 2, B) brokers
    (top_headroom) that hold no replica of the candidate's partition
    (cand_r None: every replica)."""
    top_b, top_h = top_headroom(dest_ok, dest_headroom,
                                partition_replicas.shape[1])
    rows = (replica_partition if cand_r is None
            else replica_partition[cand_r.long()]).long()
    inf = torch.full((), float("inf"), device=top_h.device)
    sib = partition_replicas[rows]
    sib_broker = torch.where(
        sib >= 0, replica_broker[torch.clamp_min(sib, 0).long()],
        torch.full_like(sib, -1))
    blocked = torch.any(sib_broker[:, :, None] == top_b[None, None, :], 1)
    best = torch.max(torch.where(blocked, -inf, top_h[None, :]), 1).values
    return best >= w_c


def dest_has(cand_r, w_c, dest_ok, dest_headroom, replica_broker,
             replica_partition, partition_replicas) -> torch.Tensor:
    """K11 dispatch (guard entry): the plain version on the CPU; on the
    card one launch of csrc/dest_feasibility.cu cc_dest_has, which selects
    the top brokers itself."""
    if not w_c.is_cuda:
        return dest_has_plain(cand_r, w_c, dest_ok, dest_headroom,
                              replica_broker, replica_partition,
                              partition_replicas)
    from cruise_control_tpu_torch import cuda_kernels
    return cuda_kernels.dest_has(
        None if cand_r is None else _int_ids(cand_r), w_c,
        dest_ok.contiguous(), dest_headroom, replica_broker,
        replica_partition, partition_replicas)


def cand_has_dest(state, cand_r, w_c, dest_ok, dest_headroom,
                  partition_replicas) -> torch.Tensor:
    """bool[C] — does some destination fit each candidate (top RF+2
    headroom argument)?"""
    return dest_has(cand_r, w_c, dest_ok, dest_headroom,
                    state.replica_broker, state.replica_partition,
                    partition_replicas)


def feasible_dest_exists(state, w, dest_ok, dest_headroom,
                         partition_replicas) -> torch.Tensor:
    """bool[R] — replica-level form of cand_has_dest."""
    return dest_has(None, w, dest_ok, dest_headroom, state.replica_broker,
                    state.replica_partition, partition_replicas)


def shed_score(w: torch.Tensor, excess_r: torch.Tensor) -> torch.Tensor:
    """Replicas fitting the excess beat overshooting ones; largest
    fitting first, smallest overshooting first."""
    return torch.where(w <= excess_r, w, -w)


# ---------------------------------------------------------------------------
# K14: the source-side prefix gate of a [B, k] candidate table
# ---------------------------------------------------------------------------

def prefix_gate_plain(has, w, excess, cand, terms, k: int) -> torch.Tensor:
    """Plain version of K14: bool[B*k], the pessimistic source-side
    prefix gate over each broker's rank-ordered row of k candidates (the
    reference's round bodies, `jnp.cumsum` in XLA:CPU's order).  First
    `wm = has ? w : 0` and `has &= scan(wm) - wm < excess[b]`; then for
    each term (t_w, t_hr) in order `tw = has ? t_w[max(cand, 0)] : 0`
    (t_w None: weight 1.0) and `has &= (j == 0) | (scan(tw) <=
    t_hr[b])`, each term on the `has` the one before left.
    `w` f32[B*k] per candidate, `cand` the candidate replica ids (-1 for
    none), `t_w` f32[R], `excess` and `t_hr` f32[B]."""
    num_b = excess.shape[0]
    zero = torch.zeros((), device=w.device)
    wm = torch.where(has, w, zero).reshape(num_b, k)
    before = ops.cumsum_f32_plain(wm, 1) - wm
    has = has & (before < excess[:, None]).reshape(-1)
    rank = _arange(k, w.device)[None, :]
    safe = torch.clamp_min(cand, 0).long()
    one = torch.ones((), device=w.device)
    for t_w, t_hr in terms:
        tw = torch.where(has, one if t_w is None else t_w[safe],
                         zero).reshape(num_b, k)
        incl = ops.cumsum_f32_plain(tw, 1)
        has = has & ((rank == 0) | (incl <= t_hr[:, None])).reshape(-1)
    return has


def prefix_gate(has, w, excess, cand, terms, k: int) -> torch.Tensor:
    """K14 dispatch (see `prefix_gate_plain`): the plain version on the
    CPU, one launch of csrc/cumsum_blocks.cu on the card."""
    from cruise_control_tpu_torch import cuda_kernels
    terms = list(terms)
    cuda_kernels.check_gate(k, len(terms))
    if not w.is_cuda:
        return prefix_gate_plain(has, w, excess, cand, terms, k)
    return cuda_kernels.prefix_gate(has.contiguous(), w.contiguous(), excess,
                                    cand.to(torch.int32).contiguous(), terms,
                                    k)


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
        cand_r, cand_struct, _, _, struct_any = row_topk(
            sc_rows, cache.broker_table, kk)
        cand_r_safe = torch.clamp_min(cand_r, 0).long()
        cand_w = w[cand_r_safe]
        hd = cand_has_dest(state, cand_r_safe, cand_w, dest_ok,
                           dest_headroom, partition_replicas)
        cand_has = cand_struct & hd
        if kk > 1:
            # cumulative-excess gate, prefix-pessimistic (rank 0 free for
            # the source-side terms)
            cand_has = prefix_gate(cand_has, cand_w, src_excess, cand_r,
                                   (src_terms or ()) if multi else (), kk)

        # starvation escalation, thin-progress form (struct_any: K1's rows
        # holding an eligible slot)
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
            pref = assign_pref(state, crs, dest_ids, dest_ok, dest_pref,
                               accept_matrix_fn, partition_replicas, ch, cw,
                               dest_headroom)
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
    _, sel = ops.topk_total(torch.where(cand_has, gain, -inf), width)
    return ((sel, gain[sel], cand_has[sel])
            + tuple(a[sel] for a in arrays))


def _dest_shortlist(dest_ok, dest_pref) -> torch.Tensor:
    """int64[K] — the top-K eligible destinations by preference."""
    k = min(DEST_SHORTLIST, dest_ok.shape[0])
    inf = torch.full((), float("inf"), device=dest_pref.device)
    _, idx = ops.topk_total(torch.where(dest_ok, dest_pref, -inf), k)
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


def salted_jitter(n: int, salt, device=None) -> torch.Tensor:
    """f32[n] deterministic pseudo-random values in [0, 1) keyed by a
    scalar salt (an int or a 0-d integer tensor, read as the reference's
    int32 -> uint32 cast): the reference's uint32 hash, emulated in
    int64."""
    if isinstance(salt, torch.Tensor):
        device = salt.device if device is None else device
        salt_u = salt.to(device=device, dtype=torch.int64) & _U32
        mix = _mul_u32((salt_u + 1) & _U32, 97919)
    else:
        # a host salt mixes on the host: no host-to-device copy
        mix = ((((int(salt) & _U32) + 1) & _U32) * 97919) & _U32
    i = torch.arange(n, dtype=torch.int64, device=device)
    x = (_mul_u32(i, 2654435761) + mix) & _U32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 2246822519)
    x = x ^ (x >> 13)
    return (x & 0xFFFFFF).to(torch.float32) / float(1 << 24)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound."""
    return (((x + 2 ** 31) & _U32) - 2 ** 31).to(torch.int32)


def rotation_salt(leader_count: torch.Tensor,
                  load_col: torch.Tensor) -> torch.Tensor:
    """i32 0-d state-hash salt for window tie-rotation: a float mix of
    leader counts and loads reduced mod 2**31 before the cast, plus an
    integral leader-count term with int32 wraparound (the reference's
    int32-safe form).  Float sums follow XLA:CPU's order (ops.sum_f32)."""
    num_b = leader_count.shape[0]
    dev = leader_count.device
    hash_w = salted_jitter(num_b, 13, device=dev)
    float_mix = (ops.sum_f32(leader_count.to(torch.float32) * hash_w)
                 + ops.sum_f32(load_col * hash_w))
    int_w = (hash_w * 1021.0).to(torch.int32)
    int_mix = torch.sum(leader_count.to(torch.int64) * int_w.to(torch.int64))
    rem = ops.remainder_f(float_mix, 2.0 ** 31)
    # XLA's float -> int32 convert saturates (NaN -> 0)
    as_int = torch.where(torch.isnan(rem), torch.zeros_like(rem), rem)
    as_int = torch.clamp(as_int.to(torch.int64), -2 ** 31, 2 ** 31 - 1)
    return _wrap_i32(as_int + _wrap_i32(int_mix).to(torch.int64))


def table_window_gain(cand_bonus_b, cand_has, salt_r) -> torch.Tensor:
    """f32[C] window selection score of the leadership table round: each
    candidate's bonus plus 0.35 x the spread of the candidates' bonuses x
    a salted jitter, the product and the sum rounded once (the
    reference's compiled round contracts them into one FMA)."""
    inf = torch.full((), float("inf"), device=cand_bonus_b.device)
    g_lo = torch.min(torch.where(cand_has, cand_bonus_b, inf))
    g_hi = torch.max(torch.where(cand_has, cand_bonus_b, -inf))
    spread_g = torch.where(g_hi > g_lo, g_hi - g_lo,
                           torch.clamp_min(torch.abs(g_hi), 1.0))
    jitter = salted_jitter(cand_bonus_b.shape[0], salt_r)
    return ops.fma_f32(0.35 * spread_g, jitter, cand_bonus_b)


def assign_amp(pref) -> torch.Tensor:
    """f32 0-d jitter amplitude of an assignment: 0.35 times the spread of
    the finite (> NEG / 2) preferences, 0 when there is none or the spread
    is not finite, plus 1e-6, rounded once (one FMA, as the reference's
    compiled program contracts it)."""
    dev = pref.device
    finite = pref > NEG / 2
    inf = torch.full((), float("inf"), device=dev)
    pmax = torch.max(torch.where(finite, pref, -inf))
    pmin = torch.min(torch.where(finite, pref, inf))
    spread = torch.where(torch.isfinite(pmax - pmin), pmax - pmin,
                         torch.zeros((), device=dev))
    return ops.fma_f32(torch.full((), 0.35, device=dev), spread,
                       torch.full((), 1e-6, device=dev))


def assign_pass_plain(pref, dest_ids, taken_cnt, cap, cand_has, k: int, amp,
                      assigned, dest, keep=None, prev_best=None):
    """Plain version of K2: one pass of assign_destinations.  First the
    previous pass's fold: where `keep`, dest = prev_best and assigned =
    True (`dest` and `assigned` are updated in place).  Pass 0 writes
    the jitter amplitude (assign_amp) into the 0-d `amp`; later passes
    read it.  Then, per candidate row, the first-max slot of the
    (jittered for k > 0: fma(amp, jitter, pref), one rounding, as the
    reference's compiled pass) preference over the open destination
    slots -- slot j is open while taken_cnt[dest_ids[j]] <
    cap[dest_ids[j]] (cap None: 1, one arrival a destination) -- for rows
    not yet assigned.
    Returns (best i32[C], the broker id dest_ids[slot]; has bool[C],
    whether the row has a usable slot)."""
    c, kk = pref.shape
    if keep is not None:
        dest.copy_(torch.where(keep, prev_best, dest))
        assigned |= keep
    if k == 0:
        amp.copy_(assign_amp(pref))
    ids = dest_ids.long()
    dest_open = taken_cnt[ids] < (cap[ids] if cap is not None else 1)
    neg = torch.full((), NEG, dtype=pref.dtype, device=pref.device)
    if k == 0:
        pass_pref = pref
    else:
        finite = pref > NEG / 2
        jit = _pairwise_jitter(c, kk, salt=k, device=pref.device)
        pass_pref = torch.where(finite, ops.fma_f32(amp, jit, pref), neg)
    open_pref = torch.where(dest_open[None, :], pass_pref, neg)
    open_pref = torch.where(assigned[:, None], neg, open_pref)
    mx, best_slot = torch.max(open_pref, 1)
    return (dest_ids[best_slot].to(torch.int32),
            cand_has & (mx > NEG / 2))


def assign_pass(pref, dest_ids, taken_cnt, cap, cand_has, k: int, amp,
                assigned, dest, keep=None, prev_best=None):
    """K2 dispatch (see `assign_pass_plain`): the plain version on the
    CPU, one launch of csrc/assign_pass.cu on the card."""
    if not pref.is_cuda:
        return assign_pass_plain(pref, dest_ids, taken_cnt, cap, cand_has,
                                 k, amp, assigned, dest, keep, prev_best)
    from cruise_control_tpu_torch import cuda_kernels
    return cuda_kernels.assign_pass(pref, dest_ids, taken_cnt, cap, cand_has,
                                    k, amp, assigned, dest, keep, prev_best)


def _stack_rows(rows, n: int, dev) -> torch.Tensor:
    """f32[T, n] of T f32[n] rows (f32[0, n] for none), contiguous."""
    if not rows:
        return torch.zeros((0, n), device=dev)
    return torch.stack(list(rows)).contiguous()


def assign_destinations(pref, gain, cand_has, num_b: int, dest_ids=None,
                        dest_terms=None, dest_cap=None):
    """Assign candidates to destination brokers over ASSIGN_PASSES passes
    (pass 0 un-jittered, later passes jittered per pass).  Single-commit
    (`dest_terms` None): one arrival per destination per round.
    Multi-commit: each destination accepts a gain-ranked prefix
    (rank_accept).  A multi-commit pass is K2 (which folds the pass
    before it into `dest` and `assigned`, builds the open mask and, in
    pass 0, the jitter amplitude) and K8 (acceptance and commit), with
    nothing between them.  Returns (dest i32[C], valid bool[C])."""
    c, kk = pref.shape
    dev = pref.device
    if dest_ids is None:
        dest_ids = torch.arange(kk, dtype=torch.int32, device=dev)
    dest_ids = dest_ids.to(torch.int32)
    multi = dest_terms is not None
    amp = torch.empty((), device=dev)
    taken_cnt = torch.zeros(num_b, dtype=torch.int32, device=dev)
    assigned = torch.zeros(c, dtype=torch.bool, device=dev)
    dest = torch.zeros(c, dtype=torch.int32, device=dev)
    cap_b = None
    if multi:
        cap_b = (dest_cap if dest_cap is not None
                 else torch.full((num_b,), MAX_ARRIVALS_PER_ROUND,
                                 dtype=torch.int32, device=dev))
        # the terms stacked once: K8 ranks, accepts and commits each pass,
        # updating taken_cnt and the [T, B] cumulants in place
        cum = torch.zeros((len(dest_terms), num_b), device=dev)
        d_w = _stack_rows([w_c for w_c, _ in dest_terms], c, dev)
        hr = _stack_rows([hr_d for _, hr_d in dest_terms], num_b, dev)
    keep = best = None
    for k in range(MULTI_ASSIGN_PASSES if multi else ASSIGN_PASSES):
        best, has = assign_pass(pref, dest_ids, taken_cnt, cap_b, cand_has,
                                k, amp, assigned, dest, keep, best)
        if multi:
            keep = rank_accept_commit(best, gain, has, num_b, taken_cnt,
                                      cap_b, cum, d_w, hr)
        else:
            keep = resolve_dest_conflicts(best, gain, has, num_b)
            kept_d = torch.where(keep, best, torch.full_like(best, num_b))
            taken_cnt = taken_cnt + ops.segment_sum(
                torch.ones_like(kept_d), kept_d, num_b)
    # the last pass's fold
    return torch.where(keep, best, dest), assigned | keep


# ---------------------------------------------------------------------------
# K7: forced-candidate selection, and the forced-move round
# ---------------------------------------------------------------------------

def forced_select_plain(forced, w, replica_partition, replica_broker,
                        partition_replicas, top_b, top_h, k: int):
    """Plain version of K7: the table-less candidate selection of a
    forced-move round.  forced_ok = forced & feasible_dest_exists (the
    guard against the top headroom brokers `top_b` / `top_h`), then
    jax.lax.top_k of `forced_ok ? w + 1 : -inf` over all R replicas
    (score descending, ties and the -inf tail in index order; the
    tie-blind sort is that order here: w + 1.0 is never -0.0, so no two
    scores are zeros of both signs).  Returns
    (cand_r i32[k], cand_has bool[k], forced_ok bool[R]); k == 0 computes
    only the guard (the first two are None)."""
    inf = torch.full((), float("inf"), device=w.device)
    sib = partition_replicas[replica_partition.long()]
    sib_broker = torch.where(
        sib >= 0, replica_broker[torch.clamp_min(sib, 0).long()],
        torch.full_like(sib, -1))
    blocked = torch.any(sib_broker[:, :, None] == top_b[None, None, :], 1)
    best = torch.max(torch.where(blocked, -inf, top_h[None, :]), 1).values
    forced_ok = forced & (best >= w)
    if k == 0:
        return None, None, forced_ok
    _, idx = ops.topk_stable(torch.where(forced_ok, w + 1.0, -inf), k)
    return idx.to(torch.int32), forced_ok[idx], forced_ok


def forced_select(forced, w, replica_partition, replica_broker,
                  partition_replicas, top_b, top_h, k: int):
    """K7 dispatch: the plain version on the CPU, csrc/forced_select.cu on
    the card."""
    if not w.is_cuda:
        return forced_select_plain(forced, w, replica_partition,
                                   replica_broker, partition_replicas, top_b,
                                   top_h, k)
    from cruise_control_tpu_torch import cuda_kernels
    return cuda_kernels.forced_select(
        forced.contiguous(), w.contiguous(), replica_partition,
        replica_broker, partition_replicas,
        top_b.to(torch.int32).contiguous(), top_h.contiguous(), k)


def forced_move_round(state: ClusterState, forced, w, dest_ok,
                      accept_matrix_fn, dest_pref, partition_replicas,
                      max_candidates: int = 4096,
                      cap_alive_sources: bool = True, cache=None,
                      dest_terms=None, dest_stack_headroom=None,
                      stack_w=None):
    """One round of global forced-move search (self-healing, rack
    awareness): candidates are not limited to one per source broker.
    Without a broker table the top `max_candidates` forced replicas
    (largest load first) come from K7; with one, a per-broker row top-k
    (k = 1 when alive sources are capped to one departure, else 4) with a
    guarded re-pick when every candidate is blocked.  `dest_terms`
    switches the assignment to multi-commit.  Returns (cand_r i32[C],
    cand_dest i32[C], cand_valid bool[C])."""
    num_b = state.num_brokers
    rb = state.replica_broker.long()
    dev = w.device
    max_candidates = min(max_candidates, state.num_replicas)
    multi = dest_terms is not None
    dest_cap = None
    rf = partition_replicas.shape[1]
    inf_room = torch.full((num_b,), float("inf"), device=dev)
    neg = torch.full((), NEG, device=dev)

    if _has_table(cache):
        dest_ok = dest_ok & (cache.table_fill < cache.broker_table.shape[1])
        if multi:
            dest_cap = (cache.broker_table.shape[1]
                        - cache.table_fill).to(torch.int32)
        k = 1 if cap_alive_sources else 4
        # candidates first, destination existence second; if every
        # candidate of the round is blocked while forced replicas remain,
        # re-pick once among the guarded replicas
        score = torch.where(forced, w + 1.0, neg)
        cand_r, cand_struct = table_pick_topk(cache, score, forced, k)
        cand_r = torch.clamp_min(cand_r, 0)
        cand_has = cand_struct & cand_has_dest(
            state, cand_r, w[cand_r.long()], dest_ok, inf_room,
            partition_replicas)
        if bool(torch.any(cand_struct) & ~torch.any(cand_has)):
            top_b, top_h = top_headroom(dest_ok, inf_room, rf)
            _, _, forced_ok = forced_select(
                forced, w, state.replica_partition, state.replica_broker,
                partition_replicas, top_b, top_h, 0)
            f_cand, f_has = table_pick_topk(
                cache, torch.where(forced_ok, w + 1.0, neg), forced_ok, k)
            cand_r, cand_has = torch.clamp_min(f_cand, 0), f_has
    else:
        top_b, top_h = top_headroom(dest_ok, inf_room, rf)
        cand_r, cand_has, _ = forced_select(
            forced, w, state.replica_partition, state.replica_broker,
            partition_replicas, top_b, top_h, max_candidates)

    cand_rl = cand_r.long()
    fits_w = w[cand_rl]
    d_terms = ([(t_w[cand_rl], t_hr) for t_w, t_hr in dest_terms]
               if multi else None)
    if multi and dest_stack_headroom is not None:
        # spreading bound: without it a round stacks a whole evacuation
        # onto the single best destination
        sw = (stack_w if stack_w is not None else w)[cand_rl]
        d_terms = [(sw, dest_stack_headroom)] + d_terms

    def assign_with(dest_ids):
        pref = assign_pref(state, cand_rl, dest_ids, dest_ok, dest_pref,
                           accept_matrix_fn, partition_replicas, cand_has)
        return assign_destinations(pref, fits_w, cand_has, num_b, dest_ids,
                                   dest_terms=d_terms, dest_cap=dest_cap)

    cand_dest, cand_valid = _assign_with_escalation(
        assign_with, dest_ok, dest_pref, cand_has, num_b)
    cand_valid = resolve_dest_conflicts(state.replica_partition[cand_rl],
                                        fits_w, cand_valid,
                                        state.num_partitions)
    if cap_alive_sources:
        # at most one departure per ALIVE source per round (a source-side
        # acceptance snapshot stays valid); dead sources stay uncapped
        src = rb[cand_rl]
        alive_src = state.broker_alive[src]
        cand_valid = (cand_valid & ~alive_src) | resolve_dest_conflicts(
            src, fits_w, cand_valid & alive_src, num_b)
    return cand_r, cand_dest, cand_valid


# ---------------------------------------------------------------------------
# Swap round
# ---------------------------------------------------------------------------

def swap_shortlist_plain(hot_b, cold_b, out_r, in_r, out_has, in_has, dev_u,
                         util, target_util, shortlist: int):
    """Plain version of K10's shortlist entry: each side's worst
    `shortlist` brokers, ranked by dev = dev_u (or util - target_util
    when None): hot ranks dev, cold ranks -dev, brokers off a side (or
    without a pick) at -inf, in jax.lax.top_k's order (-0.0 below +0.0,
    ties to the lower broker id).  Returns (h_ids i64[H], c_ids i64[H],
    out_h i64[H] = max(out_r, 0)[h_ids], in_c i64[H] = max(in_r,
    0)[c_ids], dev f32[B])."""
    if dev_u is None:
        dev_u = util - target_util
    inf = torch.full((), float("inf"), device=dev_u.device)
    hot_rank = torch.where(hot_b & out_has, dev_u, -inf)
    cold_rank = torch.where(cold_b & in_has, -dev_u, -inf)
    _, h_ids = ops.topk_total(hot_rank, shortlist)
    _, c_ids = ops.topk_total(cold_rank, shortlist)
    out_h = torch.clamp_min(out_r, 0).long()[h_ids]
    in_c = torch.clamp_min(in_r, 0).long()[c_ids]
    return h_ids, c_ids, out_h, in_c, dev_u


def swap_shortlist(hot_b, cold_b, out_r, in_r, out_has, in_has, dev_u, util,
                   target_util, shortlist: int):
    """K10 dispatch, shortlist entry: the plain version on the CPU, one
    launch of csrc/swap_pair.cu cc_swap_shortlist on the card."""
    if not hot_b.is_cuda:
        return swap_shortlist_plain(hot_b, cold_b, out_r, in_r, out_has,
                                    in_has, dev_u, util, target_util,
                                    shortlist)
    from cruise_control_tpu_torch import cuda_kernels
    return cuda_kernels.swap_shortlist(
        hot_b.contiguous(), cold_b.contiguous(), out_r.contiguous(),
        in_r.contiguous(), out_has.contiguous(), in_has.contiguous(), dev_u,
        util, target_util, shortlist)


def swap_plane_plain(h_ids, c_ids, out_r, in_r, out_has, in_has, hot_b,
                     cold_b, w, dev_u, util, lower, upper, accept,
                     replica_partition, partition_replicas, replica_broker):
    """The swap round's [H, C] pair plane.  Hot row h sheds broker
    h_ids[h]'s replica, cold column c takes broker c_ids[c]'s; a pair is
    feasible when both picks exist, the exchange moves load hot -> cold
    and lowers the squared deviation, neither replica meets a sibling, the
    acceptance plane allows it and it stays inside the band (`lower` /
    `upper`, when given).  Returns (sel f32[H], the best improvement or
    NEG; slot int64[H], its first cold column)."""
    neg = torch.full((), NEG, device=w.device)
    h_ids = h_ids.long()
    c_ids = c_ids.long()
    rb = replica_broker.long()
    out_h = torch.clamp_min(out_r, 0).long()[h_ids]
    in_c = torch.clamp_min(in_r, 0).long()[c_ids]
    delta = w[out_h][:, None] - w[in_c][None, :]
    dev_h = dev_u[h_ids][:, None]
    dev_c = dev_u[c_ids][None, :]
    # each sum of squares is one fused multiply-add in the reference's
    # compiled program: fma(x, x, y * y)
    dev_before = ops.fma_f32(dev_h, dev_h, (dev_c * dev_c).expand_as(delta))
    dev_h_after = dev_h - delta
    dev_c_after = dev_c + delta
    imp = dev_before - ops.fma_f32(dev_h_after, dev_h_after,
                                   dev_c_after * dev_c_after)

    def sibling_on(cand_rows, dest_ids):
        sib = partition_replicas[replica_partition[cand_rows].long()]
        sib_b = torch.where(sib >= 0, rb[torch.clamp_min(sib, 0).long()],
                            torch.full_like(sib, -1).long())
        return torch.any(sib_b[:, :, None] == dest_ids[None, None, :], 1)

    dup_out = sibling_on(out_h, c_ids)
    dup_in = sibling_on(in_c, h_ids)
    feasible = (out_has[h_ids][:, None] & in_has[c_ids][None, :]
                & hot_b[h_ids][:, None] & cold_b[c_ids][None, :]
                & (delta > 0) & (imp > 0)
                & ~dup_out & ~dup_in.T & accept)
    if lower is not None:
        feasible &= util[h_ids][:, None] - delta >= lower[h_ids][:, None]
    if upper is not None:
        feasible &= util[c_ids][None, :] + delta <= upper[c_ids][None, :]
    score = torch.where(feasible, imp, neg)
    return torch.max(score, 1)


def swap_pair_plain(h_ids, c_ids, out_r, in_r, out_has, in_has, hot_b,
                    cold_b, w, dev_u, util, lower, upper, accept,
                    replica_partition, partition_replicas, replica_broker):
    """Plain version of K10's pair entry: the pair plane
    (swap_plane_plain), each hot row's best cold column, then at most one
    swap per cold broker, per outgoing replica's partition and per
    incoming replica's partition (resolve_dest_conflicts_plain in that
    order: the best improvement, ties to the lowest row), scattered onto
    the broker axis.  Returns (cold i32[B], valid bool[B]), zeros off the
    shortlist."""
    num_b = hot_b.shape[0]
    sel_h, cold_slot = swap_plane_plain(
        h_ids, c_ids, out_r, in_r, out_has, in_has, hot_b, cold_b, w, dev_u,
        util, lower, upper, accept, replica_partition, partition_replicas,
        replica_broker)
    h_ids = h_ids.long()
    valid_h = sel_h > NEG / 2
    cold_h = c_ids.long()[cold_slot.long()]
    valid_h = resolve_dest_conflicts_plain(cold_h, sel_h, valid_h, num_b)
    num_p = partition_replicas.shape[0]
    p_out = replica_partition[torch.clamp_min(out_r, 0).long()[h_ids]]
    p_in = replica_partition[torch.clamp_min(in_r[cold_h], 0).long()]
    valid_h = resolve_dest_conflicts_plain(p_out, sel_h, valid_h, num_p)
    valid_h = resolve_dest_conflicts_plain(p_in, sel_h, valid_h, num_p)
    cold = torch.zeros((num_b,), dtype=torch.int32, device=w.device)
    cold[h_ids] = cold_h.to(torch.int32)
    valid = torch.zeros((num_b,), dtype=torch.bool, device=w.device)
    valid[h_ids] = valid_h
    return cold, valid


def swap_pair(h_ids, c_ids, out_r, in_r, out_has, in_has, hot_b, cold_b, w,
              dev_u, util, lower, upper, accept, replica_partition,
              partition_replicas, replica_broker):
    """K10 dispatch, pair entry: the plain version on the CPU, one launch
    of csrc/swap_pair.cu cc_swap_pair on the card (vectors and the
    acceptance plane read through their strides).  (cold i32[B], valid
    bool[B])."""
    if not w.is_cuda:
        return swap_pair_plain(h_ids, c_ids, out_r, in_r, out_has, in_has,
                               hot_b, cold_b, w, dev_u, util, lower, upper,
                               accept, replica_partition, partition_replicas,
                               replica_broker)
    from cruise_control_tpu_torch import cuda_kernels
    return cuda_kernels.swap_pair(
        h_ids, c_ids, out_r.contiguous(), in_r.contiguous(),
        out_has.contiguous(), in_has.contiguous(), hot_b.contiguous(),
        cold_b.contiguous(), w, dev_u, util, lower, upper, accept,
        replica_partition, partition_replicas, replica_broker)


def swap_round(state: ClusterState, w, movable, hot_b, cold_b, util,
               target_util, accept_pair_fn, partition_replicas, cache=None,
               w_rows=None, lower=None, upper=None, dev_u=None):
    """One round of batched replica-swap search: each hot broker
    nominates its largest movable replica, each cold broker its smallest
    (K1 or K9); the worst SWAP_SHORTLIST brokers per side (K10's
    shortlist entry) are paired on an [H, C] plane scored by
    squared-deviation improvement under the acceptance stack, and the
    best pairs that share no broker or partition are kept (K10's pair
    entry).  `dev_u`, when given, is the caller's own `util -
    target_util`.  Returns (out_r i32[B], in_r i32[B], cold i32[B], valid
    bool[B])."""
    num_b = state.num_brokers
    rb = state.replica_broker.long()
    neg = torch.full((), NEG, device=w.device)
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
    h_ids, c_ids, out_h, in_c, dev_u = swap_shortlist(
        hot_b, cold_b, out_r, in_r, out_has, in_has, dev_u, util,
        target_util, shortlist)
    accept = accept_pair_fn(out_h[:, None], in_c[None, :])
    cold, valid = swap_pair(
        h_ids, c_ids, out_r, in_r, out_has, in_has, hot_b, cold_b, w, dev_u,
        util, lower, upper, accept, state.replica_partition,
        partition_replicas, state.replica_broker)
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
    """Apply a move round to the state and the cache.  The caller gives
    up `cache`: the commit (K3 on the card) updates its planes in place."""
    from cruise_control_tpu_torch.analyzer.context import \
        update_cache_for_moves
    r = torch.clamp_min(cand_r, 0)
    v = cand_valid & (cand_r >= 0)
    new_cache = update_cache_for_moves(state, cache, r, cand_dest, v)
    return S.apply_moves(state, r, cand_dest, v), new_cache


def commit_swaps_cached(state: ClusterState, cache, out_r, in_r, cold,
                        valid):
    """Apply a swap round as one move batch; `cache` is given up as in
    `commit_moves_cached`."""
    from cruise_control_tpu_torch.analyzer.context import \
        update_cache_for_moves
    replicas, dests, ok = _swap_moves(state, out_r, in_r, cold, valid)
    new_cache = update_cache_for_moves(state, cache, replicas, dests, ok)
    return S.apply_moves(state, replicas, dests, ok), new_cache


# ---------------------------------------------------------------------------
# K4: one follower-assignment pass of the leadership search
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LeaderTail:
    """The buffers of one follower assignment (leadership_round's
    run_tail), shared by its K4 passes.  Pass 0 reads the candidate rows,
    their sibling rows (-1 for none) and the prior goals' acceptance plane
    (bool, broadcasting to [C, RF]) and writes the option planes, the rows'
    source brokers and gains and the jitter amplitude; it zeroes the
    counters, `assigned` and `dest_replica`, which later passes update in
    place, and (multi-commit) every pass writes K8's weights `d_w`
    (t_ws[:, promoted replica])."""
    rows: torch.Tensor            # int32 / int64 [C] candidate leaders
    sib: torch.Tensor             # int32 [C, RF]
    accept: torch.Tensor          # bool, broadcasts to [C, RF]
    cand_has: torch.Tensor        # bool [C]
    replica_broker: torch.Tensor  # int32 [R]
    replica_offline: torch.Tensor  # bool [R]
    leader_ok: torch.Tensor       # bool [B]
    bonus_w: torch.Tensor         # f32 [R]
    dest_headroom: torch.Tensor   # f32 [B]
    dest_pref: torch.Tensor       # f32 [B]
    pref: torch.Tensor            # f32 [C, RF]
    sib_broker: torch.Tensor      # int32 [C, RF]
    sib_replica: torch.Tensor     # int32 [C, RF]
    src: torch.Tensor             # int32 [C]
    gain: torch.Tensor            # f32 [C]
    amp: torch.Tensor             # f32 0-d
    taken_cnt: torch.Tensor       # int32 [B]
    dep_cnt: torch.Tensor         # int32 [B]
    assigned: torch.Tensor        # bool [C]
    dest_replica: torch.Tensor    # int32 [C]
    t_ws: Optional[torch.Tensor] = None   # f32 [T, R] (multi-commit)
    d_w: Optional[torch.Tensor] = None    # f32 [T, C] (multi-commit)


def leader_tail(state: ClusterState, rows, sib, accept, cand_has, leader_ok,
                bonus_w, dest_headroom, dest_pref,
                t_ws=None) -> LeaderTail:
    """A LeaderTail over the candidate rows, its planes and state
    allocated (uninitialised: K4's pass 0 writes them)."""
    c, rf = sib.shape
    num_b = leader_ok.shape[0]
    dev = sib.device

    def new(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)
    i32, f32 = torch.int32, torch.float32
    return LeaderTail(
        rows=rows, sib=sib, accept=accept, cand_has=cand_has,
        replica_broker=state.replica_broker,
        replica_offline=state.replica_offline, leader_ok=leader_ok,
        bonus_w=bonus_w, dest_headroom=dest_headroom, dest_pref=dest_pref,
        pref=new((c, rf), f32), sib_broker=new((c, rf), i32),
        sib_replica=new((c, rf), i32), src=new(c, i32), gain=new(c, f32),
        amp=new((), f32), taken_cnt=new(num_b, i32), dep_cnt=new(num_b, i32),
        assigned=new(c, torch.bool), dest_replica=new(c, i32), t_ws=t_ws,
        d_w=None if t_ws is None else new((t_ws.shape[0], c), f32))


def leader_assign_pass_plain(t: LeaderTail, k: int, multi: bool, keep=None,
                             prev_db=None, prev_dr=None):
    """Plain version of K4: pass k of leadership_round's follower
    assignment over the buffers `t`.
    Pass 0 first builds the plane: per candidate row c (replica rows[c])
    and option j (sibling replica s = sib[c, j], broker b of max(s, 0)),
    pref[c, j] = dest_pref[b] where cand_has[c], s >= 0, s != rows[c],
    leader_ok[b], the sibling is online, bonus_w[rows[c]] <=
    dest_headroom[b] and accept[c, j] hold, else NEG; the option brokers
    and replicas, src = the rows' brokers, gain = bonus_w[rows], the
    amplitude (assign_amp) and zero counters, `assigned` and
    `dest_replica`.  Pass k > 0 first folds pass k - 1 (`keep`, its
    brokers `prev_db` and promoted replicas `prev_dr`) into dest_replica
    and assigned and, single-commit, into taken_cnt and dep_cnt (one
    arrival a kept destination, one departure a kept source).  Then the
    first-max option of the (jittered for k > 0: fma(amp, jitter, pref),
    one rounding) preference over the open options -- multi-commit: the
    option's broker has taken fewer than MAX_ARRIVALS_PER_ROUND arrivals;
    single-commit: it took none and the row's source handed off none --
    masked for assigned rows; multi-commit, d_w = t_ws[:, promoted].
    Returns (dest broker i32[C], promoted replica i32[C], has bool[C])."""
    c, rf = t.sib.shape
    num_b = t.taken_cnt.shape[0]
    dev = t.sib.device
    neg = torch.full((), NEG, dtype=torch.float32, device=dev)
    if k == 0:
        rows = t.rows.long()
        rb = t.replica_broker.long()
        sib_safe = torch.clamp_min(t.sib, 0).long()
        sib_b = rb[sib_safe]
        bonus = t.bonus_w[rows]
        ok = (t.sib >= 0) & (t.sib != rows[:, None])
        ok &= t.leader_ok[sib_b] & ~t.replica_offline[sib_safe]
        ok &= bonus[:, None] <= t.dest_headroom[sib_b]
        ok &= t.accept & t.cand_has[:, None]
        t.pref.copy_(torch.where(ok, t.dest_pref[sib_b], neg))
        t.sib_broker.copy_(sib_b)
        t.sib_replica.copy_(sib_safe)
        t.src.copy_(rb[rows])
        t.gain.copy_(bonus)
        t.amp.copy_(assign_amp(t.pref))
        for x in (t.taken_cnt, t.dep_cnt, t.assigned, t.dest_replica):
            x.zero_()
        pass_pref = t.pref
    else:
        t.dest_replica.copy_(torch.where(keep, prev_dr, t.dest_replica))
        t.assigned |= keep
        if not multi:
            ones = torch.ones_like(prev_db)
            t.taken_cnt += ops.segment_sum(
                ones, torch.where(keep, prev_db, num_b), num_b)
            t.dep_cnt += ops.segment_sum(
                ones, torch.where(keep, t.src, num_b), num_b)
        jit = _pairwise_jitter(c, rf, salt=k, device=dev)
        pass_pref = torch.where(t.pref > NEG / 2,
                                ops.fma_f32(t.amp, jit, t.pref), neg)
    taken_b = t.taken_cnt[t.sib_broker.long()]
    if multi:
        open_pref = torch.where(taken_b < MAX_ARRIVALS_PER_ROUND, pass_pref,
                                neg)
    else:
        closed = (taken_b > 0) | (t.dep_cnt[t.src.long()] > 0)[:, None]
        open_pref = torch.where(closed, neg, pass_pref)
    open_pref = torch.where(t.assigned[:, None], neg, open_pref)
    mx, slot = torch.max(open_pref, 1)
    db = torch.gather(t.sib_broker, 1, slot[:, None])[:, 0]
    dr = torch.gather(t.sib_replica, 1, slot[:, None])[:, 0]
    if multi:
        t.d_w.copy_(t.t_ws[:, dr.long()])
    return db, dr, t.cand_has & (mx > NEG / 2)


def leader_assign_pass(t: LeaderTail, k: int, multi: bool, keep=None,
                       prev_db=None, prev_dr=None):
    """K4 dispatch: the plain version on the CPU, one launch of
    csrc/leader_assign.cu on the card."""
    if not t.sib.is_cuda:
        return leader_assign_pass_plain(t, k, multi, keep, prev_db, prev_dr)
    from cruise_control_tpu_torch import cuda_kernels
    return cuda_kernels.leader_assign_pass(t, k, multi, keep, prev_db,
                                           prev_dr)


# ---------------------------------------------------------------------------
# Leadership round
# ---------------------------------------------------------------------------

def leadership_round(state: ClusterState, bonus_w, src_excess, movable,
                     leader_ok, dest_headroom, accept_fn, dest_pref,
                     partition_replicas, cache=None, bonus_rows=None,
                     value_rows=None, dest_terms=None, src_terms=None,
                     dest_stack_headroom=None, escalate: bool = True):
    """One round of batched leadership-transfer search (see the
    reference's docstring for the arguments).  Resident-row mode
    (`bonus_rows` + `value_rows` and a broker table): a structural
    per-broker top-16 (K1), source prefix gating, salted window rotation,
    compaction to CAND_COMPACT and the follower assignment (K4 passes),
    with the zero-commit fallbacks `deep_pick(64)` then the full plane as
    host `if`s.  Otherwise one candidate per broker from the full plane.
    Returns (src_replica i32[C], dest_replica i32[C], valid bool[C])."""
    num_b = state.num_brokers
    rb = state.replica_broker.long()
    dev = bonus_w.device
    r_idx = _arange(rb.shape[0], dev)
    part = state.replica_partition.long()

    def options_feasible(rows, row_bonus):
        """[n, RF] follower options of `rows` (replica ids): (follower
        replica, follower broker, structural + acceptance feasibility)."""
        sib = partition_replicas[part[rows]]
        sib_safe = torch.clamp_min(sib, 0).long()
        ok = (sib >= 0) & (sib != rows[:, None])
        sib_b = rb[sib_safe]
        ok &= leader_ok[sib_b] & ~state.replica_offline[sib_safe]
        ok &= row_bonus[:, None] <= dest_headroom[sib_b]
        ok &= accept_fn(rows[:, None], sib_safe)
        return sib_safe, sib_b, ok

    is_src = src_excess > 0.0
    multi = dest_terms is not None
    if multi:
        own_hr = (torch.minimum(dest_headroom, dest_stack_headroom)
                  if dest_stack_headroom is not None else dest_headroom)
        dest_terms = [(bonus_w, own_hr)] + list(dest_terms)

    def run_tail(cand_r_safe, cand_has):
        """Follower assignment for one candidate set: (dest_replica
        i32[n], assigned bool[n]).  The sibling rows and the prior goals'
        acceptance plane, then a pass is one K4 launch (which builds the
        plane and the amplitude in pass 0 and folds the pass before it
        after) and K8 (multi-commit) or K9 twice (single-commit)."""
        sib = partition_replicas[part[cand_r_safe]]
        acc = accept_fn(cand_r_safe[:, None], torch.clamp_min(sib, 0).long())
        t_ws = (_stack_rows([t_w for t_w, _ in dest_terms],
                            bonus_w.shape[0], dev) if multi else None)
        t = leader_tail(state, cand_r_safe, sib, acc, cand_has, leader_ok,
                        bonus_w, dest_headroom, dest_pref, t_ws)
        if multi:
            # K8 commits into taken_cnt and cum in place
            cap = torch.full((num_b,), MAX_ARRIVALS_PER_ROUND,
                             dtype=torch.int32, device=dev)
            hrs = _stack_rows([hr for _, hr in dest_terms], num_b, dev)
            cum = torch.zeros((len(dest_terms), num_b), device=dev)
        keep = db = dr = None
        for k in range(MULTI_ASSIGN_PASSES if multi else ASSIGN_PASSES):
            db, dr, has = leader_assign_pass(t, k, multi, keep, db, dr)
            if multi:
                keep = rank_accept_commit(db, t.gain, has, num_b,
                                          t.taken_cnt, cap, cum, t.d_w, hrs)
            else:
                keep = resolve_dest_conflicts(db, t.gain, has, num_b)
                keep = resolve_dest_conflicts(t.src, t.gain, keep, num_b)
        # the last pass's fold
        return torch.where(keep, dr, t.dest_replica), t.assigned | keep

    def lead_eligible():
        return (movable & state.replica_is_leader & is_src[rb]
                & (bonus_w > 0.0))

    if bonus_rows is not None and value_rows is not None and \
            _has_table(cache):
        s_w = cache.broker_table.shape[1]
        k0 = min(16, max(s_w, 1))
        cand_r, cand_has = row_topk(bonus_rows, cache.broker_table, k0)[:2]
        cand_r_safe = torch.clamp_min(cand_r, 0).long()
        cand_bonus_b = bonus_w[cand_r_safe]
        if multi and k0 > 1:
            # source-side strict bounds, prefix-gated over each broker's
            # rank-ordered candidates (rank 0 free)
            cand_has = prefix_gate(cand_has, cand_bonus_b, src_excess,
                                   cand_r, src_terms or (), k0)
        c_full = cand_r.shape[0]
        sel = None
        if c_full > CAND_COMPACT:
            # window tie-rotation keyed by a state hash (the selection
            # score only; the assignment ranks by the true gain)
            salt_r = rotation_salt(cache.leader_count,
                                   cache.broker_load[:, 0])
            gain_sel = table_window_gain(cand_bonus_b, cand_has, salt_r)
            sel, _, ch_c, cr_safe_c = compact_candidates(
                CAND_COMPACT, gain_sel, cand_has, cand_r_safe)
        else:
            ch_c, cr_safe_c = cand_has, cand_r_safe
        dest_c, asg_c = run_tail(cr_safe_c, ch_c)
        if sel is not None:
            dest_full = torch.zeros((c_full,), dtype=torch.int32,
                                    device=dev)
            dest_full[sel] = dest_c
            valid_full = torch.zeros((c_full,), dtype=torch.bool,
                                     device=dev)
            valid_full[sel] = asg_c
        else:
            dest_full, valid_full = dest_c, asg_c
        if not escalate:
            return cand_r, dest_full, valid_full

        def fb_triple(pick, has):
            """[B]-candidate fallback embedded at slot 0 of each broker's
            row of the [c_full] layout."""
            dest_b, asg_b = run_tail(torch.clamp_min(pick, 0).long(), has)
            idx = _arange(num_b, dev) * k0
            cr = torch.full((c_full,), -1, dtype=torch.int32, device=dev)
            cr[idx] = pick.to(torch.int32)
            dst = torch.zeros((c_full,), dtype=torch.int32, device=dev)
            dst[idx] = dest_b
            vld = torch.zeros((c_full,), dtype=torch.bool, device=dev)
            vld[idx] = asg_b & has
            return cr, dst, vld

        def deep_pick(k):
            """Per-broker first ACCEPTED candidate among each row's top-k
            structural candidates."""
            k = min(k, max(s_w, 1))
            ck, hs, _, t_slots, _ = row_topk(bonus_rows, cache.broker_table,
                                             k)
            flat = torch.clamp_min(ck, 0).long()
            fb = torch.gather(value_rows, 1, t_slots.long()).reshape(-1)
            _, _, ok = options_feasible(flat, fb)
            ok_rows = torch.any(ok, 1).reshape(num_b, k) & hs.reshape(num_b,
                                                                      k)
            first = torch.argmax(ok_rows.to(torch.int8), 1)
            has = torch.any(ok_rows, 1)
            picked = torch.gather(ck.reshape(num_b, k), 1, first[:, None])
            pick = torch.where(has, picked[:, 0], torch.full_like(
                picked[:, 0], -1))
            return pick, has

        def full_plane_pick():
            _, _, ok_full = options_feasible(r_idx, bonus_w)
            r_has = torch.any(ok_full, 1) & lead_eligible()
            score = torch.where(r_has, shed_score(bonus_w, src_excess[rb]),
                                torch.full((), NEG, device=dev))
            return table_pick_best(cache, score, r_has)

        # zero-commit fallbacks (the reference's lax.cond chain)
        if bool(torch.any(cand_has) & ~torch.any(valid_full)):
            cand_r, dest_full, valid_full = fb_triple(*deep_pick(64))
            if not bool(torch.any(valid_full)):
                return fb_triple(*full_plane_pick())
        return cand_r, dest_full, valid_full

    # full-plane selection (no resident rows / no table): one candidate
    # per broker, acceptance evaluated at selection
    _, sib_b_all, ok_all = options_feasible(r_idx, bonus_w)
    feasible = ok_all & lead_eligible()[:, None]
    neg = torch.full((), NEG, device=dev)
    pref_full = torch.where(feasible, dest_pref[sib_b_all], neg)
    r_has = torch.max(pref_full, 1).values > NEG / 2
    score = torch.where(r_has, shed_score(bonus_w, src_excess[rb]), neg)
    if _has_table(cache):
        cand_r, cand_has = table_pick_best(cache, score, r_has)
    else:
        cand_r, _, cand_has = per_segment_argmax(score, rb, num_b, r_has)
    dest, asg = run_tail(torch.clamp_min(cand_r, 0).long(), cand_has)
    return cand_r, dest, asg


def commit_leadership_cached(state: ClusterState, cache, cand_r,
                             cand_dest_replica, cand_valid,
                             donate: bool = False):
    """Apply a leadership round to the state and the cache.  `donate`:
    the caller gives up `cache`, whose planes the card's kernel (K5) may
    then update in place."""
    from cruise_control_tpu_torch.analyzer.context import \
        update_cache_for_leadership
    src = torch.clamp_min(cand_r, 0)
    v = cand_valid & (cand_r >= 0)
    new_cache = update_cache_for_leadership(state, cache, src,
                                            cand_dest_replica, v,
                                            donate=donate)
    return S.apply_leadership_transfers(state, src, cand_dest_replica,
                                        v), new_cache


def commit_leadership(state: ClusterState, cand_r, cand_dest_replica,
                      cand_valid) -> ClusterState:
    return S.apply_leadership_transfers(state, torch.clamp_min(cand_r, 0),
                                        cand_dest_replica,
                                        cand_valid & (cand_r >= 0))
