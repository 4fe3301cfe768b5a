"""The plain versions of K4 (a leadership pass with its plane and fold)
and of K1's table source against the JAX package and the pass sequence
they replace, on the CPU.

`leader_assign_pass_plain` (analyzer/kernels.py) builds in pass 0 the
option planes, the rows' sources and gains and the jitter amplitude, and
folds each pass into the next.  Held here:
  * over 8 passes in both commit modes, between K8 (multi-commit) or K9
    twice (single-commit), against the sequence that preceded it: the
    options, the preference plane and the amplitude built by torch ops,
    then per pass the one-pass body and the torch folds of `keep` into
    `dest_replica`, `assigned` and the two counters -- every pick, keep,
    count, fold and K8 weight (`d_w`) equal;
  * pass 0's planes and `amp` against the reference's run_tail lines
    (cruise_control_tpu/analyzer/kernels.py, `sib_of`, `options_feasible`,
    `pref_c` and the amplitude) under `jax.jit`, bit for bit, with rows
    whose every option is closed, tied and NEG options, and a plane with no
    finite preference;
  * K1's table source (`table_topk_plain`, behind table_pick_best /
    table_pick_topk) and its per-row `any` against the reference's
    table_pick_best / table_pick_topk and `jnp.any`, with ties, -0.0,
    pad slots, all-NEG rows and k = S.
The inputs are made with numpy from a seed; integers and booleans must be
equal, floats bit for bit.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import kernels as JK
from cruise_control_tpu_torch import ops
from cruise_control_tpu_torch.analyzer import kernels as K

RF = 3


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    if a.dtype.kind == "f":
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), what
    else:
        assert np.array_equal(a, b), what


def _inputs(seed, c=96, nb=12, num_r=400, t_terms=2):
    """A candidate set of c rows over num_r replicas on nb brokers: the
    rows' sibling rows (the row itself among them, -1 pads), an acceptance
    plane, per-replica brokers, offline flags and bonuses, per-broker
    flags, headrooms and preferences (two tied, one NEG), weights of
    t_terms destination terms.  Rows 0-3: every option closed (no
    candidate, no acceptance, a NEG broker preference, no headroom)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, num_r, c).astype(np.int64)
    sib = rng.integers(0, num_r, (c, RF)).astype(np.int32)
    sib[:, 0] = rows
    sib[rng.random((c, RF)) < 0.1] = -1
    rb = rng.integers(0, nb, num_r).astype(np.int32)
    pref = -np.round(rng.random(nb) * 6).astype(np.float32)
    pref[3] = JK.NEG
    pref[5] = pref[6]
    x = dict(rows=rows, sib=sib, accept=rng.random((c, RF)) < 0.85,
             cand_has=rng.random(c) < 0.9, replica_broker=rb,
             replica_offline=rng.random(num_r) < 0.05,
             leader_ok=rng.random(nb) < 0.9,
             bonus_w=np.round(rng.random(num_r) * 4).astype(np.float32),
             dest_headroom=(rng.random(nb) * 5).astype(np.float32),
             dest_pref=pref,
             t_ws=rng.random((t_terms, num_r)).astype(np.float32))
    x["cand_has"][0] = False
    x["accept"][1] = False
    sib[2] = np.where(rb[np.maximum(sib[2], 0)] == 3, sib[2], -1)
    x["bonus_w"][rows[3]] = 1e9
    return x


def _tail(x: dict, multi: bool) -> K.LeaderTail:
    t = {n: torch.from_numpy(np.array(v)) for n, v in x.items()}
    state = types.SimpleNamespace(replica_broker=t["replica_broker"],
                                  replica_offline=t["replica_offline"])
    return K.leader_tail(state, t["rows"], t["sib"], t["accept"],
                         t["cand_has"], t["leader_ok"], t["bonus_w"],
                         t["dest_headroom"], t["dest_pref"],
                         t["t_ws"] if multi else None)


def _parent_planes(x: dict):
    """The options, preference plane and amplitude as torch ops built them
    before K4 built them itself: (pref, sib broker, sib replica, src,
    gain, amp)."""
    t = {n: torch.from_numpy(np.array(v)) for n, v in x.items()}
    rows, sib = t["rows"], t["sib"]
    rb = t["replica_broker"].long()
    sib_safe = torch.clamp_min(sib, 0).long()
    ok = (sib >= 0) & (sib != rows[:, None])
    sib_b = rb[sib_safe]
    ok &= t["leader_ok"][sib_b] & ~t["replica_offline"][sib_safe]
    ok &= t["bonus_w"][rows][:, None] <= t["dest_headroom"][sib_b]
    ok &= t["accept"]
    ok &= t["cand_has"][:, None]
    pref = torch.where(ok, t["dest_pref"][sib_b], torch.full((), K.NEG))
    return (pref, sib_b.to(torch.int32), sib_safe.to(torch.int32),
            rb[rows].to(torch.int32), t["bonus_w"][rows], K.assign_amp(pref))


def _parent_pass(pref, sib_b, sib_r, src, taken, dep, assigned, cand_has, k,
                 amp, multi):
    """The one-pass body before the fold moved into K4: (db, dr, has)."""
    c, rf = pref.shape
    neg = torch.full((), K.NEG)
    pass_pref = pref if k == 0 else torch.where(
        pref > K.NEG / 2,
        ops.fma_f32(amp, K._pairwise_jitter(c, rf, salt=k), pref), neg)
    taken_b = taken[sib_b.long()]
    if multi:
        open_pref = torch.where(taken_b < K.MAX_ARRIVALS_PER_ROUND,
                                pass_pref, neg)
    else:
        closed = (taken_b > 0) | (dep[src.long()] > 0)[:, None]
        open_pref = torch.where(closed, neg, pass_pref)
    open_pref = torch.where(assigned[:, None], neg, open_pref)
    mx, slot = torch.max(open_pref, 1)
    return (torch.gather(sib_b, 1, slot[:, None])[:, 0],
            torch.gather(sib_r, 1, slot[:, None])[:, 0],
            cand_has & (mx > K.NEG / 2))


def _accept_inputs(x: dict, multi: bool, nb: int):
    """K8's caps, headrooms and cumulants (multi-commit), or None."""
    if not multi:
        return None
    rng = np.random.default_rng(3)
    return dict(cap=torch.full((nb,), 2, dtype=torch.int32),
                hr=torch.from_numpy((rng.random((x["t_ws"].shape[0], nb))
                                     * 3).astype(np.float32)),
                cum=torch.zeros((x["t_ws"].shape[0], nb)))


@pytest.mark.parametrize("multi", [False, True])
def test_leader_pass_chain_matches_the_parent_sequence(multi):
    """Eight passes of the new plain K4 between K8 / K9 against the pass
    body and torch folds it replaced, on the same inputs."""
    x = _inputs(seed=int(multi))
    nb = x["dest_pref"].shape[0]
    c = x["rows"].shape[0]
    t = _tail(x, multi)
    pref, sib_b, sib_r, src, gain, amp = _parent_planes(x)
    cand_has = torch.from_numpy(x["cand_has"])
    t_ws = torch.from_numpy(x["t_ws"])
    taken = torch.zeros(nb, dtype=torch.int32)
    dep = torch.zeros(nb, dtype=torch.int32)
    assigned = torch.zeros(c, dtype=torch.bool)
    dest_replica = torch.zeros(c, dtype=torch.int32)
    acc_new, acc_old = _accept_inputs(x, multi, nb), _accept_inputs(
        x, multi, nb)
    keep = db = dr = None
    kept = 0
    for k in range(K.MULTI_ASSIGN_PASSES if multi else K.ASSIGN_PASSES):
        db, dr, has = K.leader_assign_pass_plain(t, k, multi, keep, db, dr)
        if k == 0:
            for got, want, what in ((t.pref, pref, "pref"),
                                    (t.sib_broker, sib_b, "sib_broker"),
                                    (t.sib_replica, sib_r, "sib_replica"),
                                    (t.src, src, "src"), (t.gain, gain,
                                                          "gain"),
                                    (t.amp, amp, "amp")):
                _eq(want, got, what)
        w_db, w_dr, w_has = _parent_pass(pref, sib_b, sib_r, src, taken, dep,
                                         assigned, cand_has, k, amp, multi)
        _eq(w_db, db, f"db pass {k}")
        _eq(w_dr, dr, f"dr pass {k}")
        _eq(w_has, has, f"has pass {k}")
        _eq(dest_replica, t.dest_replica, f"dest_replica pass {k}")
        _eq(assigned, t.assigned, f"assigned pass {k}")
        if multi:
            w_dw = t_ws[:, w_dr.long()]
            _eq(w_dw, t.d_w, f"d_w pass {k}")
            keep = K.rank_accept_commit(db, t.gain, has, nb, t.taken_cnt,
                                        acc_new["cap"], acc_new["cum"],
                                        t.d_w, acc_new["hr"])
            w_keep = K.rank_accept_commit(w_db, gain, w_has, nb, taken,
                                          acc_old["cap"], acc_old["cum"],
                                          w_dw, acc_old["hr"])
            _eq(acc_old["cum"], acc_new["cum"], f"cum pass {k}")
            _eq(taken, t.taken_cnt, f"taken_cnt after pass {k}")
        else:
            _eq(taken, t.taken_cnt, f"taken_cnt pass {k}")
            _eq(dep, t.dep_cnt, f"dep_cnt pass {k}")
            keep = K.resolve_dest_conflicts(db, t.gain, has, nb)
            keep = K.resolve_dest_conflicts(t.src, t.gain, keep, nb)
            w_keep = K.resolve_dest_conflicts(w_db, gain, w_has, nb)
            w_keep = K.resolve_dest_conflicts(src, gain, w_keep, nb)
            kept_d = torch.where(w_keep, w_db, torch.full_like(w_db, nb))
            kept_s = torch.where(w_keep, src, torch.full_like(src, nb))
            taken = taken + ops.segment_sum(torch.ones_like(kept_d), kept_d,
                                            nb)
            dep = dep + ops.segment_sum(torch.ones_like(kept_s), kept_s, nb)
        _eq(w_keep, keep, f"keep pass {k}")
        dest_replica = torch.where(w_keep, w_dr, dest_replica)
        assigned = assigned | w_keep
        kept += int(keep.sum())
    _eq(dest_replica, torch.where(keep, dr, t.dest_replica), "dest_replica")
    _eq(assigned, t.assigned | keep, "assigned")
    assert 0 < kept < c


@jax.jit
def _jax_pass0(x):
    """The reference's run_tail lines above the pass loop (sib_of,
    options_feasible with a given acceptance plane, pref_c, the
    amplitude), compiled as its goal programs are."""
    rows = x["rows"]
    sib = x["sib"]
    sib_safe = jnp.maximum(sib, 0)
    ok = (sib >= 0) & (sib != rows[:, None])
    sib_b = x["replica_broker"][sib_safe]
    ok &= x["leader_ok"][sib_b] & ~x["replica_offline"][sib_safe]
    cand_bonus = x["bonus_w"][rows]
    ok &= cand_bonus[:, None] <= x["dest_headroom"][sib_b]
    ok &= x["accept"]
    acc_c = ok & x["cand_has"][:, None]
    pref_c = jnp.where(acc_c, x["dest_pref"][sib_b], JK.NEG)
    finite_p = pref_c > JK.NEG / 2
    pmax = jnp.max(jnp.where(finite_p, pref_c, -jnp.inf))
    pmin = jnp.min(jnp.where(finite_p, pref_c, jnp.inf))
    spread_p = jnp.where(jnp.isfinite(pmax - pmin), pmax - pmin, 0.0)
    amp_p = 0.35 * spread_p + 1e-6
    return (pref_c, sib_b, sib_safe, x["replica_broker"][rows], cand_bonus,
            amp_p)


@pytest.mark.parametrize("case", ["random", "no finite preference"])
def test_leader_pass0_plane_matches_the_reference(case):
    """Pass 0's planes, sources, gains and amplitude against the
    reference's lines under jax.jit, and its pick against jnp.argmax of
    the reference's plane."""
    x = _inputs(seed=7)
    if case == "no finite preference":
        x["dest_pref"][:] = JK.NEG
    j = _jax_pass0({n: jnp.asarray(v) for n, v in x.items()
                    if n != "t_ws"})
    t = _tail(x, multi=False)
    db, dr, has = K.leader_assign_pass_plain(t, 0, False)
    for want, got, what in zip(j, (t.pref, t.sib_broker, t.sib_replica,
                                   t.src, t.gain, t.amp),
                               ("pref", "sib_broker", "sib_replica", "src",
                                "gain", "amp")):
        _eq(np.asarray(want).astype(got.numpy().dtype), got, what)
    slot = np.asarray(jnp.argmax(j[0], axis=1))
    c = slot.shape[0]
    _eq(np.asarray(j[1])[np.arange(c), slot], db, "db")
    _eq(np.asarray(j[2])[np.arange(c), slot], dr, "dr")
    _eq(x["cand_has"] & (np.asarray(j[0]).max(1) > JK.NEG / 2), has, "has")
    assert not bool(has[:4].any())
    assert bool(has.any()) == (case == "random")


class _Table:
    """A cache stand-in carrying only the broker table."""

    def __init__(self, table):
        self.broker_table = table


@pytest.mark.parametrize("k", [1, 4, 16, 40])
def test_table_topk_matches_the_reference(k):
    """K1's table source (plain) against the reference's table_pick_best /
    table_pick_topk, and K1's per-row `any` against jnp.any, on both
    sources."""
    rng = np.random.default_rng(k)
    b, s, num_r = 9, 40, 300
    ids = np.full(b * s, num_r, np.int32)
    ids[rng.permutation(b * s)[:num_r]] = np.arange(num_r, dtype=np.int32)
    table = ids.reshape(b, s)
    table[2] = num_r                       # a row of pads
    score = np.round(rng.random(num_r) * 4).astype(np.float32)
    score[rng.random(num_r) < 0.1] = -0.0
    valid = rng.random(num_r) < 0.7
    valid[table[4][table[4] < num_r]] = False   # a row of invalid slots
    jt, pt = _Table(jnp.asarray(table)), _Table(torch.from_numpy(table))
    js, ps = jnp.asarray(score), torch.from_numpy(score)
    jv, pv = jnp.asarray(valid), torch.from_numpy(valid)
    if k == 1:
        jc, jh = JK.table_pick_best(jt, js, jv)
        pc, ph = K.table_pick_best(pt, ps, pv)
    else:
        jc, jh = JK.table_pick_topk(jt, js, jv, k)
        pc, ph = K.table_pick_topk(pt, ps, pv, k)
    _eq(jc, pc, "cand")
    _eq(jh, ph, "has")
    rows = JK._table_rows(jt, js, jv)
    out = K.table_topk_plain(pt.broker_table, ps, pv, k)
    want_any = jnp.any(rows > JK.NEG / 2, 1)
    _eq(want_any, out[4], "any (table)")
    plane = torch.from_numpy(np.array(rows))
    _eq(want_any, K.row_topk_plain(plane, pt.broker_table, k)[4],
        "any (plane)")
    # the plane source on the same rows, -0.0 below +0.0 as lax.top_k
    for want, got, what in zip(JK.rows_pick_topk(jt, rows, k),
                               K.rows_pick_topk(pt, plane, k),
                               ("cand", "has", "top")):
        _eq(want, got, f"plane {what}")
    assert not bool(out[4][2]) and not bool(out[4][4])
    if k == 40:                            # k = S: the whole row
        top, _ = jax.lax.top_k(rows, s)
        _eq(top, out[2], "top")
