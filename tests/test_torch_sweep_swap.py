"""The port's top-k sites in `jax.lax.top_k`'s order, and the plain
versions of K6 and K10, against the JAX reference on the CPU.

* Signed zeros.  `jax.lax.top_k` orders floats by XLA's total order,
  -0.0 below +0.0; each crafted input below puts both zeros at a cut or
  a tie so that a sort that ties them picks other entries:
  `top_headroom` (against `lax.top_k` itself, and through
  `cand_has_dest` / `feasible_dest_exists`, whose result the order
  cannot change: at most RF of the RF + 2 top brokers are blocked, so
  the best unblocked headroom has the same value in either order, up to
  the sign of a zero), `compact_candidates`, `_dest_shortlist` and the
  swap round's shortlists (through `swap_round`).  K7's plain select is
  pinned instead: its scores are `w + 1` or -inf, and a float32 sum with
  +1.0 is never -0.0, so both orders agree.
* `sweep_window_plain` over three rounds, each folding the round before
  it, in both modes, with and without the tiebreak, compacting (P >
  4096) and not, against `jax.jit` of the reference's round-body lines.
* `swap_shortlist_plain` + `swap_pair_plain` against the reference's
  `swap_round`, with a lower and an upper band and signed-zero ranks.

Integers and booleans must be equal and floats equal bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import kernels as JK
from cruise_control_tpu.analyzer import leadership as JL
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer import kernels as K
from cruise_control_tpu_torch.analyzer import leadership as L
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)

SPEC = dict(num_brokers=16, num_partitions=400, replication_factor=3,
            num_racks=4, num_topics=8, seed=0, skew_fraction=0.3)
PZ, NZ = np.float32(0.0), np.float32(-0.0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind == "f":
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), what
    else:
        assert np.array_equal(a, b), what


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def cluster():
    js, _ = j_random_cluster(JSpec(**SPEC))
    ps, _ = random_cluster(RandomClusterSpec(**SPEC), device="cpu")
    pr = C.partition_replica_index(ps)
    return js, ps, pr


def _zeros_low_ids_negative(n: int, n_neg: int) -> np.ndarray:
    """n zeros, the first n_neg of them -0.0: a tie-blind sort keeps the
    low ids, the total order the +0.0 ones."""
    return np.where(np.arange(n) < n_neg, NZ, PZ).astype(np.float32)


# ---------------------------------------------------------------------------
# Signed zeros at the top-k sites
# ---------------------------------------------------------------------------

def test_top_headroom_orders_signed_zeros(cluster):
    """top_headroom's brokers are lax.top_k's (-0.0 below +0.0), and the
    guards built on them agree with the reference."""
    js, ps, pr = cluster
    nb = ps.num_brokers
    rf = pr.shape[1]
    k = min(rf + 2, nb)
    headroom = _zeros_low_ids_negative(nb, 8)
    headroom[3] = 5.0
    dest_ok = np.ones(nb, bool)
    dest_ok[12] = False
    j_h, j_b = jax.lax.top_k(jnp.where(jnp.asarray(dest_ok),
                                       jnp.asarray(headroom), -jnp.inf), k)
    top_b, top_h = K.top_headroom(_t(dest_ok), _t(headroom), rf)
    _eq(j_b, top_b, "top_b")
    _eq(j_h, top_h, "top_h")
    rng = np.random.default_rng(1)
    w = np.where(rng.random(ps.num_replicas) < 0.5, PZ, NZ)
    w[::7] = 1.0
    w = w.astype(np.float32)
    _eq(JK.feasible_dest_exists(js, jnp.asarray(w), jnp.asarray(dest_ok),
                                jnp.asarray(headroom), jnp.asarray(pr)),
        K.feasible_dest_exists(ps, _t(w), _t(dest_ok), _t(headroom),
                               _t(pr)), "feasible_dest_exists")
    cand = rng.choice(ps.num_replicas, 200, replace=False).astype(np.int32)
    _eq(JK.cand_has_dest(js, jnp.asarray(cand), jnp.asarray(w[cand]),
                         jnp.asarray(dest_ok), jnp.asarray(headroom),
                         jnp.asarray(pr)),
        K.cand_has_dest(ps, _t(cand), _t(w[cand]), _t(dest_ok),
                        _t(headroom), _t(pr)), "cand_has_dest")


def test_compact_candidates_orders_signed_zeros():
    """The window cut falls among tied gains of both signs."""
    c, width = 40, 16
    gain = _zeros_low_ids_negative(c, 20)
    gain[5] = 2.0
    gain[30] = 1.0
    has = np.ones(c, bool)
    has[25] = False
    extra = np.arange(c, dtype=np.int32) * 3
    j_sel, j_gain, j_has, j_extra = JK.compact_candidates(
        width, jnp.asarray(gain), jnp.asarray(has), jnp.asarray(extra))
    sel, p_gain, p_has, p_extra = K.compact_candidates(
        width, _t(gain), _t(has), _t(extra))
    _eq(j_sel, sel.to(torch.int32), "sel")
    _eq(j_gain, p_gain, "gain")
    _eq(j_has, p_has, "has")
    _eq(j_extra, p_extra, "extra")


def test_dest_shortlist_orders_signed_zeros():
    """More eligible brokers than DEST_SHORTLIST, the cut among zeros."""
    nb = K.DEST_SHORTLIST + 64
    pref = _zeros_low_ids_negative(nb, 100)
    pref[200:] = 1.0
    dest_ok = np.ones(nb, bool)
    dest_ok[210] = False
    want = JK._dest_shortlist(jnp.asarray(dest_ok), jnp.asarray(pref))
    got = K._dest_shortlist(_t(dest_ok), _t(pref))
    _eq(want, got.to(torch.int32), "dest_ids")


def _swap_signed_zero_args(ps, rng):
    """Every cold broker at util +-0.0 against a target of 0, so the cold
    ranks (-dev) are signed zeros; equal weights make every cold column
    of a hot row tie, so the column order picks the cold broker."""
    nb, nr = ps.num_brokers, ps.num_replicas
    hot = np.zeros(nb, bool)
    hot[:5] = True
    cold = ~hot
    util = np.where(np.arange(nb) % 2 == 0, PZ, NZ).astype(np.float32)
    util[hot] = np.float32(4.0)
    util[1] = NZ
    target = np.zeros(nb, np.float32)
    rb = ps.replica_broker.numpy()
    w = np.where(hot[rb], np.float32(2.0), np.float32(1.0)).astype(np.float32)
    movable = rng.random(nr) < 0.95
    return w, util, target, hot, cold, movable


def _j_swap(js, pr, w, util, target, hot, cold, movable, accept, lower=None,
            upper=None):
    def j_accept(r, d):
        return accept(r, d) if accept else jnp.ones(
            jnp.broadcast_shapes(r.shape, d.shape), bool)
    return JK.swap_round(js, jnp.asarray(w), jnp.asarray(movable),
                         jnp.asarray(hot), jnp.asarray(cold),
                         jnp.asarray(util), jnp.asarray(target), j_accept,
                         jnp.asarray(pr),
                         lower=None if lower is None else jnp.asarray(lower),
                         upper=None if upper is None else jnp.asarray(upper))


def test_swap_shortlists_order_signed_zeros(cluster):
    js, ps, pr = cluster
    args = _swap_signed_zero_args(ps, np.random.default_rng(2))
    want = _j_swap(js, pr, *args, accept=None)
    w, util, target, hot, cold, movable = args
    got = K.swap_round(ps, _t(w), _t(movable), _t(hot), _t(cold), _t(util),
                       _t(target),
                       lambda r, d: torch.ones(
                           torch.broadcast_shapes(r.shape, d.shape),
                           dtype=torch.bool), _t(pr))
    for a, b, what in zip(want, got, ("out_r", "in_r", "cold", "valid")):
        _eq(a, b, what)
    assert int(got[3].sum()) > 0


def test_forced_select_scores_hold_no_negative_zero(cluster):
    """K7's plain select keeps its tie-blind sort: its scores are w + 1 or
    -inf, and w + 1.0 rounds to +0.0 (never -0.0) at w = -1.0 and to 1.0
    at w = -0.0, so no two scores are zeros of both signs, and its
    selection equals lax.top_k's."""
    js, ps, pr = cluster
    nr = ps.num_replicas
    w = np.where(np.arange(nr) % 3 == 0, np.float32(-1.0), NZ)
    w[::5] = PZ
    w = w.astype(np.float32)
    score = w + np.float32(1.0)
    assert not np.any(np.signbit(score[score == 0]))
    assert np.any(score == 0) and np.any(w == 0)
    forced = np.arange(nr) % 2 == 0
    dest_ok = np.ones(ps.num_brokers, bool)
    room = np.full(ps.num_brokers, np.inf, np.float32)
    k = nr // 3
    j_ok = jnp.asarray(forced) & JK.feasible_dest_exists(
        js, jnp.asarray(w), jnp.asarray(dest_ok), jnp.asarray(room),
        jnp.asarray(pr))
    _, j_idx = jax.lax.top_k(jnp.where(j_ok, jnp.asarray(w) + 1.0,
                                       -jnp.inf), k)
    top_b, top_h = K.top_headroom(_t(dest_ok), _t(room), pr.shape[1])
    cand, has, ok = K.forced_select_plain(
        _t(forced), _t(w), ps.replica_partition, ps.replica_broker, _t(pr),
        top_b, top_h, k)
    _eq(j_ok, ok, "forced_ok")
    _eq(j_idx, cand, "cand_r")


# ---------------------------------------------------------------------------
# K6's plain version: three sweep rounds, each folding the one before
# ---------------------------------------------------------------------------

def _j_window(cur, failed, rows, jit_plane, rb, value, static_ok, alive,
              leader_ok, W, shed_to, fill_to, hard_cap, tb, salt,
              improve_gate, select_jitter):
    """The reference's round-body lines from cur_safe0 through dst_b
    (cruise_control_tpu/analyzer/leadership.py round_body)."""
    num_p = rows.shape[0]
    rows_safe = jnp.maximum(rows, 0)
    cur_safe0 = jnp.maximum(cur, 0)
    src_b0 = rb[cur_safe0]
    value_leave0 = value[cur_safe0]
    live = ((cur >= 0) & static_ok[cur_safe0]
            & (W[src_b0] > shed_to[src_b0]) & (value_leave0 > 0.0))
    if improve_gate:
        live &= value_leave0 < 2.0 * (W[src_b0] - shed_to[src_b0])
    gain0 = value_leave0
    g_lo = jnp.min(jnp.where(live, gain0, jnp.inf))
    g_hi = jnp.max(jnp.where(live, gain0, -jnp.inf))
    spread0 = jnp.where(g_hi > g_lo, g_hi - g_lo, 1.0)
    amp = spread0 * select_jitter
    gain_sel = (gain0
                + amp * JK.salted_jitter(
                    gain0.shape[0], (salt * 100.0).astype(jnp.int32))
                - failed * (spread0 + amp))
    (sel, _, has, cur_safe, src_b,
     value_leave, gain) = JK.compact_candidates(
        JL.SWEEP_COMPACT, gain_sel, live, cur_safe0, src_b0,
        value_leave0, gain0)
    if sel is None:
        sel = jnp.arange(num_p, dtype=jnp.int32)
    live_w = has
    rows_w = rows[sel]
    rows_w_safe = rows_safe[sel]
    cand_b = rb[rows_w_safe]
    value_arrive = value[rows_w_safe]
    ok = ((rows_w >= 0) & (rows_w != cur_safe[:, None])
          & static_ok[rows_w_safe] & alive[cand_b] & leader_ok[cand_b]
          & (W[cand_b] + value_arrive <= hard_cap[cand_b]))
    deficit = (fill_to - W)[cand_b]
    if improve_gate:
        ok &= value_arrive < 2.0 * deficit
    jit = jit_plane[sel]
    spread = jnp.maximum(jnp.max(jnp.abs(deficit)), 1e-6)
    score = deficit + 0.1 * spread * ((jit + salt) % 1.0)
    if tb is not None:
        tb_lo = jnp.min(tb)
        tb_norm = (tb - tb_lo) / jnp.maximum(jnp.max(tb) - tb_lo, 1e-9)
        score = score + 0.5 * spread * tb_norm[cand_b]
    score = jnp.where(ok, score, -jnp.inf)
    best = jnp.argmax(score, axis=1)
    dst_r = jnp.take_along_axis(rows_w_safe, best[:, None], axis=1)[:, 0]
    has = has & jnp.any(ok, axis=1)
    return sel, has, live_w, cur_safe, src_b, value_leave, dst_r, rb[dst_r]


def _j_fold(cur, failed, rp, sel, cur_safe, dst_r, valid, live_w):
    """The reference's carried leader index and failure marks after a
    round (leadership.py round_body's last lines)."""
    num_p = cur.shape[0]
    p_w = rp[cur_safe]
    cur = cur.at[jnp.where(valid, p_w, num_p)].set(dst_r, mode="drop")
    failed = failed.at[sel].set(
        jnp.where(valid, 0.0, jnp.where(live_w & ~valid, 1.0, failed[sel])))
    return cur, failed


_J_WINDOW = jax.jit(_j_window, static_argnames=("improve_gate",
                                                "select_jitter"))
_J_FOLD = jax.jit(_j_fold)
WINDOW_FIELDS = ("sel", "has", "live_w", "cur_safe", "src_b", "value_leave",
                 "dst_r", "dst_b")


def _sweep_inputs(num_p: int, seed: int):
    """A P-partition, 24-broker, RF-3 sweep: rows with empty slots, ties in
    the values and loads, -0.0 and +0.0 among the tiebreak's values."""
    rng = np.random.default_rng(seed)
    nb, rf = 24, 3
    nr = num_p * rf
    perm = rng.permutation(nr).astype(np.int32)
    rows = perm.reshape(num_p, rf).copy()
    rp = np.empty(nr, np.int32)
    rp[perm] = np.repeat(np.arange(num_p, dtype=np.int32), rf)
    rows[rng.random((num_p, rf)) < 0.08] = -1
    cur = rows[:, 0].copy()
    cur[rng.random(num_p) < 0.03] = -1
    rb = rng.integers(0, nb, nr).astype(np.int32)
    value = (np.round(rng.random(nr) * 8.0) / 2.0).astype(np.float32)
    static_ok = rng.random(nr) < 0.92
    alive = rng.random(nb) < 0.95
    leader_ok = rng.random(nb) < 0.95
    W = (np.round(rng.random(nb) * 40.0) + 30.0).astype(np.float32)
    shed_to = np.full(nb, 50.0, np.float32)
    fill_to = np.full(nb, 55.0, np.float32)
    hard_cap = np.full(nb, 75.0, np.float32)
    tb = np.where(rng.random(nb) < 0.3, NZ,
                  -np.round(rng.random(nb) * 5.0)).astype(np.float32)
    tb[:2] = PZ
    jit_plane = np.asarray(JK._pairwise_jitter(num_p, rf, salt=0))
    return dict(cur=cur, rows=rows, rp=rp, rb=rb, value=value,
                static_ok=static_ok, alive=alive, leader_ok=leader_ok, W=W,
                shed_to=shed_to, fill_to=fill_to, hard_cap=hard_cap, tb=tb,
                jit_plane=jit_plane)


@pytest.mark.parametrize("num_p", [300, 5000])
@pytest.mark.parametrize("improve_gate,tiebreak,select_jitter",
                         [(False, False, 0.35), (False, True, 1.0),
                          (True, False, 1.0), (True, True, 0.35)])
def test_sweep_window_plain_matches_reference(num_p, improve_gate, tiebreak,
                                              select_jitter):
    """Three rounds: each window against the reference's lines, each
    fold (a random acceptance of the window's picks) against the
    reference's carried index and marks."""
    x = _sweep_inputs(num_p, seed=num_p + 2 * improve_gate + tiebreak)
    rng = np.random.default_rng(7)
    j_cur = jnp.asarray(x["cur"])
    j_failed = jnp.zeros(num_p, jnp.float32)
    cur = _t(x["cur"])
    failed = torch.zeros(num_p)
    tb = x["tb"] if tiebreak else None
    prev = None
    for rnd in range(3):
        salt = np.float32(rnd) * np.float32(0.37)
        want = _J_WINDOW(
            j_cur, j_failed, jnp.asarray(x["rows"]),
            jnp.asarray(x["jit_plane"]), jnp.asarray(x["rb"]),
            jnp.asarray(x["value"]), jnp.asarray(x["static_ok"]),
            jnp.asarray(x["alive"]), jnp.asarray(x["leader_ok"]),
            jnp.asarray(x["W"]), jnp.asarray(x["shed_to"]),
            jnp.asarray(x["fill_to"]), jnp.asarray(x["hard_cap"]),
            None if tb is None else jnp.asarray(tb), jnp.float32(salt),
            improve_gate=improve_gate, select_jitter=select_jitter)
        got = L.sweep_window_plain(
            cur, failed, prev, _t(x["rows"]), _t(x["jit_plane"]),
            _t(x["rb"]), _t(x["rp"]), _t(x["value"]), _t(x["static_ok"]),
            _t(x["alive"]), _t(x["leader_ok"]), _t(x["W"]),
            _t(x["shed_to"]), _t(x["fill_to"]), _t(x["hard_cap"]),
            None if tb is None else _t(tb), salt, improve_gate,
            select_jitter)
        # the plain fold of the round before ran in place at this call
        _eq(j_cur, cur, f"cur before round {rnd}")
        _eq(j_failed, failed, f"failed before round {rnd}")
        for a, b, what in zip(want, got, WINDOW_FIELDS):
            _eq(a, b, f"{what} round {rnd}")
        has = np.asarray(want[1])
        assert has.any() and not has.all()
        valid = has & (rng.random(has.shape[0]) < 0.6)
        j_cur, j_failed = _J_FOLD(j_cur, j_failed, jnp.asarray(x["rp"]),
                                  *(want[i] for i in (0, 3, 6)),
                                  jnp.asarray(valid), want[2])
        prev = (got, _t(valid))
    assert float(j_failed.sum()) > 0


# ---------------------------------------------------------------------------
# K10's plain versions through the swap round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["band", "lower", "upper", "signed zeros"])
def test_swap_shortlist_and_pair_plain_match_reference(cluster, case):
    """The picks (K9's plain version), swap_shortlist_plain, the
    acceptance plane and swap_pair_plain against the reference's
    swap_round (on 16 brokers the shortlists hold every broker), then a
    shortlist of 6, which cuts, against lax.top_k."""
    js, ps, pr = cluster
    rng = np.random.default_rng(len(case))
    nb, nr = ps.num_brokers, ps.num_replicas
    if case == "signed zeros":
        w, util, target, hot, cold, movable = _swap_signed_zero_args(ps, rng)
        lower = upper = None
    else:
        w = (np.round(rng.random(nr) * 4.0) + 1.0).astype(np.float32)
        util = np.round(rng.random(nb) * 8.0).astype(np.float32) * 10.0
        target = np.full(nb, 40.0, np.float32)
        hot = util > target
        cold = util < target
        movable = rng.random(nr) < 0.9
        lower = (target - 25.0).astype(np.float32)
        upper = (target + 25.0).astype(np.float32)
        if case == "lower":
            upper = None
        if case == "upper":
            lower = None

    def accept(r, d):
        return (r + d) % 7 != 0

    want = _j_swap(js, pr, w, util, target, hot, cold, movable, accept,
                   lower, upper)
    rb = ps.replica_broker.long()
    tw, tmov, thot, tcold = _t(w), _t(movable), _t(hot), _t(cold)
    out_r, _, out_has = K.per_segment_argmax_plain(tw, rb, nb,
                                                   tmov & thot[rb])
    in_r, _, in_has = K.per_segment_argmax_plain(-tw, rb, nb,
                                                 tmov & tcold[rb])
    h_ids, c_ids, out_h, in_c, dev = K.swap_shortlist_plain(
        thot, tcold, out_r, in_r, out_has, in_has, None, _t(util),
        _t(target), min(K.SWAP_SHORTLIST, nb))
    cold_b, valid = K.swap_pair_plain(
        h_ids, c_ids, out_r, in_r, out_has, in_has, thot, tcold, tw, dev,
        _t(util), None if lower is None else _t(lower),
        None if upper is None else _t(upper),
        accept(out_h[:, None], in_c[None, :]), ps.replica_partition, _t(pr),
        ps.replica_broker)
    _eq(want[0], out_r, "out_r")
    _eq(want[1], in_r, "in_r")
    _eq(want[2], cold_b, "cold")
    _eq(want[3], valid, "valid")
    assert int(valid.sum()) > 0
    # a cut shortlist: the top 6 of each side against lax.top_k
    h6, c6 = K.swap_shortlist_plain(
        thot, tcold, out_r, in_r, out_has, in_has, None, _t(util),
        _t(target), 6)[:2]
    dev_np = (util - target).astype(np.float32)
    for got, flags, rank in ((h6, hot & out_has.numpy(), dev_np),
                             (c6, cold & in_has.numpy(), -dev_np)):
        _, j_ids = jax.lax.top_k(jnp.where(jnp.asarray(flags),
                                           jnp.asarray(rank), -jnp.inf), 6)
        _eq(j_ids, got.to(torch.int32), "shortlist of 6")
