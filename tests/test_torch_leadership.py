"""Parity of the PyTorch port's leadership path with the JAX reference on
identical inputs (a seeded 20-broker cluster): the leader index and the
batched transfer, the salted jitter and the rotation salt (the large-load
inputs of test_rotation_salt.py included), detaching and reattaching the
broker table, the leadership commit with and without a table (the CPU
form is the plain version of kernel K5), `leadership_round` in multi-
and single-commit mode, through its deep-pick and full-plane fallbacks
and without a table, the global leadership sweep in limit mode and in
mean mode with the improvement gate, a destination tiebreak and a
regression guard, and the plain versions of K4 and K6 against the
reference expressions they replace.  Integers and booleans must be
equal, and so must every float (both sides add in the same order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import context as JC
from cruise_control_tpu.analyzer import kernels as JK
from cruise_control_tpu.analyzer import leadership as JL
from cruise_control_tpu.analyzer.goals import base as JB
from cruise_control_tpu.analyzer.goals.resource_distribution import (
    DiskUsageDistributionGoal as JDisk,
    NetworkInboundUsageDistributionGoal as JNwIn)
from cruise_control_tpu.model import state as JS
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer import kernels as K
from cruise_control_tpu_torch.analyzer import leadership as L
from cruise_control_tpu_torch.analyzer.goals import base as B
from cruise_control_tpu_torch.analyzer.goals.resource_distribution import (
    DiskUsageDistributionGoal, NetworkInboundUsageDistributionGoal)
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)

SPEC = dict(num_brokers=20, num_partitions=480, replication_factor=3,
            num_racks=4, num_topics=8, seed=5, skew_fraction=0.4)
NW_OUT = 2


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


def _assert_cache_equal(jcache, pcache, what=""):
    for f in C.CACHE_FIELDS:
        a = np.asarray(getattr(jcache, f))
        b = getattr(pcache, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert np.array_equal(a, b), (what, f)


class _JOpaque(JB.Goal):
    """A prior goal whose leadership acceptance is not quantitative (no
    headroom terms): the leadership search drops to single commit."""
    name = "opaque"


class _POpaque(B.Goal):
    name = "opaque"

    def optimize_cached(self, state, ctx, prev_goals, cache=None):
        return state, cache


@pytest.fixture(scope="module")
def setup():
    js, jt = j_random_cluster(JSpec(**SPEC))
    ps, pt = random_cluster(RandomClusterSpec(**SPEC), device="cpu")
    jctx = JC.make_context(js, JC.BalancingConstraint(),
                           JC.OptimizationOptions(), jt)
    pctx = C.make_context(ps, C.BalancingConstraint(),
                          C.OptimizationOptions(), pt)
    return js, ps, jctx, pctx


def _caches(setup, table: bool):
    js, ps, jctx, pctx = setup
    slots = jctx.table_slots if table else 0
    return (JC.make_round_cache(js, slots, jctx),
            C.make_round_cache(ps, slots, pctx))


def _transfers(setup, seed: int, n: int):
    """A batch of n transfers on distinct partitions: the current leader
    to another replica of the partition; about a fifth invalid."""
    js, _, jctx, _ = setup
    rng = np.random.default_rng(seed)
    cur = np.asarray(JS.partition_leader_replica(js))
    rows = np.asarray(jctx.partition_replicas)
    parts = rng.choice(rows.shape[0], size=n, replace=False)
    src = cur[parts].astype(np.int32)
    dst = np.array([rng.choice([r for r in rows[p] if r >= 0 and r != s])
                    for p, s in zip(parts, src)], dtype=np.int32)
    valid = rng.random(n) < 0.8
    return src, dst, valid


def test_partition_leader_replica(setup):
    js, ps, _, _ = setup
    _eq(JS.partition_leader_replica(js), S.partition_leader_replica(ps))


def test_apply_leadership_transfers(setup):
    js, ps, _, _ = setup
    src, dst, valid = _transfers(setup, 1, 120)
    a = JS.apply_leadership_transfers(js, jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(valid))
    b = S.apply_leadership_transfers(ps, _t(src), _t(dst), _t(valid))
    _eq(a.replica_is_leader, b.replica_is_leader)
    assert not np.array_equal(np.asarray(a.replica_is_leader),
                              np.asarray(js.replica_is_leader))
    one = S.transfer_leadership(ps, int(src[0]), int(dst[0]))
    _eq(JS.transfer_leadership(js, int(src[0]), int(dst[0])
                               ).replica_is_leader, one.replica_is_leader)


@pytest.mark.parametrize("salt", [0, 1, 13, 2 ** 31 - 1, -1, -123456789])
def test_salted_jitter_bit_exact(salt):
    a = JK.salted_jitter(300, jnp.asarray(salt, jnp.int32))
    _eq(a, K.salted_jitter(300, torch.tensor(salt, dtype=torch.int32)))
    _eq(a, K.salted_jitter(300, salt))


def _salt_cases():
    rng = np.random.RandomState(7)
    cases = [(np.full(64, 1000, np.int32),
              np.linspace(1e10, 9e10, 64).astype(np.float32)),
             (np.arange(16, dtype=np.int32),
              np.linspace(0.0, 40.0, 16).astype(np.float32)),
             (rng.randint(0, 400, 200).astype(np.int32),
              (rng.random(200) * 3e3).astype(np.float32))]
    lc = np.full(128, 50_000, np.int32)
    for _ in range(4):
        cases.append((lc.copy(), np.full(128, 7e11, np.float32)))
        s, d = rng.choice(128, size=2, replace=False)
        lc[s] -= 1
        lc[d] += 1
    return cases


@pytest.mark.parametrize("case", range(7))
def test_rotation_salt_matches(case):
    lc, load = _salt_cases()[case]
    a = int(JK.rotation_salt(jnp.asarray(lc), jnp.asarray(load)))
    b = K.rotation_salt(_t(lc), _t(load))
    assert b.dtype == torch.int32 and b.shape == ()
    assert a == int(b)


def test_strip_and_reattach_table(setup):
    js, ps, _, _ = setup
    jcache, pcache = _caches(setup, table=True)
    _assert_cache_equal(JC.strip_table(jcache), C.strip_table(pcache),
                        "strip")
    src, dst, valid = _transfers(setup, 2, 100)
    js2 = JS.apply_leadership_transfers(js, jnp.asarray(src),
                                        jnp.asarray(dst), jnp.asarray(valid))
    ps2 = S.apply_leadership_transfers(ps, _t(src), _t(dst), _t(valid))
    a = JC.reattach_table(js2, JC.strip_table(jcache), jcache.broker_table,
                          jcache.table_fill, jcache.table_bonus,
                          jcache.table_ok, jcache.replica_ok)
    b = C.reattach_table(ps2, C.strip_table(pcache), pcache.broker_table,
                         pcache.table_fill, pcache.table_bonus,
                         pcache.table_ok, pcache.replica_ok)
    _assert_cache_equal(a, b, "reattach")


@pytest.mark.parametrize("table", [False, True])
def test_update_cache_for_leadership(setup, table):
    """The commit (K5's plain version on the CPU) against the reference,
    field for field and bit for bit."""
    js, ps, _, _ = setup
    jcache, pcache = _caches(setup, table)
    src, dst, valid = _transfers(setup, 3, 150)
    ja, jb = JK.commit_leadership_cached(js, jcache, jnp.asarray(src),
                                         jnp.asarray(dst), jnp.asarray(valid))
    pa, pb = K.commit_leadership_cached(ps, pcache, _t(src), _t(dst),
                                        _t(valid))
    _eq(ja.replica_is_leader, pa.replica_is_leader)
    _assert_cache_equal(jb, pb)
    with pytest.raises(AssertionError, match="partition appears twice"):
        C.commit_leadership_plain(ps, pcache, _t(np.r_[src, src]),
                                  _t(np.r_[dst, dst]),
                                  _t(np.ones(2 * len(src), bool)))


def test_cache_carried_across_drives_the_commit(setup):
    """A reference RoundCache carried across as numpy (every field the
    leadership path reads, the table planes included) gives the same
    commit as the port's own cache."""
    js, ps, _, _ = setup
    jcache, pcache = _caches(setup, table=True)
    carried = convert.cache_from_numpy(
        {f: np.asarray(getattr(jcache, f)) for f in C.CACHE_FIELDS},
        device="cpu")
    _assert_cache_equal(jcache, carried, "carried")
    src, dst, valid = _transfers(setup, 4, 90)
    a = C.update_cache_for_leadership(ps, carried, _t(src), _t(dst),
                                      _t(valid))
    b = C.update_cache_for_leadership(ps, pcache, _t(src), _t(dst),
                                      _t(valid))
    for f in C.CACHE_FIELDS:
        _eq(getattr(a, f), getattr(b, f), f)


# ---------------------------------------------------------------------------
# leadership_round
# ---------------------------------------------------------------------------

def _j_round(st, ctx, cache, prev, veto=None, mark=None, table=True):
    """The reference's phase a of the NW_OUT goal, with an optional extra
    veto on source replicas and an optional restriction of the resident
    candidate rows to `mark`."""
    res = NW_OUT
    cap = st.broker_capacity[:, res]
    lower = ctx.balance_lower_pct[res] * cap
    upper = ctx.balance_upper_pct[res] * cap
    bonus = (st.partition_leader_bonus[st.replica_partition, res]
             * st.replica_valid)
    W = cache.broker_load[:, res]
    accept = JB.compose_leadership_acceptance(prev, st, ctx, cache)

    def accept_all(src_r, dst_r):
        db = st.replica_broker[dst_r]
        ok = accept(src_r, dst_r) & (W[db] + bonus[jnp.broadcast_to(
            src_r, jnp.broadcast_shapes(src_r.shape, dst_r.shape))]
            <= upper[db])
        if veto is not None:
            ok = ok & ~jnp.asarray(veto)[src_r]
        return ok

    lt_d, lt_s = JB.leadership_commit_terms(prev, st, ctx, cache)
    rows = value_rows = None
    if table:
        value_rows = cache.table_bonus[:, :, res]
        rows = JB.leader_shed_rows(cache, value_rows, W > upper, W - upper)
        if mark is not None:
            tab = jnp.minimum(cache.broker_table, st.num_replicas - 1)
            rows = jnp.where(jnp.asarray(mark)[tab], rows, JK.NEG)
    return JK.leadership_round(
        st, bonus, W - upper, JC.replica_static_ok(st, ctx),
        ctx.broker_leader_ok, upper - W, accept_all,
        -W / jnp.maximum(cap, 1e-9), ctx.partition_replicas, cache=cache,
        bonus_rows=rows, value_rows=value_rows, dest_terms=lt_d,
        src_terms=lt_s, dest_stack_headroom=(upper + lower) / 2.0 - W)


def _p_round(st, ctx, cache, prev, veto=None, mark=None, table=True):
    res = NW_OUT
    cap = st.broker_capacity[:, res]
    lower = ctx.balance_lower_pct[res] * cap
    upper = ctx.balance_upper_pct[res] * cap
    bonus = (st.partition_leader_bonus[st.replica_partition.long(), res]
             * st.replica_valid)
    W = cache.broker_load[:, res]
    accept = B.compose_leadership_acceptance(prev, st, ctx, cache)

    def accept_all(src_r, dst_r):
        db = st.replica_broker[dst_r].long()
        src_b = src_r.expand(torch.broadcast_shapes(src_r.shape,
                                                    dst_r.shape))
        ok = accept(src_r, dst_r) & (W[db] + bonus[src_b] <= upper[db])
        if veto is not None:
            ok = ok & ~_t(veto)[src_r]
        return ok

    lt_d, lt_s = B.leadership_commit_terms(prev, st, ctx, cache)
    rows = value_rows = None
    if table:
        value_rows = cache.table_bonus[:, :, res]
        rows = B.leader_shed_rows(cache, value_rows, W > upper, W - upper)
        if mark is not None:
            tab = torch.clamp_max(cache.broker_table,
                                  st.num_replicas - 1).long()
            rows = torch.where(_t(mark)[tab], rows,
                               torch.full((), K.NEG))
    return K.leadership_round(
        st, bonus, W - upper, C.replica_static_ok(st, ctx),
        ctx.broker_leader_ok, upper - W, accept_all,
        -W / torch.clamp_min(cap, 1e-9), ctx.partition_replicas,
        cache=cache, bonus_rows=rows, value_rows=value_rows,
        dest_terms=lt_d, src_terms=lt_s,
        dest_stack_headroom=(upper + lower) / 2.0 - W)


def _top_candidates(js, jctx, jcache, k):
    """bool[R]: each row's top-k structural candidates of phase a."""
    res = NW_OUT
    cap = js.broker_capacity[:, res]
    upper = jctx.balance_upper_pct[res] * cap
    W = jcache.broker_load[:, res]
    value_rows = jcache.table_bonus[:, :, res]
    rows = JB.leader_shed_rows(jcache, value_rows, W > upper, W - upper)
    top, slots = jax.lax.top_k(rows, k)
    ids = np.asarray(jnp.take_along_axis(jcache.broker_table, slots, 1))
    mask = np.zeros(js.num_replicas, bool)
    mask[ids[np.asarray(top) > JK.NEG / 2]] = True
    return mask


@pytest.mark.parametrize("mode", ["multi", "single", "deep", "full_plane",
                                  "tableless"])
def test_leadership_round_matches(setup, mode, monkeypatch):
    js, ps, jctx, pctx = setup
    table = mode != "tableless"
    jcache, pcache = _caches(setup, table)
    if mode == "single":
        jprev, pprev = [JDisk(), _JOpaque()], [DiskUsageDistributionGoal(),
                                               _POpaque()]
    else:
        jprev = [JDisk(), JNwIn()]
        pprev = [DiskUsageDistributionGoal(),
                 NetworkInboundUsageDistributionGoal()]
    veto = mark = None
    if mode == "deep":
        # every row's top-16 vetoed: the first pass commits nothing, the
        # deep pick reaches ranks 17-64
        veto = _top_candidates(js, jctx, jcache, 16)
    elif mode == "full_plane":
        # the resident rows hold only vetoed leaders: both the first pass
        # and the deep pick fail, the full plane finds the others
        mark = veto = _top_candidates(js, jctx, jcache, 2)
    calls = {"deep": 0, "full": 0}
    real_topk, real_pick = K.row_topk, K.table_pick_best

    def counting_topk(sc, table_, k):
        calls["deep"] += k == min(64, table_.shape[1])
        return real_topk(sc, table_, k)

    def counting_pick(*a):
        calls["full"] += 1
        return real_pick(*a)

    monkeypatch.setattr(K, "row_topk", counting_topk)
    monkeypatch.setattr(K, "table_pick_best", counting_pick)
    jr, jd, jv = _j_round(js, jctx, jcache, jprev, veto, mark, table)
    pr, pd, pv = _p_round(ps, pctx, pcache, pprev, veto, mark, table)
    _eq(jr, pr, "cand")
    _eq(jv, pv, "valid")
    assert bool(np.asarray(jv).any())
    _eq(np.where(np.asarray(jv), jd, 0), torch.where(pv, pd, 0), "dest")
    if mode == "single":
        # one transfer per source and per destination broker
        rb = ps.replica_broker
        for ids in (pr[pv].long(), pd[pv].long()):
            b = rb[ids]
            assert b.numel() == torch.unique(b).numel()
    assert calls["deep"] == (mode in ("deep", "full_plane"))
    assert calls["full"] == (mode == "full_plane")


# ---------------------------------------------------------------------------
# global leadership sweep
# ---------------------------------------------------------------------------

def _limit_kwargs(lib, st, ctx, res=NW_OUT):
    xp_take = (st.replica_partition if lib is JL
               else st.replica_partition.long())
    cap = st.broker_capacity[:, res]
    lower = ctx.balance_lower_pct[res] * cap
    upper = ctx.balance_upper_pct[res] * cap
    return dict(measure=lambda c: c.broker_load[:, res],
                value_r=(st.partition_leader_bonus[xp_take, res]
                         * st.replica_valid),
                bounds=lib.limit_bounds(upper, (upper + lower) / 2.0),
                improve_gate=False,
                select_jitter=lib.VALUE_WEIGHTED_SELECT_JITTER)


def test_sweep_limit_mode(setup):
    """The NW_OUT goal's pre-sweep with Disk and NwIn before it, threaded
    through a cache with a table."""
    js, ps, jctx, pctx = setup
    jcache, pcache = _caches(setup, table=True)
    a = JL.run_sweep_threaded(js, jctx, [JDisk(), JNwIn()], jcache,
                              **_limit_kwargs(JL, js, jctx))
    b = L.run_sweep_threaded(ps, pctx, [DiskUsageDistributionGoal(),
                                        NetworkInboundUsageDistributionGoal()],
                             pcache, **_limit_kwargs(L, ps, pctx))
    _eq(a[0].replica_is_leader, b[0].replica_is_leader, "leaders")
    assert int(a[1]) == b[1] and int(a[3]) == b[3]
    assert b[1] > 0 and b[3] > 0
    _assert_cache_equal(a[2], b[2])


def test_sweep_mean_mode_with_gate_tiebreak_and_guard(setup):
    """Mean mode on leader counts (every transfer weighs 1) with the
    strict-improvement gate, a low-bytes-in destination tiebreak and a
    regression guard, from a table-less cache."""
    js, ps, jctx, pctx = setup
    jcache, pcache = _caches(setup, table=False)
    cap_j = jnp.full((js.num_brokers,), 1e9, jnp.float32)
    cap_p = torch.full((ps.num_brokers,), 1e9)
    a = JL.global_leadership_sweep(
        js, jctx, [JDisk()],
        measure=lambda c: c.leader_count.astype(jnp.float32),
        value_r=js.replica_valid.astype(jnp.float32),
        bounds=JL.mean_bounds(lambda st, W: cap_j), improve_gate=True,
        dest_tiebreak=lambda c: -c.leader_bytes_in, cache0=jcache,
        regress_guard=lambda st, c: jnp.sum(c.leader_count > 26))
    b = L.global_leadership_sweep(
        ps, pctx, [DiskUsageDistributionGoal()],
        measure=lambda c: c.leader_count.to(torch.float32),
        value_r=ps.replica_valid.to(torch.float32),
        bounds=L.mean_bounds(lambda st, W: cap_p), improve_gate=True,
        dest_tiebreak=lambda c: -c.leader_bytes_in, cache0=pcache,
        regress_guard=lambda st, c: torch.sum(c.leader_count > 26))
    _eq(a[0].replica_is_leader, b[0].replica_is_leader, "leaders")
    assert int(a[1]) == b[1] and int(a[3]) == b[3]
    assert b[3] > 0
    _assert_cache_equal(a[2], b[2])


# ---------------------------------------------------------------------------
# plain kernel versions against the reference expressions they replace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("k", [0, 3])
def test_leader_assign_pass_plain_matches(multi, k):
    """K4's plain version against leadership_round's pass body."""
    rng = np.random.default_rng(10 * k + multi)
    c, rf, nb = 64, 3, 12
    pref = -rng.random((c, rf)).astype(np.float32)
    pref[rng.random((c, rf)) < 0.3] = JK.NEG
    pref[:, 2] = np.where(rng.random(c) < 0.2, pref[:, 0], pref[:, 2])
    sib_b = rng.integers(0, nb, (c, rf)).astype(np.int32)
    sib_r = rng.integers(0, 500, (c, rf)).astype(np.int32)
    src = rng.integers(0, nb, c).astype(np.int32)
    taken = (rng.integers(0, 3, nb) * (40 if multi else 1)).astype(np.int32)
    dep = rng.integers(0, 2, nb).astype(np.int32)
    assigned = rng.random(c) < 0.2
    has_in = rng.random(c) < 0.9
    finite = pref > JK.NEG / 2
    amp = np.float32(0.35) * (pref[finite].max() - pref[finite].min()) \
        + np.float32(1e-6)
    jp = jnp.asarray(pref)
    pass_pref = jp if k == 0 else jnp.where(
        jp > JK.NEG / 2, jp + amp * JK._pairwise_jitter(c, rf, salt=k),
        JK.NEG)
    if multi:
        open_pref = jnp.where(jnp.asarray(taken)[sib_b]
                              < JK.MAX_ARRIVALS_PER_ROUND, pass_pref, JK.NEG)
    else:
        open_pref = jnp.where((jnp.asarray(taken)[sib_b] > 0)
                              | (jnp.asarray(dep)[src] > 0)[:, None],
                              JK.NEG, pass_pref)
    open_pref = jnp.where(jnp.asarray(assigned)[:, None], JK.NEG, open_pref)
    slot = jnp.argmax(open_pref, axis=1)
    has = jnp.asarray(has_in) & (jnp.max(open_pref, axis=1) > JK.NEG / 2)
    got = K.leader_assign_pass_plain(
        _t(pref), _t(sib_b), _t(sib_r), _t(src), _t(taken), _t(dep),
        _t(assigned), _t(has_in), k, torch.tensor(amp), multi)
    _eq(slot.astype(jnp.int32), got[0], "slot")
    _eq(sib_b[np.arange(c), np.asarray(slot)], got[1], "broker")
    _eq(sib_r[np.arange(c), np.asarray(slot)], got[2], "replica")
    _eq(has, got[3], "has")
    assert bool(np.asarray(has).any()) and not bool(np.asarray(has).all())


@pytest.mark.parametrize("improve_gate,tiebreak",
                         [(False, False), (True, True)])
def test_sweep_pick_plain_matches(improve_gate, tiebreak):
    """K6's plain version against the sweep round's sibling planes."""
    rng = np.random.default_rng(int(improve_gate))
    nb, num_p, rf, wn = 14, 300, 3, 120
    num_r = num_p * rf
    rows = rng.permutation(num_r).reshape(num_p, rf).astype(np.int32)
    rows[rng.random((num_p, rf)) < 0.1] = -1
    sel = rng.choice(num_p, wn, replace=False).astype(np.int32)
    cur = np.maximum(rows[sel, 0], 0).astype(np.int32)
    has_in = rng.random(wn) < 0.85
    rb = rng.integers(0, nb, num_r).astype(np.int32)
    value = (rng.random(num_r) * 3).astype(np.float32)
    static_ok = rng.random(num_r) < 0.9
    alive = rng.random(nb) < 0.9
    leader_ok = rng.random(nb) < 0.9
    W = (rng.random(nb) * 20).astype(np.float32)
    fill_to = (rng.random(nb) * 20).astype(np.float32)
    hard_cap = (W + rng.random(nb) * 4).astype(np.float32)
    tb = (rng.random(nb)).astype(np.float32) if tiebreak else None
    jit_plane = np.asarray(JK._pairwise_jitter(num_p, rf, salt=0))
    salt = np.float32(5) * np.float32(0.37)
    # the reference's expressions (leadership.py round body)
    rows_w = jnp.asarray(rows)[sel]
    rows_w_safe = jnp.maximum(rows_w, 0)
    cand_b = jnp.asarray(rb)[rows_w_safe]
    value_arrive = jnp.asarray(value)[rows_w_safe]
    Wj = jnp.asarray(W)
    ok = ((rows_w >= 0) & (rows_w != jnp.asarray(cur)[:, None])
          & jnp.asarray(static_ok)[rows_w_safe] & jnp.asarray(alive)[cand_b]
          & jnp.asarray(leader_ok)[cand_b]
          & (Wj[cand_b] + value_arrive <= jnp.asarray(hard_cap)[cand_b]))
    deficit = (jnp.asarray(fill_to) - Wj)[cand_b]
    if improve_gate:
        ok &= value_arrive < 2.0 * deficit
    spread = jnp.maximum(jnp.max(jnp.abs(deficit)), 1e-6)
    score = deficit + 0.1 * spread * ((jnp.asarray(jit_plane)[sel]
                                       + jnp.asarray(salt)) % 1.0)
    if tb is not None:
        score = score + 0.5 * spread * jnp.asarray(tb)[cand_b]
    score = jnp.where(ok, score, -jnp.inf)
    best = jnp.argmax(score, axis=1)
    dst_r = jnp.take_along_axis(rows_w_safe, best[:, None], axis=1)[:, 0]
    has = jnp.asarray(has_in) & jnp.any(ok, axis=1)
    got = L.sweep_pick_plain(
        _t(sel), _t(has_in), _t(cur), _t(rows), _t(jit_plane), _t(rb),
        _t(value), _t(static_ok), _t(alive), _t(leader_ok), _t(W),
        _t(fill_to), _t(hard_cap), None if tb is None else _t(tb), salt,
        improve_gate)
    _eq(dst_r, got[0], "dst_r")
    _eq(has, got[1], "has")
    assert bool(np.asarray(has).any()) and not bool(np.asarray(has).all())
