"""Parity of the PyTorch port's search functions with the JAX reference
on identical inputs: the per-row top-k (K1's plain version) on a plane
with ties, the pairwise jitter, the assignment passes (K2's plain version)
in single- and multi-commit mode, the ranking and conflict resolution,
XLA's float cumsum order, and whole move and swap rounds.  Integer and
boolean outputs must match exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import context as JC
from cruise_control_tpu.analyzer import kernels as JK
from cruise_control_tpu.analyzer.goals.resource_distribution import (
    DiskUsageDistributionGoal as JDisk)
from cruise_control_tpu.analyzer.goals.base import (
    compose_move_acceptance as j_compose_move,
    compose_swap_acceptance as j_compose_swap,
    move_commit_terms as j_move_terms, shed_rows as j_shed_rows)
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu_torch import ops
from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer import kernels as K
from cruise_control_tpu_torch.analyzer.goals.base import (
    compose_move_acceptance, compose_swap_acceptance, move_commit_terms,
    shed_rows)
from cruise_control_tpu_torch.analyzer.goals.resource_distribution import (
    DiskUsageDistributionGoal)
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)

SPEC = dict(num_brokers=16, num_partitions=400, replication_factor=3,
            num_racks=4, num_topics=8, seed=2, skew_fraction=0.4)
DISK = 3


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    assert np.array_equal(a, b), what


class _Table:
    """A cache stand-in carrying only the broker table."""

    def __init__(self, table):
        self.broker_table = table


@pytest.mark.parametrize("k", [1, 4, 8])
def test_rows_pick_topk_with_ties(k):
    rng = np.random.default_rng(k)
    b, s = 12, 40
    sc = np.round(rng.random((b, s)) * 5.0).astype(np.float32)
    sc[rng.random((b, s)) < 0.3] = JK.NEG
    sc[0] = JK.NEG
    sc[1] = 2.0
    table = rng.permutation(b * s).astype(np.int32).reshape(b, s)
    jc, jh, jt = JK.rows_pick_topk(_Table(jnp.asarray(table)),
                                   jnp.asarray(sc), k)
    pc, ph, pt = K.rows_pick_topk(_Table(torch.from_numpy(table)),
                                  torch.from_numpy(sc), k)
    _eq(jc, pc, "cand")
    _eq(jh, ph, "has")
    _eq(jt, pt, "top")
    jb = JK.rows_pick_best(_Table(jnp.asarray(table)), jnp.asarray(sc))
    pb = K.rows_pick_best(_Table(torch.from_numpy(table)),
                          torch.from_numpy(sc))
    _eq(jb[0], pb[0], "best cand")
    _eq(jb[1], pb[1], "best has")


@pytest.mark.parametrize("salt", [0, 1, 3, 7, 123456789])
def test_pairwise_jitter_bit_exact(salt):
    a = np.asarray(JK._pairwise_jitter(300, 260, salt=salt))
    b = K._pairwise_jitter(300, 260, salt=salt).numpy()
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("n", [5, 16, 17, 64, 200, 2048])
def test_cumsum_follows_xla_order(n):
    x = np.random.default_rng(n).lognormal(0, 2, size=(3, n)).astype(
        np.float32)
    a = np.asarray(jnp.cumsum(jnp.asarray(x), axis=1))
    b = ops.cumsum_f32_plain(torch.from_numpy(x), 1).numpy()
    assert np.array_equal(a, b)


def _assign_inputs(seed, c=48, kk=16, num_b=20):
    rng = np.random.default_rng(seed)
    pref = -rng.random((c, kk)).astype(np.float32)
    pref[rng.random((c, kk)) < 0.3] = JK.NEG
    pref[:, 4] = pref[:, 2]
    gain = np.round(rng.random(c) * 4).astype(np.float32)
    has = rng.random(c) < 0.85
    dest_ids = rng.permutation(num_b)[:kk].astype(np.int32)
    return pref, gain, has, dest_ids, rng


#: compiled as the reference's goal programs compile it (XLA:CPU rounds
#: the jitter amplitude and the jittered preference once, as FMAs)
_j_assign = jax.jit(JK.assign_destinations, static_argnums=(3,))


@pytest.mark.parametrize("seed", [0, 1])
def test_assign_destinations_single_commit(seed):
    pref, gain, has, dest_ids, _ = _assign_inputs(seed)
    jd, jv = _j_assign(jnp.asarray(pref), jnp.asarray(gain),
                       jnp.asarray(has), 20, jnp.asarray(dest_ids))
    pd, pv = K.assign_destinations(torch.from_numpy(pref),
                                   torch.from_numpy(gain),
                                   torch.from_numpy(has), 20,
                                   torch.from_numpy(dest_ids))
    _eq(jv, pv, "valid")
    _eq(np.where(np.asarray(jv), jd, 0), torch.where(pv, pd, 0), "dest")


@pytest.mark.parametrize("seed", [0, 1])
def test_assign_destinations_multi_commit(seed):
    pref, gain, has, dest_ids, rng = _assign_inputs(seed)
    c = pref.shape[0]
    terms = [(rng.random(c).astype(np.float32),
              (rng.random(20) * 3).astype(np.float32)) for _ in range(2)]
    cap = rng.integers(1, 6, size=20).astype(np.int32)
    jd, jv = _j_assign(
        jnp.asarray(pref), jnp.asarray(gain), jnp.asarray(has), 20,
        jnp.asarray(dest_ids),
        dest_terms=[(jnp.asarray(w), jnp.asarray(h)) for w, h in terms],
        dest_cap=jnp.asarray(cap))
    pd, pv = K.assign_destinations(
        torch.from_numpy(pref), torch.from_numpy(gain), torch.from_numpy(has),
        20, torch.from_numpy(dest_ids),
        dest_terms=[(torch.from_numpy(w), torch.from_numpy(h))
                    for w, h in terms],
        dest_cap=torch.from_numpy(cap))
    _eq(jv, pv, "valid")
    _eq(np.where(np.asarray(jv), jd, 0), torch.where(pv, pd, 0), "dest")


def test_rank_accept_matches():
    rng = np.random.default_rng(4)
    c, num_b = 64, 10
    dest = rng.integers(0, num_b, size=c).astype(np.int32)
    gain = np.round(rng.random(c) * 3).astype(np.float32)
    has = rng.random(c) < 0.8
    taken = rng.integers(0, 2, size=num_b).astype(np.int32)
    cap = rng.integers(1, 8, size=num_b).astype(np.int32)
    cum = [(rng.random(num_b)).astype(np.float32)]
    w = [rng.random(c).astype(np.float32)]
    hr = [(rng.random(num_b) * 4).astype(np.float32)]
    a = JK.rank_accept(jnp.asarray(dest), jnp.asarray(gain),
                       jnp.asarray(has), num_b, jnp.asarray(taken),
                       jnp.asarray(cap), [jnp.asarray(x) for x in cum],
                       [jnp.asarray(x) for x in w],
                       [jnp.asarray(x) for x in hr])
    b = K.rank_accept(torch.from_numpy(dest), torch.from_numpy(gain),
                      torch.from_numpy(has), num_b, torch.from_numpy(taken),
                      torch.from_numpy(cap), [torch.from_numpy(x) for x in cum],
                      [torch.from_numpy(x) for x in w],
                      [torch.from_numpy(x) for x in hr])
    _eq(a, b)


def test_conflicts_and_segment_argmax_match():
    rng = np.random.default_rng(6)
    n, segs = 80, 12
    seg = rng.integers(0, segs, size=n).astype(np.int32)
    score = np.round(rng.random(n) * 4).astype(np.float32)
    valid = rng.random(n) < 0.7
    ja, jm, jh = JK.per_segment_argmax(jnp.asarray(score), jnp.asarray(seg),
                                       segs, jnp.asarray(valid))
    pa, pm, ph = K.per_segment_argmax(torch.from_numpy(score),
                                      torch.from_numpy(seg), segs,
                                      torch.from_numpy(valid))
    _eq(ja, pa, "arg")
    _eq(jh, ph, "has")
    _eq(np.where(np.asarray(jh), jm, 0), torch.where(ph, pm, 0), "max")
    _eq(JK.resolve_dest_conflicts(jnp.asarray(seg), jnp.asarray(score),
                                  jnp.asarray(valid), segs),
        K.resolve_dest_conflicts(torch.from_numpy(seg),
                                 torch.from_numpy(score),
                                 torch.from_numpy(valid), segs))


@pytest.fixture(scope="module")
def round_setup():
    js, jt = j_random_cluster(JSpec(**SPEC))
    ps, pt = random_cluster(RandomClusterSpec(**SPEC), device="cpu")
    jctx = JC.make_context(js, JC.BalancingConstraint(),
                           JC.OptimizationOptions(), jt)
    pctx = C.make_context(ps, C.BalancingConstraint(),
                          C.OptimizationOptions(), pt)
    jcache = JC.make_round_cache(js, jctx.table_slots, jctx)
    pcache = C.make_round_cache(ps, pctx.table_slots, pctx)
    return js, ps, jctx, pctx, jcache, pcache


def _bounds(ctx, state, lib):
    cap = state.broker_capacity[:, DISK]
    return ctx.balance_lower_pct[DISK] * cap, ctx.balance_upper_pct[DISK] * cap


def _move_round(lib_k, compose, terms, shed, state, ctx, cache, prev):
    """Phase b of the disk goal (shed over-limit brokers) with `prev` as
    the previously-optimized goals: multi-commit with per_src_k=4."""
    lower, upper = _bounds(ctx, state, None)
    W = cache.broker_load[:, DISK]
    w = cache.replica_load[:, DISK]
    movable = state.replica_valid & (w > 0.0)
    mt_d, mt_s = terms(prev, state, ctx, cache)
    cap = state.broker_capacity[:, DISK]
    return lib_k.move_round(
        state, w, W > upper, W - upper, movable,
        ctx.broker_dest_ok & state.broker_alive, upper - W,
        compose(prev, state, ctx, cache), -W / cap,
        ctx.partition_replicas, cache=cache,
        sc_rows=shed(cache, cache.table_load[:, :, DISK], W > upper,
                     W - upper),
        per_src_k=4, dest_terms=mt_d, src_terms=mt_s,
        dest_stack_headroom=(upper + lower) / 2.0 - W)


@pytest.mark.parametrize("with_prev", [False, True])
def test_move_round_matches(round_setup, with_prev):
    js, ps, jctx, pctx, jcache, pcache = round_setup
    jprev = [JDisk()] if with_prev else []
    pprev = [DiskUsageDistributionGoal()] if with_prev else []
    jr, jd, jv = _move_round(JK, j_compose_move, j_move_terms, j_shed_rows,
                             js, jctx, jcache, jprev)
    pr, pd, pv = _move_round(K, compose_move_acceptance, move_commit_terms,
                             shed_rows, ps, pctx, pcache, pprev)
    _eq(jr, pr, "cand")
    _eq(jv, pv, "valid")
    assert bool(np.asarray(jv).any())
    _eq(np.where(np.asarray(jv), jd, 0), torch.where(pv, pd, 0), "dest")


def test_swap_round_matches(round_setup):
    js, ps, jctx, pctx, jcache, pcache = round_setup
    out = []
    for lib_k, compose, st, ctx, cache in (
            (JK, j_compose_swap, js, jctx, jcache),
            (K, compose_swap_acceptance, ps, pctx, pcache)):
        lower, upper = _bounds(ctx, st, None)
        W = cache.broker_load[:, DISK]
        w = cache.replica_load[:, DISK]
        target = (upper + lower) / 2.0
        out.append(lib_k.swap_round(
            st, w, st.replica_valid & (w > 0.0),
            st.broker_alive & (W > upper), st.broker_alive & (W < target),
            W, target, compose([], st, ctx, cache), ctx.partition_replicas,
            cache=cache, w_rows=cache.table_load[:, :, DISK], lower=lower,
            upper=upper))
    (jo, ji, jc, jv), (po, pi, pc, pv) = out
    _eq(jo, po, "out")
    _eq(ji, pi, "in")
    _eq(jv, pv, "valid")
    assert bool(np.asarray(jv).any())
    _eq(np.where(np.asarray(jv), jc, 0), torch.where(pv, pc, 0), "cold")
