"""Parity of the PyTorch port's optimization context and round cache with
the JAX reference: `make_context`, `make_round_cache` and the incremental
`update_cache_for_moves` (whose CPU form is the plain version of the
port's commit kernel), including several arrivals per destination and a
batch that triggers the broker-table re-pack.  Integers, booleans and the
cache's float sums must match exactly (both sides add in batch order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import context as JC
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.testing.checks import cache_mismatches
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)

SPEC = dict(num_brokers=16, num_partitions=400, replication_factor=3,
            num_racks=4, num_topics=8, seed=7, skew_fraction=0.3)


@pytest.fixture(scope="module")
def setup():
    js, jt = j_random_cluster(JSpec(**SPEC))
    ps, pt = random_cluster(RandomClusterSpec(**SPEC), device="cpu")
    jctx = JC.make_context(js, JC.BalancingConstraint(),
                           JC.OptimizationOptions(), jt)
    pctx = C.make_context(ps, C.BalancingConstraint(),
                          C.OptimizationOptions(), pt)
    return js, ps, jctx, pctx


def _assert_cache_equal(jcache, pcache, what=""):
    for f in C.CACHE_FIELDS:
        a = np.asarray(getattr(jcache, f))
        b = getattr(pcache, f).numpy()
        assert a.dtype == b.dtype, (what, f)
        assert a.shape == b.shape, (what, f)
        assert np.array_equal(a, b), (what, f)


def test_make_context_matches(setup):
    _, _, jctx, pctx = setup
    for f in C.CONTEXT_FIELDS:
        assert np.array_equal(np.asarray(getattr(jctx, f)),
                              getattr(pctx, f).numpy()), f
    for f in ("max_replicas_per_broker", "rf_max", "table_slots",
              "fast_mode", "prebalance", "fix_offline_replicas_only"):
        assert getattr(jctx, f) == getattr(pctx, f), f


def test_context_carries_across(setup):
    _, _, jctx, pctx = setup
    fields = {f: np.asarray(getattr(jctx, f)) for f in C.CONTEXT_FIELDS}
    ctx = convert.context_from_numpy(
        fields, device="cpu", **{f: getattr(jctx, f)
                                 for f in convert.CONTEXT_STATIC})
    for f in C.CONTEXT_FIELDS:
        assert torch.equal(getattr(ctx, f), getattr(pctx, f)), f
    back = convert.context_to_numpy(ctx)
    assert all(np.array_equal(back[f], fields[f]) for f in fields)


@pytest.mark.parametrize("slots", [0, None])
def test_make_round_cache_matches(setup, slots):
    js, ps, jctx, pctx = setup
    s = pctx.table_slots if slots is None else slots
    jcache = JC.make_round_cache(js, s, jctx)
    pcache = C.make_round_cache(ps, s, pctx)
    _assert_cache_equal(jcache, pcache)
    carried = convert.cache_from_numpy(
        {f: np.asarray(getattr(jcache, f)) for f in C.CACHE_FIELDS},
        device="cpu")
    _assert_cache_equal(jcache, carried)
    back = convert.cache_to_numpy(pcache)
    assert all(np.array_equal(back[f], np.asarray(getattr(jcache, f)))
               for f in C.CACHE_FIELDS)


def _batch(js, rng, n, hot_dests):
    """n distinct replicas; destinations drawn from `hot_dests` brokers so
    several arrivals land on one destination; a tenth invalid."""
    reps = rng.choice(js.num_replicas, size=n, replace=False).astype(
        np.int32)
    dests = rng.choice(hot_dests, size=n).astype(np.int32)
    valid = rng.random(n) < 0.9
    return reps, dests, valid


def _run_both(js, ps, jctx, pctx, jcache, pcache, reps, dests, valid):
    jnew = JC.update_cache_for_moves(js, jcache, jnp.asarray(reps),
                                     jnp.asarray(dests), jnp.asarray(valid))
    pnew = C.update_cache_for_moves(ps, pcache, torch.from_numpy(reps),
                                    torch.from_numpy(dests),
                                    torch.from_numpy(valid))
    return jnew, pnew


@pytest.mark.parametrize("n,hot", [(24, 3), (40, 16)])
def test_update_cache_for_moves_matches(setup, n, hot):
    js, ps, jctx, pctx = setup
    s = pctx.table_slots
    jcache = JC.make_round_cache(js, s, jctx)
    pcache = C.make_round_cache(ps, s, pctx)
    rng = np.random.default_rng(n)
    reps, dests, valid = _batch(js, rng, n, np.arange(hot) * 5 % 16)
    jnew, pnew = _run_both(js, ps, jctx, pctx, jcache, pcache, reps, dests,
                           valid)
    _assert_cache_equal(jnew, pnew, "after commit")
    moved = S.apply_moves(ps, torch.from_numpy(reps),
                          torch.from_numpy(dests), torch.from_numpy(valid))
    assert cache_mismatches(moved, pctx, pnew) == []


def test_update_cache_repack_matches(setup):
    """A narrow table (width just above the fullest row) makes a batch
    of arrivals push a fill pointer to the edge, which re-packs every
    row (the batch's departures from that row leave holes the re-pack
    closes); both the re-packed tables and the fresh rebuild agree."""
    js, ps, jctx, pctx = setup
    rb = np.asarray(js.replica_broker)
    counts = np.bincount(rb, minlength=16)
    s = int(counts.max()) + 6
    jcache = JC.make_round_cache(js, s, jctx)
    pcache = C.make_round_cache(ps, s, pctx)
    full = int(np.argmax(counts))
    rng = np.random.default_rng(1)
    arrive = rng.choice(np.nonzero(rb != full)[0], size=5, replace=False)
    leave = rng.choice(np.nonzero(rb == full)[0], size=4, replace=False)
    reps = np.concatenate([arrive, leave]).astype(np.int32)
    dests = np.concatenate([np.full(5, full), (full + 1 + np.arange(4)) % 16]
                           ).astype(np.int32)
    valid = np.ones(9, dtype=bool)
    jnew, pnew = _run_both(js, ps, jctx, pctx, jcache, pcache, reps, dests,
                           valid)
    assert int(np.asarray(jnew.table_fill).max()) < s - 1  # re-packed
    _assert_cache_equal(jnew, pnew, "after re-pack")
    moved = S.apply_moves(ps, torch.from_numpy(reps),
                          torch.from_numpy(dests), torch.from_numpy(valid))
    assert cache_mismatches(moved, pctx, pnew) == []


def test_refresh_float_aggregates_matches(setup):
    js, ps, jctx, pctx = setup
    s = pctx.table_slots
    jcache = JC.refresh_float_aggregates(js, JC.make_round_cache(js, s,
                                                                 jctx))
    pcache = C.refresh_float_aggregates(ps, C.make_round_cache(ps, s, pctx))
    _assert_cache_equal(jcache, pcache)


def test_duplicate_replica_in_batch_is_refused(setup):
    _, ps, _, pctx = setup
    pcache = C.make_round_cache(ps, pctx.table_slots, pctx)
    r = torch.tensor([5, 5], dtype=torch.int32)
    d = (ps.replica_broker[r.long()] + 1) % ps.num_brokers
    with pytest.raises(AssertionError, match="twice"):
        C.update_cache_for_moves(ps, pcache, r, d,
                                 torch.ones(2, dtype=torch.bool))


def _edge_batch(js, case, s):
    """The commit batches at K3's edges on the 16-broker cluster, n = 32
    (0 for "empty"): every move dropped, every move into one broker, one
    broker the source and the destination of many moves, a row pushed past
    the table's width S, and valid moves whose replica is already on the
    destination (no-ops, which the commit drops)."""
    rb = np.asarray(js.replica_broker)
    rng = np.random.default_rng(11)
    n = 32
    reps = rng.choice(js.num_replicas, size=n, replace=False).astype(np.int32)
    dests = ((rb[reps] + 1 + rng.integers(0, 15, size=n)) % 16).astype(
        np.int32)
    valid = np.ones(n, dtype=bool)
    if case == "empty":
        return reps[:0], dests[:0], valid[:0]
    if case == "all invalid":
        valid[:] = False
    elif case == "one destination":
        reps = rng.choice(np.nonzero(rb != 3)[0], size=n,
                          replace=False).astype(np.int32)
        dests[:] = 3
    elif case == "source and destination":
        out = rng.choice(np.nonzero(rb == 5)[0], size=n // 2, replace=False)
        into = rng.choice(np.nonzero(rb != 5)[0], size=n // 2, replace=False)
        reps = np.stack([out, into], 1).reshape(-1).astype(np.int32)
        dests = np.where(rb[reps] == 5, (reps % 15 + 6) % 16, 5).astype(
            np.int32)
    elif case == "overflow":
        counts = np.bincount(rb, minlength=16)
        full = int(np.argmax(counts))
        reps = rng.choice(np.nonzero(rb != full)[0], size=n,
                          replace=False).astype(np.int32)
        dests[:] = full
        assert counts[full] + n > s
    elif case == "no-ops":
        dests[::3] = rb[reps[::3]]
    return reps, dests, valid


EDGE_CASES = ["empty", "all invalid", "one destination",
              "source and destination", "overflow", "no-ops"]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_update_cache_for_moves_edge_batches(setup, case):
    """K3's edge batches (its plain version on the CPU) against the
    reference, committed into the cache's own planes."""
    js, ps, jctx, pctx = setup
    narrow = case == "overflow"
    s = (int(np.bincount(np.asarray(js.replica_broker)).max()) + 6
         if narrow else pctx.table_slots)
    reps, dests, valid = _edge_batch(js, case, s)
    jcache = JC.make_round_cache(js, s, jctx)
    pcache = C.make_round_cache(ps, s, pctx)
    planes = {f: getattr(pcache, f) for f in C.CACHE_FIELDS}
    jnew, pnew = _run_both(js, ps, jctx, pctx, jcache, pcache, reps, dests,
                           valid)
    _assert_cache_equal(jnew, pnew, case)
    # the commit wrote into the given cache's planes (a re-pack, which the
    # overflow triggers, then rebuilds the table planes)
    kept = (C.CACHE_FIELDS if not narrow else
            [f for f in C.CACHE_FIELDS if not f.startswith("table_")
             and f != "broker_table"])
    for f in kept:
        assert getattr(pnew, f) is planes[f], f


@pytest.mark.parametrize("slots", [0, None])
def test_commit_moves_donate_writes_the_cache_planes(setup, slots):
    """K3's dispatch commits in place: the returned planes are the given
    cache's own tensors and equal the plain version's result on an
    untouched copy of the cache."""
    js, ps, _, pctx = setup
    s = pctx.table_slots if slots is None else slots
    reps, dests, valid = _edge_batch(js, "source and destination", s)
    r, d, v = (torch.from_numpy(reps), torch.from_numpy(dests),
               torch.from_numpy(valid))
    cache = C.make_round_cache(ps, s, pctx)
    counted = v & (ps.replica_broker[r.long()] != d)
    rank = C.arrival_rank(d, counted, ps.num_brokers) if s else None
    want = C.commit_moves_plain(ps, cache, r, d, counted, rank)
    assert all(want[f] is not getattr(cache, f) for f in want)
    got = C.commit_moves(ps, cache, r, d, v)
    assert set(got) == set(want)
    for f in want:
        assert got[f] is getattr(cache, f), f
        assert torch.equal(got[f], want[f]), f
