"""K9-K11's plain versions in the PyTorch port against the JAX reference,
on the CPU.

* K9 `per_segment_argmax`: random and planted edge cases (ties, -0.0
  against +0.0, empty and all-invalid segments, scores at or below NEG/2,
  negative and out-of-range segment ids).
* K10, the swap round's pair plane: `swap_round` on quantized loads that
  plant tied improvements, with and without the lower / upper band, and
  with an acceptance plane that refuses everything.
* K9's keep entry, `resolve_dest_conflicts_plain`, against the
  reference's `resolve_dest_conflicts` with the same cases and with many
  segments (the partition-keyed resolves).
* K11 `_dest_feasibility` (with a destination shortlist and with every
  broker), the preference plane (`assign_pref` through
  `dest_pref_plain`) against the reference's `_dest_feasibility` plus
  the fit test, the candidates' flags and the `where` of the move round,
  with acceptance planes that broadcast ([C, K], [C, 1], [1, K], 0-d),
  and `cand_has_dest` and `feasible_dest_exists` (their guard selects
  the top brokers itself).

Integers and booleans must match exactly, and `max` with `==` (so -0.0
equals +0.0, as the reference's `>=` ties them).  No float tolerance is
used.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import kernels as JK
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer import kernels as K
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)

SPEC = dict(num_brokers=16, num_partitions=400, replication_factor=3,
            num_racks=4, num_topics=8, seed=0, skew_fraction=0.3)
NEG = K.NEG


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    assert np.array_equal(a, b), what


def _argmax_inputs(case: str, n: int, s: int, seed: int):
    """(score f32[n], segment i32[n], valid bool[n]) for one K9 case."""
    rng = np.random.default_rng(seed)
    score = (np.round(rng.random(n) * 6.0) / 2.0 - 1.0).astype(np.float32)
    seg = rng.integers(0, s, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    if case == "signed zeros":
        score = np.where(rng.random(n) < 0.5, np.float32(0.0),
                         np.float32(-0.0)).astype(np.float32)
    elif case == "low scores":
        score = np.where(rng.random(n) < 0.5, np.float32(NEG),
                         score).astype(np.float32)
        edge = np.array([-np.inf, NEG / 2, NEG / 4, -1e31], np.float32)
        score[:4] = edge[:min(n, 4)]
    elif case == "out of range":
        seg = rng.integers(-3, s + 3, n).astype(np.int32)
    elif case == "empty and invalid":
        # segment 0 has only invalid members; the top half none at all
        seg = rng.integers(0, max(1, s // 2), n).astype(np.int32)
        valid = valid & (seg != 0)
    return score, seg, valid


@pytest.mark.parametrize("case", ["ties", "signed zeros", "low scores",
                                  "out of range", "empty and invalid"])
@pytest.mark.parametrize("n,s", [(1, 1), (300, 7), (2048, 400)])
def test_per_segment_argmax_matches(case, n, s):
    score, seg, valid = _argmax_inputs(case, n, s, seed=n + s)
    j_arg, j_max, j_has = JK.per_segment_argmax(
        jnp.asarray(score), jnp.asarray(seg), s, jnp.asarray(valid))
    arg, mx, has = K.per_segment_argmax(
        torch.from_numpy(score), torch.from_numpy(seg), s,
        torch.from_numpy(valid))
    _eq(j_arg, arg, "arg")
    _eq(j_has, has, "has")
    # == on the floats: -0.0 and +0.0 compare equal
    assert np.array_equal(np.asarray(j_max), mx.numpy())
    assert arg.dtype == torch.int32 and has.dtype == torch.bool


@pytest.fixture(scope="module")
def cluster():
    js, _ = j_random_cluster(JSpec(**SPEC))
    ps, _ = random_cluster(RandomClusterSpec(**SPEC), device="cpu")
    pr = C.partition_replica_index(ps)
    return js, ps, pr


@pytest.mark.parametrize("case", ["ties", "signed zeros", "low scores",
                                  "empty and invalid"])
@pytest.mark.parametrize("n,s", [(300, 7), (300, 2000)])
def test_resolve_dest_conflicts_plain_matches(case, n, s):
    """K9's keep entry's plain version: at most one winner a destination
    (ties to the lowest index, -0.0 tying +0.0, nothing kept at or below
    NEG/2), with few and with many segments."""
    score, seg, valid = _argmax_inputs(case, n, s, seed=3 * n + s)
    want = JK.resolve_dest_conflicts(jnp.asarray(seg), jnp.asarray(score),
                                     jnp.asarray(valid), s)
    t = torch.from_numpy
    got = K.resolve_dest_conflicts_plain(t(seg), t(score), t(valid), s)
    _eq(want, got, case)
    _eq(want, K.resolve_dest_conflicts(t(seg), t(score), t(valid), s), case)
    assert not bool(got.all())


def _swap_args(ps, case: str):
    """Swap-round inputs with quantized loads and deviations: many pairs
    tie on their improvement."""
    rng = np.random.default_rng(len(case))
    num_b, num_r = ps.num_brokers, ps.num_replicas
    w = (np.round(rng.random(num_r) * 4.0) + 1.0).astype(np.float32)
    util = np.round(rng.random(num_b) * 8.0).astype(np.float32) * 10.0
    target = np.full(num_b, 40.0, np.float32)
    hot = util > target
    cold = util < target
    movable = rng.random(num_r) < 0.9
    lower = (target - 25.0).astype(np.float32)
    upper = (target + 25.0).astype(np.float32)
    return w, util, target, hot, cold, movable, lower, upper


@pytest.mark.parametrize("case", ["ties", "band", "refuse all"])
def test_swap_round_pair_plane_matches(cluster, case):
    js, ps, pr = cluster
    w, util, target, hot, cold, movable, lower, upper = _swap_args(ps, case)
    band = case == "band"

    def j_accept(r, d):
        if case == "refuse all":
            return jnp.zeros(jnp.broadcast_shapes(r.shape, d.shape), bool)
        return (r + d) % 5 != 0

    def p_accept(r, d):
        if case == "refuse all":
            return torch.zeros(torch.broadcast_shapes(r.shape, d.shape),
                               dtype=torch.bool)
        return (r + d) % 5 != 0

    j_out = JK.swap_round(js, jnp.asarray(w), jnp.asarray(movable),
                          jnp.asarray(hot), jnp.asarray(cold),
                          jnp.asarray(util), jnp.asarray(target), j_accept,
                          jnp.asarray(pr),
                          lower=jnp.asarray(lower) if band else None,
                          upper=jnp.asarray(upper) if band else None)
    t = torch.from_numpy
    p_out = K.swap_round(ps, t(w), t(movable), t(hot), t(cold), t(util),
                         t(target), p_accept, t(pr),
                         lower=t(lower) if band else None,
                         upper=t(upper) if band else None)
    for a, b, what in zip(j_out, p_out, ("out_r", "in_r", "cold", "valid")):
        _eq(a, b, what)
    n_valid = int(p_out[3].sum())
    if case == "refuse all":
        assert n_valid == 0
    else:
        assert n_valid > 0


def test_swap_pair_plain_ties_take_the_first_column():
    """Every pair of a row ties: the first cold column wins (and takes the
    cold broker from the rows after it), and a row with nothing feasible
    returns column 0, not valid."""
    num_b = 6
    h_ids = torch.tensor([0, 1])
    c_ids = torch.tensor([2, 3, 4, 5])
    out_r = torch.tensor([0, 1, -1, -1, -1, -1], dtype=torch.int32)
    in_r = torch.tensor([-1, -1, 2, 3, 4, 5], dtype=torch.int32)
    has = torch.tensor([True] * num_b)
    hot = torch.tensor([True, True, False, False, False, False])
    w = torch.tensor([5.0, 5.0, 1.0, 1.0, 1.0, 1.0])
    dev_u = torch.tensor([4.0, 4.0, -4.0, -4.0, -4.0, -4.0])
    accept = torch.tensor([[True] * 4, [False] * 4])
    rp = torch.arange(num_b, dtype=torch.int32)
    pr = torch.full((num_b, 3), -1, dtype=torch.int32)
    pr[:, 0] = torch.arange(num_b, dtype=torch.int32)
    args = (h_ids, c_ids, out_r, in_r, has, has, hot, ~hot, w, dev_u, dev_u,
            None, None, accept, rp, pr, torch.arange(num_b,
                                                     dtype=torch.int32))
    sel, slot = K.swap_plane_plain(*args)
    assert slot.tolist() == [0, 0]
    assert sel[0] == 32.0 and sel[1] == NEG
    cold, valid = K.swap_pair(*args)
    assert cold.tolist() == [2, 2, 0, 0, 0, 0]
    assert valid.tolist() == [True, False, False, False, False, False]


@pytest.mark.parametrize("dests", ["shortlist", "every broker"])
def test_dest_feasibility_matches(cluster, dests):
    js, ps, pr = cluster
    rng = np.random.default_rng(4)
    cand = rng.choice(ps.num_replicas, 300, replace=False).astype(np.int32)
    dest_ok = rng.random(ps.num_brokers) < 0.8
    dest_ids = (rng.choice(ps.num_brokers, 7, replace=False).astype(np.int32)
                if dests == "shortlist" else None)

    def j_accept(r, d):
        return (r * 3 + d) % 7 != 0

    def p_accept(r, d):
        return (r * 3 + d) % 7 != 0

    for rows in (pr, None):
        want = JK._dest_feasibility(
            js, jnp.asarray(cand), jnp.asarray(dest_ok), j_accept,
            None if rows is None else jnp.asarray(rows),
            None if dest_ids is None else jnp.asarray(dest_ids))
        got = K._dest_feasibility(
            ps, torch.from_numpy(cand), torch.from_numpy(dest_ok), p_accept,
            None if rows is None else torch.from_numpy(rows),
            None if dest_ids is None else torch.from_numpy(dest_ids))
        _eq(want, got, f"feasibility rows={rows is not None}")
        assert got.any() and not got.all()


@pytest.mark.parametrize("fit", [True, False], ids=["fit", "no fit"])
@pytest.mark.parametrize("accept", ["[C, K]", "[C, 1]", "[1, K]", "0-d"])
def test_assign_pref_matches(cluster, accept, fit):
    """The preference plane of an assignment (assign_pref, the plain
    version of K11's preference entry on the CPU) against the reference's
    move-round lines: `fits & cand_has & _dest_feasibility(...)`, then
    `where(feasible, dest_pref[dest_ids], NEG)`; weights on the headroom
    exactly, -0.0 and NEG preferences."""
    js, ps, pr = cluster
    rng = np.random.default_rng(6)
    num_b, num_r = ps.num_brokers, ps.num_replicas
    cand = rng.choice(num_r, 300, replace=False).astype(np.int64)
    dest_ids = rng.choice(num_b, 9, replace=False).astype(np.int64)
    dest_ok = rng.random(num_b) < 0.8
    w_c = np.round(rng.random(300) * 4.0).astype(np.float32)
    room = np.round(rng.random(num_b) * 4.0).astype(np.float32)
    pref_b = (np.round(rng.random(num_b) * 8.0) - 4.0).astype(np.float32)
    pref_b[:2] = [-0.0, NEG]
    ch = rng.random(300) < 0.9

    def acc(xp):
        def fn(r, d):
            return {"[C, K]": (r * 3 + d) % 7 != 0, "[C, 1]": r % 5 != 0,
                    "[1, K]": d % 4 != 1,
                    "0-d": xp.ones((), dtype=bool)}[accept]
        return fn
    feasible = JK._dest_feasibility(js, jnp.asarray(cand),
                                    jnp.asarray(dest_ok), acc(jnp),
                                    jnp.asarray(pr), jnp.asarray(dest_ids))
    if fit:
        fits = (jnp.asarray(w_c)[:, None]
                <= jnp.asarray(room)[jnp.asarray(dest_ids)][None, :])
        feasible = fits & jnp.asarray(ch)[:, None] & feasible
    want = jnp.where(feasible, jnp.asarray(pref_b)[dest_ids][None, :],
                     NEG)
    t = torch.from_numpy
    kw = dict(cand_has=t(ch), w_c=t(w_c), dest_headroom=t(room)) if fit \
        else {}
    got = K.assign_pref(ps, t(cand), t(dest_ids), t(dest_ok), t(pref_b),
                        acc(torch), t(pr), **kw)
    _eq(np.asarray(want).view(np.uint32), got.numpy().view(np.uint32),
        accept)
    assert (got.numpy() > NEG / 2).any() and (got.numpy() == NEG).any()


@pytest.mark.parametrize("room", ["finite", "few eligible", "ties"])
def test_cand_has_dest_and_feasible_dest_exists_match(cluster, room):
    """The guard, whose plain version selects the top RF + 2 brokers
    itself: ties among the headrooms (-0.0 against +0.0 too) go to the
    lower broker id, as the reference's top_k orders them."""
    js, ps, pr = cluster
    rng = np.random.default_rng(5)
    num_b, num_r = ps.num_brokers, ps.num_replicas
    w = np.asarray(js.replica_base_load)[:, 3].astype(np.float32)
    # the best headroom near the median weight: many replicas fit nowhere
    headroom = (rng.random(num_b) * np.median(w)).astype(np.float32)
    if room == "ties":
        headroom = (np.round(rng.random(num_b) * 3.0) * np.median(w)
                    / 3.0).astype(np.float32)
        headroom[headroom == 0.0] = -0.0
    # fewer eligible brokers than RF + 2: -inf enters the top list
    dest_ok = (rng.random(num_b) < 0.8 if room != "few eligible"
               else np.arange(num_b) < 3)
    cand = rng.choice(num_r, 500, replace=False).astype(np.int32)
    t = torch.from_numpy
    want = JK.cand_has_dest(js, jnp.asarray(cand), jnp.asarray(w[cand]),
                            jnp.asarray(dest_ok), jnp.asarray(headroom),
                            jnp.asarray(pr))
    got = K.cand_has_dest(ps, t(cand), t(w[cand]), t(dest_ok), t(headroom),
                          t(pr))
    _eq(want, got, "cand_has_dest")
    want_r = JK.feasible_dest_exists(js, jnp.asarray(w), jnp.asarray(dest_ok),
                                     jnp.asarray(headroom), jnp.asarray(pr))
    got_r = K.feasible_dest_exists(ps, t(w), t(dest_ok), t(headroom), t(pr))
    _eq(want_r, got_r, "feasible_dest_exists")
    assert got_r.any() and not got_r.all()
