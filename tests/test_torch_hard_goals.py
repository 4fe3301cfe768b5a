"""The six hard goals of the PyTorch port against the JAX reference, on
the CPU: `RackAwareGoal`, `ReplicaCapacityGoal` and the four resource
`CapacityGoal`s (Disk, NwIn, NwOut, Cpu; the last two run the leadership
sweep and leadership rounds before their move rounds).

Each goal alone from the same start state, under a constraint that gives
it work; the six together on a cluster with dead brokers (self-healing
first); each goal's acceptance, headroom terms, violated brokers and
no-work predicate on one state; rack awareness's satisfiability check;
and the port's goal registry.  Integers, booleans, placements, proposals,
rounds and violated counts must match exactly; the per-goal statistics
within 1e-6 relative (about 8 float32 ulps: inside the reference's fused
goal programs XLA may order a small reduction differently, as in
tests/test_torch_slice.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import context as JC
from cruise_control_tpu.analyzer.goals import registry as JR
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.testing import fixtures as jfix
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu.testing.verifier import verify_result as j_verify
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer.goals import registry as R
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.model.state import STATE_FIELDS
from cruise_control_tpu_torch.testing import checks
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)

SPEC = dict(num_brokers=16, num_partitions=400, replication_factor=3,
            num_racks=4, num_topics=8, seed=0, skew_fraction=0.3)
DEAD = dict(SPEC, dead_brokers=2)
#: a constraint under which each goal alone has work
WORK = {
    "RackAwareGoal": {},
    "ReplicaCapacityGoal": dict(max_replicas_per_broker=80),
    "DiskCapacityGoal": dict(capacity_threshold=(0.8, 0.8, 0.8, 0.6)),
    "NetworkInboundCapacityGoal": dict(
        capacity_threshold=(0.8, 0.6, 0.8, 0.8)),
    "NetworkOutboundCapacityGoal": dict(
        capacity_threshold=(0.8, 0.8, 0.6, 0.8)),
    "CpuCapacityGoal": dict(capacity_threshold=(0.6, 0.8, 0.8, 0.8)),
}


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    assert np.array_equal(a, b), what


def _proposals(result):
    return {(str(p.partition), tuple(r.broker_id for r in p.old_replicas),
             tuple(r.broker_id for r in p.new_replicas), p.new_leader)
            for p in result.proposals}


def _solve_both(spec, names, constraint=None, max_rounds=32):
    constraint = constraint or {}
    js, jt = j_random_cluster(JSpec(**spec))
    jres = JOptimizer(JR.default_goals(max_rounds=max_rounds, names=names),
                      JC.BalancingConstraint(**constraint)
                      ).optimizations(js, jt)
    jres._topology = jt
    ps, pt = random_cluster(RandomClusterSpec(**spec), device="cpu")
    pres = GoalOptimizer(R.default_goals(max_rounds=max_rounds, names=names),
                         C.BalancingConstraint(**constraint)
                         ).optimizations(ps, pt, device="cpu")
    return js, jres, ps, pt, pres


def _assert_same_solve(jres, pres):
    for f in ("replica_broker", "replica_is_leader", "replica_disk",
              "replica_offline"):
        _eq(getattr(jres.final_state, f), getattr(pres.final_state, f), f)
    assert _proposals(jres) == _proposals(pres)
    assert jres.violated_broker_counts == pres.violated_broker_counts
    assert jres.entry_broker_counts == pres.entry_broker_counts
    assert jres.rounds_by_goal == pres.rounds_by_goal
    assert jres.converged_at_by_goal == pres.converged_at_by_goal
    assert jres.violated_goals_after == pres.violated_goals_after
    assert jres.num_leadership_movements == pres.num_leadership_movements
    assert jres.balancedness_score() == pres.balancedness_score()
    for g, stats in pres.stats_by_goal.items():
        for f, v in vars(stats).items():
            a = np.asarray(getattr(jres.stats_by_goal[g], f))
            if v.dtype.is_floating_point:
                np.testing.assert_allclose(v.numpy(), a, rtol=1e-6,
                                           err_msg=f"{g} {f}")
            else:
                assert np.array_equal(a, v.numpy()), (g, f)


@pytest.mark.parametrize("name", list(WORK))
def test_hard_goal_alone_matches(name):
    js, jres, ps, pt, pres = _solve_both(SPEC, [name], WORK[name])
    _assert_same_solve(jres, pres)
    before, own, after = pres.violated_broker_counts[name]
    assert before > 0 and own == 0 and after == 0
    assert pres.rounds_by_goal[name] > 0
    if name in ("NetworkOutboundCapacityGoal", "CpuCapacityGoal"):
        assert pres.num_leadership_movements > 0
    j_verify(js, jres)
    checks.verify_result(ps, pres, pt)


def test_six_hard_goals_on_dead_brokers_match():
    """The default hard goals after self-healing two dead brokers."""
    js, jres, ps, pt, pres = _solve_both(DEAD, R.DEFAULT_HARD_GOALS)
    _assert_same_solve(jres, pres)
    assert pres.heal_moves > 0
    assert pres.rounds_by_goal["RackAwareGoal"] > 0
    assert not pres.violated_goals_after
    j_verify(js, jres)
    checks.verify_result(ps, pres, pt)
    ctx = C.make_context(ps, C.BalancingConstraint(),
                         C.OptimizationOptions(), pt)
    assert checks.cache_mismatches(pres.final_state, ctx,
                                   pres.final_cache) == []


def _goal_pair(name):
    return JR.make_goal(name), R.make_goal(name)


@pytest.fixture(scope="module")
def predicate_setup():
    spec = dict(SPEC, skew_fraction=0.5)
    js, jt = j_random_cluster(JSpec(**spec))
    ps, pt = random_cluster(RandomClusterSpec(**spec), device="cpu")
    tight = JC.BalancingConstraint(capacity_threshold=(0.6, 0.6, 0.6, 0.6),
                                   max_replicas_per_broker=78)
    jctx = JC.make_context(js, tight, JC.OptimizationOptions(), jt)
    pctx = C.make_context(ps, C.BalancingConstraint(
        capacity_threshold=(0.6, 0.6, 0.6, 0.6), max_replicas_per_broker=78),
        C.OptimizationOptions(), pt)
    jcache = JC.make_round_cache(js, jctx.table_slots, jctx)
    pcache = C.make_round_cache(ps, pctx.table_slots, pctx)
    rng = np.random.default_rng(1)
    r = rng.integers(0, ps.num_replicas, size=(64, 1))
    d = rng.integers(0, ps.num_brokers, size=(1, 16))
    return js, ps, jctx, pctx, jcache, pcache, r, d


@pytest.mark.parametrize("name", list(WORK))
def test_hard_goal_predicates_match(predicate_setup, name):
    js, ps, jctx, pctx, jcache, pcache, r, d = predicate_setup
    jg, pg = _goal_pair(name)
    jr_, pr_ = jnp.asarray(r), torch.from_numpy(r)
    jd_, pd_ = jnp.asarray(d), torch.from_numpy(d)
    _eq(jg.accept_move(js, jctx, jcache, jr_, jd_),
        pg.accept_move(ps, pctx, pcache, pr_, pd_), "accept_move")
    other = np.roll(r, 5, axis=0)
    _eq(jg.accept_swap(js, jctx, jcache, jr_, jnp.asarray(other)),
        pg.accept_swap(ps, pctx, pcache, pr_, torch.from_numpy(other)),
        "accept_swap")
    _eq(jg.accept_leadership(js, jctx, jcache, jr_, jnp.asarray(other)),
        pg.accept_leadership(ps, pctx, pcache, pr_, torch.from_numpy(other)),
        "accept_leadership")
    violated = pg.violated_brokers(ps, pctx, pcache)
    _eq(jg.violated_brokers(js, jctx, jcache), violated, "violated")
    assert bool(violated.any())
    _eq(jg.no_work(js, jctx, jcache), pg.no_work(ps, pctx, pcache),
        "no_work")
    for jterms, pterms in (
            (jg.move_headroom_terms(js, jctx, jcache),
             pg.move_headroom_terms(ps, pctx, pcache)),
            (jg.leadership_headroom_terms(js, jctx, jcache),
             pg.leadership_headroom_terms(ps, pctx, pcache))):
        assert len(jterms) == len(pterms)
        for jt_, pt_ in zip(jterms, pterms):
            assert jt_[0] == pt_[0]
            for a, b in zip(jt_[1:], pt_[1:]):
                assert (a is None) == (b is None)
                if a is not None:
                    _eq(a, b, f"{name} terms")


def _port_state(js):
    return convert.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS},
        num_racks=js.num_racks, num_hosts=js.num_hosts,
        num_topics=js.num_topics, device="cpu")


@pytest.mark.parametrize("fixture", ["rack_aware_satisfiable",
                                     "rack_aware_unsatisfiable",
                                     "dead_broker_cluster"])
def test_rack_aware_satisfiability_matches(fixture):
    js, _ = getattr(jfix, fixture)()
    want = JR.make_goal("RackAwareGoal").is_satisfiable(js)
    assert R.make_goal("RackAwareGoal").is_satisfiable(
        _port_state(js)) == want
    if fixture == "rack_aware_unsatisfiable":
        assert not want


def test_registry_mirrors_the_reference():
    assert R.DEFAULT_GOAL_ORDER == JR.DEFAULT_GOAL_ORDER
    assert R.DEFAULT_HARD_GOALS == JR.DEFAULT_HARD_GOALS
    goals = R.default_goals(max_rounds=16, names=R.DEFAULT_HARD_GOALS)
    assert [g.name for g in goals] == R.DEFAULT_HARD_GOALS
    assert all(g.is_hard and g.max_rounds == 1024 for g in goals)
    soft = R.default_goals(max_rounds=16,
                           names=["DiskUsageDistributionGoal"])
    assert soft[0].max_rounds == 16 and not soft[0].is_hard
    for name in R.GOAL_CLASSES:
        assert R.make_goal(name).name == name
    # the whole default order is ported; the reference's other goals not
    assert set(R.DEFAULT_GOAL_ORDER) <= set(R.GOAL_CLASSES)
    for name in R.NOT_PORTED:
        assert name in JR.GOAL_CLASSES
        with pytest.raises(KeyError, match="not ported"):
            R.make_goal(name)
    with pytest.raises(KeyError, match="unknown goal"):
        R.make_goal("NoSuchGoal")
