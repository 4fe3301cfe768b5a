"""The count goals of the PyTorch port against the JAX reference, on the
CPU: `ReplicaDistributionGoal`, `TopicReplicaDistributionGoal` and
`LeaderReplicaDistributionGoal` (cruise_control_tpu_torch/analyzer/goals/
count_distribution.py).

Each goal alone from the same start state (16 brokers, 400 partitions),
then behind a prefix of prior goals whose acceptance and headroom terms
compose with it (the goal must run rounds there too), then its
function-level methods on random inputs.  Placements, leader flags,
proposals, per-goal violated counts, rounds and balancedness must be
equal; per-goal statistics within 1e-6 relative (as in
tests/test_torch_hard_goals.py).  The pre-balance runs its count
dimension whenever `ReplicaDistributionGoal` is in the list.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import context as JC
from cruise_control_tpu.analyzer.goals import registry as JR
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu.testing.verifier import verify_result as j_verify
from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer.goals import registry as R
from cruise_control_tpu_torch.testing import checks
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)
from test_torch_hard_goals import _assert_same_solve, _eq, _solve_both

SPEC = dict(num_brokers=16, num_partitions=400, replication_factor=3,
            num_racks=4, num_topics=8, seed=0, skew_fraction=0.3)
#: many small topics, strongly skewed: per-topic counts to balance
TOPICS = dict(SPEC, num_topics=40, skew_fraction=0.5)
#: a potential-NW_OUT limit that binds
TIGHT_NW_OUT = dict(capacity_threshold=(0.8, 0.8, 0.55, 0.8))

#: goal -> (prior goals, spec, constraint)
BEHIND = {
    "ReplicaDistributionGoal": (["RackAwareGoal", "DiskCapacityGoal"],
                                SPEC, {}),
    "TopicReplicaDistributionGoal": (["RackAwareGoal", "PotentialNwOutGoal"],
                                     TOPICS, TIGHT_NW_OUT),
    "LeaderReplicaDistributionGoal": (["ReplicaDistributionGoal",
                                       "CpuUsageDistributionGoal"], SPEC, {}),
}


def _check_solve(js, jres, ps, pt, pres, name):
    _assert_same_solve(jres, pres)
    assert pres.rounds_by_goal[name] > 0
    j_verify(js, jres)
    checks.verify_result(ps, pres, pt)
    ctx = C.make_context(ps, C.BalancingConstraint(),
                         C.OptimizationOptions(), pt)
    assert checks.cache_mismatches(pres.final_state, ctx,
                                   pres.final_cache) == []


@pytest.mark.parametrize("name", list(BEHIND))
def test_count_goal_alone_matches(name):
    js, jres, ps, pt, pres = _solve_both(SPEC, [name])
    _check_solve(js, jres, ps, pt, pres, name)
    before, own, _ = pres.violated_broker_counts[name]
    assert before > 0 and own <= before
    if name == "LeaderReplicaDistributionGoal":
        assert pres.num_leadership_movements > 0
    if name == "ReplicaDistributionGoal":
        # the pre-balance's count dimension ran
        assert pres.rounds_by_goal["__prebalance__"] > 0


@pytest.mark.parametrize("name", list(BEHIND))
def test_count_goal_behind_prior_goals_matches(name):
    prior, spec, constraint = BEHIND[name]
    js, jres, ps, pt, pres = _solve_both(spec, prior + [name], constraint)
    _check_solve(js, jres, ps, pt, pres, name)


@pytest.fixture(scope="module")
def predicate_setup():
    spec = dict(SPEC, skew_fraction=0.5)
    js, jt = j_random_cluster(JSpec(**spec))
    ps, pt = random_cluster(RandomClusterSpec(**spec), device="cpu")
    jctx = JC.make_context(js, JC.BalancingConstraint(),
                           JC.OptimizationOptions(), jt)
    pctx = C.make_context(ps, C.BalancingConstraint(),
                          C.OptimizationOptions(), pt)
    jcache = JC.make_round_cache(js, jctx.table_slots, jctx)
    pcache = C.make_round_cache(ps, pctx.table_slots, pctx)
    rng = np.random.default_rng(2)
    r = rng.integers(0, ps.num_replicas, size=(64, 1))
    d = rng.integers(0, ps.num_brokers, size=(1, 16))
    return js, ps, jctx, pctx, jcache, pcache, r, d


def assert_predicates_match(setup, name):
    """accept_move / accept_swap / accept_leadership on random pairs,
    violated brokers, the no-work predicate and both kinds of headroom
    terms, exactly."""
    js, ps, jctx, pctx, jcache, pcache, r, d = setup
    jg, pg = JR.make_goal(name), R.make_goal(name)
    jr_, pr_ = jnp.asarray(r), torch.from_numpy(r)
    other = np.roll(r, 5, axis=0)
    jo, po = jnp.asarray(other), torch.from_numpy(other)
    _eq(jg.accept_move(js, jctx, jcache, jr_, jnp.asarray(d)),
        pg.accept_move(ps, pctx, pcache, pr_, torch.from_numpy(d)),
        "accept_move")
    _eq(jg.accept_swap(js, jctx, jcache, jr_, jo),
        pg.accept_swap(ps, pctx, pcache, pr_, po), "accept_swap")
    _eq(jg.accept_leadership(js, jctx, jcache, jr_, jo),
        pg.accept_leadership(ps, pctx, pcache, pr_, po), "accept_leadership")
    violated = pg.violated_brokers(ps, pctx, pcache)
    _eq(jg.violated_brokers(js, jctx, jcache), violated, "violated")
    jn, pn = jg.no_work(js, jctx, jcache), pg.no_work(ps, pctx, pcache)
    assert (jn is None) == (pn is None)
    if pn is not None:
        _eq(jn, pn, "no_work")
    for jterms, pterms in (
            (jg.move_headroom_terms(js, jctx, jcache),
             pg.move_headroom_terms(ps, pctx, pcache)),
            (jg.leadership_headroom_terms(js, jctx, jcache),
             pg.leadership_headroom_terms(ps, pctx, pcache))):
        assert (jterms is None) == (pterms is None)
        if pterms is None:
            continue
        assert len(jterms) == len(pterms)
        for jt_, pt_ in zip(jterms, pterms):
            assert jt_[0] == pt_[0]
            for a, b in zip(jt_[1:], pt_[1:]):
                assert (a is None) == (b is None)
                if a is not None:
                    _eq(a, b, f"{name} terms")
    return violated


@pytest.mark.parametrize("name", list(BEHIND))
def test_count_goal_predicates_match(predicate_setup, name):
    violated = assert_predicates_match(predicate_setup, name)
    if name != "TopicReplicaDistributionGoal":
        assert bool(violated.any())


def test_stats_comparators_match():
    """stats_not_worse of each count goal on the same before/after
    statistics, including the topic goal's +0.3 slack."""
    from cruise_control_tpu.model.stats import compute_stats as j_stats
    from cruise_control_tpu_torch.model.stats import compute_stats
    js0, _ = j_random_cluster(JSpec(**SPEC))
    js1, _ = j_random_cluster(JSpec(**dict(SPEC, skew_fraction=0.6)))
    ps0, _ = random_cluster(RandomClusterSpec(**SPEC), device="cpu")
    ps1, _ = random_cluster(RandomClusterSpec(**dict(SPEC,
                                                     skew_fraction=0.6)),
                            device="cpu")
    for name in BEHIND:
        jg, pg = JR.make_goal(name), R.make_goal(name)
        for (ja, jb), (pa, pb) in (((js0, js1), (ps0, ps1)),
                                   ((js1, js0), (ps1, ps0))):
            want = bool(jg.stats_not_worse(j_stats(ja), j_stats(jb)))
            assert bool(pg.stats_not_worse(compute_stats(pa),
                                           compute_stats(pb))) == want, name
