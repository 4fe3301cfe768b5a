"""`GoalOptimizer`'s arguments beyond the goals, in the PyTorch port against
the JAX reference, on the CPU.

An 8-broker cluster under tests/test_incremental.py's `INCR_GOALS`
(RackAware, DiskCapacity, ReplicaDistribution, DiskUsageDistribution) at
the reference's default segment plan, so that one reference optimizer
compiles its programs once and every case reuses them: the eager hard
abort and the deferred check on a hard goal that cannot converge (every
topic excluded), `check_sanity=False`, the warm start (a seed from a
previous solve, and a seed that moves an excluded topic's replica, which
both packages drop), the dirty-region solve (all dirty, one dirty
broker), `data_to_move` and the balancedness score under non-default
weights, and the parameter names of `__init__`, `optimizations` and
`OptimizerResult`.  The segment plans and the host-side skip are in
tests/test_torch_segment_plans.py.

Solves must be equal (`_assert_same_solve`: placement, leaders,
proposals, per-goal counts, rounds, converged-at, balancedness, stats
within 1e-6 relative); where the reference raises, the port raises the
same exception with the same message.
"""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import context as JC
from cruise_control_tpu.analyzer import optimizer as JO
from cruise_control_tpu.analyzer.goals import registry as JR
from cruise_control_tpu.analyzer.goals.base import \
    OptimizationFailure as JFailure
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer import optimizer as O
from cruise_control_tpu_torch.analyzer.goals import registry as R
from cruise_control_tpu_torch.analyzer.goals.base import OptimizationFailure
from cruise_control_tpu_torch.testing import checks
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)
from test_torch_hard_goals import _assert_same_solve, _eq

INCR_GOALS = ["RackAwareGoal", "DiskCapacityGoal",
              "ReplicaDistributionGoal", "DiskUsageDistributionGoal"]
#: tests/test_incremental.py TestDirtyRegionSolve's cluster
INCR_SPEC = dict(num_brokers=8, num_partitions=60, replication_factor=2,
                 num_racks=2, num_topics=4, seed=7, skew_fraction=0.25)
MAX_ROUNDS = 32


@pytest.fixture(scope="module")
def j_opt():
    return JO.GoalOptimizer(JR.default_goals(MAX_ROUNDS, INCR_GOALS))


def p_opt(**kw):
    return O.GoalOptimizer(R.default_goals(MAX_ROUNDS, INCR_GOALS), **kw)


@pytest.fixture(scope="module")
def clusters():
    js, jt = j_random_cluster(JSpec(**INCR_SPEC))
    ps, pt = random_cluster(RandomClusterSpec(**INCR_SPEC), device="cpu")
    return js, jt, ps, pt


@pytest.fixture(scope="module")
def cold(j_opt, clusters):
    """The default solve in both packages: (jres, pres)."""
    js, jt, ps, pt = clusters
    jres = j_opt.optimizations(js, jt)
    jres._topology = jt
    pres = p_opt().optimizations(ps, pt, device="cpu")
    return jres, pres


def _raised(fn):
    with pytest.raises((JFailure, OptimizationFailure)) as info:
        fn()
    return type(info.value).__name__, str(info.value)


def test_cold_solve_matches(cold, clusters):
    jres, pres = cold
    _assert_same_solve(jres, pres)
    assert pres.mesh_devices == jres.mesh_devices == 1
    assert pres.skipped_goals == jres.skipped_goals == []
    assert pres.solver_provenance is jres.solver_provenance is None
    checks.verify_result(clusters[2], pres, clusters[3])


@pytest.mark.parametrize("eager", [False, True, None],
                         ids=["deferred", "eager", "constructor's"])
def test_unconverged_hard_goal_raises_the_same(eager, j_opt, clusters):
    """Every topic excluded: RackAwareGoal cannot fix the placement.
    The eager abort raises after the goal's own segment, the deferred
    check after the last goal, each with its own message; `None` takes
    the constructor's `eager_hard_abort`."""
    js, jt, ps, pt = clusters
    jo = JC.OptimizationOptions(excluded_topics=frozenset(jt.topics))
    po = C.OptimizationOptions(excluded_topics=frozenset(pt.topics))
    j_eager = JO.GoalOptimizer(JR.default_goals(MAX_ROUNDS, INCR_GOALS),
                               eager_hard_abort=True)
    want = _raised(lambda: (j_eager if eager is None else j_opt)
                   .optimizations(js, jt, jo, eager_hard_abort=eager))
    got = _raised(lambda: p_opt(eager_hard_abort=eager is None)
                  .optimizations(ps, pt, po, eager_hard_abort=eager,
                                 device="cpu"))
    assert got == want
    assert ("eager abort" in got[1]) == (eager is not False)


def test_check_sanity_off(j_opt, clusters, monkeypatch):
    """`check_sanity=False` skips the final sanity check and changes
    nothing else."""
    js, jt, ps, pt = clusters
    jres = j_opt.optimizations(js, jt, check_sanity=False)
    jres._topology = jt

    def refuse(state):
        raise AssertionError("sanity_check called")
    monkeypatch.setattr(O, "sanity_check", refuse)
    pres = p_opt().optimizations(ps, pt, check_sanity=False, device="cpu")
    _assert_same_solve(jres, pres)
    with pytest.raises(AssertionError, match="sanity_check called"):
        p_opt().optimizations(ps, pt, device="cpu")


def _raise_capacity(state, broker: int, module):
    cap = state.broker_capacity
    if module is torch:
        cap = cap.clone()
        cap[broker] = cap[broker] * 1.5
        return state.replace(broker_capacity=cap)
    return state.replace(broker_capacity=cap.at[broker].set(cap[broker]
                                                              * 1.5))


def test_warm_start_matches(j_opt, clusters, cold):
    """A capacity delta on broker 2, solved from the cold solve's final
    placement: proposals diff against the changed model, not the seed."""
    js, jt, ps, pt = clusters
    jcold, pcold = cold
    js2, ps2 = _raise_capacity(js, 2, jnp), _raise_capacity(ps, 2, torch)
    jres = j_opt.optimizations(js2, jt, warm_start=jcold.final_state)
    jres._topology = jt
    pres = p_opt().optimizations(ps2, pt, warm_start=pcold.final_state,
                                 device="cpu")
    _assert_same_solve(jres, pres)
    assert jres.violated_goals_before == pres.violated_goals_before
    # warm: the seed's placement holds, so the search starts converged
    assert sum(pres.rounds_by_goal.values()) < sum(
        pcold.rounds_by_goal.values())
    checks.verify_result(ps2, pres, pt)


def test_frozen_seed_is_dropped(j_opt, clusters, cold, caplog):
    """A request that excludes topic-1, on the cold solve's rack-aware
    final placement with broker 2's capacity raised, seeded by the
    original placement, which puts replicas of topic-1 elsewhere: both
    packages drop the seed and solve from the given placement.  (On the
    random placement an excluded topic keeps a rack violation that the
    reference's RackAwareGoal cannot fix.)"""
    js, jt, ps, pt = clusters
    jcold, pcold = cold
    jstart = _raise_capacity(jcold.final_state, 2, jnp)
    pstart = _raise_capacity(pcold.final_state, 2, torch)
    t1 = pt.topics.index("topic-1")
    topic_of_r = ps.partition_topic.numpy()[ps.replica_partition.numpy()]
    moved = (pstart.replica_broker != ps.replica_broker).numpy()
    assert moved[topic_of_r == t1].any()
    jo = JC.OptimizationOptions(excluded_topics=frozenset({"topic-1"}))
    po = C.OptimizationOptions(excluded_topics=frozenset({"topic-1"}))
    jres = j_opt.optimizations(jstart, jt, jo, warm_start=js)
    jres._topology = jt
    with caplog.at_level("INFO", logger=O.LOG.name):
        pres = p_opt().optimizations(pstart, pt, po, warm_start=ps,
                                     device="cpu")
    assert "warm-start seed ignored" in caplog.text
    _assert_same_solve(jres, pres)
    plain = p_opt().optimizations(pstart, pt, po, device="cpu")
    _eq(plain.final_state.replica_broker, pres.final_state.replica_broker)
    assert O.proposal_set(plain) == O.proposal_set(pres)


def test_all_dirty_equals_the_full_solve(j_opt, clusters, cold):
    js, jt, ps, pt = clusters
    jcold, pcold = cold
    jres = j_opt.optimizations(js, jt,
                               dirty_brokers=jnp.ones(js.num_brokers, bool))
    jres._topology = jt
    pres = p_opt().optimizations(
        ps, pt, dirty_brokers=torch.ones(ps.num_brokers, dtype=torch.bool),
        device="cpu")
    _assert_same_solve(jres, pres)
    _assert_same_solve(jcold, pres)
    _eq(pcold.final_state.replica_broker, pres.final_state.replica_broker)
    _eq(pcold.final_state.replica_is_leader,
        pres.final_state.replica_is_leader)


def test_warm_dirty_subset_matches(j_opt, clusters, cold):
    """tests/test_incremental.py's warm, dirty solve: broker 2's capacity
    raised by half, only broker 2 dirty, seeded by the cold solve."""
    js, jt, ps, pt = clusters
    jcold, pcold = cold
    js2, ps2 = _raise_capacity(js, 2, jnp), _raise_capacity(ps, 2, torch)
    jdirty = jnp.zeros(js.num_brokers, bool).at[2].set(True)
    pdirty = np.zeros(ps.num_brokers, dtype=bool)
    pdirty[2] = True
    jres = j_opt.optimizations(js2, jt, warm_start=jcold.final_state,
                               dirty_brokers=jdirty)
    jres._topology = jt
    pres = p_opt().optimizations(ps2, pt, warm_start=pcold.final_state,
                                 dirty_brokers=pdirty, device="cpu")
    _assert_same_solve(jres, pres)
    assert not set(pres.violated_goals_after) & set(INCR_GOALS[:2])
    checks.verify_result(ps2, pres, pt)


def test_data_to_move_and_weighted_balancedness(clusters):
    """`data_to_move` and `balancedness_score` under (priority,
    strictness) weights other than the default (1.1, 1.5); the cold
    solve leaves no goal violated, so both results are then made to
    report one, where the weights decide the score."""
    js, jt, ps, pt = clusters
    weights = (1.3, 2.5)
    jres = JO.GoalOptimizer(JR.default_goals(MAX_ROUNDS, INCR_GOALS),
                            balancedness_weights=weights
                            ).optimizations(js, jt)
    pres = p_opt(balancedness_weights=weights).optimizations(
        ps, pt, device="cpu")
    assert pres.balancedness_weights == jres.balancedness_weights == weights
    assert pres.data_to_move == jres.data_to_move > 0
    assert pres.balancedness_score() == jres.balancedness_score()
    # a result still violating a goal weighs it by the given weights
    for r in (jres, pres):
        r.violated_goals_after = ["ReplicaDistributionGoal"]
    assert pres.balancedness_score() == jres.balancedness_score() < 100.0
    pres.balancedness_weights = (1.1, 1.5)
    assert pres.balancedness_score() != jres.balancedness_score()


def test_parameter_names_match_the_reference():
    """Every parameter of the reference's `__init__` and `optimizations`
    is one of the port's, and `OptimizerResult` has every field of the
    reference's; the port's `optimizations` adds only `device`."""
    for name in ("__init__", "optimizations"):
        ref = list(inspect.signature(getattr(JO.GoalOptimizer,
                                             name)).parameters)
        port = list(inspect.signature(getattr(O.GoalOptimizer,
                                              name)).parameters)
        assert port[:len(ref)] == ref, name
        assert port[len(ref):] == ([] if name == "__init__" else ["device"])
    ref_fields = {f.name for f in dataclasses.fields(JO.OptimizerResult)}
    port_fields = {f.name for f in dataclasses.fields(O.OptimizerResult)}
    assert ref_fields <= port_fields
    for name in ("data_to_move", "num_replica_movements",
                 "num_leadership_movements"):
        assert isinstance(getattr(O.OptimizerResult, name), property)


def test_mesh_other_than_none_raises(clusters):
    _, _, ps, pt = clusters
    with pytest.raises(NotImplementedError, match="mesh"):
        p_opt().optimizations(ps, pt, mesh=object(), device="cpu")
