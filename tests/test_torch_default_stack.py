"""The whole default goal stack of the PyTorch port against the JAX
reference, on the CPU.

`GoalOptimizer(default_goals(max_rounds=32)).optimizations(state,
topology)`: the 15 goals of `DEFAULT_GOAL_ORDER` (six hard goals, then
the replica-count, potential-NW_OUT, four usage, topic, leader-count and
leader-bytes-in goals) with default options, on two seeded 16-broker
clusters of one shape, so that the reference compiles its goal programs
once (about three minutes on a CPU) and both solves share them.
Placement, leader flags, proposals, per-goal violated counts (before, at
entry, after its own run, after all), rounds, converged-at rounds and
balancedness must be EQUAL; per-goal statistics within 1e-6 relative (as
in tests/test_torch_slice.py).  Both results pass the verifiers and the
port's final cache equals a rebuild.

The add-broker solve (BENCH config 4's first half) runs here too: two
empty brokers appended to 14 (`new_brokers=2`), the same array shapes, so
the reference reuses its compiled programs.  While new brokers exist the
distribution goals move onto them only (`new_broker_dest_mask`); the
solve must equal the reference's and fill the new brokers.

The joint pre-balance alone with its replica-count dimension on
(`balance_counts=True`, which `ReplicaDistributionGoal` in a goal list
turns on) is held against the reference's too, with the count band the
only dimension it sheds and with every dimension.
"""
import jax
import numpy as np
import pytest

from cruise_control_tpu.analyzer import context as JC
from cruise_control_tpu.analyzer import prebalance as JP
from cruise_control_tpu.analyzer.goals import registry as JR
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu.testing.verifier import verify_result as j_verify
from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer import prebalance as P
from cruise_control_tpu_torch.analyzer.goals import registry as R
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.testing import checks
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)
from test_torch_hard_goals import _assert_same_solve, _eq

SEEDS = [0, 2]
MAX_ROUNDS = 32


def spec(seed: int) -> dict:
    return dict(num_brokers=16, num_partitions=400, replication_factor=3,
                num_racks=4, num_topics=8, seed=seed, skew_fraction=0.3)


def solve_stack(spec_: dict, j_opt=None):
    """The default stack on `spec_` in both packages: (js, jres, ps, pt,
    pres)."""
    js, jt = j_random_cluster(JSpec(**spec_))
    j_opt = j_opt or JOptimizer(JR.default_goals(max_rounds=MAX_ROUNDS))
    jres = j_opt.optimizations(js, jt)
    jres._topology = jt
    ps, pt = random_cluster(RandomClusterSpec(**spec_), device="cpu")
    pres = GoalOptimizer(R.default_goals(max_rounds=MAX_ROUNDS)
                         ).optimizations(ps, pt, device="cpu")
    return js, jres, ps, pt, pres


@pytest.fixture(scope="module")
def j_optimizer():
    return JOptimizer(JR.default_goals(max_rounds=MAX_ROUNDS))


@pytest.fixture(scope="module", params=SEEDS)
def solved(request, j_optimizer):
    return solve_stack(spec(request.param), j_optimizer)


#: the add-broker case: 14 brokers and 2 new, 16 in all
ADD = dict(spec(0), num_brokers=14, new_brokers=2)


@pytest.fixture(scope="module")
def solved_add(j_optimizer):
    return solve_stack(ADD, j_optimizer)


def test_default_goals_build_the_whole_order():
    goals = R.default_goals()
    assert [g.name for g in goals] == R.DEFAULT_GOAL_ORDER == \
        JR.DEFAULT_GOAL_ORDER
    assert len(goals) == 15
    assert [g.name for g in goals if g.is_hard] == R.DEFAULT_HARD_GOALS


def test_default_stack_placement_and_leaders_equal(solved):
    _, jres, _, _, pres = solved
    for f in ("replica_broker", "replica_is_leader", "replica_disk"):
        _eq(getattr(jres.final_state, f), getattr(pres.final_state, f), f)


def test_default_stack_solve_equal(solved):
    """Proposals (new leaders included), violated counts, entry counts,
    rounds, converged-at rounds, balancedness and statistics."""
    _, jres, _, _, pres = solved
    _assert_same_solve(jres, pres)
    assert jres.violated_goals_before == pres.violated_goals_before
    assert jres.regressed_goals == pres.regressed_goals
    assert pres.num_replica_movements > 0
    assert pres.num_leadership_movements > 0
    # the count pre-balance and the leader goals ran
    assert pres.rounds_by_goal["__prebalance__"] > 0
    assert pres.rounds_by_goal["LeaderReplicaDistributionGoal"] > 0
    assert pres.rounds_by_goal["LeaderBytesInDistributionGoal"] > 0


def test_default_stack_verifiers_and_cache(solved):
    js, jres, ps, pt, pres = solved
    j_verify(js, jres)
    checks.verify_result(ps, pres, pt)
    ctx = C.make_context(ps, C.BalancingConstraint(),
                         C.OptimizationOptions(), pt)
    assert checks.cache_mismatches(pres.final_state, ctx,
                                   pres.final_cache) == []
    assert not set(pres.violated_goals_after) & set(R.DEFAULT_HARD_GOALS)


def test_add_broker_solve_equal(solved_add):
    _, jres, _, _, pres = solved_add
    _assert_same_solve(jres, pres)
    assert jres.violated_goals_before == pres.violated_goals_before
    assert pres.num_replica_movements > 0


def test_add_broker_fills_the_new_brokers(solved_add):
    _, _, ps, _, pres = solved_add
    new = ps.broker_new.numpy()
    assert new.sum() == ADD["new_brokers"]
    assert not np.isin(np.nonzero(new)[0], ps.replica_broker.numpy()).any()
    held = np.bincount(pres.final_state.replica_broker.numpy(),
                       minlength=new.size)
    assert (held[new] > 0).all()


def test_add_broker_verifiers_and_cache(solved_add):
    test_default_stack_verifiers_and_cache(solved_add)


_j_prebalance = jax.jit(JP.prebalance,
                        static_argnames=("count_margin", "max_rounds",
                                         "active_resources",
                                         "balance_counts"))


@pytest.mark.parametrize("active", [(False,) * 4, (True,) * 4],
                         ids=["count band only", "every dimension"])
def test_prebalance_with_the_count_band_matches(active):
    sp = spec(0)
    js, jt = j_random_cluster(JSpec(**sp))
    jctx = JC.make_context(js, JC.BalancingConstraint(),
                           JC.OptimizationOptions(), jt)
    jstate, jrounds, jcache = _j_prebalance(
        js, jctx, count_margin=0.09, active_resources=active,
        balance_counts=True)
    ps, pt = random_cluster(RandomClusterSpec(**sp), device="cpu")
    pctx = C.make_context(ps, C.BalancingConstraint(),
                          C.OptimizationOptions(), pt)
    pstate, prounds, pcache = P.prebalance(
        ps, pctx, count_margin=0.09, active_resources=active,
        balance_counts=True)
    assert int(jrounds) == prounds > 0
    for f in ("replica_broker", "replica_is_leader"):
        _eq(getattr(jstate, f), getattr(pstate, f), f)
    for f in ("replica_count", "leader_count", "broker_topic_count",
              "broker_table", "table_fill"):
        _eq(getattr(jcache, f), getattr(pcache, f), f)
    np.testing.assert_array_equal(np.asarray(jcache.broker_load),
                                  pcache.broker_load.numpy())


@pytest.mark.slow
def test_bench_config3_shape_matches_reference():
    """BENCH_r06.json's config-3 shape (`BENCH_CONFIG=3 BENCH_BROKERS=48
    BENCH_PARTITIONS=1500 BENCH_ROUNDS=48`: bench.py `_build`, 8 racks, 8
    topics, seed 4, skew 0.2) under the default stack at 48 rounds,
    against a live reference solve (not against the numbers pinned
    there).  Marked slow: the reference compiles its goal programs for
    this shape for several minutes on a CPU."""
    sp = dict(num_brokers=48, num_partitions=1500, replication_factor=3,
              num_racks=8, num_topics=8, seed=4, skew_fraction=0.2)
    js, jt = j_random_cluster(JSpec(**sp))
    jres = JOptimizer(JR.default_goals(max_rounds=48)).optimizations(js, jt)
    jres._topology = jt
    ps, pt = random_cluster(RandomClusterSpec(**sp), device="cpu")
    pres = GoalOptimizer(R.default_goals(max_rounds=48)).optimizations(
        ps, pt, device="cpu")
    _assert_same_solve(jres, pres)
    j_verify(js, jres)
    checks.verify_result(ps, pres, pt)
