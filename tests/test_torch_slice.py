"""The PyTorch port's slice end to end against the JAX reference.

`GoalOptimizer([DiskUsageDistributionGoal(),
NetworkInboundUsageDistributionGoal()]).optimizations(state, topology)`
with default options (joint pre-balance on) on two seeded 16-broker
clusters, in the reference and in the port on the CPU.  The final
placement, the proposals, the per-goal violated-broker counts, rounds,
converged-at rounds and the balancedness score must be EQUAL; both results
must pass sanity and the verifier's invariants.  Each run has pre-balance
work and at least one swap round.
"""
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.goals.resource_distribution import (
    DiskUsageDistributionGoal as JDisk,
    NetworkInboundUsageDistributionGoal as JNwIn)
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu.testing.verifier import verify_result as j_verify
from cruise_control_tpu_torch.analyzer import kernels as K
from cruise_control_tpu_torch.analyzer.context import (BalancingConstraint,
                                                       OptimizationOptions,
                                                       make_context)
from cruise_control_tpu_torch.analyzer.goals.resource_distribution import (
    DiskUsageDistributionGoal, NetworkInboundUsageDistributionGoal,
    ResourceDistributionGoal)
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.model.sanity import sanity_check
from cruise_control_tpu_torch.testing import checks
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)

SEEDS = [0, 2]


def _spec(seed):
    return dict(num_brokers=16, num_partitions=400, replication_factor=3,
                num_racks=4, num_topics=8, seed=seed, skew_fraction=0.3)


def _proposals(result):
    return {(str(p.partition), tuple(r.broker_id for r in p.old_replicas),
             tuple(r.broker_id for r in p.new_replicas))
            for p in result.proposals}


@pytest.fixture(scope="module")
def j_optimizer():
    return JOptimizer([JDisk(), JNwIn()])


@pytest.fixture(scope="module", params=SEEDS)
def solved(request, j_optimizer):
    spec = _spec(request.param)
    js, jt = j_random_cluster(JSpec(**spec))
    jres = j_optimizer.optimizations(js, jt)
    jres._topology = jt
    ps, pt = random_cluster(RandomClusterSpec(**spec), device="cpu")
    swaps = []
    real_swap = K.swap_round

    def counting_swap(*args, **kwargs):
        swaps.append(1)
        return real_swap(*args, **kwargs)

    K.swap_round = counting_swap
    try:
        pres = GoalOptimizer([DiskUsageDistributionGoal(),
                              NetworkInboundUsageDistributionGoal()]
                             ).optimizations(ps, pt, device="cpu")
    finally:
        K.swap_round = real_swap
    return js, jres, ps, pt, pres, len(swaps)


def test_final_placement_equal(solved):
    js, jres, _, _, pres, _ = solved
    for f in ("replica_broker", "replica_is_leader"):
        assert np.array_equal(np.asarray(getattr(jres.final_state, f)),
                              getattr(pres.final_state, f).numpy()), f


def test_proposals_equal(solved):
    _, jres, _, _, pres, _ = solved
    assert _proposals(jres) == _proposals(pres)
    assert len(pres.proposals) > 0


def test_instruments_equal(solved):
    _, jres, _, _, pres, swaps = solved
    assert jres.violated_broker_counts == pres.violated_broker_counts
    assert jres.entry_broker_counts == pres.entry_broker_counts
    assert jres.rounds_by_goal == pres.rounds_by_goal
    assert jres.converged_at_by_goal == pres.converged_at_by_goal
    assert jres.balancedness_score() == pres.balancedness_score()
    assert jres.violated_goals_before == pres.violated_goals_before
    assert jres.violated_goals_after == pres.violated_goals_after
    assert pres.rounds_by_goal["__prebalance__"] > 0
    assert swaps > 0


def test_stats_match(solved):
    """Per-goal statistics.  The port sums in XLA's standalone order
    (exact in test_torch_model); inside the reference's fused goal
    programs XLA may order a small reduction differently, so the floats
    agree to 1e-6 relative (about 8 float32 ulps) and counts exactly."""
    _, jres, _, _, pres, _ = solved
    for g, stats in pres.stats_by_goal.items():
        for f, v in vars(stats).items():
            a = np.asarray(getattr(jres.stats_by_goal[g], f))
            if v.dtype.is_floating_point:
                np.testing.assert_allclose(v.numpy(), a, rtol=1e-6,
                                           err_msg=f"{g} {f}")
            else:
                assert np.array_equal(a, v.numpy()), (g, f)


def test_both_pass_the_verifier(solved):
    js, jres, ps, pt, pres, _ = solved
    j_verify(js, jres)
    sanity_check(pres.final_state)
    checks.verify_result(ps, pres, pt)


def test_final_cache_equals_rebuild(solved):
    _, _, ps, pt, pres, _ = solved
    ctx = make_context(ps, BalancingConstraint(), OptimizationOptions(), pt)
    assert checks.cache_mismatches(pres.final_state, ctx,
                                   pres.final_cache) == []


def test_entry_point_needs_the_card_unless_cpu_is_asked_for():
    """No hidden CPU run: without a card, the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    ps, pt = random_cluster(RandomClusterSpec(**_spec(0)), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        GoalOptimizer([DiskUsageDistributionGoal()]).optimizations(ps, pt)
    with pytest.raises(RuntimeError, match="CUDA"):
        random_cluster(RandomClusterSpec(**_spec(0)))


@pytest.mark.parametrize("resource", [Resource.CPU, Resource.NW_OUT])
def test_leadership_goals_are_not_offered_yet(resource):
    goal_cls = type("G", (ResourceDistributionGoal,), {"resource": resource})
    with pytest.raises(NotImplementedError, match="leadership"):
        goal_cls()


def test_offline_replicas_are_refused():
    spec = dict(_spec(0), dead_brokers=1)
    ps, pt = random_cluster(RandomClusterSpec(**spec), device="cpu")
    with pytest.raises(NotImplementedError, match="self-healing"):
        GoalOptimizer([DiskUsageDistributionGoal()]).optimizations(
            ps, pt, device="cpu")


def test_slice_geometry_matches_reference(j_optimizer):
    """The slice's own geometry (200 brokers, 20K partitions, rf 3, 8
    racks, 10 topics, seed 4, skew 0.2): the port on the CPU against the
    reference, with the same equalities as above."""
    spec = dict(num_brokers=200, num_partitions=20_000, replication_factor=3,
                num_racks=8, num_topics=10, seed=4, skew_fraction=0.2)
    js, jt = j_random_cluster(JSpec(**spec))
    jres = j_optimizer.optimizations(js, jt)
    ps, pt = random_cluster(RandomClusterSpec(**spec), device="cpu")
    pres = GoalOptimizer([DiskUsageDistributionGoal(),
                          NetworkInboundUsageDistributionGoal()]
                         ).optimizations(ps, pt, device="cpu")
    assert np.array_equal(np.asarray(jres.final_state.replica_broker),
                          pres.final_state.replica_broker.numpy())
    assert _proposals(jres) == _proposals(pres)
    assert jres.violated_broker_counts == pres.violated_broker_counts
    assert jres.rounds_by_goal == pres.rounds_by_goal
    assert jres.converged_at_by_goal == pres.converged_at_by_goal
    assert jres.balancedness_score() == pres.balancedness_score()
