"""The PyTorch port's slice end to end against the JAX reference.

`GoalOptimizer([DiskUsageDistributionGoal(),
NetworkInboundUsageDistributionGoal()]).optimizations(state, topology)`
with default options (joint pre-balance on) on two seeded 16-broker
clusters, in the reference and in the port on the CPU.  The final
placement, the proposals, the per-goal violated-broker counts, rounds,
converged-at rounds and the balancedness score must be EQUAL; both results
must pass sanity and the verifier's invariants.  Each run has pre-balance
work and at least one swap round.

The same holds with a dead broker, whose replicas are healed first, and
for the four goals of config 2 (Disk, NwIn, NwOut, Cpu),
whose last two run the leadership sweep and the leadership table rounds,
on the same seeds — leader flags and proposals' new leaders included —
and for NwOut alone and Cpu alone from the same start states.
"""
import dataclasses

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.goals.resource_distribution import (
    CpuUsageDistributionGoal as JCpu, DiskUsageDistributionGoal as JDisk,
    NetworkInboundUsageDistributionGoal as JNwIn,
    NetworkOutboundUsageDistributionGoal as JNwOut)
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu.testing.verifier import verify_result as j_verify
from cruise_control_tpu_torch.analyzer import kernels as K
from cruise_control_tpu_torch.analyzer.context import (BalancingConstraint,
                                                       OptimizationOptions,
                                                       make_context)
from cruise_control_tpu_torch.analyzer.goals.resource_distribution import (
    CpuUsageDistributionGoal, DiskUsageDistributionGoal,
    NetworkInboundUsageDistributionGoal,
    NetworkOutboundUsageDistributionGoal)
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
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


# ---------------------------------------------------------------------------
# the leadership goals: config 2's four goals, and NwOut / Cpu alone
# ---------------------------------------------------------------------------

FOUR = ((JDisk, DiskUsageDistributionGoal),
        (JNwIn, NetworkInboundUsageDistributionGoal),
        (JNwOut, NetworkOutboundUsageDistributionGoal),
        (JCpu, CpuUsageDistributionGoal))


def _solve_both(goal_pairs, seed, j_opt=None):
    spec = _spec(seed)
    js, jt = j_random_cluster(JSpec(**spec))
    j_opt = j_opt or JOptimizer([j() for j, _ in goal_pairs])
    jres = j_opt.optimizations(js, jt)
    jres._topology = jt
    ps, pt = random_cluster(RandomClusterSpec(**spec), device="cpu")
    pres = GoalOptimizer([p() for _, p in goal_pairs]).optimizations(
        ps, pt, device="cpu")
    return js, jres, ps, pt, pres


@pytest.fixture(scope="module")
def j_optimizer4():
    return JOptimizer([j() for j, _ in FOUR])


@pytest.fixture(scope="module", params=SEEDS)
def solved4(request, j_optimizer4):
    return _solve_both(FOUR, request.param, j_optimizer4)


def _assert_same_solve(jres, pres):
    for f in ("replica_broker", "replica_is_leader"):
        assert np.array_equal(np.asarray(getattr(jres.final_state, f)),
                              getattr(pres.final_state, f).numpy()), f
    # proposals list the leader first: equal tuples mean equal leaders
    assert _proposals(jres) == _proposals(pres)
    assert ({(str(p.partition), p.new_leader) for p in jres.proposals}
            == {(str(p.partition), p.new_leader) for p in pres.proposals})
    assert jres.violated_broker_counts == pres.violated_broker_counts
    assert jres.entry_broker_counts == pres.entry_broker_counts
    assert jres.rounds_by_goal == pres.rounds_by_goal
    assert jres.converged_at_by_goal == pres.converged_at_by_goal
    assert jres.num_leadership_movements == pres.num_leadership_movements
    assert jres.balancedness_score() == pres.balancedness_score()


def test_four_goals_placement_and_leaders_equal(solved4):
    _, jres, _, _, pres = solved4
    for f in ("replica_broker", "replica_is_leader"):
        assert np.array_equal(np.asarray(getattr(jres.final_state, f)),
                              getattr(pres.final_state, f).numpy()), f


def test_four_goals_proposals_equal(solved4):
    _, jres, _, _, pres = solved4
    _assert_same_solve(jres, pres)
    assert pres.num_leadership_movements > 0
    assert pres.num_replica_movements > 0


def test_four_goals_instruments_equal(solved4):
    """Rounds include the leadership sweep's (the goal's sink adds them)."""
    _, jres, _, _, pres = solved4
    assert jres.violated_broker_counts == pres.violated_broker_counts
    assert jres.rounds_by_goal == pres.rounds_by_goal
    assert jres.converged_at_by_goal == pres.converged_at_by_goal
    assert jres.violated_goals_after == pres.violated_goals_after
    for g in ("NetworkOutboundUsageDistributionGoal",
              "CpuUsageDistributionGoal"):
        assert pres.rounds_by_goal[g] > 0


def test_four_goals_stats_match(solved4):
    """Per-goal statistics within 1e-6 relative, as in test_stats_match."""
    _, jres, _, _, pres = solved4
    for g, stats in pres.stats_by_goal.items():
        for f, v in vars(stats).items():
            a = np.asarray(getattr(jres.stats_by_goal[g], f))
            if v.dtype.is_floating_point:
                np.testing.assert_allclose(v.numpy(), a, rtol=1e-6,
                                           err_msg=f"{g} {f}")
            else:
                assert np.array_equal(a, v.numpy()), (g, f)


def test_four_goals_verifier_and_cache(solved4):
    js, jres, ps, pt, pres = solved4
    j_verify(js, jres)
    checks.verify_result(ps, pres, pt)
    ctx = make_context(ps, BalancingConstraint(), OptimizationOptions(), pt)
    assert checks.cache_mismatches(pres.final_state, ctx,
                                   pres.final_cache) == []


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("which", [2, 3], ids=["NwOut", "Cpu"])
def test_leadership_goal_alone_matches(which, seed):
    _, jres, ps, pt, pres = _solve_both([FOUR[which]], seed)
    _assert_same_solve(jres, pres)
    assert pres.num_leadership_movements > 0
    checks.verify_result(ps, pres, pt)


def test_verify_result_checks_new_leaders():
    """The replay gate fails a proposal whose new leader is not the
    partition's final leader, and a leader change with no proposal."""
    ps, pt = random_cluster(RandomClusterSpec(**_spec(0)), device="cpu")
    pres = GoalOptimizer([NetworkOutboundUsageDistributionGoal()]
                         ).optimizations(ps, pt, device="cpu")
    checks.verify_result(ps, pres, pt)
    lead_only = next(p for p in pres.proposals
                     if p.has_leader_action and not p.has_replica_action)
    swapped = dataclasses.replace(
        lead_only, new_replicas=lead_only.new_replicas[::-1])
    bad = dataclasses.replace(pres, proposals=[
        swapped if p is lead_only else p for p in pres.proposals])
    with pytest.raises(AssertionError, match="names leader"):
        checks.verify_result(ps, bad, pt)
    dropped = dataclasses.replace(pres, proposals=[
        p for p in pres.proposals if p is not lead_only])
    with pytest.raises(AssertionError, match="without a proposal"):
        checks.verify_result(ps, dropped, pt)


def test_offline_replicas_are_healed_like_the_reference(j_optimizer):
    """A dead broker's replicas are healed first (the port used to refuse
    them), then the two goals run: the same fixture in both packages
    gives the same solve."""
    spec = dict(_spec(0), dead_brokers=1)
    js, jt = j_random_cluster(JSpec(**spec))
    jres = j_optimizer.optimizations(js, jt)
    jres._topology = jt
    ps, pt = random_cluster(RandomClusterSpec(**spec), device="cpu")
    pres = GoalOptimizer([DiskUsageDistributionGoal(),
                          NetworkInboundUsageDistributionGoal()]
                         ).optimizations(ps, pt, device="cpu")
    assert pres.heal_moves == int(ps.replica_offline.sum()) > 0
    for f in ("replica_broker", "replica_offline", "replica_is_leader"):
        assert np.array_equal(np.asarray(getattr(jres.final_state, f)),
                              getattr(pres.final_state, f).numpy()), f
    assert _proposals(jres) == _proposals(pres)
    assert jres.violated_broker_counts == pres.violated_broker_counts
    assert jres.rounds_by_goal == pres.rounds_by_goal
    assert jres.converged_at_by_goal == pres.converged_at_by_goal
    j_verify(js, jres)
    checks.verify_result(ps, pres, pt)


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


@pytest.mark.slow
def test_four_goal_config2_geometry_matches_reference(j_optimizer4):
    """Config 2 whole (Disk, NwIn, NwOut, Cpu) on the slice geometry: the
    port on the CPU against the reference.  Marked slow: the two solves
    take over a minute on a CPU, and this file's tier-1 cases already
    take about four minutes on one worker."""
    spec = dict(num_brokers=200, num_partitions=20_000, replication_factor=3,
                num_racks=8, num_topics=10, seed=4, skew_fraction=0.2)
    js, jt = j_random_cluster(JSpec(**spec))
    jres = j_optimizer4.optimizations(js, jt)
    ps, pt = random_cluster(RandomClusterSpec(**spec), device="cpu")
    pres = GoalOptimizer([p() for _, p in FOUR]).optimizations(
        ps, pt, device="cpu")
    _assert_same_solve(jres, pres)
    checks.verify_result(ps, pres, pt)
