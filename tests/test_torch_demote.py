"""The demote-broker path of the PyTorch port against the JAX reference,
on the CPU: brokers marked demoted (`set_broker_state(demoted=True)`),
then `PreferredLeaderElectionGoal` through `GoalOptimizer`, as the
reference's `facade.demote_brokers` solves it.

The goal's elected leader, transfers and violated brokers function by
function, then whole solves with one and two demoted brokers and with a
demoted and a dead broker (self-healing first).  Integers and booleans
must match exactly (leader flags, placements, proposals, rounds,
violated counts); per-goal statistics within 1e-6 relative (about 8
float32 ulps: inside the reference's fused goal programs XLA may order a
small reduction differently, as in tests/test_torch_slice.py).
"""
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import context as JC
from cruise_control_tpu.analyzer.goals import registry as JR
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.model import state as JS
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu.testing.verifier import verify_result as j_verify
from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer.goals import registry as R
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.testing import checks
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)

SPEC = dict(num_brokers=16, num_partitions=400, replication_factor=3,
            num_racks=4, num_topics=8, seed=0, skew_fraction=0.3)
GOAL = "PreferredLeaderElectionGoal"
#: (demoted brokers, killed brokers)
CASES = {"one demoted": ((3,), ()), "two demoted": ((3, 9), ()),
         "demoted and dead": ((3,), (9,))}


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    assert np.array_equal(a, b), what


def _states(case):
    demoted, dead = CASES[case]
    js, jt = j_random_cluster(JSpec(**SPEC))
    ps, pt = random_cluster(RandomClusterSpec(**SPEC), device="cpu")
    for b in demoted:
        js = JS.set_broker_state(js, b, demoted=True)
        ps = S.set_broker_state(ps, b, demoted=True)
    for b in dead:
        js = JS.set_broker_state(js, b, alive=False)
        ps = S.set_broker_state(ps, b, alive=False)
    return js, jt, ps, pt


@pytest.mark.parametrize("case", list(CASES))
def test_elected_leader_and_violations_match(case):
    js, jt, ps, pt = _states(case)
    jctx = JC.make_context(js, JC.BalancingConstraint(),
                           JC.OptimizationOptions(), jt)
    pctx = C.make_context(ps, C.BalancingConstraint(),
                          C.OptimizationOptions(), pt)
    jgoal, pgoal = JR.make_goal(GOAL), R.make_goal(GOAL)
    j_has, j_chosen = jgoal._elected_leader(js, jctx)
    p_has, p_chosen = pgoal._elected_leader(ps, pctx)
    _eq(j_has, p_has, "has_candidate")
    _eq(j_chosen, p_chosen.to(torch.int32), "chosen")
    j_viol = jgoal.violated_brokers(js, jctx, JC.make_round_cache(js))
    p_viol = pgoal.violated_brokers(ps, pctx, C.make_round_cache(ps))
    _eq(j_viol, p_viol, "violated brokers")
    assert p_viol.any()
    jout = jgoal.optimize(js, jctx, ())
    pout = pgoal.optimize(ps, pctx, ())
    _eq(jout.replica_is_leader, pout.replica_is_leader, "leader flags")
    assert not pgoal.violated_brokers(pout, pctx,
                                      C.make_round_cache(pout)).any()


def _proposals(result):
    return {(str(p.partition), tuple(r.broker_id for r in p.old_replicas),
             tuple(r.broker_id for r in p.new_replicas), p.new_leader)
            for p in result.proposals}


@pytest.mark.parametrize("case", list(CASES))
def test_demote_solve_matches(case):
    js, jt, ps, pt = _states(case)
    jres = JOptimizer([JR.make_goal(GOAL)]).optimizations(js, jt)
    jres._topology = jt
    pres = GoalOptimizer([R.make_goal(GOAL)]).optimizations(ps, pt,
                                                            device="cpu")
    for f in ("replica_broker", "replica_is_leader", "replica_disk",
              "replica_offline"):
        _eq(getattr(jres.final_state, f), getattr(pres.final_state, f), f)
    assert _proposals(jres) == _proposals(pres)
    assert jres.violated_broker_counts == pres.violated_broker_counts
    assert jres.entry_broker_counts == pres.entry_broker_counts
    assert jres.rounds_by_goal == pres.rounds_by_goal
    assert jres.converged_at_by_goal == pres.converged_at_by_goal
    assert jres.num_leadership_movements == pres.num_leadership_movements
    assert jres.balancedness_score() == pres.balancedness_score()
    for f, v in vars(pres.stats_by_goal[GOAL]).items():
        a = np.asarray(getattr(jres.stats_by_goal[GOAL], f))
        if v.dtype.is_floating_point:
            np.testing.assert_allclose(v.numpy(), a, rtol=1e-6, err_msg=f)
        else:
            assert np.array_equal(a, v.numpy()), f
    j_verify(js, jres)
    checks.verify_result(ps, pres, pt)
    assert pres.num_leadership_movements > 0
    # no demoted broker leads a partition that has another eligible replica
    before, own, after = pres.violated_broker_counts[GOAL]
    assert before > 0 and own == 0 and after == 0
