"""The kafka-assigner mode of the PyTorch port against the JAX reference,
on the CPU: `KafkaAssignerEvenRackAwareGoal` (rack-aware rounds with a
fewest-replicas preference, then a zero-margin count-evening pass) and
`KafkaAssignerDiskUsageDistributionGoal` (swap rounds only), each alone
on the reference's fixtures, then `KAFKA_ASSIGNER_GOAL_ORDER` through
`GoalOptimizer` on two random clusters.

Integers and booleans must match exactly (placements, leader flags,
proposals, rounds, violated counts); per-goal statistics within 1e-6
relative (about 8 float32 ulps: inside the reference's fused goal
programs XLA may order a small reduction differently, as in
tests/test_torch_slice.py).
"""
import numpy as np
import pytest
import torch

from test_kafkaassigner import skewed_disk_cluster

from cruise_control_tpu.analyzer import context as JC
from cruise_control_tpu.analyzer.goals import base as JB
from cruise_control_tpu.analyzer.goals import registry as JR
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.common.resources import Resource as JRes
from cruise_control_tpu.model.builder import ClusterModelBuilder
from cruise_control_tpu.testing import fixtures as jfix
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu.testing.verifier import verify_result as j_verify
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer.goals import base as B
from cruise_control_tpu_torch.analyzer.goals import registry as R
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.model.state import STATE_FIELDS
from cruise_control_tpu_torch.testing import checks
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)

SPEC = dict(num_brokers=16, num_partitions=400, replication_factor=3,
            num_racks=4, num_topics=8, seed=0, skew_fraction=0.3)
#: the reference's own kafka-assigner stack test (tests/test_kafkaassigner.py)
SMALL = dict(num_brokers=8, num_partitions=64, replication_factor=2,
             num_racks=4, num_topics=4, seed=11, skew_fraction=0.5)


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    assert np.array_equal(a, b), what


def _port_state(js):
    return convert.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS},
        num_racks=js.num_racks, num_hosts=js.num_hosts,
        num_topics=js.num_topics, device="cpu")


def swap_fixture():
    """Big partitions on brokers 0-1, small ones on 2-5 (the reference's
    swap-preserves-counts case)."""
    b = ClusterModelBuilder()
    cap = {JRes.CPU: 100.0, JRes.NW_IN: 1e6, JRes.NW_OUT: 1e6,
           JRes.DISK: 1e6}
    for i in range(6):
        b.add_broker(i, rack_id=f"r{i % 3}", capacity=cap)
    for p in range(48):
        broker, size = (p % 2, 5000.0) if p < 16 else (2 + p % 4, 100.0)
        b.add_replica("t", p, broker, True,
                      {JRes.DISK: size, JRes.NW_IN: 1.0, JRes.NW_OUT: 1.0,
                       JRes.CPU: 0.1})
    return b.build()


def _goal_alone(name, fixture, **kwargs):
    """(reference out, port out, reference rounds, port rounds) of one
    goal's optimize on the fixture."""
    js, jt = fixture()
    ps = _port_state(js)
    jctx = JC.make_context(js, JC.BalancingConstraint(),
                           JC.OptimizationOptions(), jt)
    pctx = C.make_context(ps, C.BalancingConstraint(),
                          C.OptimizationOptions())
    jgoal = JR.GOAL_CLASSES[name](**kwargs)
    pgoal = R.GOAL_CLASSES[name](**kwargs)
    _eq(jgoal.violated_brokers(js, jctx, JC.make_round_cache(js)),
        pgoal.violated_brokers(ps, pctx, C.make_round_cache(ps)),
        "violated before")
    j_sink, p_sink = [], []
    JB.set_round_sink(j_sink)
    try:
        jout = jgoal.optimize(js, jctx, ())
    finally:
        JB.set_round_sink(None)
    B.set_round_sink(p_sink)
    try:
        pout = pgoal.optimize(ps, pctx, ())
    finally:
        B.set_round_sink(None)
    for f in STATE_FIELDS:
        _eq(getattr(jout, f), getattr(pout, f), f)
    _eq(jgoal.violated_brokers(jout, jctx, JC.make_round_cache(jout)),
        pgoal.violated_brokers(pout, pctx, C.make_round_cache(pout)),
        "violated after")
    j_rounds = [int(x) for x in JB.collapse_sink(j_sink)]
    assert j_rounds == list(B.collapse_sink(p_sink))
    return ps, pout, j_rounds


def test_even_rack_aware_alone_matches():
    ps, pout, rounds = _goal_alone("KafkaAssignerEvenRackAwareGoal",
                                   jfix.rack_aware_satisfiable,
                                   max_rounds=64)
    assert rounds[0] > 0
    assert (pout.replica_broker != ps.replica_broker).any()


@pytest.mark.parametrize("fixture", ["swap", "skewed"])
def test_disk_swap_alone_matches(fixture):
    fn = swap_fixture if fixture == "swap" else skewed_disk_cluster
    ps, pout, rounds = _goal_alone("KafkaAssignerDiskUsageDistributionGoal",
                                   fn, max_rounds=32)
    assert rounds[0] > 0
    before = torch.bincount(ps.replica_broker.long(), minlength=6)
    after = torch.bincount(pout.replica_broker.long(), minlength=6)
    assert torch.equal(before, after)       # swaps keep replica counts
    if fixture == "swap":
        assert (pout.replica_broker != ps.replica_broker).any()


def _proposals(result):
    return {(str(p.partition), tuple(r.broker_id for r in p.old_replicas),
             tuple(r.broker_id for r in p.new_replicas), p.new_leader)
            for p in result.proposals}


@pytest.mark.parametrize("spec", [SPEC, SMALL], ids=["16 brokers",
                                                     "8 brokers rf 2"])
def test_kafka_assigner_order_matches(spec):
    names = R.KAFKA_ASSIGNER_GOAL_ORDER
    js, jt = j_random_cluster(JSpec(**spec))
    jres = JOptimizer(JR.default_goals(names=names)).optimizations(js, jt)
    jres._topology = jt
    ps, pt = random_cluster(RandomClusterSpec(**spec), device="cpu")
    pres = GoalOptimizer(R.default_goals(names=names)).optimizations(
        ps, pt, device="cpu")
    for f in ("replica_broker", "replica_is_leader", "replica_disk",
              "replica_offline"):
        _eq(getattr(jres.final_state, f), getattr(pres.final_state, f), f)
    assert _proposals(jres) == _proposals(pres)
    assert jres.violated_broker_counts == pres.violated_broker_counts
    assert jres.entry_broker_counts == pres.entry_broker_counts
    assert jres.rounds_by_goal == pres.rounds_by_goal
    assert jres.converged_at_by_goal == pres.converged_at_by_goal
    assert jres.violated_goals_after == pres.violated_goals_after
    assert jres.balancedness_score() == pres.balancedness_score()
    for g, stats in pres.stats_by_goal.items():
        for f, v in vars(stats).items():
            a = np.asarray(getattr(jres.stats_by_goal[g], f))
            if v.dtype.is_floating_point:
                np.testing.assert_allclose(v.numpy(), a, rtol=1e-6,
                                           err_msg=f"{g} {f}")
            else:
                assert np.array_equal(a, v.numpy()), (g, f)
    j_verify(js, jres)
    checks.verify_result(ps, pres, pt)
    assert all(pres.rounds_by_goal[g] > 0 for g in names)
    assert "KafkaAssignerEvenRackAwareGoal" not in pres.violated_goals_after
