"""The default goal stack on the reference's hand-derived fixture, in the
PyTorch port and in the JAX reference, on the CPU.

`cruise_control_tpu.testing.fixtures.small_cluster` (BENCH config 1: 3
brokers in 2 racks, 3 partitions, RF 2) is carried into the port through
`cruise_control_tpu_torch.convert` (numpy arrays) with its topology, and
both packages solve it under the 15 goals of `DEFAULT_GOAL_ORDER`.
tests/test_differential_reference.py derives the outcome by hand: the
one forced rack move of T1-0 onto broker 2 and nothing else.  The port
must give the reference's solve exactly (placement, leaders, proposals,
violated counts, rounds, balancedness) and that outcome.  A file of its
own: the reference compiles its goal programs for this shape.
"""
import numpy as np

from cruise_control_tpu.analyzer.goals import registry as JR
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.testing.fixtures import small_cluster
from cruise_control_tpu.testing.verifier import verify_result as j_verify
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer.goals import registry as R
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.model.state import STATE_FIELDS
from cruise_control_tpu_torch.model.topology import (ClusterTopology,
                                                     PartitionId)
from cruise_control_tpu_torch.testing import checks
from test_torch_hard_goals import _assert_same_solve


def _port_copy(js, jt):
    ps = convert.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS},
        num_racks=js.num_racks, num_hosts=js.num_hosts,
        num_topics=js.num_topics, device="cpu")
    pt = ClusterTopology(
        broker_ids=list(jt.broker_ids), rack_ids=list(jt.rack_ids),
        host_names=list(jt.host_names), topics=list(jt.topics),
        partitions=[PartitionId(p.topic, p.partition)
                    for p in jt.partitions],
        disk_names=list(jt.disk_names))
    return ps, pt


def test_config1_fixture_solve_matches_and_pins_the_rack_move():
    js, jt = small_cluster()
    jres = JOptimizer(JR.default_goals(max_rounds=192)).optimizations(js, jt)
    jres._topology = jt
    ps, pt = _port_copy(js, jt)
    pres = GoalOptimizer(R.default_goals(max_rounds=192)).optimizations(
        ps, pt, device="cpu")
    _assert_same_solve(jres, pres)
    j_verify(js, jres)
    checks.verify_result(ps, pres, pt)
    # the hand-derived outcome: one forced rack move, T1-0 gains broker 2
    assert len(pres.proposals) == 1
    p = pres.proposals[0]
    assert (p.partition.topic, p.partition.partition) == ("T1", 0)
    new_brokers = {r.broker_id for r in p.new_replicas}
    assert 2 in new_brokers and len(new_brokers) == 2
    assert pres.violated_broker_counts["RackAwareGoal"] == (2, 0, 0)
    assert not pres.regressed_goals
