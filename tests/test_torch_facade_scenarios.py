"""The PyTorch port's what-if requests (`CruiseControl.evaluate_scenarios`
and several candidate broker sets in `add_brokers`, `remove_brokers` and
`demote_brokers`) against the JAX reference's facade, on the CPU.

The facades of tests/test_torch_facade.py: a JAX `CruiseControl` over a
9-broker `SimulatedCluster` (`RackAwareGoal` and
`DiskUsageDistributionGoal`, an excluded-topics pattern) beside a port
`CruiseControl` over a `SnapshotLoadMonitor` fed the same snapshot, leader
loads and capacities.  In one sequence both serve:
`evaluate_scenarios` of two variants with the base scenario first, three
without it, `remove_brokers([[1], [2]])`, `add_brokers([[8],
[7]])` (each set the only destinations) and `demote_brokers([[0], [1]])`
(a sub-batch of the preferred-leader goal beside the base lane).  Every
outcome equals the reference's (verdicts, counts, rounds, movement,
proposals; stats within 1e-6 relative), and so do the winning
candidate's proposals and the ranked report (timings aside).  A request
with candidate sets and `dryrun=False` raises the reference's
ValueError, and one candidate set keeps the single-solve path.
"""
import pytest

from cruise_control_tpu.scenario import ScenarioSpec as JSpec
from cruise_control_tpu_torch.scenario import (BASE_SCENARIO_NAME,
                                               ScenarioSpec)
from test_torch_facade import make_pair, proposal_keys
from test_torch_scenario import TIMING, assert_same_outcome


#: a hard goal and a distribution goal
GOALS = ("RackAwareGoal", "DiskUsageDistributionGoal")


def _variants(spec):
    return [spec(name="hot", load_scale={"nw_in": 1.3}),
            spec(name="cap", capacity_overrides={2: {"disk": 1.5e6}})]


@pytest.fixture(scope="module")
def served():
    """{request: (reference answer, port answer)} of the sequence."""
    # every batch of two lanes: the reference traces its batched
    # programs once for the goal list (and once for the demotions' goal)
    sim, jcc, pmon, pcc, clock = make_pair(GOALS,
                                           scenario_include_base=False)
    out = {}
    try:
        for name, call in (
                ("with base", lambda cc, spec: cc.evaluate_scenarios(
                    _variants(spec)[:1], include_base=True)),
                ("without base", lambda cc, spec: cc.evaluate_scenarios(
                    _variants(spec))),
                ("remove", lambda cc, spec: cc.remove_brokers([[1], [2]])),
                ("add", lambda cc, spec: cc.add_brokers([[8], [7]])),
                ("demote", lambda cc, spec: cc.demote_brokers([[0], [1]]))):
            out[name] = (call(jcc, JSpec), call(pcc, ScenarioSpec))
        # one candidate set is the single solve (held against the
        # reference in tests/test_torch_facade.py)
        for name, ids in (("single set", [[1]]), ("flat", [1])):
            out[name] = pcc.remove_brokers(ids)
        for cc in (jcc, pcc):
            with pytest.raises(ValueError) as info:
                cc.remove_brokers([[1], [2]], dryrun=False)
            out.setdefault("execute", []).append(str(info.value))
    finally:
        jcc.shutdown()
    return out, pcc


def _report(answer):
    report = dict(answer.scenario_report)
    report["batch"] = {k: v for k, v in report["batch"].items()
                       if k not in TIMING}
    return report


@pytest.mark.parametrize("name", ["with base", "without base"])
def test_evaluate_scenarios_equals_reference(served, name):
    out, _ = served
    j, p = out[name]
    assert [o.spec.name for o in p.outcomes] == \
        [o.spec.name for o in j.outcomes]
    for a, b in zip(j.outcomes, p.outcomes):
        assert_same_outcome(a, b)
    assert p.batch_sizes == j.batch_sizes
    assert p.rung == j.rung == "FUSED"
    first = p.outcomes[0].spec.name
    assert (first == BASE_SCENARIO_NAME) == (name == "with base")


@pytest.mark.parametrize("name", ["remove", "add", "demote"])
def test_candidate_sets_equal_reference(served, name):
    out, _ = served
    j, p = out[name]
    assert p.optimizer_result is None and p.dryrun
    assert p.execution_uuid is None
    assert proposal_keys(p) == proposal_keys(j)
    assert _report(p) == _report(j)
    candidates = {s["name"] for s in p.scenario_report["scenarios"]}
    assert len(candidates) == 2 and p.scenario_report["base"] is None
    assert all(s["rung"] == "FUSED" for s in p.scenario_report["scenarios"])


def test_candidate_routes(served):
    out, pcc = served
    remove = out["remove"][1].scenario_report
    assert {s["name"] for s in remove["scenarios"]} == {"remove-1",
                                                        "remove-2"}
    add = out["add"][1]
    assert all(set(b.broker_id for b in p.new_replicas)
               - set(b.broker_id for b in p.old_replicas) <= {7, 8}
               for p in add.proposals)
    demote = out["demote"][1]
    # a demotion moves leadership only, from its own sub-batch
    assert all(not p.replicas_to_add for p in demote.proposals)
    assert demote.scenario_report["batch"]["deviceBatchSizes"] == [2]
    assert pcc.scenario_engine.total_batches == 5
    assert pcc.scenario_engine.ladder.rung.name == "FUSED"


def test_candidate_sets_refuse_execution(served):
    out, _ = served
    want, got = out["execute"]
    assert got == want and "dry-run only" in got


def test_one_set_keeps_the_single_solve(served):
    out, pcc = served
    one, flat = out["single set"], out["flat"]
    for p in (one, flat):
        assert p.scenario_report is None and p.optimizer_result is not None
    assert proposal_keys(one) == proposal_keys(flat)
    assert one.optimizer_result.rounds_by_goal == \
        flat.optimizer_result.rounds_by_goal
