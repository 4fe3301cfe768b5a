"""The PyTorch port's what-if scenarios (cruise_control_tpu_torch/
scenario/) against the JAX reference's, on the CPU.

One rig, as tests/test_scenario.py builds it: the reference's 3-broker
`fixtures.small_cluster()` (carried into the port through `convert`),
`RackAwareGoal`, `DiskCapacityGoal` and `ReplicaDistributionGoal` at 16
rounds in segments of two, and one engine per package.  One evaluation
of four specs runs in each package and is compared outcome by outcome:
a K = 3 batch mixing broker counts (the base scenario, a hypothetical
broker on a new rack that is the only destination, and the removal of
rack B's only broker, which no solve can repair) and a goal override
that opens its own sub-batch.  Integer and boolean outputs, verdicts,
reasons, proposals and the movement metrics must be equal; the
statistics equal within 1e-6 relative (they agree bit for bit here).
Also: spec validation and payloads against the reference's errors,
`materialize` and `compile_batch` field for field, `batch_report` JSON,
and the engine's failure paths (out-of-memory halving, an out-of-memory
batch of one descending to EAGER, each EAGER outcome equal to its FUSED
twin, a broker table re-widened, a kernel that fails to build or launch
and any other error raising through at FUSED and at EAGER, with no
host-rung solve).
"""
import json

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.context import \
    BalancingConstraint as JConstraint
from cruise_control_tpu.analyzer.goals.registry import \
    default_goals as j_default_goals
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.scenario import BrokerAdd as JAdd
from cruise_control_tpu.scenario import ScenarioEngine as JEngine
from cruise_control_tpu.scenario import ScenarioSpec as JSpec
from cruise_control_tpu.scenario import ScenarioSpecError as JSpecError
from cruise_control_tpu.scenario import compiler as JCompiler
from cruise_control_tpu.scenario import engine as JEngineModule
from cruise_control_tpu.scenario import report as JReport
from cruise_control_tpu.scenario import \
    parse_scenarios_payload as j_parse
from cruise_control_tpu.testing import fixtures
from cruise_control_tpu_torch import cuda_kernels
from cruise_control_tpu_torch.analyzer.context import (CONTEXT_FIELDS,
                                                       BalancingConstraint)
from cruise_control_tpu_torch.analyzer.degradation import SolverRung
from cruise_control_tpu_torch.analyzer.goals.registry import default_goals
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.convert import CONTEXT_STATIC
from cruise_control_tpu_torch.model.state import STATE_FIELDS, own_copy
from cruise_control_tpu_torch.scenario import (BASE_SCENARIO_NAME, BrokerAdd,
                                               ScenarioEngine, ScenarioSpec,
                                               ScenarioSpecError,
                                               candidate_broker_sets,
                                               parse_scenarios_payload)
from cruise_control_tpu_torch.scenario import compiler as C
from cruise_control_tpu_torch.scenario import engine as E
from cruise_control_tpu_torch.scenario import report as R
from cruise_control_tpu_torch.utils import faults
from test_torch_default_stack_fixture import _port_copy

SCENARIO_GOALS = ["RackAwareGoal", "DiskCapacityGoal",
                  "ReplicaDistributionGoal"]
#: the batch's timing keys (measured, not compared)
TIMING = ("compileS", "solveS", "durationS")


def _specs(spec, add):
    """The evaluation both packages run: three lanes of the default goal
    list (4 brokers: one hypothetical on the new rack C) and one lane of
    a goal override."""
    return [spec(name=BASE_SCENARIO_NAME),
            spec(name="grow",
                 add_brokers=(add(9, rack="C", capacity={"disk": 900.0}),),
                 only_move_to_added=True, load_scale={"nw_in": 1.25}),
            spec(name="doomed", remove_brokers=(2,)),
            spec(name="rack-only", load_scale={"disk": 1.2},
                 goals=("RackAwareGoal",))]


@pytest.fixture(scope="module")
def rig():
    """(JAX state, topology, optimizer, engine) and the port's, one
    engine per package for the module."""
    js, jt = fixtures.small_cluster()
    jc = JConstraint()
    jopt = JOptimizer(j_default_goals(max_rounds=16, names=SCENARIO_GOALS),
                      jc, pipeline_segment_size=2)
    jengine = JEngine(lambda names: jopt if names is None else JOptimizer(
        j_default_goals(max_rounds=16, names=names), jc), jc)
    ps, pt = _port_copy(js, jt)
    pc = BalancingConstraint()
    popt = GoalOptimizer(default_goals(max_rounds=16, names=SCENARIO_GOALS),
                         pc, pipeline_segment_size=2)
    pengine = ScenarioEngine(
        lambda names: popt if names is None else GoalOptimizer(
            default_goals(max_rounds=16, names=names), pc), pc,
        device="cpu")
    return dict(js=js, jt=jt, jopt=jopt, jengine=jengine, ps=ps, pt=pt,
                popt=popt, pengine=pengine)


@pytest.fixture(scope="module")
def both(rig):
    """The one evaluation, in both packages: (reference, port)."""
    jres = rig["jengine"].evaluate(rig["js"], rig["jt"], _specs(JSpec, JAdd))
    pres = rig["pengine"].evaluate(rig["ps"], rig["pt"],
                                   _specs(ScenarioSpec, BrokerAdd))
    return jres, pres


def _proposal_keys(proposals):
    return sorted((str(p.partition),
                   tuple((r.broker_id, r.logdir) for r in p.old_replicas),
                   tuple((r.broker_id, r.logdir) for r in p.new_replicas),
                   p.new_leader, p.partition_size)
                  for p in proposals)


def _stats_equal(j, p, what):
    """Floats within 1e-6 relative, integers exactly."""
    if j is None or p is None:
        assert j is None and p is None, what
        return
    for f, v in vars(p).items():
        a = np.asarray(getattr(j, f))
        if v.dtype.is_floating_point:
            np.testing.assert_allclose(v.numpy(), a, rtol=1e-6,
                                       err_msg=f"{what} {f}")
        else:
            assert np.array_equal(v.numpy(), a), (what, f)


def assert_same_outcome(j, p):
    name = p.spec.name
    assert j.spec.name == name
    for f in ("feasible", "reason", "rung", "violated_goals_before",
              "violated_goals_after", "violated_broker_counts",
              "entry_broker_counts", "rounds_by_goal",
              "converged_at_by_goal", "regressed_goals", "invalid_input",
              "balancedness", "num_replica_moves", "num_leadership_moves",
              "data_to_move"):
        assert getattr(j, f) == getattr(p, f), (name, f)
    assert _proposal_keys(j.proposals) == _proposal_keys(p.proposals), name
    _stats_equal(j.stats_before, p.stats_before, f"{name} before")
    _stats_equal(j.stats_after, p.stats_after, f"{name} after")
    assert set(j.stats_by_goal) == set(p.stats_by_goal), name
    for g in p.stats_by_goal:
        _stats_equal(j.stats_by_goal[g], p.stats_by_goal[g], f"{name} {g}")


def _error(fn):
    try:
        fn()
    except (JSpecError, ScenarioSpecError) as exc:
        return str(exc)
    return None


# ---------------------------------------------------------------------------
# specs and payloads
# ---------------------------------------------------------------------------

def test_spec_json_both_ways_and_noop():
    def full(spec, add):
        return spec(name="s1", add_brokers=(add(broker_id=9, rack="B",
                                                capacity={"disk": 123.0}),),
                    remove_brokers=(1,), demote_brokers=(2,),
                    load_scale={"disk": 1.5},
                    capacity_overrides={0: {"cpu": 50.0}},
                    goals=("RackAwareGoal",), only_move_to_added=True)
    j, p = full(JSpec, JAdd), full(ScenarioSpec, BrokerAdd)
    assert p.to_json() == j.to_json()
    assert ScenarioSpec.from_json(j.to_json()) == p
    assert not p.is_noop() and ScenarioSpec(name="base").is_noop()
    assert np.array_equal(p.load_scale_vector(), j.load_scale_vector())
    assert p.load_scale_vector().dtype == np.float32


BAD_SPECS = [
    dict(name=""), dict(name="x", load_scale={"ram": 2.0}),
    dict(name="x", load_scale={"disk": -1.0}),
    dict(name="x", load_scale={"disk": 0.0}),
    dict(name="x", capacity_overrides={0: {"cpu": "a"}}),
    dict(name="x", add=(1,), remove_brokers=(1,)),
    dict(name="x", add=(1, 1)),
    dict(name="x", only_move_to_added=True),
    dict(name="x", remove_brokers=(77,), topology=True),
    dict(name="x", demote_brokers=(5,), add=(5,), topology=True),
    dict(name="x", capacity_overrides={66: {"cpu": 1.0}}, topology=True),
]


@pytest.mark.parametrize("case", range(len(BAD_SPECS)))
def test_spec_validation_matches_reference(case, rig):
    kw = dict(BAD_SPECS[case])
    topo = kw.pop("topology", False)
    adds = kw.pop("add", ())

    def check(spec, add, topology):
        s = spec(add_brokers=tuple(add(b) for b in adds), **kw)
        return lambda: s.validate(topology if topo else None)
    want = _error(check(JSpec, JAdd, rig["jt"]))
    got = _error(check(ScenarioSpec, BrokerAdd, rig["pt"]))
    if case == len(BAD_SPECS) - 2:
        assert want is None and got is None    # an added broker is known
    else:
        assert want is not None and got == want


PAYLOADS = [
    json.dumps({"scenarios": [{"name": "a"}, {"name": "b",
                                               "loadScale": {"cpu": 2.0}}],
                "goals": ["RackAwareGoal"], "includeBase": False}),
    json.dumps({"scenarios": [{"name": "a", "addBrokers": [
        7, {"brokerId": 8, "rack": "B", "capacity": {"disk": 5.0}}],
        "capacityOverrides": {"1": {"nw_in": 3.0}},
        "onlyMoveToAdded": True}]}).encode(),
    {"scenarios": [{"name": "a", "removeBrokers": [1],
                    "demoteBrokers": [2]}], "includeBase": True},
    None, "", "{}", "not json", json.dumps({"scenarios": []}),
    json.dumps({"scenarios": [{"name": "a"}], "extra": 1}),
    json.dumps({"scenarios": [{"name": "a"}, {"name": "a"}]}),
    json.dumps({"scenarios": [{"name": "a", "bogus": 1}]}),
    json.dumps({"scenarios": [{"name": "a"}], "goals": "RackAwareGoal"}),
    json.dumps({"scenarios": [{"name": "a", "addBrokers": [{"rack": "B"}]}]}),
    json.dumps({"scenarios": [{"name": "a",
                               "capacityOverrides": {"x": {"cpu": 1}}}]}),
    json.dumps({"scenarios": ["a"]}),
]


@pytest.mark.parametrize("case", range(len(PAYLOADS)))
def test_payload_parser_matches_reference(case):
    body = PAYLOADS[case]
    try:
        want = j_parse(body)
    except JSpecError as exc:
        with pytest.raises(ScenarioSpecError) as info:
            parse_scenarios_payload(body)
        assert str(info.value) == str(exc)
        return
    got = parse_scenarios_payload(body)
    assert [s.to_json() for s in got[0]] == [s.to_json() for s in want[0]]
    assert got[1:] == want[1:]


def test_candidate_broker_sets_match():
    from cruise_control_tpu.scenario import candidate_broker_sets as j_sets
    for ids in ([1, 2], [[3, 1], [2]], [], [(4,), {5, 6}]):
        assert candidate_broker_sets(ids) == j_sets(ids)
    with pytest.raises(ScenarioSpecError, match="not a mix"):
        candidate_broker_sets([[1], 2])


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------

def _state_equal(js, ps, what):
    for f in STATE_FIELDS:
        a = np.asarray(getattr(js, f))
        b = getattr(ps, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, f)
    for f in ("num_racks", "num_hosts", "num_topics"):
        assert getattr(js, f) == getattr(ps, f), (what, f)


def _topology_equal(jt, pt, what):
    for f in ("broker_ids", "rack_ids", "host_names", "topics",
              "disk_names"):
        assert list(getattr(jt, f)) == list(getattr(pt, f)), (what, f)
    assert [(p.topic, p.partition) for p in jt.partitions] == \
        [(p.topic, p.partition) for p in pt.partitions], what


def test_materialize_matches_reference(rig):
    jspecs, pspecs = _specs(JSpec, JAdd)[:3], _specs(ScenarioSpec,
                                                    BrokerAdd)[:3]
    jgeo = JCompiler._batch_geometry(rig["js"], rig["jt"], jspecs)
    pgeo = C._batch_geometry(rig["ps"], rig["pt"], pspecs)
    assert jgeo == pgeo and pgeo[0] == 4 and pgeo[2] == 3
    for js_, ps_ in zip(jspecs, pspecs):
        jst, jtopo, jopts = JCompiler.materialize(rig["js"], rig["jt"], js_,
                                                  *jgeo)
        pst, ptopo, popts = C.materialize(rig["ps"], rig["pt"], ps_, *pgeo)
        _state_equal(jst, pst, ps_.name)
        _topology_equal(jtopo, ptopo, ps_.name)
        assert popts.requested_destination_broker_ids == \
            jopts.requested_destination_broker_ids
        # the variant owns its tensors: the base model is untouched
        assert all(getattr(pst, f).data_ptr()
                   != getattr(rig["ps"], f).data_ptr() for f in STATE_FIELDS)


def test_compile_batch_matches_reference(rig):
    """A batch mixing broker counts: every lane at the padded geometry,
    each context field for field, one table width, the shared
    partition rows; slices and re-widening keep the lanes."""
    jb = JCompiler.compile_batch(rig["js"], rig["jt"],
                                 _specs(JSpec, JAdd)[:3])
    pb = C.compile_batch(rig["ps"], rig["pt"],
                         _specs(ScenarioSpec, BrokerAdd)[:3])
    assert pb.num_brokers == jb.num_brokers == 4
    assert np.array_equal(pb.partition_rows, jb.partition_rows)
    for i in range(3):
        _state_equal(jb.states[i], pb.states[i], f"lane {i}")
        _topology_equal(jb.topologies[i], pb.topologies[i], f"lane {i}")
        for f in CONTEXT_FIELDS:
            a = np.asarray(getattr(jb.contexts[i], f))
            b = getattr(pb.contexts[i], f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, f)
        for f in CONTEXT_STATIC:
            assert getattr(jb.contexts[i], f) == \
                getattr(pb.contexts[i], f), (i, f)
        assert np.array_equal(pb.rows_of(i), jb.rows_of(i))
    half = pb.slice(1, None)
    assert [s.name for s in half.specs] == ["grow", "doomed"]
    assert half.states[0] is pb.states[1]
    wide = pb.with_table_slots(64)
    assert {c.table_slots for c in wide.contexts} == {64}


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_engine_matches_reference(both):
    jres, pres = both
    assert [o.spec.name for o in pres.outcomes] == \
        [s.name for s in _specs(ScenarioSpec, BrokerAdd)]
    for j, p in zip(jres.outcomes, pres.outcomes):
        assert_same_outcome(j, p)
    assert pres.batch_sizes == jres.batch_sizes == [3, 1]
    assert pres.rung == jres.rung == "FUSED"
    assert pres.oom_halvings == jres.oom_halvings == 0


def test_heterogeneous_lanes_see_their_brokers(both):
    """The base lane, padded to the batch's 4 brokers, counts its 3; the
    grown lane 4, and moves only onto the added broker."""
    _, pres = both
    base, grow = pres.outcome(BASE_SCENARIO_NAME), pres.outcome("grow")
    assert int(base.stats_after.num_alive_brokers) == 3
    assert int(grow.stats_after.num_alive_brokers) == 4
    assert grow.num_replica_moves > 0
    assert all(set(r.broker_id for r in p.new_replicas)
               - set(r.broker_id for r in p.old_replicas) <= {9}
               for p in grow.proposals)


def test_base_lane_equals_the_single_solve(rig, both):
    """The base lane at the padded geometry equals the port's single
    solve of the unpadded model: dead rows weigh nothing."""
    _, pres = both
    single = rig["popt"].optimizations(rig["ps"], rig["pt"],
                                       check_sanity=False, device="cpu")
    base = pres.outcome(BASE_SCENARIO_NAME)
    assert base.violated_broker_counts == single.violated_broker_counts
    assert base.rounds_by_goal == single.rounds_by_goal
    assert _proposal_keys(base.proposals) == \
        _proposal_keys(single.proposals)
    for f in ("util_avg", "util_std", "util_max", "replica_count_std",
              "leader_count_std"):
        assert torch.equal(getattr(base.stats_after, f),
                           getattr(single.stats_after, f)), f


def test_goal_override_opens_its_own_sub_batch(both):
    jres, pres = both
    rack = pres.outcome("rack-only")
    assert set(rack.violated_broker_counts) == {"RackAwareGoal"}
    assert set(pres.outcome(BASE_SCENARIO_NAME).violated_broker_counts) \
        == set(SCENARIO_GOALS)
    assert_same_outcome(jres.outcome("rack-only"), rack)


def test_doomed_scenario_reported_infeasible(both):
    _, pres = both
    bad = pres.outcome("doomed")
    assert not bad.feasible and "RackAwareGoal" in bad.reason
    assert bad.proposals == []
    assert pres.outcome(BASE_SCENARIO_NAME).feasible
    assert R.rank(pres.outcomes)[-1].spec.name == "doomed"


@pytest.mark.parametrize("verbose", [False, True])
def test_batch_report_matches_reference(both, verbose):
    jres, pres = both
    want = JReport.batch_report(jres, verbose=verbose)
    got = R.batch_report(pres, verbose=verbose)
    for doc in (want, got):
        for k in TIMING:
            doc["batch"].pop(k)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


def test_movement_metrics_match_reference(rig, both):
    """The lanes' movement epilogue against the reference's on the same
    initial and final placements."""
    import jax.numpy as jnp
    from cruise_control_tpu.model.state import ClusterState as JState
    _, pres = both
    batch = C.compile_batch(rig["ps"], rig["pt"],
                            _specs(ScenarioSpec, BrokerAdd)[:1])
    initial = batch.states[0]
    lane = own_copy(initial)
    run = rig["popt"]._pipeline(lane, lane, batch.contexts[0],
                                fault_site=None, raise_verdicts=False)

    def jstate(s):
        return JState(**{f: jnp.asarray(getattr(s, f).numpy())
                         for f in STATE_FIELDS},
                      num_racks=s.num_racks, num_hosts=s.num_hosts,
                      num_topics=s.num_topics)
    want = JEngineModule._movement_metrics(jstate(initial),
                                           jstate(run.state))
    got = E._movement_metrics(initial, run.state)
    assert got == (int(want[0]), int(want[1]), float(want[2]))
    base = pres.outcome(BASE_SCENARIO_NAME)
    assert got == (base.num_replica_moves, base.num_leadership_moves,
                   base.data_to_move)


def _fresh_engine(rig):
    return ScenarioEngine(lambda names: rig["popt"], BalancingConstraint(),
                          device="cpu")


def _oom(site):
    return torch.cuda.OutOfMemoryError("CUDA out of memory: scenario batch")


def test_oom_halving_retry(rig, monkeypatch):
    """An out-of-memory failure of the first batch halves it and solves
    both halves, each materialized again at the whole batch's geometry
    and table width; the ladder does not descend, and the outcomes are
    the unhalved batch's."""
    engine = _fresh_engine(rig)
    specs = [ScenarioSpec(name=f"g{i}", load_scale={"disk": 1.0 + 0.1 * i})
             for i in range(3)] + [ScenarioSpec(
                 name="grow", add_brokers=(BrokerAdd(9, rack="C"),))]
    compiled = []
    real = E.compile_batch

    def compile_batch(*args, **kwargs):
        batch = real(*args, **kwargs)
        compiled.append((len(batch.specs), batch.num_brokers,
                         batch.contexts[0].table_slots,
                         tuple(s.num_brokers for s in batch.states)))
        return batch
    monkeypatch.setattr(E, "compile_batch", compile_batch)
    plan = faults.FaultPlan().fail_nth("scenario.execute", 1,
                                       exc_factory=_oom)
    with faults.injected(plan):
        res = engine.evaluate(rig["ps"], rig["pt"], specs)
    assert res.oom_halvings == 1 and engine.total_oom_halvings == 1
    assert res.batch_sizes == [2, 2]
    assert all(o.feasible and o.rung == "FUSED" for o in res.outcomes)
    assert engine.ladder.rung is SolverRung.FUSED
    # the whole batch, then each half at its geometry (4 brokers: the
    # hypothetical one of the second half pads the first's lanes too)
    assert [c[0] for c in compiled] == [4, 2, 2]
    assert {c[1:3] for c in compiled} == {compiled[0][1:3]}
    assert all(set(c[3]) == {4} for c in compiled)
    whole = engine.evaluate(rig["ps"], rig["pt"], specs)
    assert whole.batch_sizes == [4]
    for a, b in zip(whole.outcomes, res.outcomes):
        assert_same_outcome(a, b)


def test_oom_at_batch_of_one_descends(rig):
    """An out-of-memory batch of one cannot halve: the engine's ladder
    descends to the per-scenario EAGER solve, which serves it; a later
    batch probes back to FUSED."""
    engine = _fresh_engine(rig)
    plan = faults.FaultPlan().fail_always(
        "scenario.execute",
        exc_factory=lambda site: torch.cuda.OutOfMemoryError(
            "CUDA out of memory"))
    with faults.injected(plan):
        res = engine.evaluate(rig["ps"], rig["pt"],
                              [ScenarioSpec(name="solo")])
    out = res.outcomes[0]
    assert out.feasible and out.rung == "EAGER"
    assert engine.ladder.rung is SolverRung.EAGER
    assert engine.total_descents == 1 and res.batch_sizes == [1]
    eager = rig["popt"].optimizations(rig["ps"], rig["pt"],
                                      check_sanity=False, eager_driver=True,
                                      device="cpu")
    assert _proposal_keys(out.proposals) == _proposal_keys(eager.proposals)
    again = engine.evaluate(rig["ps"], rig["pt"],
                            [ScenarioSpec(name="heal")])
    assert again.outcomes[0].rung == "FUSED"
    assert engine.ladder.rung is SolverRung.FUSED


def test_table_overflow_rewidens(rig, both, monkeypatch):
    """A lane that overfills the broker table makes the whole chunk run
    again at the wider width; the outcomes are the plain run's."""
    engine = _fresh_engine(rig)
    specs = _specs(ScenarioSpec, BrokerAdd)[:3]
    runs = []
    real = GoalOptimizer._pipeline

    def pipeline(self, *args, **kwargs):
        runs.append(kwargs.get("pre_only", False))
        return real(self, *args, **kwargs)
    monkeypatch.setattr(GoalOptimizer, "_pipeline", pipeline)
    res = E.ScenarioBatchResult(outcomes=[])
    outs = engine._solve_chunk(rig["popt"], rig["ps"], rig["pt"], specs,
                               None, True, res, table_override=1)
    assert res.batch_sizes == [3]
    # the first run stopped the lanes after the first at their
    # pre-program, then every lane ran whole at the wider width
    assert runs == [False, True, True, False, False, False]
    _, pres = both
    for got, want in zip(outs, pres.outcomes[:3]):
        assert got.rounds_by_goal == want.rounds_by_goal
        assert got.violated_broker_counts == want.violated_broker_counts
        assert _proposal_keys(got.proposals) == \
            _proposal_keys(want.proposals)


def _no_host_rung(monkeypatch):
    def host(*args, **kwargs):
        raise AssertionError("served from the host rung")
    monkeypatch.setattr("cruise_control_tpu_torch.model.cpu_model."
                        "host_fallback_solve", host)


def test_kernel_build_failure_raises_through(rig, monkeypatch):
    """A kernel that fails to build is not ladder material: it raises
    out of the engine, which stays at FUSED."""
    engine = _fresh_engine(rig)
    _no_host_rung(monkeypatch)

    def broken(*args, **kwargs):
        raise cuda_kernels.KernelBuildError("nvcc failed for row_topk.cu")

    monkeypatch.setattr(rig["popt"], "_pipeline", broken)
    with pytest.raises(cuda_kernels.KernelBuildError):
        engine.evaluate(rig["ps"], rig["pt"], [ScenarioSpec(name="k")])
    assert engine.ladder.rung is SolverRung.FUSED
    assert engine.total_descents == 0


def _launch_failure(*args, **kwargs):
    """What a wrapper raises when its kernel's C entry returns a CUDA
    error."""
    cuda_kernels._raise_on(700, "row_topk")


def _contract_failure(*args, **kwargs):
    raise cuda_kernels.KernelContractError("table must be a CUDA tensor")


def _bug(*args, **kwargs):
    raise RuntimeError("a bug in the port")


#: what each failure raises out of the engine
RAISED = {_launch_failure: cuda_kernels.KernelLaunchError,
          _contract_failure: cuda_kernels.KernelContractError,
          _bug: RuntimeError}


@pytest.mark.parametrize("broken", [_launch_failure, _contract_failure,
                                    _bug],
                         ids=["kernel launch", "kernel contract",
                              "any other error"])
@pytest.mark.parametrize("rung", ["FUSED", "EAGER"])
def test_launch_failure_raises_through(rig, monkeypatch, broken, rung):
    """A kernel that fails to launch, a wrapper called outside its
    contract or any other error raises out of the engine, at FUSED and
    at EAGER (after an injected fault sent the batch there): no lane is
    served from a lower rung, and no solve from the host rung."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "card")
    engine = _fresh_engine(rig)
    _no_host_rung(monkeypatch)
    if rung == "FUSED":
        monkeypatch.setattr(rig["popt"], "_pipeline", broken)
        plan = faults.FaultPlan()
    else:
        monkeypatch.setattr(rig["popt"], "optimizations", broken)
        plan = faults.FaultPlan().fail_nth("scenario.execute", 1)
    with faults.injected(plan):
        with pytest.raises(RAISED[broken]) as raised:
            engine.evaluate(rig["ps"], rig["pt"],
                            [ScenarioSpec(name="a"),
                             ScenarioSpec(name="b",
                                          load_scale={"disk": 1.2})])
    assert not isinstance(raised.value, faults.FaultError)
    assert engine.ladder.rung.name == rung
    assert engine.total_descents == (rung == "EAGER")


def test_reference_counts_leadership_moves_differently_by_rung():
    """JAX only.  The reference's FUSED lane counts leadership-only moves
    a replica (`_movement_metrics`: a replica that became leader without
    moving), its EAGER rung a proposal (`OptimizerResult.
    num_leadership_movements`: a partition whose leader changed and whose
    replica set did not).  A partition that moves one replica and hands
    its leadership to a replica that stays counts one on the FUSED lane
    and none on the EAGER rung, so a lane's leadership count is not its
    EAGER twin's; the data to move is one quantity summed two ways."""
    from types import SimpleNamespace

    from cruise_control_tpu.analyzer.context import \
        partition_replica_index as j_rows
    from cruise_control_tpu.analyzer.optimizer import \
        OptimizerResult as JResult
    from cruise_control_tpu.analyzer.proposals import diff_proposals
    js, jt = fixtures.small_cluster()
    # partition 0: replica 0 (broker 0, the leader) and replica 1
    # (broker 1); replica 0 moves to broker 2, replica 1 takes the lead
    assert np.asarray(js.replica_partition)[:2].tolist() == [0, 0]
    assert np.asarray(js.replica_is_leader)[:2].tolist() == [True, False]
    final = js.replace(
        replica_broker=js.replica_broker.at[0].set(2),
        replica_is_leader=js.replica_is_leader.at[0].set(False)
        .at[1].set(True))
    moves, leaders, data = JEngineModule._movement_metrics(js, final)
    proposals = diff_proposals(js, final, jt, j_rows(js))
    eager_count = JResult.num_leadership_movements.fget(
        SimpleNamespace(proposals=proposals))
    assert (int(moves), int(leaders)) == (1, 1)
    assert len(proposals) == 1 and eager_count == 0
    assert float(data) == sum(p.inter_broker_data_to_move
                              for p in proposals)


def _leadership_only(proposals) -> int:
    """The EAGER rung's leadership count (`OptimizerResult.
    num_leadership_movements`) of a FUSED lane's proposals."""
    return sum(1 for p in proposals
               if p.has_leader_action and not p.has_replica_action)


def test_eager_outcomes_equal_their_fused_twins(rig):
    """A batch whose specs add no broker has each spec's own geometry,
    so its EAGER rung (one eager-driver solve a spec) must give each
    lane's FUSED outcome: verdicts, instruments, proposals and the stats
    bit for bit.  The leadership count is held to the FUSED proposals'
    count as the EAGER rung counts it (see the test above), and the data
    to move to 1e-6 relative (one quantity, summed two ways)."""
    specs = [ScenarioSpec(name=BASE_SCENARIO_NAME),
             ScenarioSpec(name="disk", load_scale={"disk": 1.2}),
             ScenarioSpec(name="hot", load_scale={"nw_in": 1.5,
                                                  "cpu": 1.3})]
    fused = _fresh_engine(rig).evaluate(rig["ps"], rig["pt"], specs)
    engine = _fresh_engine(rig)
    with faults.injected(faults.FaultPlan().fail_nth("scenario.execute",
                                                     1)):
        eager = engine.evaluate(rig["ps"], rig["pt"], specs)
    assert engine.total_descents == 1
    assert [o.rung for o in fused.outcomes] == ["FUSED"] * 3
    assert [o.rung for o in eager.outcomes] == ["EAGER"] * 3
    for f, e in zip(fused.outcomes, eager.outcomes):
        assert f.feasible and e.feasible, f.spec.name
        for field in ("violated_goals_before", "violated_goals_after",
                      "violated_broker_counts", "entry_broker_counts",
                      "rounds_by_goal", "converged_at_by_goal",
                      "num_replica_moves", "balancedness"):
            assert getattr(f, field) == getattr(e, field), \
                (f.spec.name, field)
        assert _proposal_keys(f.proposals) == _proposal_keys(e.proposals)
        assert e.num_leadership_moves == _leadership_only(f.proposals)
        assert e.data_to_move == pytest.approx(f.data_to_move, rel=1e-6)
        for which in ("stats_before", "stats_after"):
            a, b = getattr(f, which), getattr(e, which)
            for name, v in vars(a).items():
                assert torch.equal(v, getattr(b, name)), (which, name)
