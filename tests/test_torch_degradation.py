"""The PyTorch port's degradation ladder and its host rung
(cruise_control_tpu_torch/analyzer/degradation.py, model/cpu_model.py
and the facade's `_solve`) against the JAX reference, on the CPU.

* `BackoffPolicy`, `CircuitBreaker` and `DegradationLadder` driven
  through the same scripted sequences as the reference's classes, on one
  clock: every state, rung and JSON view equal after every step;
* `classify_failure` and `ladder_material` on the port's own errors
  (injected faults by site, the card's out-of-memory error, invalid
  input, the kernels' build, launch and contract errors);
* `host_fallback_solve` against the reference's on a cluster with two
  dead brokers and on one with a broken logdir (and with operator
  exclusions): proposals, final placement and stats bit for bit, and the
  same errors when nothing can be placed or the model is invalid;
* the facade's descent FUSED -> EAGER -> CPU under injected faults at
  `optimizer.execute`, beside the reference's facade on the same
  9-broker cluster with a dead broker: the same calls at the fault site,
  the CPU rung's answer, retries, descents, the store invalidated and
  the trace marked degraded; then the breaker's pin and the probes back
  up, one rung a request;
* what is not ladder material raises at once and moves nothing, with
  no EAGER or host-rung solve: a solver verdict, an invalid model, a
  kernel library that fails to build or to load, a kernel that fails to
  launch, a wrapper called outside its contract and any other error;
  the card's out-of-memory error descends as an injected fault does.
"""
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import degradation as JD
from cruise_control_tpu.analyzer.context import \
    OptimizationOptions as JOptions
from cruise_control_tpu.analyzer.goals.base import \
    OptimizationFailure as JFailure
from cruise_control_tpu.model import state as JS
from cruise_control_tpu.model.cpu_model import \
    host_fallback_solve as j_fallback
from cruise_control_tpu.testing.random_cluster import \
    RandomClusterSpec as JSpec
from cruise_control_tpu.testing.random_cluster import \
    random_cluster as j_random_cluster
from cruise_control_tpu.utils import faults as jfaults
from cruise_control_tpu_torch import cuda_kernels
from cruise_control_tpu_torch import facade as F
from cruise_control_tpu_torch.analyzer import degradation as D
from cruise_control_tpu_torch.analyzer import optimizer as PO
from cruise_control_tpu_torch.analyzer.context import OptimizationOptions
from cruise_control_tpu_torch.analyzer.goals.base import OptimizationFailure
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model.cpu_model import host_fallback_solve
from cruise_control_tpu_torch.obs import trace as obs_trace
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)
from cruise_control_tpu_torch.utils import faults
from test_torch_facade import INCR_GOALS, make_pair, proposal_keys
from test_torch_monitor import port_snapshot

SPEC = dict(num_brokers=12, num_partitions=90, replication_factor=3,
            num_racks=3, num_topics=5, seed=11, skew_fraction=0.2)
JBOD_SPEC = dict(SPEC, jbod_disks=3, skew_fraction=0.0)


# ---------------------------------------------------------------------------
# backoff, breaker, ladder
# ---------------------------------------------------------------------------

def test_backoff_delays_match_reference():
    for kw in ({}, dict(base_s=0.5, max_s=3.0, jitter=0.5, seed=7),
               dict(base_s=2.0, max_s=5.0, jitter=0.0, seed=1)):
        want, got = JD.BackoffPolicy(**kw).delays(), \
            D.BackoffPolicy(**kw).delays()
        assert [next(got) for _ in range(8)] == \
            [next(want) for _ in range(8)]


# each step: (op, arg); "t" advances the shared clock
BREAKER_SCRIPT = (
    ("fail", None), ("fail", None), ("t", 10.0), ("fail", None),
    ("t", 20.0), ("fail", None), ("t", 31.0), ("success", None),
    ("fail", None), ("fail", None), ("fail", None), ("t", 60.0),
    ("fail", None), ("t", 5.0), ("success", None))


def test_breaker_transitions_match_reference():
    clock = {"now": 100.0}
    j = JD.CircuitBreaker(3, 30.0, time_fn=lambda: clock["now"])
    p = D.CircuitBreaker(3, 30.0, time_fn=lambda: clock["now"])
    for op, arg in BREAKER_SCRIPT:
        if op == "t":
            clock["now"] += arg
        elif op == "fail":
            assert p.record_failure() == j.record_failure()
        else:
            j.record_success()
            p.record_success()
        assert p.state.value == j.state.value
        assert p.consecutive_failures == j.consecutive_failures
        assert p.cooldown_remaining_s() == j.cooldown_remaining_s()
        assert p.to_json() == j.to_json()


LADDER_SCRIPT = (
    ("entry",), ("failure", "FUSED"), ("descend", "FUSED"), ("entry",),
    ("failure", "EAGER"), ("failure", "EAGER"), ("descend", "EAGER"),
    ("entry",), ("success", "CPU"), ("t", 50.0), ("entry",),
    ("success", "EAGER"), ("entry",), ("success", "FUSED"), ("entry",),
    ("descend", "CPU"), ("failure", "FUSED"), ("descend", "FUSED"),
    ("descend", "FUSED"), ("success", "FUSED"))


def test_ladder_transitions_match_reference():
    clock = {"now": 0.0}
    j = JD.DegradationLadder(JD.CircuitBreaker(
        2, 40.0, time_fn=lambda: clock["now"]))
    p = D.DegradationLadder(D.CircuitBreaker(
        2, 40.0, time_fn=lambda: clock["now"]))
    for step in LADDER_SCRIPT:
        op = step[0]
        if op == "t":
            clock["now"] += step[1]
        elif op == "entry":
            assert p.entry_rung().name == j.entry_rung().name
        elif op == "failure":
            assert p.on_failure(D.SolverRung[step[1]]) == \
                j.on_failure(JD.SolverRung[step[1]])
        elif op == "descend":
            want = j.descend(JD.SolverRung[step[1]])
            got = p.descend(D.SolverRung[step[1]])
            assert (None if got is None else got.name) == \
                (None if want is None else want.name)
        else:
            j.on_success(JD.SolverRung[step[1]])
            p.on_success(D.SolverRung[step[1]])
        assert p.rung.name == j.rung.name
        assert p.to_json() == j.to_json()
    assert [(r.name, int(r)) for r in D.SolverRung] == \
        [(r.name, int(r)) for r in JD.SolverRung]


def test_classify_failure_on_the_ports_errors():
    K = D.FailureKind
    cases = [
        (faults.FaultError("optimizer.compile"),
         jfaults.FaultError("optimizer.compile"), K.COMPILE),
        (faults.FaultError("optimizer.execute"),
         jfaults.FaultError("optimizer.execute"), K.RUNTIME),
        (faults.FaultError("scenario.execute"),
         jfaults.FaultError("scenario.execute"), K.RUNTIME),
        (D.InvalidModelInputError("nan"), JD.InvalidModelInputError("nan"),
         K.INVALID_INPUT),
        (ValueError("loss is NaN"), ValueError("loss is NaN"), K.RUNTIME),
    ]
    for port_exc, ref_exc, kind in cases:
        assert D.classify_failure(port_exc) is kind
        assert JD.classify_failure(ref_exc).value == kind.value
    # the card's out-of-memory error, as the reference reads
    # RESOURCE_EXHAUSTED
    assert D.classify_failure(torch.cuda.OutOfMemoryError(
        "CUDA out of memory")) is K.RUNTIME
    assert JD.classify_failure(RuntimeError(
        "RESOURCE_EXHAUSTED: out of memory")) is JD.FailureKind.RUNTIME
    # the port reads its own types only: no text heuristic
    assert D.classify_failure(RuntimeError(
        "nvrtc: compilation failed")) is K.RUNTIME
    assert set(K.__members__) == {"INVALID_INPUT", "COMPILE", "RUNTIME"}
    # only an injected fault and the card's out-of-memory error descend
    for exc in (faults.FaultError("optimizer.execute"),
                torch.cuda.OutOfMemoryError("CUDA out of memory")):
        assert D.ladder_material(exc)
    for exc in (D.InvalidModelInputError("nan"),
                OptimizationFailure("hard goal"),
                cuda_kernels.KernelBuildError("nvcc failed"),
                cuda_kernels.KernelLaunchError("CUDA kernel row_topk failed"),
                cuda_kernels.KernelContractError("table must be int32"),
                RuntimeError("a bug"), ValueError("a bug")):
        assert not D.ladder_material(exc), exc
    # a wrapper's contract error is still the ValueError or TypeError it
    # was
    assert issubclass(cuda_kernels.KernelContractError, ValueError)
    assert issubclass(cuda_kernels.KernelContractError, TypeError)
    # the port's old import paths still serve the moved classes
    assert F.SolverRung is D.SolverRung
    assert PO.InvalidModelInputError is D.InvalidModelInputError


# ---------------------------------------------------------------------------
# the host rung
# ---------------------------------------------------------------------------

def _pair(spec, mutate):
    js, jt = j_random_cluster(JSpec(**spec))
    ps, pt = random_cluster(RandomClusterSpec(**spec), device="cpu")
    return mutate(js, JS), jt, mutate(ps, S), pt


def _dead_brokers(state, module):
    for b in (1, 7):
        state = module.set_broker_state(state, b, alive=False)
    return state


def _broken_logdir(state, module):
    return module.mark_disk_dead(state, 4)


def _assert_same_fallback(jres, pres):
    for f in ("replica_broker", "replica_disk", "replica_offline",
              "replica_is_leader"):
        assert np.array_equal(np.asarray(getattr(jres.final_state, f)),
                              getattr(pres.final_state, f).numpy()), f
    assert proposal_keys(pres) == proposal_keys(jres)
    assert pres.rounds_by_goal == jres.rounds_by_goal
    for which in ("stats_before", "stats_after"):
        j, p = getattr(jres, which), getattr(pres, which)
        for f, v in vars(p).items():
            a = np.asarray(getattr(j, f))
            assert v.numpy().dtype == a.dtype, (which, f)
            assert np.array_equal(v.numpy().view(np.uint32)
                                  if a.dtype == np.float32 else v.numpy(),
                                  a.view(np.uint32)
                                  if a.dtype == np.float32 else a), \
                (which, f)
    assert pres.stats_by_goal == {} and pres.violated_goals_after == []


@pytest.mark.parametrize("mutate", [_dead_brokers, _broken_logdir],
                         ids=["dead brokers", "broken logdir"])
@pytest.mark.parametrize("excluded", [False, True],
                         ids=["no options", "exclusions"])
def test_host_fallback_matches_reference(mutate, excluded):
    spec = SPEC if mutate is _dead_brokers else JBOD_SPEC
    js, jt, ps, pt = _pair(spec, mutate)
    assert bool(S.self_healing_eligible(ps).any())
    jopt = popt = None
    if excluded:
        kw = dict(excluded_brokers_for_replica_move=frozenset({0, 3}),
                  requested_destination_broker_ids=frozenset(range(9)))
        jopt, popt = JOptions(**kw), OptimizationOptions(**kw)
    jres = j_fallback(js, jt, options=jopt, time_fn=lambda: 0.0)
    pres = host_fallback_solve(ps, pt, options=popt, time_fn=lambda: 0.0)
    _assert_same_fallback(jres, pres)
    assert pres.proposals and not bool(S.self_healing_eligible(
        pres.final_state).any())
    assert pres.final_state.device == ps.device


def test_host_fallback_errors_match_reference():
    js, jt, ps, pt = _pair(SPEC, _dead_brokers)
    only = dict(requested_destination_broker_ids=frozenset({1}))
    with pytest.raises(JFailure) as want:
        j_fallback(js, jt, options=JOptions(**only))
    with pytest.raises(OptimizationFailure) as got:
        host_fallback_solve(ps, pt, options=OptimizationOptions(**only))
    assert str(got.value) == str(want.value)
    bad = ps.replace(replica_base_load=ps.replica_base_load.clone())
    bad.replica_base_load[0, 0] = float("nan")
    with pytest.raises(D.InvalidModelInputError, match="NaN"):
        host_fallback_solve(bad, pt)


# ---------------------------------------------------------------------------
# the facade's ladder
# ---------------------------------------------------------------------------

def _pair_with_dead_broker():
    """The facades of tests/test_torch_facade.py (retry backoff on the
    simulated clock in both), broker 3 dead."""
    sim, jcc, pmon, pcc, clock = make_pair()

    pcc._sleep = lambda s: None
    sim.kill_broker(3)
    pmon.update_cluster(port_snapshot(
        jcc.load_monitor.metadata.refresh_metadata()))
    return sim, jcc, pmon, pcc, clock


def test_facade_descends_to_the_host_rung_like_the_reference():
    sim, jcc, pmon, pcc, clock = _pair_with_dead_broker()
    try:
        # a resident model: each descent below FUSED invalidates the
        # store (the EAGER attempt rebuilt and installed it again)
        for cc in (jcc, pcc):
            cc._model_for_solve()
        plan = lambda m: m.FaultPlan().fail_always("optimizer.execute")
        with jfaults.injected(plan(jfaults)) as jinj:
            jres = jcc.optimizations(ignore_proposal_cache=True)
        with obs_trace.solve_trace("test") as trace:
            with faults.injected(plan(faults)) as pinj:
                pres = pcc.optimizations(ignore_proposal_cache=True)
        # FUSED, its retry, EAGER, its retry: four calls, each failing
        assert pinj.call_count("optimizer.execute") == \
            jinj.call_count("optimizer.execute") == 4
        assert proposal_keys(pres) == proposal_keys(jres)
        _assert_same_fallback(jres, pres)
        assert pres.rounds_by_goal["__host_fallback__"] > 0
        meters = jcc.metrics.to_json()
        assert pcc.solver_descents == meters["solver-descents"]["count"] == 2
        assert pcc.solver_retries == meters["solver-retries"]["count"] == 2
        jl, pl = jcc.solver_ladder.to_json(), pcc.solver_ladder.to_json()
        # the breaker's remaining cooldown reads each package's own
        # sleeps on the shared clock
        for doc in (jl, pl):
            doc["breaker"].pop("cooldownRemainingS")
        assert pl == jl and pl["breaker"]["state"] == "OPEN"
        assert pcc.solver_ladder.rung is D.SolverRung.CPU
        assert pcc.last_solve_rung is D.SolverRung.CPU
        assert pcc.model_store.invalidations == \
            jcc._model_store.invalidations == 2
        assert trace.outcome == "degraded"
        root = trace.to_json()["root"]
        # the solve ran as a scheduler job: its queue wait, then its
        # dispatch, which holds the ladder's attempts and events
        assert [c["name"] for c in root["children"]] == \
            ["sched.queue-wait", "sched.dispatch"]
        dispatch = root["children"][1]
        assert [c["name"] for c in dispatch["children"]] == \
            ["solve.rung-attempt"] * 5
        events = [(e["name"], e.get("from_rung"), e.get("to_rung"))
                  for e in dispatch["events"]]
        assert [e for e in events if e[0] == "solve.descend"] == [
            ("solve.descend", "FUSED", "EAGER"),
            ("solve.descend", "EAGER", "CPU")]
        assert sum(e[0] == "solve.failure" for e in events) == 4
        # the breaker opened (four failures, threshold 3): the rung is
        # pinned, and no device solve is tried
        with faults.injected(plan(faults)) as pinj:
            pcc.optimizations(ignore_proposal_cache=True)
        assert pinj.call_count("optimizer.execute") == 0
        assert pcc.last_solve_rung is D.SolverRung.CPU
        assert pcc.last_solve_trace.outcome == "degraded"
        # the broker is back and the cooldown over: each request probes
        # one rung up
        sim.restart_broker(3)
        pmon.update_cluster(port_snapshot(
            jcc.load_monitor.metadata.refresh_metadata()))
        clock["now"] += pcc.solver_breaker.cooldown_s + 1.0
        pcc.optimizations(ignore_proposal_cache=True)
        assert pcc.last_solve_rung is D.SolverRung.EAGER
        assert pcc.last_solve_trace.outcome == "degraded"
        back = pcc.optimizations(ignore_proposal_cache=True)
        assert pcc.last_solve_rung is D.SolverRung.FUSED
        assert pcc.last_solve_trace.outcome == "ok"
        assert pcc.solver_ladder.rung is D.SolverRung.FUSED
        assert back.stats_by_goal and pcc.solver_descents == 2
    finally:
        jcc.shutdown()


def test_transient_fault_is_retried_on_its_rung():
    sim, jcc, pmon, pcc, clock = make_pair()
    jcc.shutdown()
    pcc._sleep = lambda s: None
    want = pcc.optimizations(ignore_proposal_cache=True)
    plan = faults.FaultPlan().fail_nth("optimizer.execute", 2)
    with faults.injected(plan):
        got = pcc.optimizations(ignore_proposal_cache=True)
    assert pcc.solver_retries == 1 and pcc.solver_descents == 0
    assert pcc.last_solve_rung is D.SolverRung.FUSED
    assert proposal_keys(got) == proposal_keys(want)


def _raising(monkeypatch, exc):
    """GoalOptimizer.optimizations raising `exc` (a callable: called),
    and no host-rung solve allowed; the device solves tried."""
    calls = []

    def solve(self, *args, **kwargs):
        calls.append(kwargs.get("eager_driver", False))
        if callable(exc) and not isinstance(exc, BaseException):
            exc()
        raise exc

    def host(*args, **kwargs):
        raise AssertionError("served from the host rung")
    monkeypatch.setattr(PO.GoalOptimizer, "optimizations", solve)
    monkeypatch.setattr("cruise_control_tpu_torch.model.cpu_model."
                        "host_fallback_solve", host)
    return calls


def _launch_failure():
    """What a wrapper raises when its kernel's C entry returns a CUDA
    error (`_raise_on`)."""
    cuda_kernels._raise_on(700, "row_topk")


@pytest.mark.parametrize("exc", [
    OptimizationFailure("hard goal RackAwareGoal still violated"),
    D.InvalidModelInputError("NaN loads"),
    cuda_kernels.KernelBuildError("nvcc failed for row_topk.cu"),
    _launch_failure,
    cuda_kernels.KernelContractError("table must be a CUDA tensor"),
    RuntimeError("a bug in the port")],
    ids=["solver verdict", "invalid input", "kernel build", "kernel launch",
         "kernel contract", "any other error"])
def test_not_ladder_material_raises_at_once(monkeypatch, exc):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "card")
    sim, jcc, pmon, pcc, clock = make_pair()
    jcc.shutdown()
    calls = _raising(monkeypatch, exc)
    sleeps = []
    pcc._sleep = sleeps.append
    want = (cuda_kernels.KernelLaunchError if exc is _launch_failure
            else type(exc))
    with pytest.raises(want):
        pcc.optimizations(ignore_proposal_cache=True)
    # one FUSED attempt, no retry, no EAGER solve, no host rung
    assert calls == [False]
    assert pcc.solver_ladder.rung is D.SolverRung.FUSED
    assert pcc.solver_descents == pcc.solver_retries == 0 and not sleeps
    assert pcc.solver_breaker.consecutive_failures == 0
    assert pcc.last_solve_trace.outcome != "degraded"


def test_out_of_memory_descends_like_a_fault(monkeypatch):
    """The card's out-of-memory error is ladder material: FUSED and
    EAGER each fail twice, and the host rung serves the request."""
    sim, jcc, pmon, pcc, clock = _pair_with_dead_broker()
    jcc.shutdown()
    calls = []

    def solve(self, *args, **kwargs):
        calls.append(kwargs.get("eager_driver", False))
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    monkeypatch.setattr(PO.GoalOptimizer, "optimizations", solve)
    res = pcc.optimizations(ignore_proposal_cache=True)
    assert calls == [False, False, True, True]
    assert pcc.last_solve_rung is D.SolverRung.CPU
    assert pcc.solver_descents == 2 and pcc.solver_retries == 2
    assert pcc.last_solve_trace.outcome == "degraded"
    assert res.rounds_by_goal["__host_fallback__"] > 0


#: a stand-in for nvcc: "build" fails to compile, "load" writes a file
#: that is no shared library wherever it is asked for an output
FAKE_NVCC = {
    "build": "#!/bin/sh\necho 'error: broken kernel' >&2\nexit 1\n",
    "load": ("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
             "  if [ \"$1\" = -o ]; then echo junk > \"$2\"; fi\n"
             "  shift\ndone\n"),
}


@pytest.mark.parametrize("stage", list(FAKE_NVCC))
def test_a_kernel_library_that_fails_to_build_raises_through(
        monkeypatch, tmp_path, stage):
    """The build itself failing (nvcc exits 1) or the library it made
    failing to load: the error of `cuda_kernels.build()` is a
    KernelBuildError, and the ladder raises it instead of serving the
    request from the host rung."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC[stage])
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_kernels, "_LIB", None)
    monkeypatch.setattr(cuda_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_kernels, "_nvcc", lambda: str(nvcc))
    real = PO.GoalOptimizer.optimizations
    host = []

    def building(self, *args, **kwargs):
        cuda_kernels.build()
        return real(self, *args, **kwargs)
    monkeypatch.setattr(PO.GoalOptimizer, "optimizations", building)
    monkeypatch.setattr("cruise_control_tpu_torch.model.cpu_model."
                        "host_fallback_solve", host.append)
    sim, jcc, pmon, pcc, clock = make_pair()
    jcc.shutdown()
    match = "nvcc failed" if stage == "build" else "failed to load"
    with pytest.raises(cuda_kernels.KernelBuildError, match=match):
        pcc.optimizations(ignore_proposal_cache=True)
    assert pcc.solver_ladder.rung is D.SolverRung.FUSED
    assert pcc.solver_descents == 0 and not host
    assert cuda_kernels._LIB is None


def test_ladder_off_raises_the_first_failure():
    sim, jcc, pmon, pcc, clock = make_pair(solver_degradation_enabled=False)
    jcc.shutdown()
    with faults.injected(faults.FaultPlan().fail_always(
            "optimizer.execute")):
        with pytest.raises(faults.FaultError):
            pcc.optimizations(ignore_proposal_cache=True)
    assert pcc.solver_descents == 0
    assert pcc.solver_ladder.rung is D.SolverRung.FUSED
    assert INCR_GOALS == [g.name for g in pcc.goal_optimizer.goals]
