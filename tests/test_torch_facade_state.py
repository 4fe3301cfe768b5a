"""The port's facade behind its device-time scheduler, its background
precompute and its observability surface (cruise_control_tpu_torch/
facade.py), on the CPU.

The facades are built on the reference's facade-test stack
(`tests/test_torch_facade_sampled.py` `make_stack`: 4 brokers, one topic
of 12 partitions, the sampled `LoadMonitor` on a virtual clock).

- An interactive request preempts an in-flight precompute at its first
  goal-segment checkpoint: the order is pre-solve, interactive solve,
  pre-solve again, pre-complete, and both results equal their
  unpreempted twins on a facade without a scheduler.
- The scheduler on and off give byte-identical results for every
  request.
- Every `GoalOptimizer.optimizations`, `ScenarioEngine.evaluate` and
  `host_fallback_solve` call of the facade runs under the scheduler's
  gateway (`sched_runtime.under_gateway()`), the port's stand-in for the
  reference's lint rule.
- `precompute_wedged`, the precompute's statuses and its capped backoff.
- Two compatible what-if sweeps fold into one engine batch whose base is
  solved once, each split outcome equal to the sweep evaluated alone.
- `state()` equals the reference facade's on the shared substates after
  the same requests; naming `anomaly_detector` or `portfolio` raises.
"""
import json
import threading
import time as _real_time

import pytest

from cruise_control_tpu_torch import facade as F
from cruise_control_tpu_torch.analyzer.context import OptimizationOptions
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.cluster.simulated import \
    SimulatedCluster as PSim
from cruise_control_tpu_torch.cluster.types import TopicPartition as PTP
from cruise_control_tpu_torch.model import cpu_model
from cruise_control_tpu_torch.model.state import STATE_FIELDS
from cruise_control_tpu_torch.monitor.sampling.sampler import \
    SimulatedClusterSampler as PSampler
from cruise_control_tpu_torch.obs import export as obs_export
from cruise_control_tpu_torch.scenario.engine import ScenarioEngine
from cruise_control_tpu_torch.scenario.spec import ScenarioSpec
from cruise_control_tpu_torch.sched import runtime as sched_runtime
from cruise_control_tpu_torch.sched.policy import SchedulerClass
from cruise_control_tpu_torch.sched.scheduler import SolveJob
from cruise_control_tpu_torch.utils import faults
from test_torch_facade import proposal_keys
from test_torch_facade_sampled import (FACADE_TEST_GOALS, MONITOR_KWARGS,
                                       feed_samples, make_stack, result_key)

#: the interactive request of the preemption: self-healing exclusions
HEAL = OptimizationOptions(excluded_brokers_for_leadership=frozenset({0}),
                           is_triggered_by_goal_violation=True)


def port_stack(rounds=8, precompute=False, **settings):
    """The port half of `make_stack`, with facade settings: (sim, facade,
    clock), sampled `rounds` times; with `precompute`, the precompute
    thread started."""
    sim = PSim()
    clock = {"now": 10_000.0}
    for b in range(4):
        sim.add_broker(b, rack=f"rack{b % 2}")
    sim.create_topic("t0", [[i % 2 for i in range(2)] for _ in range(12)],
                     size_bytes=1e4)
    for p in range(12):
        sim.set_partition_load(PTP("t0", p), leader_cpu=2.0, nw_in=100.0,
                               nw_out=300.0)
    cc = F.CruiseControl(
        sim, PSampler(sim), device="cpu", time_fn=lambda: clock["now"],
        sleep_fn=lambda s: (sim.advance(s),
                            clock.__setitem__("now", clock["now"] + s)),
        monitor_kwargs=dict(MONITOR_KWARGS),
        executor_kwargs=dict(progress_check_interval_s=1.0),
        goal_names=list(FACADE_TEST_GOALS), **settings)
    cc.start_up(do_sampling=False, start_proposal_precompute=precompute)
    if rounds:
        feed_samples(cc, clock, rounds)
    return sim, cc, clock


def _wait(pred, timeout=60.0):
    deadline = _real_time.monotonic() + timeout
    while not pred():
        assert _real_time.monotonic() < deadline, "timed out"
        _real_time.sleep(0.005)


def _state_key(state) -> tuple:
    return tuple(getattr(state, f).numpy().tobytes() for f in STATE_FIELDS)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------
def test_interactive_request_preempts_the_precompute(monkeypatch):
    _, twin, _ = port_stack(scheduler_enabled=False)
    _, cc, _ = port_stack()
    try:
        want_pre = result_key(twin.optimizations(
            _scheduler_class=SchedulerClass.PRECOMPUTE))
        want_heal = result_key(twin.rebalance(options=HEAL)
                               .optimizer_result)
        order, lock = [], threading.Lock()
        blocked, queued = threading.Event(), threading.Event()
        real_checkpoint = sched_runtime.segment_checkpoint
        segments = []

        def checkpoint():
            # the precompute (the one preemptible job) parks at its first
            # segment boundary until the interactive request is queued
            if getattr(sched_runtime._TLS, "preempt_check", None) is not None:
                segments.append(threading.current_thread().name)
                if len(segments) == 1:
                    blocked.set()
                    assert queued.wait(60.0)
            real_checkpoint()
        monkeypatch.setattr(sched_runtime, "segment_checkpoint", checkpoint)
        real_solve = cc.goal_optimizer.optimizations

        def noted(state, topo, options=None, **kw):
            heal = options is not None and \
                options.is_triggered_by_goal_violation
            with lock:
                order.append("interactive-solve" if heal else "pre-solve")
            result = real_solve(state, topo, options, **kw)
            if not heal:
                with lock:
                    order.append("pre-complete")
            return result
        cc.goal_optimizer.optimizations = noted
        resident = []
        out = {}

        def precompute():
            out["status"] = cc._precompute_once_status()
        pre = threading.Thread(target=precompute)
        pre.start()
        assert blocked.wait(60.0)
        resident.append(_state_key(cc.model_store._state))

        def interactive():
            out["heal"] = cc.rebalance(options=HEAL)
        heal = threading.Thread(target=interactive)
        heal.start()
        _wait(lambda: cc.solve_scheduler.queue.depth() >= 1)
        queued.set()
        heal.join(120.0)
        pre.join(120.0)
        assert out["status"] == "computed"
        assert order == ["pre-solve", "interactive-solve", "pre-solve",
                         "pre-complete"]
        assert set(segments) == {"solve-scheduler"}
        stats = cc.solve_scheduler.stats
        assert stats.preemptions == 1 and stats.failed == 0
        sensors = cc.metrics.to_json()
        assert sensors["sched-preemptions"]["count"] == 1
        assert result_key(out["heal"].optimizer_result) == want_heal
        cached = cc.optimizations()
        assert result_key(cached) == want_pre
        assert cc._warm_seed[0] is cached.final_state
        # the abandoned attempt committed into its own copy only
        assert _state_key(cc.model_store._state) == resident[0] == \
            _state_key(twin.model_store._state)
        trace = cc.last_solve_trace
        assert trace is not None
    finally:
        cc.shutdown()
        twin.shutdown()


def test_scheduler_on_and_off_give_identical_results():
    _, on, _ = port_stack()
    _, off, _ = port_stack(scheduler_enabled=False)
    try:
        def requests(cc):
            return [
                result_key(cc.optimizations()),
                result_key(cc.rebalance(options=HEAL).optimizer_result),
                proposal_keys(cc.remove_brokers([1])),
                proposal_keys(cc.demote_brokers([0])),
                proposal_keys(cc.add_brokers([3])),
                json.dumps(cc.remove_brokers([[2], [3]]).scenario_report,
                           sort_keys=True, default=str)]
        a, b = requests(on), requests(off)
        assert a == b
        assert on.solve_scheduler.stats.completed == 6
        assert off.solve_scheduler.stats.completed == 6
        assert on.solve_scheduler.enabled and not off.solve_scheduler.enabled
    finally:
        on.shutdown()
        off.shutdown()


# ---------------------------------------------------------------------------
# the single gateway
# ---------------------------------------------------------------------------
def test_every_solve_runs_under_the_gateway(monkeypatch):
    calls = {"optimizer": 0, "engine": 0, "host": 0}
    outside = []

    def guard(kind, fn):
        def run(*a, **kw):
            calls[kind] += 1
            if not sched_runtime.under_gateway():
                outside.append(kind)
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(GoalOptimizer, "optimizations",
                        guard("optimizer", GoalOptimizer.optimizations))
    monkeypatch.setattr(ScenarioEngine, "evaluate",
                        guard("engine", ScenarioEngine.evaluate))
    monkeypatch.setattr(cpu_model, "host_fallback_solve",
                        guard("host", cpu_model.host_fallback_solve))
    sim, cc, clock = port_stack(solver_breaker_cooldown_s=0.0)
    try:
        cc.optimizations()
        cc.optimizations(ignore_proposal_cache=True,
                         _scheduler_class=SchedulerClass.PRECOMPUTE)
        cc.rebalance(options=HEAL)
        cc.add_brokers([3])
        cc.remove_brokers([1])
        cc.demote_brokers([0])
        cc.remove_brokers([[2], [3]])
        cc.evaluate_scenarios([ScenarioSpec(name="x",
                                            remove_brokers=(2,))])
        assert cc.precompute_proposals_once() is False   # cache warm
        cc._invalidate_proposal_cache()
        assert cc.precompute_proposals_once() is True
        with faults.injected(faults.FaultPlan().fail_always(
                "optimizer.execute")):
            cc.optimizations(ignore_proposal_cache=True)
        assert cc.last_solve_rung.name == "CPU"
        sim.kill_broker(0)
        feed_samples(cc, clock, 2)
        cc.fix_offline_replicas()
    finally:
        cc.shutdown()
    assert not outside
    assert calls["optimizer"] >= 8 and calls["engine"] == 2
    assert calls["host"] >= 1


# ---------------------------------------------------------------------------
# the precompute's watchdog, statuses and backoff
# ---------------------------------------------------------------------------
def test_precompute_statuses_wedge_and_backoff(monkeypatch):
    _, cc, clock = port_stack(rounds=0, precompute_solve_deadline_s=60.0)
    try:
        assert cc._precompute_once_status() == "skipped"   # no window
        feed_samples(cc, clock)
        with faults.injected(faults.FaultPlan().fail_nth(
                "facade.precompute", 1)):
            assert cc._precompute_once_status() == "failed"
        assert not cc.precompute_wedged()
        # a solve that overruns its deadline on the facade's clock
        entered, release = threading.Event(), threading.Event()
        real_solve = cc.goal_optimizer.optimizations

        def slow(*a, **kw):
            entered.set()
            assert release.wait(60.0)
            return real_solve(*a, **kw)
        cc.goal_optimizer.optimizations = slow
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "status", cc._precompute_once_status()))
        t.start()
        assert entered.wait(60.0)
        assert cc._precompute_ticket is not None
        assert not cc.precompute_wedged()
        clock["now"] += 61.0
        assert cc.precompute_wedged()
        assert cc.state(["analyzer"])["AnalyzerState"][
            "solverDegradation"]["precomputeWedged"] is True
        release.set()
        t.join(60.0)
        cc.goal_optimizer.optimizations = real_solve
        assert out["status"] == "computed" and not cc.precompute_wedged()
        assert cc._precompute_once_status() == "skipped"    # cache warm
        assert cc.precompute_proposals_once() is False
    finally:
        cc.shutdown()
    # the loop: the first pass at once, then one an interval, failures
    # backing off exponentially up to 32 intervals
    statuses = iter(["failed", "failed", "computed", "failed", "failed",
                     "failed", "failed", "failed", "failed", "skipped"])
    delays = []

    class Stop:
        def is_set(self):
            return False

        def wait(self, delay):
            delays.append(delay)
            return len(delays) > 9

    monkeypatch.setattr(cc, "_precompute_stop", Stop())
    monkeypatch.setattr(cc, "_precompute_once_status",
                        lambda: next(statuses))
    cc._precompute_loop()
    assert delays == [60.0, 120.0, 30.0, 60.0, 120.0, 240.0, 480.0,
                      960.0, 960.0, 30.0]


def test_shutdown_stops_the_precompute_thread():
    # the first passes skip (no valid window yet); a later one computes
    _, cc, _ = port_stack(precompute=True,
                          proposal_precompute_interval_s=0.05)
    _wait(lambda: cc._cached_result is not None)
    assert cc._precompute_thread.name == "proposal-precompute"
    cc.shutdown()
    assert not cc._precompute_thread.is_alive()
    with pytest.raises(Exception, match="stopped"):
        cc.optimizations(ignore_proposal_cache=True)


# ---------------------------------------------------------------------------
# the scenario fold
# ---------------------------------------------------------------------------
def test_compatible_sweeps_fold_into_one_batch():
    a = [ScenarioSpec(name="remove 2", remove_brokers=(2,)),
         ScenarioSpec(name="cpu x 1.5", load_scale={"cpu": 1.5})]
    b = [ScenarioSpec(name="remove 3", remove_brokers=(3,)),
         ScenarioSpec(name="disk x 2", load_scale={"disk": 2.0})]
    _, alone, _ = port_stack(scheduler_enabled=False)
    _, cc, _ = port_stack()
    try:
        want = [alone.evaluate_scenarios(specs) for specs in (a, b)]
        gate, started = threading.Event(), threading.Event()

        def park():
            started.set()
            assert gate.wait(60.0)
        parked = threading.Thread(target=lambda: cc.solve_scheduler.submit(
            SolveJob(klass=SchedulerClass.ANOMALY_HEAL, run=park)))
        parked.start()
        assert started.wait(60.0)
        got = {}
        sweeps = [threading.Thread(target=lambda i=i, s=s: got.setdefault(
            i, cc.evaluate_scenarios(s))) for i, s in enumerate((a, b))]
        for t in sweeps:
            t.start()
            _wait(lambda n=len(got) + sweeps.index(t) + 1:
                  cc.solve_scheduler.queue.depth() == n)
        gate.set()
        for t in sweeps + [parked]:
            t.join(120.0)
        assert cc.solve_scheduler.stats.folded == 1
        # one batch: the shared base once, then each sweep's two specs
        assert cc.scenario_engine.total_batches == 1
        assert cc.scenario_engine.last_batch_size == 5
        for i, w in enumerate(want):
            assert [o.spec.name for o in got[i].outcomes] == \
                ["__base__"] + [s.name for s in (a, b)[i]]
            for o, wo in zip(got[i].outcomes, w.outcomes):
                assert (o.feasible, o.num_replica_moves,
                        o.num_leadership_moves, o.rounds_by_goal,
                        o.balancedness) == \
                    (wo.feasible, wo.num_replica_moves,
                     wo.num_leadership_moves, wo.rounds_by_goal,
                     wo.balancedness)
                assert sorted(map(str, o.proposals)) == \
                    sorted(map(str, wo.proposals))
        assert got[0].outcomes[0] is got[1].outcomes[0]
    finally:
        cc.shutdown()
        alone.shutdown()


# ---------------------------------------------------------------------------
# state() against the reference facade's
# ---------------------------------------------------------------------------
SUBSTATES = ["monitor", "executor", "analyzer", "scenario", "scheduler",
             "incremental", "slo", "sensors"]


def _comparable(doc: dict) -> dict:
    """The shared substates, the engine's host timings dropped (each
    package times its own engine)."""
    doc = json.loads(json.dumps(doc, sort_keys=True, default=str))
    for key in ("lastCompileS", "lastSolveS"):
        doc["ScenarioEngineState"].pop(key)
    doc["sloStatus"].pop("detector", None)
    return doc


def test_state_equals_the_reference_facade():
    jsim, jcc, jclock = make_stack(True)
    psim, pcc, pclock = make_stack(False)
    try:
        for cc, clock in ((jcc, jclock), (pcc, pclock)):
            feed_samples(cc, clock)
            cc.optimizations()
            cc.optimizations()
            cc.rebalance(options=OptimizationOptions(
                excluded_brokers_for_leadership=frozenset({0}),
                is_triggered_by_goal_violation=True))
        jstate = _comparable(jcc.state(SUBSTATES))
        pstate = _comparable(pcc.state(SUBSTATES))
        jsensors, psensors = jstate.pop("Sensors"), pstate.pop("Sensors")
        assert not set(psensors) - set(jsensors)
        shared = {k: jsensors[k] for k in psensors}
        assert psensors == shared
        assert pstate == jstate
        assert pstate["SchedulerState"]["completed"] == 2
        assert pstate["AnalyzerState"]["isProposalReady"] is True
        assert pcc.state() == {k: v for k, v in pcc.state(
            SUBSTATES[:-1]).items()}
        for name, module in (("anomaly_detector", "detector/"),
                             ("portfolio", "portfolio/")):
            with pytest.raises(NotImplementedError, match=module):
                pcc.state([name])
        page = obs_export.render_for(pcc)
        assert page.endswith("# EOF\n")
        for sensor in psensors:
            assert sensor.replace("-", "_") in page
    finally:
        jcc.shutdown()
        pcc.shutdown()
