"""The port's device-time scheduler (cruise_control_tpu_torch/sched/)
against the reference's (cruise_control_tpu/sched/), on the CPU.

Each test runs one script twice, once on each package's classes, under
a fake clock that moves only where the script moves it, and requires the
two records to be equal as JSON text: the policy's aging order and its
validation, the queue's caps with `retry_after_s`, coalescing and class
upgrade, dispatch order, requeue keeping `enqueued_at`, positions and
ETA, the preemption predicate, fold peers, the scheduler's inline and
dispatched runs, coalesced and folded submissions (with a
`FoldedFailure`), preemption at a segment checkpoint, stop failing
queued tickets, the `sched.dispatch` fault site, and the scheduler's and
its sensors' JSON.  The jobs are stubs: no device work.
"""
import json
import threading
import time as _real_time
from types import SimpleNamespace

import pytest

import cruise_control_tpu.sched as j_sched
import cruise_control_tpu.sched.policy as j_policy
import cruise_control_tpu.sched.queue as j_queue
import cruise_control_tpu.sched.runtime as j_runtime
import cruise_control_tpu.sched.scheduler as j_scheduler
import cruise_control_tpu.utils.faults as j_faults
import cruise_control_tpu.utils.metrics as j_metrics
import cruise_control_tpu_torch.sched as p_sched
import cruise_control_tpu_torch.sched.policy as p_policy
import cruise_control_tpu_torch.sched.queue as p_queue
import cruise_control_tpu_torch.sched.runtime as p_runtime
import cruise_control_tpu_torch.sched.scheduler as p_scheduler
import cruise_control_tpu_torch.utils.faults as p_faults
import cruise_control_tpu_torch.utils.metrics as p_metrics

PACKAGES = {
    "reference": SimpleNamespace(policy=j_policy, queue=j_queue,
                                 runtime=j_runtime, scheduler=j_scheduler,
                                 faults=j_faults, metrics=j_metrics),
    "port": SimpleNamespace(policy=p_policy, queue=p_queue,
                            runtime=p_runtime, scheduler=p_scheduler,
                            faults=p_faults, metrics=p_metrics),
}


def both(script) -> str:
    """The script's record on each package, equal as JSON text."""
    texts = {name: json.dumps(script(pkg), sort_keys=True, default=str)
             for name, pkg in PACKAGES.items()}
    assert texts["port"] == texts["reference"]
    return texts["port"]


def _wait(pred, timeout=10.0):
    deadline = _real_time.monotonic() + timeout
    while not pred():
        if _real_time.monotonic() > deadline:
            raise AssertionError("timed out")
        _real_time.sleep(0.005)


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------
def policy_script(m):
    P = m.policy
    out = {"default": P.SchedulerPolicy.default().to_json(),
           "custom": P.SchedulerPolicy.from_lists(
               weights=[1, 2, 3, 4], queue_caps=[1, 2, 3, 4],
               deadline_budgets_s=[1.5, 2.5, 3.5, 4.5],
               preemption_enabled=False).to_json(),
           "preemptible": sorted(c.name for c in P.PREEMPTIBLE_CLASSES),
           "classes": {c.name: c.value for c in P.SchedulerClass}}
    p = P.SchedulerPolicy.default()
    out["effective"] = {
        c.name: [p.effective_priority(c, w)
                 for w in (-1.0, 0.0, 1.0, 30.0, 119.5, 600.0, 3600.0)]
        for c in P.SchedulerClass}
    out["caps"] = {c.name: (p.queue_cap(c), p.is_preemptible(c))
                   for c in P.SchedulerClass}
    # the aging order: a class that waited a multiple of its budget
    waits = {c: n * p.classes[c].deadline_budget_s
             for n, c in zip((0, 0.5, 1, 2), P.SchedulerClass)}
    out["aging_order"] = [c.name for c in sorted(
        P.SchedulerClass,
        key=lambda c: (p.effective_priority(c, waits[c]), c.value))]
    errors = []
    for kw in (dict(weights=[1, 2, 3]), dict(queue_caps=[0, 1, 1, 1]),
               dict(weights=[1, -1, 1, 1]),
               dict(deadline_budgets_s=[1, 1, 0, 1]),
               dict(queue_caps=[1, 2, 3, 4, 5])):
        try:
            P.SchedulerPolicy.from_lists(**kw)
            errors.append(None)
        except ValueError as exc:
            errors.append(str(exc))
    out["errors"] = errors
    return out


def test_policy_matches_reference():
    text = both(policy_script)
    doc = json.loads(text)
    assert doc["preemptible"] == ["PRECOMPUTE", "SCENARIO_SWEEP"]
    # USER aged half a budget beats a fresh HEAL; PRECOMPUTE aged one
    # budget ties HEAL's base and loses on class value
    assert doc["aging_order"] == ["USER_INTERACTIVE", "ANOMALY_HEAL",
                                  "PRECOMPUTE", "SCENARIO_SWEEP"]
    assert all(doc["errors"])


def test_port_keeps_scheduler_class_values():
    assert {c.name: c.value for c in p_policy.SchedulerClass} == {
        "ANOMALY_HEAL": 0, "USER_INTERACTIVE": 1, "PRECOMPUTE": 2,
        "SCENARIO_SWEEP": 3}
    assert p_sched.SchedulerClass is p_policy.SchedulerClass
    assert sorted(p_sched.__all__) == sorted(j_sched.__all__)


# ---------------------------------------------------------------------------
# the admission queue
# ---------------------------------------------------------------------------
def queue_script(m):
    P, Q, S = m.policy, m.queue, m.scheduler
    C = P.SchedulerClass
    clock = {"t": 0.0}
    stop = threading.Event()
    out = {}

    def make(caps=(8, 16, 2, 8), **kw):
        return Q.AdmissionQueue(P.SchedulerPolicy.from_lists(
            queue_caps=list(caps), **kw), lambda: clock["t"])

    def job(klass=C.USER_INTERACTIVE, **kw):
        return S.SolveJob(klass=klass, run=lambda: None, **kw)

    # caps and Retry-After
    q = make(caps=(8, 2, 2, 8))
    q.offer(job())
    q.offer(job())
    q.observe_latency(3.0)
    try:
        q.offer(job())
    except Q.QueueFullError as exc:
        out["full"] = [str(exc), exc.retry_after_s, exc.klass.name,
                       exc.depth, exc.cap, exc.trace_outcome]
    q.offer(job(klass=C.ANOMALY_HEAL))
    out["depths"] = {c.name: d for c, d in q.depths().items()}
    # coalescing and the class upgrade
    clock["t"] = 5.0
    q = make()
    t1, c1 = q.offer(job(klass=C.PRECOMPUTE, coalesce_key=("k",)))
    t2, c2 = q.offer(job(klass=C.ANOMALY_HEAL, coalesce_key=("k",)))
    e = q.take(stop)
    out["coalesce"] = [c1, c2, t1 is t2, t1.attach_count, t1.klass.name,
                       e.best_klass.name, e.klass.name, t1.started_at]
    t3, c3 = q.offer(job(coalesce_key=("k",)))
    q.finish(e)
    t1.resolve("r")
    t4, c4 = q.offer(job(coalesce_key=("k",)))
    out["inflight"] = [t3 is t1, c3, t4 is t1, c4, t1.wait(0)]
    # dispatch order: priority, then arrival
    q = make()
    for label, klass in (("a", C.SCENARIO_SWEEP), ("b", C.USER_INTERACTIVE),
                         ("c", C.USER_INTERACTIVE), ("d", C.PRECOMPUTE),
                         ("e", C.ANOMALY_HEAL)):
        q.offer(job(klass=klass, label=label))
    out["order"] = [q.take(stop).job.label for _ in range(5)]
    # positions and ETA
    clock["t"] = 10.0
    q = make()
    q.observe_latency(2.0)
    q.observe_latency(4.0)
    a, _ = q.offer(job())
    b, _ = q.offer(job(klass=C.SCENARIO_SWEEP))
    out["eta"] = [a.queue_position(), b.queue_position(),
                  b.estimated_start_ms(), q.latency_ewma_s()]
    e = q.take(stop)
    clock["t"] = 12.0
    out["eta"] += [a.queue_position(), a.estimated_start_ms(),
                   b.queue_position(), b.estimated_start_ms(),
                   q.idle()]
    q.done_serving()
    # requeue keeps enqueued_at
    q = make()
    clock["t"] = 20.0
    q.offer(job(klass=C.PRECOMPUTE))
    e = q.take(stop)
    clock["t"] = 120.0
    q.requeue(e)
    out["requeue"] = [e.enqueued_at, e.last_queued_at, q.oldest_wait_s(),
                      e.ticket.started_at, q.depth(), q.idle()]
    # the preemption predicate with the running job's aging
    clock["t"] = 0.0
    p = P.SchedulerPolicy.default()
    q = Q.AdmissionQueue(p, lambda: clock["t"])
    q.offer(job(klass=C.PRECOMPUTE))
    e = q.take(stop)

    def running():
        return p.effective_priority(e.best_klass,
                                    clock["t"] - e.enqueued_at)
    preds = []
    clock["t"] = 1.0
    q.offer(job())
    preds.append(q.has_effective_better_than(running()))
    q.take(stop)
    clock["t"] = 70.0
    q.offer(job())
    preds.append(q.has_effective_better_than(running()))
    q.offer(job(klass=C.ANOMALY_HEAL))
    preds.append(q.has_effective_better_than(running()))
    out["predicate"] = preds
    # no starvation: a sweep under a fresh USER arrival every round
    clock["t"] = 0.0
    q = make(deadline_budgets_s=[5.0, 30.0, 120.0, 60.0])
    sweep, _ = q.offer(job(klass=C.SCENARIO_SWEEP))
    rounds = 0
    for rounds in range(1, 101):
        q.offer(job())
        e = q.take(stop)
        clock["t"] += 10.0
        if e.ticket is sweep:
            break
    out["starvation_rounds"] = rounds
    # fold peers, drain
    q = make()
    for i in range(4):
        q.offer(job(klass=C.SCENARIO_SWEEP, fold_key=("f",),
                    fold_payload=i, label=f"s{i}"))
    q.offer(job(klass=C.SCENARIO_SWEEP, fold_key=("g",), label="other"))
    first = q.take(stop)
    peers = q.take_fold_peers(("f",), 2)
    out["fold"] = [first.job.label, [x.job.label for x in peers],
                   q.take_fold_peers(("f",), 0), q.depth()]
    left = q.drain()
    out["drain"] = [sorted(x.job.label for x in left), q.depth(),
                    {c.name: d for c, d in q.depths().items()}]
    return out


def test_queue_matches_reference():
    doc = json.loads(both(queue_script))
    assert doc["full"][1] == 9.0 and doc["full"][5] == "rejected"
    assert doc["order"] == ["e", "b", "c", "d", "a"]
    assert doc["predicate"] == [True, False, True]
    assert doc["starvation_rounds"] < 20


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------
def _parked(S, C, clock_fn, policy=None, **kw):
    """A scheduler whose dispatch thread is parked on a gate job, so that
    submissions from other threads queue deterministically."""
    sched = S.DeviceTimeScheduler(policy, time_fn=clock_fn, **kw)
    gate, started = threading.Event(), threading.Event()

    def gate_run():
        started.set()
        assert gate.wait(30.0)
        return "gate"
    waiter = threading.Thread(target=lambda: sched.submit(S.SolveJob(
        klass=C.USER_INTERACTIVE, run=gate_run, label="gate")),
        daemon=True)
    waiter.start()
    assert started.wait(10.0)
    return sched, gate, waiter


def _submit(sched, job):
    out = {}

    def run():
        try:
            out["result"] = sched.submit(job)
        except BaseException as exc:  # noqa: BLE001 - recorded
            out["exc"] = f"{type(exc).__name__}: {exc}"
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def scheduler_script(m):
    P, S, R, F, M = m.policy, m.scheduler, m.runtime, m.faults, m.metrics
    C = P.SchedulerClass
    clock = {"t": 100.0}
    now = lambda: clock["t"]  # noqa: E731
    out = {}
    # disabled: inline on the caller's thread, inside the gateway
    inline = S.DeviceTimeScheduler(enabled=False, time_fn=now)
    seen = {}

    def probe():
        seen["gateway"] = R.under_gateway()
        seen["async"] = R.dispatch_is_async()
        seen["same thread"] = threading.current_thread() is main
        R.segment_checkpoint()
        return "inline"
    main = threading.current_thread()
    out["inline"] = [inline.submit(S.SolveJob(klass=C.PRECOMPUTE,
                                              run=probe,
                                              preemptible=True)), seen,
                     inline.stats.to_json()]
    inline.stop()
    out["inline after stop"] = inline.submit(S.SolveJob(
        klass=C.USER_INTERACTIVE, run=lambda: "still"))
    # coalesced submissions share one execution; a fold with a failure
    registry = M.MetricRegistry(now)
    sched, gate, gate_thread = _parked(S, C, now)
    sched.attach_metrics(registry)
    calls = []
    order = []

    def solve():
        calls.append(1)
        order.append("coalesced")
        return "r"

    def fold_run(payloads):
        order.append(["fold", list(payloads)])
        return [S.FoldedFailure(ValueError(f"lane {p} infeasible"))
                if p == 1 else f"r{p}" for p in payloads]
    waiters = [_submit(sched, S.SolveJob(
        klass=C.USER_INTERACTIVE, run=solve, label="same",
        coalesce_key=("same",))) for _ in range(3)]
    _wait(lambda: sched.stats.coalesced == 2)
    for i in range(3):
        waiters.append(_submit(sched, S.SolveJob(
            klass=C.SCENARIO_SWEEP, run=lambda: None, label=f"sweep{i}",
            fold_key=("f",), fold_payload=i, fold_run=fold_run)))
        _wait(lambda i=i: sched.queue.depth() == 2 + i)
    waiters.append(_submit(sched, S.SolveJob(
        klass=C.ANOMALY_HEAL, run=lambda: order.append("heal") or "h",
        label="heal")))
    _wait(lambda: sched.queue.depth() == 5)
    out["queued"] = sched.to_json()
    gate.set()
    for t, _ in waiters:
        t.join(timeout=10.0)
    gate_thread.join(timeout=10.0)
    out["served"] = [order, len(calls), [w[1] for w in waiters]]
    # preemption at a segment checkpoint, then the re-run
    steps = []
    entered, urgent = threading.Event(), threading.Event()

    def pre_run():
        steps.append(["pre", R.under_gateway(), R.dispatch_is_async()])
        entered.set()
        assert urgent.wait(10.0)
        R.segment_checkpoint()
        steps.append("pre-finish")
        return "pre"
    pre = _submit(sched, S.SolveJob(klass=C.PRECOMPUTE, run=pre_run,
                                    label="pre", preemptible=True))
    assert entered.wait(10.0)
    clock["t"] += 1.0
    user = _submit(sched, S.SolveJob(
        klass=C.USER_INTERACTIVE, run=lambda: steps.append("user") or "u",
        label="user"))
    _wait(lambda: sched.queue.depth() == 1)
    urgent.set()
    for t, _ in (pre, user):
        t.join(timeout=10.0)
    out["preempted"] = [steps, pre[1], user[1]]
    # the dispatch fault site, and a failure reaching every waiter
    with F.injected(F.FaultPlan().fail_nth("sched.dispatch", 1)):
        out["fault"] = _submit(sched, S.SolveJob(
            klass=C.USER_INTERACTIVE, run=lambda: "x"))
        out["fault"][0].join(timeout=10.0)
        out["fault"] = out["fault"][1]
    out["nested"] = sched.submit(S.SolveJob(
        klass=C.USER_INTERACTIVE,
        run=lambda: sched.submit(S.SolveJob(klass=C.USER_INTERACTIVE,
                                            run=lambda: "inner"))))
    out["state"] = sched.to_json()
    out["sensors"] = registry.to_json()
    # stop fails what is queued; a submission after stop is refused
    sched2, gate2, gate2_thread = _parked(S, C, now)
    late = _submit(sched2, S.SolveJob(klass=C.PRECOMPUTE,
                                      run=lambda: "late"))
    _wait(lambda: sched2.queue.depth() == 1)
    stopper = threading.Thread(target=sched2.stop, daemon=True)
    stopper.start()
    gate2.set()
    stopper.join(timeout=10.0)
    late[0].join(timeout=10.0)
    gate2_thread.join(timeout=10.0)
    try:
        sched2.submit(S.SolveJob(klass=C.USER_INTERACTIVE,
                                 run=lambda: "after"))
    except S.SchedulerStoppedError as exc:
        out["after stop"] = str(exc)
    out["stopped"] = [late[1], sched2.quiesce(1.0), sched2.to_json()]
    sched.stop()
    return out


def test_scheduler_matches_reference():
    doc = json.loads(both(scheduler_script))
    order, calls, results = doc["served"]
    assert order == ["heal", "coalesced", ["fold", [0, 1, 2]]]
    assert calls == 1
    assert [r.get("result") for r in results] == [
        "r", "r", "r", "r0", None, "r2", "h"]
    assert results[4]["exc"] == "ValueError: lane 1 infeasible"
    steps, pre, user = doc["preempted"]
    assert steps == [["pre", True, True], "user",
                     ["pre", True, True], "pre-finish"]
    assert pre == {"result": "pre"} and user == {"result": "u"}
    assert doc["state"]["preemptions"] == 1
    assert doc["state"]["folded"] == 2 and doc["state"]["coalesced"] == 2
    assert doc["fault"]["exc"].startswith("FaultError")
    assert doc["stopped"][0]["exc"].startswith("SchedulerStoppedError")
    assert doc["sensors"]["sched-preemptions"]["count"] == 1


def test_optimizer_checkpoint_raises_solve_preempted():
    """The port's optimizer checkpoints between goal segments: under a
    check that fires, the solve unwinds with SolvePreempted; without one
    the same solve completes."""
    from cruise_control_tpu_torch.analyzer.goals.registry import \
        default_goals
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.testing.random_cluster import (
        RandomClusterSpec, random_cluster)
    state, topo = random_cluster(RandomClusterSpec(
        num_brokers=6, num_partitions=40, seed=3), device="cpu")
    optimizer = GoalOptimizer(default_goals(
        names=["RackAwareGoal", "DiskCapacityGoal"]))
    with p_runtime.gateway(lambda: True):
        with pytest.raises(p_runtime.SolvePreempted):
            optimizer.optimizations(state, topo, check_sanity=False,
                                    device="cpu")
    result = optimizer.optimizations(state, topo, check_sanity=False,
                                     device="cpu")
    assert result.final_state is not None
