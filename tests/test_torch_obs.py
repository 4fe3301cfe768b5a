"""The port's observability modules (cruise_control_tpu_torch/obs/ and
utils/metrics.py) against the reference's, on the CPU.

Each parity test runs one script on each package, under a fake clock,
and requires the records to be equal as JSON text or, for the
OpenMetrics page, as text: the `MetricRegistry`'s JSON (counters,
meters, timers, histograms with bucket overrides, gauges, a broken
gauge, the collision check), the rendered page, the flight recorder's
ring, pins, exports, filters, sampling and `dump`, and the SLO
evaluator's `evaluate()` over windows of histogram snapshots.  Then the
port's own wiring: `obs_trace.finish` hands each trace to the recorder
(thinned by `sample_rate`), and a preempted scheduler job's trace is
marked and pinned.
"""
import json
import logging
import re
import threading
import time as _real_time
from types import SimpleNamespace

import pytest

import cruise_control_tpu.obs.export as j_export
import cruise_control_tpu.obs.recorder as j_recorder
import cruise_control_tpu.obs.slo as j_slo
import cruise_control_tpu.obs.trace as j_trace
import cruise_control_tpu.utils.metrics as j_metrics
import cruise_control_tpu_torch.obs.export as p_export
import cruise_control_tpu_torch.obs.recorder as p_recorder
import cruise_control_tpu_torch.obs.slo as p_slo
import cruise_control_tpu_torch.obs.trace as p_trace
import cruise_control_tpu_torch.utils.metrics as p_metrics
from cruise_control_tpu_torch.sched import runtime as p_runtime
from cruise_control_tpu_torch.sched.policy import SchedulerClass
from cruise_control_tpu_torch.sched.scheduler import (DeviceTimeScheduler,
                                                      SolveJob)

PACKAGES = {
    "reference": SimpleNamespace(export=j_export, recorder=j_recorder,
                                 slo=j_slo, trace=j_trace,
                                 metrics=j_metrics),
    "port": SimpleNamespace(export=p_export, recorder=p_recorder,
                            slo=p_slo, trace=p_trace, metrics=p_metrics),
}


@pytest.fixture(autouse=True)
def fresh_obs():
    """A fresh recorder and unsampled tracing in both packages, before
    and after each test."""
    for m in PACKAGES.values():
        m.trace.configure(enabled=True, trace_log_enabled=False,
                          sample_rate=1.0)
        m.recorder.install(m.recorder.FlightRecorder())
    yield
    for m in PACKAGES.values():
        m.trace.configure(enabled=True, trace_log_enabled=False,
                          sample_rate=1.0)
        m.recorder.install(m.recorder.FlightRecorder())


def both(script):
    """The script's record on each package, equal as JSON text."""
    texts = {name: json.dumps(script(pkg), sort_keys=True, default=str)
             for name, pkg in PACKAGES.items()}
    assert texts["port"] == texts["reference"]
    return json.loads(texts["port"])


# ---------------------------------------------------------------------------
# the metric registry and its OpenMetrics page
# ---------------------------------------------------------------------------
def registry_script(m):
    clock = {"t": 50.0}
    reg = m.metrics.MetricRegistry(
        lambda: clock["t"],
        bucket_overrides={"sched-wait-hist": (0.5, 0.1, 2.0),
                          "sched-wait-hist-precompute": (1.0, 3.0)})
    out = {}
    reg.counter("my-counter").inc(3)
    reg.meter("my-meter").mark(2)
    clock["t"] = 60.0
    reg.meter("my-meter").mark()
    reg.meter("other-meter").mark(150)
    for d in (0.25, 0.003, 1.5, 0.25):
        reg.timer("my-timer").update(d)
    with reg.timer("ctx-timer").time():
        clock["t"] = 61.5
    for v in (0.0005, 0.003, 0.03, 0.3, 999.0):
        reg.update_histogram("sched-wait-hist-user-interactive", v)
        reg.update_histogram("sched-wait-hist-precompute", v)
        reg.update_histogram("plain-hist", v)
    reg.set_bucket_overrides({"late": (4.0, 2.0)})
    reg.update_histogram("late-hist", 3.0)
    reg.gauge("my-gauge", lambda: 7.0)
    reg.gauge("broken-gauge", lambda: 1 / 0)
    reg.gauge("cluster-ish", lambda: 2)
    try:
        reg.counter("my.counter")
    except ValueError as exc:
        out["collision"] = str(exc)
    reg.counter("my-counter")
    out["buckets_for"] = [reg.buckets_for(n) for n in (
        "sched-wait-hist-user-interactive", "sched-wait-hist-precompute",
        "late-hist", "plain-hist")]
    out["peek"] = [reg.peek("my-counter") is not None,
                   reg.peek("absent") is None]
    clock["t"] = 400.0
    out["json"] = reg.to_json()
    out["page"] = m.export.render_openmetrics(out["json"])
    out["tagged"] = m.export.render_openmetrics({
        "cluster.alpha.solver-rung": {"type": "gauge", "value": 0},
        "cluster.kafka.prod.eu.solver-rung": {"type": "gauge", "value": 2},
        "weird": {"type": "unknown", "count": 4}})
    out["canonical"] = [m.metrics.canonical_sensor_name(n) for n in (
        "proposal-computation-timer", "REBALANCE-request-rate", "9x",
        "--", "a.b-c")]
    out["labels"] = [m.metrics.openmetrics_sensor(n) for n in (
        "cluster.alpha.solver-rung", "cluster.kafka.prod.eu.x",
        "cluster.", "solver-rung")]
    return out


#: the sample-line grammar of a rendered page
SAMPLE = re.compile(
    r"^[a-zA-Z_][a-zA-Z0-9_]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? '
    r"(-?[0-9.]+(e[+-]?[0-9]+)?|NaN)$")


def assert_parseable(text: str) -> None:
    assert text.endswith("# EOF\n")
    for line in text.splitlines()[:-1]:
        if line.startswith("# TYPE "):
            assert re.match(r"^# TYPE [a-zA-Z_][a-zA-Z0-9_]* "
                            r"(counter|gauge|histogram)$", line), line
        else:
            assert SAMPLE.match(line), line


def test_registry_and_page_match_reference():
    doc = both(registry_script)
    assert doc["json"]["broken-gauge"]["value"] is None
    # constructor overrides are kept as given; the histogram sorts them
    assert doc["buckets_for"][0] == [0.5, 0.1, 2.0]
    assert "collides" in doc["collision"]
    assert_parseable(doc["page"])
    assert "cc_tpu_plain_hist_seconds_bucket" in doc["page"]
    assert 'cc_tpu_solver_rung{cluster="kafka.prod.eu"} 2' in doc["tagged"]


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------
def recorder_script(m):
    R = m.recorder
    out = {}

    def doc(i, outcome="ok", start=0.0, dur=1.0, cluster=None):
        d = {"traceId": f"t{i:03d}", "outcome": outcome,
             "startMs": start, "durationMs": dur, "root": {
                 "name": "solve", "children": [
                     {"name": "a", "durationMs": dur / 2},
                     {"name": "b", "durationMs": dur / 4,
                      "children": [{"name": "a", "durationMs": 1.0}]}]}}
        if cluster:
            d["tags"] = {"cluster": cluster}
        return d
    rec = R.FlightRecorder(capacity=4, max_pinned=3)
    rec.record(doc(0, "degraded", 10.0, 50.0, "x"))
    for i in range(1, 9):
        rec.record(doc(i, start=100.0 * i, dur=float(i), cluster=(
            "x" if i % 2 else "y")))
    rec.record(doc(9, "rejected"))
    for i in range(10, 14):
        rec.record(doc(i, "failed"))
    out["ring"] = [d["traceId"] for d in rec.query(export=False)]
    out["json"] = rec.to_json()
    out["filters"] = [
        [d["traceId"] for d in rec.query(export=False, **kw)] for kw in (
            dict(cluster="x"), dict(outcome="failed"), dict(limit=2),
            dict(since_ms=500.0), dict(min_duration_ms=7.0),
            dict(since_ms=500.0, min_duration_ms=8.0), dict(limit=0))]
    out["get"] = rec.get("t012")["traceId"]
    out["after get"] = rec.to_json()
    out["exported"] = [d["traceId"] for d in rec.query(outcome="failed")]
    out["after export"] = rec.to_json()
    out["snapshot"] = [d["traceId"] for d in rec.snapshot()]
    out["summary"] = R.phase_summary(rec.snapshot())
    out["empty summary"] = R.phase_summary([])
    out["dump"] = rec.dump(reason="test", active={"traceId": "live"})
    rec.record_sampled_out()
    live = R.install(R.FlightRecorder(capacity=8))
    for i in range(6):
        live.record(doc(100 + i, "preempted" if i % 2 else "ok"))
    R.configure(capacity=3, max_pinned=1)
    out["configured"] = [R.get_recorder().to_json(),
                         [d["traceId"] for d in live.snapshot()]]
    return out


def test_recorder_matches_reference():
    doc = both(recorder_script)
    assert doc["json"]["pinned"] == 3 and doc["json"]["retained"] == 4
    # t012 was exported (unpinned) by `get`; the other pins come first
    assert doc["exported"][:3] == ["t013", "t011", "t012"]
    assert doc["after export"]["pinned"] == 0
    assert doc["dump"] >= 1


def sampling_script(m):
    """Deterministic keep decisions at a sample rate, and the handoff of
    finished traces to the recorder."""
    T = m.trace
    ids = [f"{k:08x}00000000" for k in range(0, 2 ** 32, 2 ** 28)]
    out = {}
    for rate in (0.0, 0.3, 0.5, 1.0, 7.0, -1.0):
        T.configure(sample_rate=rate)
        out[str(rate)] = [T.sample_rate(), [T._sampled_in(t) for t in ids]]
    return out


def test_sampling_decisions_match_reference():
    doc = both(sampling_script)
    assert sum(doc["0.5"][1]) == 8 and doc["7.0"][0] == 1.0


def test_finish_hands_traces_to_the_recorder_thinned_by_sample_rate():
    # a ring wide enough that nothing is evicted: every kept trace stays
    rec = p_recorder.install(p_recorder.FlightRecorder(capacity=1024))
    p_trace.configure(sample_rate=0.1)
    bad = p_trace.start("incident")
    p_trace.mark("degraded")
    p_trace.finish(bad)
    rejected = p_trace.start("rejected")
    from cruise_control_tpu_torch.sched.queue import QueueFullError
    p_trace.finish(rejected, error=QueueFullError(
        SchedulerClass.USER_INTERACTIVE, 6, 6, 12.0))
    kept = []
    for i in range(320):
        tr = p_trace.start(f"ok{i}")
        p_trace.finish(tr)
        kept.append(p_trace._sampled_in(tr.trace_id))
    stats = rec.to_json()
    assert stats["sampledOut"] == kept.count(False) > 0
    assert stats["recorded"] == kept.count(True) + 2
    hit = rec.query(trace_id=bad.trace_id, export=False)
    assert hit and hit[0]["outcome"] == "degraded"
    assert rec.query(trace_id=rejected.trace_id,
                     export=False)[0]["outcome"] == "rejected"
    assert stats["pinned"] == 1
    p_trace.configure(sample_rate=1.0, enabled=False)
    assert p_trace.start("off") is None
    p_trace.configure(enabled=True)


def test_preempted_job_trace_is_marked_and_pinned():
    """A preemptible job yields at its checkpoint: its trace is marked
    "preempted", records the sched.preempted span, and is pinned in the
    recorder once its request finishes."""
    rec = p_recorder.get_recorder()
    sched = DeviceTimeScheduler()
    entered, urgent = threading.Event(), threading.Event()

    def pre_run():
        entered.set()
        assert urgent.wait(10.0)
        p_runtime.segment_checkpoint()
        return "pre"
    out = {}

    def precompute():
        with p_trace.solve_trace("solve.precompute") as tr:
            out["trace"] = tr
            out["result"] = sched.submit(SolveJob(
                klass=SchedulerClass.PRECOMPUTE, run=pre_run,
                preemptible=True, trace=p_trace.current_context()))
    t = threading.Thread(target=precompute)
    t.start()
    assert entered.wait(10.0)
    heal = threading.Thread(target=lambda: sched.submit(SolveJob(
        klass=SchedulerClass.ANOMALY_HEAL, run=lambda: "h")))
    heal.start()
    deadline = _real_time.monotonic() + 10.0
    while sched.queue.depth() < 1:
        assert _real_time.monotonic() < deadline
        _real_time.sleep(0.005)
    urgent.set()
    t.join(10.0)
    heal.join(10.0)
    sched.stop()
    tr = out["trace"]
    assert out["result"] == "pre" and tr.outcome == "preempted"
    doc = rec.query(trace_id=tr.trace_id, export=False)[0]
    names = [c["name"] for c in doc["root"]["children"]]
    assert names.count("sched.queue-wait") == 2
    assert "sched.preempted" in names and names.count("sched.dispatch") == 2
    assert rec.to_json()["pinned"] == 1


# ---------------------------------------------------------------------------
# the SLO evaluator
# ---------------------------------------------------------------------------
def slo_script(m):
    clock = {"t": 1000.0}
    reg = m.metrics.MetricRegistry(lambda: clock["t"])
    ev = m.slo.SloEvaluator(reg, window_s=60.0, alert_threshold=2.0,
                            min_refresh_s=1.0, time_fn=lambda: clock["t"])
    ev.attach_metrics(reg)
    out = {"empty": ev.evaluate(force=True)}

    def observe(klass, wait, dev, n=1):
        for _ in range(n):
            reg.update_histogram(f"sched-wait-hist-{klass}", wait)
            reg.update_histogram(f"sched-device-busy-hist-{klass}", dev)
    steps = []
    for dt, obs in ((5.0, [("user-interactive", 0.1, 0.5, 20)]),
                    (0.5, [("user-interactive", 0.1, 3.0, 1)]),
                    (5.0, [("user-interactive", 0.6, 3.0, 2),
                           ("precompute", 20.0, 10.0, 3)]),
                    (30.0, [("scenario-sweep", 1.0, 100.0, 1)]),
                    (70.0, [("anomaly-heal", 0.01, 0.2, 5)]),
                    (70.0, [])):
        clock["t"] += dt
        for o in obs:
            observe(*o)
        steps.append(ev.evaluate())
    out["steps"] = steps
    out["forced"] = ev.evaluate(force=True)
    out["gauges"] = {k: v for k, v in reg.to_json().items()
                     if k.startswith("slo-")}
    out["burn"] = [ev.burn(k) for k in sorted(m.slo.CLASS_SENSOR_SUFFIX)]
    out["over"] = [m.slo.over_threshold(
        {"count": 5, "buckets": {"0.1": 1, "0.5": 3, "bad": 4,
                                 "+Inf": 5}}, t) for t in
        (0.05, 0.1, 0.3, 0.5, 9.0)]
    out["disabled"] = m.slo.SloEvaluator(reg, enabled=False).evaluate()
    try:
        m.slo.SloEvaluator(reg, objectives={"BOGUS": m.slo.ClassObjective(
            1.0, 1.0, 0.1)})
    except ValueError as exc:
        out["unknown"] = str(exc)
    out["status"] = ev.status_level()
    return out


def test_slo_evaluator_matches_reference():
    doc = both(slo_script)
    assert doc["empty"]["status"] == "ok"
    assert any(s["status"] == "breach" for s in doc["steps"])
    assert doc["steps"][-1]["status"] == "ok"


def test_port_obs_modules_import_nothing_of_the_reference():
    import cruise_control_tpu_torch.obs as pkg
    for mod in (p_export, p_recorder, p_slo, p_trace, p_metrics):
        text = open(mod.__file__).read()
        assert not re.search(r"^\s*(import|from)\s+(jax|cruise_control_tpu)"
                             r"(\.|\s|$)", text, re.M), mod.__name__
    assert sorted(pkg.__all__) == ["export", "recorder", "slo", "trace"]
    logging.getLogger("flightRecorder").info("ok")
