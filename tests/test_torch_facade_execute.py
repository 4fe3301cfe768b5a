"""The PyTorch port's facade execution side (cruise_control_tpu_torch/
facade.py: `dryrun=False`, `_maybe_execute`, `OngoingExecutionError`,
the executor's broker history in `_self_healing_options`,
`recover_interrupted_execution`, the journal's error hook) against the
JAX reference's `CruiseControl`, on the CPU.

The cluster of tests/test_torch_facade.py (9 brokers on two racks, two
topics of rf 2, the `INCR_GOALS` stack): the JAX facade samples its own
`SimulatedCluster` and executes on it; the port's facade is fed that
monitor's snapshot, loads and capacities, and executes on a port
`SimulatedCluster` built the same way (the two sims' snapshots are
checked equal first).  In order, each with a fixed execution uuid:
`rebalance(dryrun=False)` (a second `dryrun=False` while it runs raises
`OngoingExecutionError` in both), `remove_brokers([1], dryrun=False)`
and `demote_brokers([0], dryrun=False)`.  After each the port's monitor
is refreshed from its own cluster (`MetadataClient`) and fed the JAX
monitor's current loads, as a sampling loop would.  Each request must
give the reference's proposals, execution uuid and executed snapshot;
then the same recent-broker history and the same next self-healing
options.  Also: recovery of a crashed journaled execution through both
facades, a journal failure counted by the port's facade, and
`dryrun=False` without an admin client raising ValueError.
"""
import threading

import pytest

from cruise_control_tpu.analyzer.options_generator import \
    DefaultOptimizationOptionsGenerator as JGenerator
from cruise_control_tpu.facade import CruiseControl as JCruiseControl
from cruise_control_tpu.facade import OngoingExecutionError as JOngoing
from cruise_control_tpu.monitor.sampling.sampler import \
    SimulatedClusterSampler
from cruise_control_tpu_torch import facade as F
from cruise_control_tpu_torch.analyzer.options_generator import \
    DefaultOptimizationOptionsGenerator
from cruise_control_tpu_torch.cluster.metadata import MetadataClient
from cruise_control_tpu_torch.cluster.simulated import SimulatedCluster
from cruise_control_tpu_torch.cluster.types import TopicPartition
from cruise_control_tpu_torch.monitor.load_monitor import \
    SnapshotLoadMonitor
from cruise_control_tpu_torch.utils import faults
from test_torch_executor import KITS, norm, snapshot_key, tasks_key
from test_torch_executor_recovery import crashed_run
from test_torch_facade import INCR_GOALS, PATTERN, make_sim, proposal_keys
from test_torch_monitor import monitor_inputs

UUIDS = {"rebalance": "e0000000-0000-4000-8000-000000000001",
         "remove": "e0000000-0000-4000-8000-000000000002",
         "demote": "e0000000-0000-4000-8000-000000000003"}


def make_port_sim():
    """The port's twin of test_torch_facade.make_sim."""
    sim = SimulatedCluster()
    for b in range(9):
        sim.add_broker(b, rack=f"rack{b % 2}")
    for t, n in (("t0", 16), ("t1", 8)):
        sim.create_topic(t, [[p % 8, (p + 1) % 8] for p in range(n)],
                         size_bytes=1e4)
        for p in range(n):
            hot = 3.0 if p % 8 < 2 else 1.0
            sim.set_partition_load(TopicPartition(t, p),
                                   leader_cpu=2.0 * hot,
                                   nw_in=100.0 * hot, nw_out=300.0)
    return sim


def _ticking(sim, clock):
    def sleep(s):
        sim.advance(s)
        clock["now"] += s
    return sleep


def hold_first_sleep(executor):
    """Hold the executor's runnable in its first sleep until released."""
    held, release = threading.Event(), threading.Event()
    orig = executor._sleep

    def sleep(s):
        if not held.is_set():
            held.set()
            release.wait(60.0)
        orig(s)
    executor._sleep = sleep
    return held, release


@pytest.fixture(scope="module")
def executed():
    """Both facades through the three executed requests: {request: (JAX
    answer, port answer, JAX snapshot, port snapshot, JAX tasks, port
    tasks, ongoing refusals)} and the facades."""
    jsim = make_sim()
    jclock = {"now": 10_000.0}
    jcc = JCruiseControl(
        jsim, SimulatedClusterSampler(jsim), time_fn=lambda: jclock["now"],
        sleep_fn=_ticking(jsim, jclock),
        monitor_kwargs=dict(num_windows=3, window_ms=10_000,
                            min_samples_per_window=1,
                            sampling_interval_ms=5_000),
        executor_kwargs=dict(progress_check_interval_s=1.0),
        auto_warmup=False, scheduler_enabled=False,
        goal_names=list(INCR_GOALS), options_generator=JGenerator(PATTERN))
    jcc.start_up(do_sampling=False, start_detection=False)
    psim = make_port_sim()

    def sample(rounds):
        for _ in range(rounds):
            jcc.load_monitor.task_runner.sample_once()
            jsim.advance(5)
            psim.advance(5)
            jclock["now"] += 5
            pclock["now"] += 5

    pclock = {"now": jclock["now"]}
    sample(8)
    jsnap, loads, caps = monitor_inputs(jcc.load_monitor,
                                        jclock["now"] * 1000.0)
    psnap = MetadataClient(psim).refresh_metadata()
    assert snapshot_key(psnap) == snapshot_key(jsnap)
    pmon = SnapshotLoadMonitor(psnap, loads, caps, device="cpu")
    pcc = F.CruiseControl(
        load_monitor=pmon, admin=psim, device="cpu",
        goal_names=list(INCR_GOALS),
        options_generator=DefaultOptimizationOptionsGenerator(PATTERN),
        time_fn=lambda: pclock["now"], sleep_fn=_ticking(psim, pclock),
        executor_kwargs=dict(progress_check_interval_s=1.0))

    def refresh():
        """What a sampling loop would do after an execution: new
        metadata, the windows' current loads."""
        sample(1)
        jsnap, loads, _caps = monitor_inputs(jcc.load_monitor,
                                             jclock["now"] * 1000.0)
        psnap = MetadataClient(psim).refresh_metadata()
        assert snapshot_key(psnap) == snapshot_key(jsnap)
        pmon.update_cluster(psnap)
        pmon.update_loads(loads)

    out = {}
    try:
        for name, call in (
                ("rebalance", lambda cc, **kw: cc.rebalance(**kw)),
                ("remove", lambda cc, **kw: cc.remove_brokers([1], **kw)),
                ("demote", lambda cc, **kw: cc.demote_brokers([0], **kw))):
            answers, refusals = [], []
            for cc, ongoing in ((jcc, JOngoing),
                                (pcc, F.OngoingExecutionError)):
                held, release = hold_first_sleep(cc.executor)
                try:
                    answers.append(call(cc, dryrun=False,
                                        uuid=UUIDS[name]))
                    if answers[-1].execution_uuid is not None:
                        assert held.wait(60.0)
                        with pytest.raises(ongoing) as err:
                            call(cc, dryrun=False)
                        refusals.append(str(err.value))
                finally:
                    release.set()
                assert cc.executor.await_completion(timeout=60.0)
            out[name] = (answers[0], answers[1],
                         snapshot_key(jsim.describe_cluster()),
                         snapshot_key(psim.describe_cluster()),
                         tasks_key(jcc.executor), tasks_key(pcc.executor),
                         refusals)
            refresh()
        out["history"] = tuple(
            (sorted(cc.executor.recently_removed_brokers()),
             sorted(cc.executor.recently_demoted_brokers()),
             norm(cc._self_healing_options())) for cc in (jcc, pcc))
        out["sampling"] = pmon.sampling_paused_reason
    finally:
        jcc.shutdown()
        pcc.shutdown()
    return out


@pytest.mark.parametrize("name", list(UUIDS))
def test_executed_request_equals_reference(executed, name):
    j, p, jsnap, psnap, jtasks, ptasks, refusals = executed[name]
    assert proposal_keys(p) == proposal_keys(j) and p.proposals
    assert p.execution_uuid == j.execution_uuid == UUIDS[name]
    assert p.dryrun is False and j.dryrun is False
    assert psnap == jsnap
    assert ptasks == jtasks
    assert {t[2] for t in ptasks} == {"COMPLETED"}
    assert len(refusals) == 2 and refusals[1] == refusals[0]


def test_history_and_next_self_healing_options(executed):
    jax_side, port_side = executed["history"]
    assert port_side == jax_side
    assert port_side[0] == [1] and port_side[1] == [0]
    assert port_side[2] is not None
    assert executed["sampling"] is None


def test_recovery_through_the_facades(tmp_path):
    """A crashed journaled execution recovered by each package's facade:
    the same report and snapshot, idempotent; the port keeps the
    recovery's trace."""
    outs = []
    for k in KITS:
        jdir = str(tmp_path / k.name)
        sim, _growth, uuid = crashed_run(k, jdir, kill_sleep=2,
                                         throttle=100e6)
        clock = lambda sim=sim: sim.now_ms() / 1000.0  # noqa: E731
        if k.name == "jax":
            cc = JCruiseControl(
                sim, SimulatedClusterSampler(sim), time_fn=clock,
                sleep_fn=sim.advance,
                executor_kwargs=dict(progress_check_interval_s=1.0),
                executor_journal_dir=jdir, auto_warmup=False,
                scheduler_enabled=False)
        else:
            cc = F.CruiseControl(
                load_monitor=SnapshotLoadMonitor(
                    MetadataClient(sim).refresh_metadata(), {}, {},
                    device="cpu"),
                admin=sim, device="cpu", time_fn=clock,
                sleep_fn=sim.advance,
                executor_kwargs=dict(progress_check_interval_s=1.0),
                executor_journal_dir=jdir)
        try:
            report = cc.recover_interrupted_execution()
            assert report is not None and report["uuid"] == uuid
            assert cc.executor.await_completion(timeout=60.0)
            assert cc.recover_interrupted_execution() is None
            outs.append((report, snapshot_key(sim.describe_cluster())))
            if k.name == "port":
                doc = cc.last_recovery_trace.to_json()
                assert doc["outcome"] == "ok"
                assert [c["name"] for c in doc["root"]["children"]] == [
                    "recovery.replay", "recovery.reconcile",
                    "recovery.resume"]
        finally:
            cc.shutdown()
    assert outs[1] == outs[0]


def test_journal_error_is_counted(tmp_path):
    sim = make_port_sim()
    pcc = F.CruiseControl(
        load_monitor=SnapshotLoadMonitor(
            MetadataClient(sim).refresh_metadata(), {}, {}, device="cpu"),
        admin=sim, device="cpu", time_fn=lambda: sim.now_ms() / 1000.0,
        sleep_fn=sim.advance, executor_journal_dir=str(tmp_path / "j"),
        executor_kwargs=dict(progress_check_interval_s=1.0))
    from cruise_control_tpu_torch.analyzer.proposals import (
        ExecutionProposal, ReplicaPlacement)
    from cruise_control_tpu_torch.model.topology import PartitionId
    proposal = ExecutionProposal(
        PartitionId("t0", 0), 0, (ReplicaPlacement(0), ReplicaPlacement(1)),
        (ReplicaPlacement(2), ReplicaPlacement(1)), 1e4)
    try:
        with faults.injected(faults.FaultPlan().fail_always(
                "executor.journal.write")):
            pcc.executor.execute_proposals([proposal], wait=True)
        assert pcc.journal_error_events == 1
        assert pcc.last_journal_error.startswith("FaultError")
        info = sim.describe_cluster().partition(TopicPartition("t0", 0))
        assert set(info.replicas) == {1, 2}
    finally:
        pcc.shutdown()


def test_dryrun_false_needs_an_admin():
    sim = make_port_sim()
    pcc = F.CruiseControl(load_monitor=SnapshotLoadMonitor(
        MetadataClient(sim).refresh_metadata(), {}, {}, device="cpu"),
        device="cpu")
    assert pcc.executor is None
    for call in (lambda: pcc.rebalance(dryrun=False),
                 lambda: pcc.remove_brokers([1], dryrun=False),
                 lambda: pcc.fix_offline_replicas(dryrun=False)):
        with pytest.raises(ValueError, match="admin"):
            call()
    with pytest.raises(ValueError, match="resume|abort"):
        F.CruiseControl(load_monitor=pcc.load_monitor, device="cpu",
                        executor_recovery_mode="later")
