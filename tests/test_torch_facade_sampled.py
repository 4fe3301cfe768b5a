"""The PyTorch port's facade built as the reference's is, over its own
sampled `LoadMonitor` (cruise_control_tpu_torch/facade.py), against the
JAX reference's `CruiseControl`, on the CPU.

Both facades are built with the reference's `make_stack` arguments
(tests/test_facade.py: 4 brokers on two racks, one topic of 12
partitions at rf 2 all on brokers 0 and 1, the simulated sampler, 3
windows of 10 s, `FACADE_TEST_GOALS`), each over its own package's
`SimulatedCluster` on its own virtual clock: `CruiseControl(sim,
SimulatedClusterSampler(sim), time_fn=..., sleep_fn=...,
monitor_kwargs=..., executor_kwargs=..., goal_names=...)`, the port's
with `device="cpu"`.  Both start up without a sampling thread and take 8
sampling rounds, then in one sequence:
- `optimizations()`: proposals, stats (before, after and by goal, bit
  for bit), rounds, balancedness; the same again is a cache hit;
- `update_topic_replication_factor` up to 3 and down to 1, dry runs,
  and its errors;
- `rebalance(dryrun=False, wait=True)`: proposals and the cluster after;
- 8 more sampling rounds, then `optimizations()` again: its model
  (rebuilt by the sampled monitor, with no `update_cluster` call) holds
  the executed placement, and its answer and the store's counters equal
  the reference's;
- `update_topic_replication_factor` up to 3 and back to 1, executed:
  proposals and the simulated clusters' replica sets after each.
"""
import numpy as np
import pytest

from cruise_control_tpu.cluster.simulated import SimulatedCluster as JSim
from cruise_control_tpu.cluster.types import TopicPartition as JTP
from cruise_control_tpu.facade import CruiseControl as JCruiseControl
from cruise_control_tpu.monitor.sampling.sampler import \
    SimulatedClusterSampler as JSampler
from cruise_control_tpu_torch import facade as F
from cruise_control_tpu_torch.cluster.simulated import \
    SimulatedCluster as PSim
from cruise_control_tpu_torch.cluster.types import TopicPartition as PTP
from cruise_control_tpu_torch.model.stats import ClusterModelStats
from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor
from cruise_control_tpu_torch.monitor.sampling.sampler import \
    SimulatedClusterSampler as PSampler
from test_torch_executor import snapshot_key
from test_torch_facade import COUNTERS, counters, proposal_keys

#: the reference's facade test goals (tests/test_facade.py)
FACADE_TEST_GOALS = ["RackAwareGoal", "DiskCapacityGoal",
                     "ReplicaDistributionGoal",
                     "DiskUsageDistributionGoal"]
MONITOR_KWARGS = dict(num_windows=3, window_ms=10_000,
                      min_samples_per_window=1, sampling_interval_ms=5_000)


def make_stack(jax: bool, num_brokers=4, partitions=12, rf=2):
    """The reference's make_stack (skewed: every replica on brokers 0 and
    1) for one package: (sim, facade, clock)."""
    Sim, TP = (JSim, JTP) if jax else (PSim, PTP)
    sim = Sim()
    clock = {"now": 10_000.0}
    for b in range(num_brokers):
        sim.add_broker(b, rack=f"rack{b % 2}")
    sim.create_topic("t0", [[i % 2 for i in range(rf)]
                            for _ in range(partitions)], size_bytes=1e4)
    for p in range(partitions):
        sim.set_partition_load(TP("t0", p), leader_cpu=2.0, nw_in=100.0,
                               nw_out=300.0)
    common = dict(
        time_fn=lambda: clock["now"],
        sleep_fn=lambda s: (sim.advance(s),
                            clock.__setitem__("now", clock["now"] + s)),
        monitor_kwargs=dict(MONITOR_KWARGS),
        executor_kwargs=dict(progress_check_interval_s=1.0),
        goal_names=list(FACADE_TEST_GOALS))
    if jax:
        cc = JCruiseControl(sim, JSampler(sim), auto_warmup=False, **common)
        cc.start_up(do_sampling=False, start_detection=False)
    else:
        cc = F.CruiseControl(sim, PSampler(sim), device="cpu", **common)
        cc.start_up(do_sampling=False)
    return sim, cc, clock


def feed_samples(cc, clock, rounds=8):
    for _ in range(rounds):
        cc.load_monitor.task_runner.sample_once()
        clock["now"] += 10.0


def stats_key(stats) -> tuple:
    return tuple((f, np.asarray(v.cpu() if hasattr(v, "cpu") else v)
                  .tobytes()) for f, v in
                 ((f, getattr(stats, f))
                  for f in ClusterModelStats.__dataclass_fields__))


def result_key(r) -> tuple:
    return (proposal_keys(r), stats_key(r.stats_before),
            stats_key(r.stats_after),
            tuple(sorted((g, stats_key(s))
                         for g, s in r.stats_by_goal.items())),
            tuple(sorted(r.rounds_by_goal.items())),
            float(r.balancedness_score()))


def rf_key(op) -> tuple:
    """A topic-configuration answer: each proposal whole, in order."""
    return (op.dryrun, op.execution_uuid is not None, tuple(
        (p.partition.topic, p.partition.partition, p.old_leader,
         tuple(r.broker_id for r in p.old_replicas),
         tuple(r.broker_id for r in p.new_replicas)) for p in op.proposals))


def replica_sets(sim) -> tuple:
    return tuple((p.tp.topic, p.tp.partition, p.leader, tuple(p.replicas))
                 for p in sim.describe_cluster().partitions)


def model_placement(state, topo) -> dict:
    """{(topic, partition): (broker set, leader)} of a model."""
    valid = state.replica_valid.cpu().numpy()
    part = state.replica_partition.cpu().numpy()
    broker = state.replica_broker.cpu().numpy()
    lead = state.replica_is_leader.cpu().numpy()
    out: dict = {}
    for ok, p, b, is_lead in zip(valid, part, broker, lead):
        if ok:
            pid = topo.partitions[p]
            brokers, leader = out.setdefault((pid.topic, pid.partition),
                                             (set(), [None]))
            brokers.add(topo.broker_ids[b])
            if is_lead:
                leader[0] = topo.broker_ids[b]
    return {k: (frozenset(b), lead[0]) for k, (b, lead) in out.items()}


@pytest.fixture(scope="module")
def sequence():
    """{step: (JAX answer, port answer)} of the whole sequence."""
    jsim, jcc, jclock = make_stack(True)
    psim, pcc, pclock = make_stack(False)
    assert isinstance(pcc.load_monitor, LoadMonitor)
    out = {}

    def both(name, j_call, p_call, key):
        out[name] = (key(j_call()), key(p_call()))
    try:
        feed_samples(jcc, jclock)
        feed_samples(pcc, pclock)
        first = [cc.optimizations() for cc in (jcc, pcc)]
        out["optimizations"] = tuple(result_key(r) for r in first)
        out["cache hit"] = tuple(cc.optimizations() is r
                                 for cc, r in zip((jcc, pcc), first))
        for rf in (3, 1):
            both(f"rf {rf} dry run",
                 lambda: jcc.update_topic_replication_factor("t0", rf),
                 lambda: pcc.update_topic_replication_factor("t0", rf),
                 rf_key)
        errors = []
        for cc in (jcc, pcc):
            got = []
            for args in (("nope", 2), ("t0", 5), ("t0", 0)):
                with pytest.raises(ValueError) as exc:
                    cc.update_topic_replication_factor(*args)
                got.append(str(exc.value))
            errors.append(tuple(got))
        out["rf errors"] = tuple(errors)
        executed = [cc.rebalance(dryrun=False, wait=True)
                    for cc in (jcc, pcc)]
        out["rebalance executed"] = tuple(
            (proposal_keys(op), op.dryrun, op.execution_uuid is not None,
             snapshot_key(sim.describe_cluster()))
            for op, sim in zip(executed, (jsim, psim)))
        feed_samples(jcc, jclock)
        feed_samples(pcc, pclock)
        again = [cc.optimizations() for cc in (jcc, pcc)]
        out["after sampling"] = tuple(result_key(r) for r in again)
        out["store"] = (counters(jcc._model_store.to_json()),
                        counters(pcc.model_store.to_json()))
        state, topo = pcc.model_store._state, pcc.model_store._topology
        out["placement"] = (
            {(p.tp.topic, p.tp.partition): (frozenset(p.replicas), p.leader)
             for p in psim.describe_cluster().partitions},
            model_placement(state, topo))
        for rf in (3, 1):
            both(f"rf {rf} executed",
                 lambda: jcc.update_topic_replication_factor(
                     "t0", rf, dryrun=False, wait=True),
                 lambda: pcc.update_topic_replication_factor(
                     "t0", rf, dryrun=False, wait=True), rf_key)
            out[f"rf {rf} replica sets"] = (replica_sets(jsim),
                                            replica_sets(psim))
    finally:
        jcc.shutdown()
        pcc.shutdown()
    out["stopped"] = (pcc.load_monitor.task_runner._shutdown,
                      pcc.load_monitor._fetcher._pool._shutdown)
    return out


STEPS = ["optimizations", "cache hit", "rf 3 dry run", "rf 1 dry run",
         "rf errors", "rebalance executed", "after sampling", "store",
         "rf 3 executed", "rf 3 replica sets", "rf 1 executed",
         "rf 1 replica sets"]


@pytest.mark.parametrize("step", STEPS)
def test_sampled_facade_step_equals_reference(sequence, step):
    want, got = sequence[step]
    assert got == want


def test_sampled_facade_outcomes(sequence):
    """What the steps must show beyond equality: a solve with proposals,
    real topic changes, an execution, and the executed placement in the
    next sampled model."""
    assert sequence["optimizations"][1][0]
    assert sequence["cache hit"] == (True, True)
    assert len(sequence["rf 3 dry run"][1][2]) == 12
    assert sequence["rebalance executed"][1][2] is True
    cluster, modeled = sequence["placement"]
    assert modeled == cluster
    # the solve moved replicas off brokers 0 and 1: the model shows it
    assert any(b >= 2 for brokers, _ in modeled.values() for b in brokers)
    assert all(len(r[3]) == 3 for r in sequence["rf 3 replica sets"][1])
    assert all(len(r[3]) == 1 for r in sequence["rf 1 replica sets"][1])
    assert sequence["stopped"] == (True, True)
    assert set(COUNTERS) <= set(sequence["store"][1])
