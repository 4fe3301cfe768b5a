"""The PyTorch port's sampling plane (cruise_control_tpu_torch/monitor/
sampling/, monitor/task_runner.py, config/capacity.py's resolvers,
model/cpu_model.py's linear CPU model) against the JAX reference's, on
the CPU.

Two `SimulatedCluster`s, one of each package, are built alike: 6 brokers
on 3 racks, two topics of rf 3 and 2, seeded loads over six decades.
- holder bytes: each package's partition and broker samples serialize
  to the same bytes, each reads the other's, and both refuse a newer
  version alike; the quarantine and the value completion agree;
- `SimulatedClusterSampler`: every mode, a subset assignment and a dead
  broker give the same samples in the same order;
- `MetricFetcherManager` at 1 and 3 fetchers over a sampler that
  corrupts some samples (NaN, Inf, negative): the same merged rounds,
  quarantine counts and aggregations; the `monitor.sampler.fetch` fault
  gives the same partial round, and `monitor.sampler.store` keeps the
  aggregation and persists nothing, in both;
- `FileSampleStore`: both files byte for byte after several rounds and
  after a retention compaction and an eviction, each package loading the
  other's files (a torn record at the end too);
- the task runner's states through start, pause, resume, loading and
  bootstrap, the sampling thread stopped by `shutdown`;
- `BrokerCapacityConfigFileResolver` on one JSON file (flat, JBOD, cores,
  the default entry), with and without estimation, and its errors;
- `LinearRegressionCpuModel`: coefficients, training error and coverage
  bit for bit, a fit that drops a negative feature, too few samples.
"""
import json
import math
import struct
import time

import numpy as np
import pytest

from cruise_control_tpu.cluster.metadata import MetadataClient as JMeta
from cruise_control_tpu.cluster.simulated import SimulatedCluster as JSim
from cruise_control_tpu.cluster.types import TopicPartition as JTP
from cruise_control_tpu.config import capacity as JC
from cruise_control_tpu.model import cpu_model as JCM
from cruise_control_tpu.monitor import aggregators as JAg
from cruise_control_tpu.monitor import task_runner as JTR
from cruise_control_tpu.monitor.sampling import fetcher as JF
from cruise_control_tpu.monitor.sampling import holder as JH
from cruise_control_tpu.monitor.sampling import sample_store as JSt
from cruise_control_tpu.monitor.sampling import sampler as JS
from cruise_control_tpu.utils import faults as jfaults
from cruise_control_tpu_torch.cluster.metadata import MetadataClient as PMeta
from cruise_control_tpu_torch.cluster.simulated import \
    SimulatedCluster as PSim
from cruise_control_tpu_torch.cluster.types import TopicPartition as PTP
from cruise_control_tpu_torch.config import capacity as PC
from cruise_control_tpu_torch.model import cpu_model as PCM
from cruise_control_tpu_torch.monitor import aggregators as PAg
from cruise_control_tpu_torch.monitor import task_runner as PTR
from cruise_control_tpu_torch.monitor.sampling import fetcher as PF
from cruise_control_tpu_torch.monitor.sampling import holder as PH
from cruise_control_tpu_torch.monitor.sampling import sample_store as PSt
from cruise_control_tpu_torch.monitor.sampling import sampler as PS
from cruise_control_tpu_torch.utils import faults as pfaults
from test_torch_aggregator import canon

#: (package name, simulated cluster, topic-partition, holder, sampler,
#: fetcher, sample store, aggregators, task runner, metadata, faults)
PKGS = {"jax": (JSim, JTP, JH, JS, JF, JSt, JAg, JTR, JMeta, jfaults),
        "port": (PSim, PTP, PH, PS, PF, PSt, PAg, PTR, PMeta, pfaults)}
TOPICS = (("t0", 20, 3), ("t1", 7, 2))


def loads(seed=7):
    g = np.random.default_rng(seed)
    out = {}
    for t, n, _rf in TOPICS:
        for p in range(n):
            cpu, nin, nout, size = g.lognormal(2.0, 2.0, size=4)
            out[(t, p)] = (float(cpu), float(nin * 100), float(nout * 300),
                           float(size * 1e4))
    return out


def make_sim(pkg: str, seed=7):
    Sim, TP = PKGS[pkg][:2]
    sim = Sim()
    for b in range(6):
        sim.add_broker(b, rack=f"rack{b % 3}")
    for t, n, rf in TOPICS:
        step = 1 if t == "t0" else 2
        sim.create_topic(t, [[(step * p + i) % 6 for i in range(rf)]
                             for p in range(n)], size_bytes=1e4)
    for (t, p), (cpu, nin, nout, size) in loads(seed).items():
        sim.set_partition_load(TP(t, p), leader_cpu=cpu, nw_in=nin,
                               nw_out=nout, size_bytes=size)
    return sim


def samples_key(samples) -> tuple:
    """The samples of a round in order, as plain values."""
    return (tuple((s.broker_id, s.tp.topic, s.tp.partition,
                   s.sample_time_ms, tuple(sorted(s.values.items())))
                  for s in samples.partition_samples),
            tuple((s.broker_id, s.sample_time_ms,
                   tuple(sorted(s.values.items())))
                  for s in samples.broker_samples))


def nan_safe(key):
    """`samples_key` with NaN made comparable."""
    return json.dumps(key, default=str)


# ---------------------------------------------------------------------------
def test_holder_bytes_identical_both_ways():
    g = np.random.default_rng(3)
    vals = {i: float(v) for i, v in enumerate(g.lognormal(3.0, 3.0, 9))}
    bvals = {i: float(v) for i, v in enumerate(g.lognormal(3.0, 3.0, 20))}
    jp = JH.PartitionMetricSample(3, JTP("topic-é", 5), 12_345.9, vals)
    pp = PH.PartitionMetricSample(3, PTP("topic-é", 5), 12_345.9, vals)
    jb = JH.BrokerMetricSample(4, 99_000.0, bvals)
    pb = PH.BrokerMetricSample(4, 99_000.0, bvals)
    assert pp.to_bytes() == jp.to_bytes()
    assert pb.to_bytes() == jb.to_bytes()

    def pkey(s):
        return (s.broker_id, s.tp.topic, s.tp.partition, s.sample_time_ms,
                sorted(s.values.items()))
    assert pkey(PH.PartitionMetricSample.from_bytes(jp.to_bytes())) == \
        pkey(JH.PartitionMetricSample.from_bytes(pp.to_bytes()))
    bj = JH.BrokerMetricSample.from_bytes(pb.to_bytes())
    bp = PH.BrokerMetricSample.from_bytes(jb.to_bytes())
    assert (bp.broker_id, bp.sample_time_ms, bp.values) == \
        (bj.broker_id, bj.sample_time_ms, bj.values)
    # values pass through float32, as the aggregator keeps them
    assert bp.values[0] == float(np.float32(bvals[0]))
    newer = bytes([2]) + jb.to_bytes()[1:]
    errors = []
    for cls in (JH.BrokerMetricSample, PH.BrokerMetricSample,
                JH.PartitionMetricSample, PH.PartitionMetricSample):
        with pytest.raises(ValueError) as exc:
            cls.from_bytes(newer)
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and errors[2] == errors[3]
    bad = [JH.BrokerMetricSample(1, 0.0, {0: math.nan}),
           JH.BrokerMetricSample(2, 0.0, {0: 1.0}),
           JH.BrokerMetricSample(3, 0.0, {0: -1.0, 1: math.inf})]
    kept, dropped = PH.quarantine_invalid(bad)
    assert ([s.broker_id for s in kept], dropped) == \
        ([s.broker_id for s in JH.quarantine_invalid(bad)[0]],
         JH.quarantine_invalid(bad)[1]) == ([2], 2)
    assert PH.complete_partition_values({2: 5.0}) == \
        JH.complete_partition_values({2: 5.0})
    assert PH.complete_broker_values({12: 5.0}) == \
        JH.complete_broker_values({12: 5.0})
    assert pb.metric_value("CPU_USAGE") == jb.metric_value("CPU_USAGE")


@pytest.mark.parametrize("dead", [False, True])
def test_simulated_sampler_equals_reference(dead):
    keys = {}
    for pkg in PKGS:
        sim = make_sim(pkg)
        if dead:
            sim.kill_broker(2)
        S, TP = PKGS[pkg][3], PKGS[pkg][1]
        sampler = S.SimulatedClusterSampler(sim)
        snap = sim.describe_cluster()
        every = {p.tp for p in snap.partitions}
        subset = {TP("t0", p) for p in range(0, 20, 3)} | {TP("t1", 4)}
        keys[pkg] = [samples_key(sampler.get_samples(
            snap, assigned, 1_000.0, 2_000.0, mode))
            for assigned in (every, subset)
            for mode in S.SamplingMode]
    assert keys["port"] == keys["jax"]
    # a round of every partition and every alive broker
    assert len(keys["port"][0][0]) == 27
    assert len(keys["port"][0][1]) == (5 if dead else 6)


class Corrupting:
    """A sampler wrapper that poisons a few samples of each round: the
    leader CPU of t0-3 NaN, t1-2's disk Inf, broker 4's bytes-in
    negative; with `fail_window`, the fetcher whose partitions include
    t0-5 raises in the rounds starting at those times."""

    def __new__(cls, S, TP, sim, fail_window=()):
        base = S.SimulatedClusterSampler(sim)

        class Wrapped(S.MetricSampler):
            def get_samples(self, cluster, assigned, start_ms, end_ms,
                            mode=S.SamplingMode.ALL):
                if start_ms in fail_window and TP("t0", 5) in assigned:
                    raise RuntimeError("this fetcher's sampler failed")
                out = base.get_samples(cluster, assigned, start_ms, end_ms,
                                       mode)
                for s in out.partition_samples:
                    if (s.tp.topic, s.tp.partition) == ("t0", 3):
                        s.values[0] = math.nan
                    if (s.tp.topic, s.tp.partition) == ("t1", 2):
                        s.values[3] = math.inf
                for s in out.broker_samples:
                    if s.broker_id == 4:
                        s.values[1] = -1.0
                return out
        return Wrapped()


def fetch_rounds(pkg, num_fetchers, rounds=4, plan=None, store_dir=None,
                 fail_window=()):
    """(merged rounds, quarantined, partition and broker aggregations,
    fault counts) of `rounds` sampling rounds one window apart."""
    (Sim, TP, H, S, F, St, Ag, TR, Meta, faults) = PKGS[pkg]
    sim = make_sim(pkg)
    pagg = Ag.PartitionMetricSampleAggregator(3, 10_000, 1)
    bagg = Ag.BrokerMetricSampleAggregator(3, 10_000, 1)
    store = St.FileSampleStore(store_dir) if store_dir else None
    mgr = F.MetricFetcherManager(Corrupting(S, TP, sim, fail_window), pagg,
                                 bagg, store, num_fetchers=num_fetchers)
    merged, counts = [], None
    try:
        injector = faults.install(plan) if plan is not None else None
        for r in range(rounds):
            snap = sim.describe_cluster()
            merged.append(nan_safe(samples_key(mgr.fetch_metrics_for_model(
                snap, r * 10_000.0, (r + 1) * 10_000.0 - 1))))
        if injector is not None:
            counts = injector.counts()
    finally:
        if plan is not None:
            faults.uninstall()
        mgr.shutdown()
        if store is not None:
            store.close()
    aggs = []
    for agg in (pagg, bagg):
        try:
            aggs.append(canon(agg.aggregate(-np.inf, np.inf)))
        except Exception as exc:  # noqa: BLE001 - compared
            aggs.append((type(exc).__name__, str(exc)))
    return merged, mgr.num_quarantined_samples, aggs, counts


@pytest.mark.parametrize("num_fetchers", [1, 3])
def test_fetcher_rounds_and_quarantine_equal_reference(num_fetchers):
    ref = fetch_rounds("jax", num_fetchers)
    port = fetch_rounds("port", num_fetchers)
    assert port == ref
    # 3 samples a round quarantined, 4 rounds
    assert port[1] == 12


def test_fetcher_partial_round_equals_reference():
    """One of 3 fetchers fails in round 1: the round keeps the others'
    samples, merged in submission order, in both packages."""
    ref = fetch_rounds("jax", 3, fail_window=(10_000.0,))
    port = fetch_rounds("port", 3, fail_window=(10_000.0,))
    assert port == ref
    rounds = [json.loads(m) for m in port[0]]
    assert 0 < len(rounds[1][0]) < len(rounds[0][0]) == 25
    assert len(rounds[2][0]) == 25


@pytest.mark.parametrize("site", ["monitor.sampler.fetch",
                                  "monitor.sampler.store"])
def test_fetcher_fault_sites_equal_reference(site, tmp_path):
    out = {}
    for pkg in PKGS:
        faults = PKGS[pkg][-1]
        plan = faults.FaultPlan()
        if site.endswith("fetch"):
            # one fetcher: the call count is the round's (with several
            # fetchers it would be the threads' race)
            plan.fail_nth(site, [2, 4])
            fetchers = 1
        else:
            plan.fail_always(site)
            fetchers = 3
        d = tmp_path / pkg
        out[pkg] = fetch_rounds(pkg, fetchers, plan=plan, store_dir=str(d))
        St = PKGS[pkg][5]
        loaded = []

        class Loader(St.SampleLoader):
            def load_samples(self, samples):
                loaded.append(samples_key(samples))
        store = St.FileSampleStore(str(d))
        store.load_samples(Loader())
        store.close()
        out[pkg] += (nan_safe(loaded),)
    assert out["port"] == out["jax"]
    merged, _q, _aggs, counts, loaded = out["port"]
    assert counts[site][1] >= 2
    if site.endswith("store"):
        # nothing persisted, the aggregation kept
        assert json.loads(loaded) == [[[], []]]
        assert "Error" not in str(_aggs[0][:1])
    else:
        # calls 2 and 4 fail: rounds 1 and 3 are empty, 0 and 2 whole (2
        # partition and 1 broker sample quarantined a round)
        rounds = [json.loads(m) for m in merged]
        assert rounds[1] == rounds[3] == [[], []]
        assert len(rounds[0][0]) == len(rounds[2][0]) == 25
        assert len(rounds[0][1]) == len(rounds[2][1]) == 5


def test_file_sample_store_bytes_and_cross_load(tmp_path):
    rounds = []
    for r in range(4):
        sim = make_sim("jax", seed=20 + r)
        got = JS.SimulatedClusterSampler(sim).get_samples(
            sim.describe_cluster(), {p.tp for p in
                                     sim.describe_cluster().partitions},
            r * 1000.0, (r + 1) * 1000.0)
        rounds.append(samples_key(got))

    def as_samples(pkg, key):
        H, S, TP = PKGS[pkg][2], PKGS[pkg][3], PKGS[pkg][1]
        parts, brokers = key
        return S.Samples(
            [H.PartitionMetricSample(b, TP(t, p), ts, dict(v))
             for b, t, p, ts, v in parts],
            [H.BrokerMetricSample(b, ts, dict(v)) for b, ts, v in brokers])

    clock = {"now": 1.0}
    stores = {}
    for pkg in PKGS:
        St = PKGS[pkg][5]
        stores[pkg] = St.FileSampleStore(
            str(tmp_path / pkg), partition_retention_ms=2_500.0,
            broker_retention_ms=3_500.0, compaction_interval_ms=1e12,
            time_fn=lambda: clock["now"])
    files = ("partition-samples.bin", "broker-samples.bin")

    def read(pkg):
        return [(tmp_path / pkg / f).read_bytes() for f in files]
    for key in rounds:
        for pkg in PKGS:
            stores[pkg].store_samples(as_samples(pkg, key))
    assert read("port") == read("jax") and len(read("port")[0]) > 1000
    # retention compaction at now = 4.5 s (the first store call ran it at
    # now = 1 s and set the cadence)
    clock["now"] = 4.5
    for pkg in PKGS:
        stores[pkg]._last_compaction_ms = None
        stores[pkg].store_samples(as_samples(pkg, rounds[-1]))
    assert read("port") == read("jax")
    assert stores["port"].evicted_samples == stores["jax"].evicted_samples > 0
    for pkg in PKGS:
        stores[pkg].evict_samples_before(3_000.0)
    assert read("port") == read("jax")
    # a torn record at the end of each partition file
    for pkg in PKGS:
        stores[pkg].close()
        with open(tmp_path / pkg / files[0], "ab") as f:
            f.write(struct.pack("<I", 500) + b"\x01\x02")
    loaded = {}
    for reader in PKGS:
        for writer in PKGS:
            St = PKGS[reader][5]
            got = []

            class Loader(St.SampleLoader):
                def load_samples(self, samples):
                    got.append(samples_key(samples))
            store = St.FileSampleStore(str(tmp_path / writer),
                                       partition_retention_ms=2_500.0,
                                       time_fn=lambda: 5.0)
            store.load_samples(Loader())
            store.close()
            loaded[(reader, writer)] = got
    assert len(set(map(repr, loaded.values()))) == 1
    assert loaded[("port", "jax")][0][0] and loaded[("port", "jax")][0][1]


def test_task_runner_states_equal_reference():
    logs = {}
    for pkg in PKGS:
        (Sim, TP, H, S, F, St, Ag, TR, Meta, faults) = PKGS[pkg]
        sim = make_sim(pkg)
        clock = {"now": 100.0}
        pagg = Ag.PartitionMetricSampleAggregator(3, 10_000, 1)
        bagg = Ag.BrokerMetricSampleAggregator(3, 10_000, 1)
        mgr = F.MetricFetcherManager(S.SimulatedClusterSampler(sim), pagg,
                                     bagg)
        runner = TR.LoadMonitorTaskRunner(Meta(sim), mgr, 5_000,
                                          time_fn=lambda: clock["now"])
        log = [runner.state.value]
        runner.start(do_sampling=False)
        log.append(runner.state.value)
        with pytest.raises(RuntimeError) as exc:
            runner.start()
        log.append(str(exc.value))
        runner.pause_sampling("an execution")
        log += [runner.state.value, runner.reason_of_pause]
        runner.set_loading(True)
        log.append(runner.state.value)
        runner.set_loading(False)
        log.append(runner.state.value)
        runner.resume_sampling("done")
        log += [runner.state.value, runner.reason_of_pause]
        seen = []
        real = mgr.fetch_metrics_for_model

        def fetch(cluster, start, end, mode, _seen=seen, _r=runner,
                  _real=real):
            _seen.append((_r.state.value, start, end))
            return _real(cluster, start, end, mode)
        mgr.fetch_metrics_for_model = fetch
        runner.bootstrap(3, advance_fn=lambda s: clock.__setitem__(
            "now", clock["now"] + s))
        log += [seen, runner.state.value, pagg.generation,
                pagg.num_samples()]
        runner.shutdown()
        mgr.shutdown()
        # the background loop: started, sampling, stopped by shutdown
        runner2 = TR.LoadMonitorTaskRunner(Meta(sim), F.MetricFetcherManager(
            S.SimulatedClusterSampler(sim), pagg, bagg), 10)
        runner2.start(do_sampling=True)
        deadline = time.time() + 10.0
        while pagg.num_samples() <= log[-1] and time.time() < deadline:
            time.sleep(0.01)
        runner2.shutdown()
        log.append(runner2._thread.is_alive())
        logs[pkg] = log
    assert logs["port"] == logs["jax"]
    assert logs["port"][-1] is False


def test_capacity_file_resolver_equals_reference(tmp_path):
    doc = {"brokerCapacities": [
        {"brokerId": "-1", "capacity": {"DISK": "1000000", "CPU": "100",
                                        "NW_IN": "100000",
                                        "NW_OUT": "100000"}},
        {"brokerId": "0", "capacity": {"DISK": {"/d0": "500000",
                                                "/d1": "250000.5"},
                                       "CPU": {"num.cores": "8"},
                                       "NW_IN": "200000",
                                       "NW_OUT": "200000"}},
        {"brokerId": "1", "capacity": {"DISK": "3e6", "CPU": "400",
                                       "NW_IN": "1.5e5",
                                       "NW_OUT": "9e4"}}]}
    path = tmp_path / "capacity.json"
    path.write_text(json.dumps(doc))

    def answers(C):
        r = C.BrokerCapacityConfigFileResolver(str(path))
        out = []
        for b in (0, 1, 7):
            for allow in (True, False):
                try:
                    cap = r.capacity_for_broker("rack0", f"h{b}", b, allow)
                    out.append((cap.capacity, cap.disk_capacity_by_logdir,
                                cap.num_cpu_cores, cap.is_estimated,
                                cap.estimation_info, cap.resource(
                                    C.Resource.DISK)))
                except KeyError as exc:
                    out.append(str(exc))
        s = C.StaticCapacityResolver(cpu=250.0)
        out.append(s.capacity_for_broker(None, "h", 3).capacity)
        for bad in ({"brokerCapacities": doc["brokerCapacities"][1:]},
                    {"brokerCapacities": [{"brokerId": "-1", "capacity": {
                        "DISK": "1", "CPU": "1"}}]}):
            bp = tmp_path / "bad.json"
            bp.write_text(json.dumps(bad))
            with pytest.raises(ValueError) as exc:
                C.BrokerCapacityConfigFileResolver(str(bp))
            out.append(str(exc.value))
        return out
    assert answers(PC) == answers(JC)
    assert answers(PC)[0][3] is False and answers(PC)[4][3] is True


def test_linear_cpu_model_equals_reference():
    g = np.random.default_rng(11)
    rows = g.lognormal(4.0, 1.0, size=(60, 3))
    cpu = rows @ np.array([0.002, 0.0007, 0.0011]) + g.normal(0, 0.05, 60)
    # a second set whose replication feature anti-correlates: the first
    # fit is negative there and the refit drops it
    cpu2 = rows[:, 0] * 0.003 - rows[:, 2] * 0.002
    out = {}
    for name, M in (("jax", JCM), ("port", PCM)):
        res = []
        for target in (cpu, cpu2):
            m = M.LinearRegressionCpuModel(cpu_util_bucket_size_pct=1,
                                           min_num_cpu_util_buckets=3,
                                           required_samples_per_bucket=2)
            with pytest.raises(ValueError) as exc:
                m.add_sample(1.0, 1.0, 1.0, 1.0)
                m.train()
            res.append(str(exc.value))
            m.clear_samples()
            res.append((m.training_error(), m.trained))
            for c, r in zip(target, rows):
                m.add_sample(float(c), float(r[0]), float(r[1]), float(r[2]))
            coefs = m.train()
            res.append((coefs.leader_bytes_in, coefs.leader_bytes_out,
                        coefs.follower_bytes_in, m.training_error(),
                        m.training_coverage(), m.ready_to_train,
                        m.num_samples, m.trained,
                        coefs.estimate_leader_cpu(1e3, 2e3),
                        coefs.estimate_follower_cpu(1e3)))
        out[name] = res
    assert out["port"] == out["jax"]
    assert 0.0 in out["port"][5][:3]     # a dropped feature
