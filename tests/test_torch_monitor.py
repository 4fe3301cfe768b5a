"""The PyTorch port's monitor model half, model deltas and device model
store (cruise_control_tpu_torch/monitor/load_monitor.py, monitor/
deltas.py, model/store.py) against the JAX reference, on the CPU.

A JAX `LoadMonitor` samples a `SimulatedCluster` (as tests/
test_incremental.py builds one) with JBOD logdirs on the even brokers,
one of them failed, and a capacity resolver that lists them.  Its
metadata snapshot, its capacities and the expected leader loads of its
aggregated windows are converted field by field into the port's records
and feed the port's `SnapshotLoadMonitor`.  Then:
- `cluster_model()` equals the reference's exactly, before any delta,
  after each delta kind (capacity override, load update, demote, add,
  remove), after one delta of every kind and after a chain, and
  `deltas_between` gives the same chain;
- for the port alone, the store's fast-forward equals a rebuild byte for
  byte for every delta kind and for the chain, as the reference's pin
  does (tests/test_incremental.py:151-181);
- an unlogged change breaks the chain, a capacity-flag mismatch never
  fast-forwards, unknown ids are rejected or unsupported, and a failure
  mid-apply (the store's fault site `store.apply_delta`) quarantines the
  store.
"""
import numpy as np
import pytest
import torch

from cruise_control_tpu.cluster.simulated import SimulatedCluster
from cruise_control_tpu.cluster.types import TopicPartition as JTP
from cruise_control_tpu.config.capacity import (
    BrokerCapacity as JBrokerCapacity, BrokerCapacityConfigResolver)
from cruise_control_tpu.monitor import deltas as JD
from cruise_control_tpu.monitor.completeness import \
    ModelCompletenessRequirements
from cruise_control_tpu.monitor.load_monitor import LoadMonitor as JMonitor
from cruise_control_tpu.monitor.sampling.sampler import \
    SimulatedClusterSampler
from cruise_control_tpu.scenario.spec import BrokerAdd as JBrokerAdd
from cruise_control_tpu_torch.cluster import types as PT
from cruise_control_tpu_torch.config.capacity import BrokerCapacity
from cruise_control_tpu_torch.model import store as ST
from cruise_control_tpu_torch.model.state import STATE_FIELDS
from cruise_control_tpu_torch.monitor import deltas as PD
from cruise_control_tpu_torch.monitor.load_monitor import \
    SnapshotLoadMonitor
from cruise_control_tpu_torch.scenario.spec import BrokerAdd
from cruise_control_tpu_torch.utils import faults

STATIC = ("num_racks", "num_hosts", "num_topics")
JBOD_DISKS = {"/d0": 6e5, "/d1": 6e5}


class JbodResolver(BrokerCapacityConfigResolver):
    """Uniform capacities; the even brokers list two logdirs."""

    def capacity_for_broker(self, rack, host, broker_id,
                            allow_estimation=True):
        caps = (100.0, 2e5, 2e5, 1.2e6)
        if broker_id % 2 == 0:
            return JBrokerCapacity(caps, dict(JBOD_DISKS))
        return JBrokerCapacity(caps)


def build_sim(num_brokers=6, partitions=20):
    """Brokers on 3 racks (JBOD on the even ones, broker 0's /d0
    failed), one topic of rf 3 with rising loads."""
    sim = SimulatedCluster()
    for b in range(num_brokers):
        sim.add_broker(b, rack=f"rack{b % 3}",
                       logdirs=("/d0", "/d1") if b % 2 == 0 else ("/d0",))
    assignments = [[(p + i) % num_brokers for i in range(3)]
                   for p in range(partitions)]
    sim.create_topic("t0", assignments, size_bytes=1e4)
    for p in range(partitions):
        sim.set_partition_load(JTP("t0", p), leader_cpu=2.0 + p * 0.1,
                               nw_in=100.0 + p, nw_out=300.0)
    sim.fail_disk(0, "/d0")
    return sim


def sample(mon, sim, clock, rounds=6):
    for _ in range(rounds):
        mon.task_runner.sample_once()
        sim.advance(5)
        clock["now"] += 5


def make_jax_monitor(sim, clock, **kwargs):
    mon = JMonitor(sim, SimulatedClusterSampler(sim), JbodResolver(),
                   num_windows=3, window_ms=10_000, min_samples_per_window=1,
                   time_fn=lambda: clock["now"], **kwargs)
    mon.task_runner.start(do_sampling=False)
    sample(mon, sim, clock)
    return mon


# ---------------------------------------------------------------------------
# the reference's records, field by field, as the port's
# ---------------------------------------------------------------------------
def port_snapshot(js):
    brokers = tuple(PT.BrokerInfo(
        b.broker_id, b.host, b.rack, b.alive,
        tuple(PT.LogDirInfo(d.path, d.capacity_bytes, d.used_bytes,
                            d.offline) for d in b.logdirs))
        for b in js.brokers)
    partitions = tuple(PT.PartitionInfo(
        PT.TopicPartition(p.tp.topic, p.tp.partition), p.leader,
        tuple(p.replicas), tuple(p.in_sync), tuple(p.offline_replicas),
        dict(p.logdir_by_broker)) for p in js.partitions)
    return PT.ClusterSnapshot(js.generation, brokers, partitions,
                              js.controller_id)


def port_capacity(jc):
    return BrokerCapacity(
        tuple(jc.capacity),
        None if jc.disk_capacity_by_logdir is None
        else dict(jc.disk_capacity_by_logdir),
        jc.num_cpu_cores, jc.is_estimated, jc.estimation_info)


def port_delta(jd):
    return PD.ModelDelta(
        add_brokers=tuple(BrokerAdd(a.broker_id, a.rack, a.capacity)
                          for a in jd.add_brokers),
        remove_brokers=tuple(jd.remove_brokers),
        demote_brokers=tuple(jd.demote_brokers),
        capacity_overrides={b: dict(c)
                            for b, c in jd.capacity_overrides.items()},
        load_updates=tuple(PD.PartitionLoadUpdate(u.topic, u.partition,
                                                  tuple(u.load))
                           for u in jd.load_updates),
        reason=jd.reason)


def monitor_inputs(jmon, now_ms):
    """(snapshot, leader loads, capacities) the JAX monitor's next build
    reads: its metadata, the windows' expected leader utilization of
    every sampled partition, each broker's resolved capacity."""
    snap = jmon.metadata.refresh_metadata()
    result = jmon.partition_aggregator.aggregate_with_requirements(
        now_ms, ModelCompletenessRequirements(
            min_monitored_partitions_percentage=(
                jmon._min_valid_partition_ratio)),
        max_allowed_extrapolations=jmon._max_extrapolations_partition)
    loads = {(e.topic, e.partition): jmon._expected_utilization(v)
             for e, v in result.entity_values.items()}
    caps = {b.broker_id: port_capacity(
        jmon._capacity_resolver.capacity_for_broker(b.rack, b.host,
                                                    b.broker_id, True))
            for b in snap.brokers}
    return port_snapshot(snap), loads, caps


def port_monitor(jmon, clock, **kwargs):
    snap, loads, caps = monitor_inputs(jmon, clock["now"] * 1000.0)
    return SnapshotLoadMonitor(snap, loads, caps, device="cpu", **kwargs)


def assert_states_equal(js, ps):
    for f in STATE_FIELDS:
        want = np.asarray(getattr(js, f))
        got = getattr(ps, f).cpu().numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), f
    for f in STATIC:
        assert getattr(ps, f) == getattr(js, f), f


def assert_models_equal(jmon, pmon):
    (js, jt), (ps, pt) = jmon.cluster_model(), pmon.cluster_model()
    assert_states_equal(js, ps)
    assert pt.broker_ids == jt.broker_ids and pt.topics == jt.topics
    assert pt.rack_ids == jt.rack_ids and pt.host_names == jt.host_names
    assert pt.disk_names == jt.disk_names
    assert ([(p.topic, p.partition) for p in pt.partitions]
            == [(p.topic, p.partition) for p in jt.partitions])
    return ps, pt


def port_states_equal(a, b) -> bool:
    return all(getattr(a, f).dtype == getattr(b, f).dtype
               and torch.equal(getattr(a, f), getattr(b, f))
               for f in STATE_FIELDS) and all(
        getattr(a, f) == getattr(b, f) for f in STATIC)


# ---------------------------------------------------------------------------
@pytest.fixture()
def rig():
    sim = build_sim()
    clock = {"now": 10_000.0}
    jmon = make_jax_monitor(sim, clock)
    pmon = port_monitor(jmon, clock)
    store = ST.DeviceModelStore()
    state, topo = pmon.cluster_model()
    store.install(pmon.model_generation(), state, topo, True,
                  pmon.follower_cpu_estimator())
    yield sim, jmon, pmon, store, clock
    jmon.shutdown()


DELTAS = {
    "capacity": JD.ModelDelta(capacity_overrides={2: {"disk": 5e5,
                                                      "cpu": 80.0}}),
    "load": JD.ModelDelta(load_updates=(
        JD.PartitionLoadUpdate("t0", 5, (6.0, 140.0, 420.0, 3e4)),
        JD.PartitionLoadUpdate("t0", 11, (1.0, 10.0, 30.0, 1e3)),
        JD.PartitionLoadUpdate("t0", 5, (7.0, 150.0, 400.0, 2e4)))),
    "demote": JD.ModelDelta(demote_brokers=(4,)),
    "add-new": JD.ModelDelta(add_brokers=(JBrokerAdd(broker_id=1),)),
    "remove": JD.ModelDelta(remove_brokers=(5,)),
    "every kind": JD.ModelDelta(
        add_brokers=(JBrokerAdd(broker_id=3),), remove_brokers=(1,),
        demote_brokers=(2, 4), capacity_overrides={0: {"nw_in": 3e5}},
        load_updates=(JD.PartitionLoadUpdate("t0", 2,
                                             (3.0, 50.0, 90.0, 2e4)),)),
}
CHAIN = (JD.ModelDelta(capacity_overrides={0: {"nw_in": 3e5}}),
         JD.ModelDelta(load_updates=(JD.PartitionLoadUpdate(
             "t0", 2, (3.0, 50.0, 90.0, 2e4)),)),
         JD.ModelDelta(demote_brokers=(1,)),
         JD.ModelDelta(capacity_overrides={0: {"cpu": 70.0}}))


def test_cluster_model_equals_reference(rig):
    _sim, jmon, pmon, _store, _clock = rig
    ps, _ = assert_models_equal(jmon, pmon)
    # the rig carries a failed logdir, so offline replicas and bad disks
    assert bool(ps.replica_offline.any()) and bool(ps.broker_bad_disks.any())
    assert not bool(ps.disk_alive.all())


def _apply_both(jmon, pmon, deltas):
    for jd in deltas:
        jg = jmon.apply_model_delta(jd)
        pg = pmon.apply_model_delta(port_delta(jd))
        assert (pg.cluster_generation, pg.delta_generation) == \
            (jg.cluster_generation, jg.delta_generation)
    return jg, pg


def _assert_chains_equal(jchain, pchain):
    assert [(r.seq, port_delta(r.delta)) for r in jchain] == \
        [(r.seq, r.delta) for r in pchain]
    for jr, pr in zip(jchain, pchain):
        for jg, pg in ((jr.from_generation, pr.from_generation),
                       (jr.to_generation, pr.to_generation)):
            assert (pg.cluster_generation, pg.delta_generation) == \
                (jg.cluster_generation, jg.delta_generation)


@pytest.mark.parametrize("kind", sorted(DELTAS))
def test_delta_kind_matches_reference_and_fast_forwards(rig, kind):
    _sim, jmon, pmon, store, _clock = rig
    j0, p0 = jmon.model_generation(), pmon.model_generation()
    jg, pg = _apply_both(jmon, pmon, [DELTAS[kind]])
    rebuilt, _ = assert_models_equal(jmon, pmon)
    jchain, pchain = jmon.deltas_between(j0, jg), \
        pmon.deltas_between(p0, pg)
    assert pchain and len(pchain) == 1
    _assert_chains_equal(jchain, pchain)
    got = store.advance(pchain, pg)
    assert got is not None, store.last_fallback_reason
    assert port_states_equal(got[0], rebuilt)
    assert store.last_dirty_brokers >= 1 and store.delta_applies == 1
    assert store.hits == 1 and store.fallbacks == 0


def test_chain_matches_reference_and_fast_forwards(rig):
    _sim, jmon, pmon, store, _clock = rig
    j0, p0 = jmon.model_generation(), pmon.model_generation()
    jg, pg = _apply_both(jmon, pmon, CHAIN)
    rebuilt, _ = assert_models_equal(jmon, pmon)
    pchain = pmon.deltas_between(p0, pg)
    assert pchain and len(pchain) == len(CHAIN)
    _assert_chains_equal(jmon.deltas_between(j0, jg), pchain)
    # a sub-chain from the middle, and the empty chain
    mid_j, mid_p = jmon.deltas_between(j0, jg)[1], pchain[1]
    _assert_chains_equal(
        jmon.deltas_between(mid_j.from_generation, jg),
        pmon.deltas_between(mid_p.from_generation, pg))
    assert pmon.deltas_between(pg, pg) == []
    got = store.advance(pchain, pg)
    assert got is not None
    assert port_states_equal(got[0], rebuilt)
    dirty = store.dirty_since(p0)
    assert dirty is not None and bool(dirty[[0, 1]].all())
    assert store.dirty_since(pg).sum() == 0
    assert store.to_json()["dirtyChainLength"] == len(CHAIN)


def test_new_loads_prune_overrides_as_the_reference(rig):
    """A load override stamped before fresh samples is superseded."""
    sim, jmon, pmon, _store, clock = rig
    _apply_both(jmon, pmon, [DELTAS["load"]])
    sample(jmon, sim, clock, rounds=2)
    _snap, loads, _caps = monitor_inputs(jmon, clock["now"] * 1000.0)
    before = pmon.model_generation()
    pmon.update_loads(loads)
    assert pmon.model_generation().load_generation == \
        before.load_generation + 1
    assert_models_equal(jmon, pmon)


def test_new_metadata_moves_the_cluster_generation(rig):
    sim, jmon, pmon, _store, clock = rig
    sim.kill_broker(3)
    snap, _loads, _caps = monitor_inputs(jmon, clock["now"] * 1000.0)
    g0 = pmon.model_generation()
    g1 = pmon.update_cluster(snap)
    assert g1.cluster_generation > g0.cluster_generation
    assert pmon.deltas_between(g0, g1) is None
    ps, _ = assert_models_equal(jmon, pmon)
    assert not bool(ps.broker_alive[3])


def test_unlogged_change_breaks_the_chain(rig):
    _sim, _jmon, pmon, store, _clock = rig
    g0 = store.generation
    g1 = pmon.apply_model_delta(PD.ModelDelta(
        capacity_overrides={0: {"disk": 9e5}}))
    pmon.update_loads({k: v * 1.0 for k, v in pmon._loads.items()})
    g2 = pmon.model_generation()
    assert g2 != g1
    assert pmon.deltas_between(g0, g2) is None
    assert store.advance([], g2) is None
    assert store.fallbacks == 1 and store.misses == 1
    assert store.last_fallback_reason == "generation-gap"


def test_capacity_flag_mismatch_never_fast_forwards(rig):
    from cruise_control_tpu_torch.facade import CruiseControl
    _sim, _jmon, pmon, _store, _clock = rig
    cc = CruiseControl(load_monitor=pmon, device="cpu")
    cc._model_for_solve()
    pmon.apply_model_delta(PD.ModelDelta(
        capacity_overrides={0: {"disk": 9e5}}))
    store = cc.model_store
    assert store.capacity_flag is True
    assert store.get(pmon.model_generation(), False) is None
    cc._model_for_solve(allow_capacity_estimation=False)
    assert store.delta_applies == 0
    assert store.last_fallback_reason == "capacity-estimation-flag"
    assert store.capacity_flag is False and store.misses == 2


def test_unknown_ids_are_rejected_or_unsupported(rig):
    _sim, jmon, pmon, store, _clock = rig
    for bad in (PD.ModelDelta(demote_brokers=(99,)),
                PD.ModelDelta(add_brokers=(BrokerAdd(1, rack="r"),)),
                PD.ModelDelta(),
                PD.ModelDelta(add_brokers=(BrokerAdd(1),),
                              remove_brokers=(1,)),
                PD.ModelDelta(capacity_overrides={1: {"gpu": 1.0}}),
                PD.ModelDelta(load_updates=(
                    PD.PartitionLoadUpdate("nope", 0, (1, 1, 1, 1)),))):
        with pytest.raises(PD.ModelDeltaError):
            pmon.apply_model_delta(bad)
    with pytest.raises(PD.ModelDeltaError):
        PD.PartitionLoadUpdate("t0", 0, (1.0, -1.0, 0.0, 0.0))
    # a partition the resident model has no load for: the monitor takes
    # the update, the store cannot address it and falls back
    loads = dict(pmon._loads)
    del loads[("t0", 7)]
    pmon.update_loads(loads)
    state, topo = pmon.cluster_model()
    store.install(pmon.model_generation(), state, topo, True,
                  pmon.follower_cpu_estimator())
    g0 = pmon.model_generation()
    g1 = pmon.apply_model_delta(PD.ModelDelta(load_updates=(
        PD.PartitionLoadUpdate("t0", 7, (1.0, 1.0, 1.0, 1.0)),)))
    assert store.advance(pmon.deltas_between(g0, g1), g1) is None
    assert store.last_fallback_reason.startswith("unsupported-delta")
    assert store.quarantines == 0 and store.to_json()["resident"]


def test_failure_mid_apply_quarantines(rig):
    _sim, _jmon, pmon, store, _clock = rig
    g0 = store.generation
    g1 = pmon.apply_model_delta(PD.ModelDelta(
        capacity_overrides={0: {"disk": 1.3e6}}))
    plan = faults.FaultPlan().fail_nth("store.apply_delta", 1)
    with faults.injected(plan) as injector:
        assert store.advance(pmon.deltas_between(g0, g1), g1) is None
    assert injector.failure_count("store.apply_delta") == 1
    assert store.quarantines == 1 and store.fallbacks == 1
    assert store.last_fallback_reason.startswith("quarantined")
    assert not store.to_json()["resident"]
    # the next consult rebuilds and installs
    from cruise_control_tpu_torch.facade import CruiseControl
    cc = CruiseControl(load_monitor=pmon, device="cpu")
    cc.model_store = store
    state, _ = cc._model_for_solve()
    assert store.to_json()["resident"] and store.misses == 1
    assert port_states_equal(state, pmon.cluster_model()[0])


def test_overlay_clear_and_estimator_weights():
    sim = build_sim()
    clock = {"now": 10_000.0}
    weights = (0.5, 0.3, 0.4)
    jmon = make_jax_monitor(sim, clock, cpu_util_weights=weights)
    try:
        pmon = port_monitor(jmon, clock, cpu_util_weights=weights)
        assert_models_equal(jmon, pmon)
        _, before = _apply_both(jmon, pmon, [DELTAS["every kind"]])
        assert_models_equal(jmon, pmon)
        jg, pg = jmon.clear_model_overlay(), pmon.clear_model_overlay()
        assert pg.delta_generation == jg.delta_generation
        # a clear is not logged: the store must rebuild across it
        assert pmon.deltas_between(before, pg) is None
        assert_models_equal(jmon, pmon)
    finally:
        jmon.shutdown()


def test_monitor_raises_without_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    snap = PT.ClusterSnapshot(1, (PT.BrokerInfo(0),), ())
    with pytest.raises(RuntimeError):
        SnapshotLoadMonitor(snap, {},
                            {0: BrokerCapacity((1.0, 1.0, 1.0, 1.0))})
