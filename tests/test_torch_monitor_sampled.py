"""The PyTorch port's sampled `LoadMonitor` (cruise_control_tpu_torch/
monitor/load_monitor.py) against the JAX reference's, on the CPU.

Two `SimulatedCluster`s, one of each package, are built as tests/
test_torch_monitor.py builds its rig (6 brokers on 3 racks, JBOD logdirs
on the even brokers with broker 0's /d0 failed, one topic of rf 3 with
rising loads) and each is sampled by its own package's monitor, with
the same settings, resolver and virtual clock.  One script of steps runs
on both and must give the same answers:
- `cluster_model` after sampling rounds, under several completeness
  requirements: every array of the state (bit for bit) and the topology;
- the completeness errors (no sample, too few windows, too few monitored
  partitions) and `meet_completeness_requirements`;
- `get_state` at each step, its TTL cache included, and pause / resume;
- `train` from the broker windows, then a rebuild with the trained
  follower-CPU attribution;
- a dead broker sampled and modeled;
- the sequence of model generations across sampling rounds, deltas, an
  overlay clear, training and metadata changes, and the delta chains.
For the port alone, training moves the generation unlogged, so the
device model store rebuilds (a counted `generation-gap` fallback) rather
than fast-forwards, and `shutdown` stops the sampling thread and the
fetcher pool.
"""
import dataclasses

import numpy as np
import pytest

from cruise_control_tpu.cluster.simulated import SimulatedCluster as JSim
from cruise_control_tpu.cluster.types import TopicPartition as JTP
from cruise_control_tpu.config.capacity import (
    BrokerCapacity as JBrokerCapacity, BrokerCapacityConfigResolver as JR)
from cruise_control_tpu.core.aggregator import \
    NotEnoughValidWindowsError as JNotEnough
from cruise_control_tpu.monitor import deltas as JD
from cruise_control_tpu.monitor.completeness import \
    ModelCompletenessRequirements as JReq
from cruise_control_tpu.monitor.load_monitor import LoadMonitor as JMonitor
from cruise_control_tpu.monitor.sampling.sampler import \
    SimulatedClusterSampler as JSampler
from cruise_control_tpu_torch.cluster.simulated import \
    SimulatedCluster as PSim
from cruise_control_tpu_torch.cluster.types import TopicPartition as PTP
from cruise_control_tpu_torch.config.capacity import (
    BrokerCapacity as PBrokerCapacity, BrokerCapacityConfigResolver as PR)
from cruise_control_tpu_torch.core.aggregator import \
    NotEnoughValidWindowsError as PNotEnough
from cruise_control_tpu_torch.facade import CruiseControl
from cruise_control_tpu_torch.monitor.completeness import \
    ModelCompletenessRequirements as PReq
from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor
from cruise_control_tpu_torch.monitor.sampling.sampler import \
    SimulatedClusterSampler as PSampler
from test_torch_monitor import JBOD_DISKS, assert_states_equal, port_delta

SETTINGS = dict(num_windows=3, window_ms=10_000, min_samples_per_window=1,
                sampling_interval_ms=5_000, state_update_interval_ms=2_000)


def resolver(base, capacity_cls):
    class Jbod(base):
        """Uniform capacities; the even brokers list two logdirs."""

        def capacity_for_broker(self, rack, host, broker_id,
                                allow_estimation=True):
            caps = (100.0, 2e5, 2e5, 1.2e6)
            if broker_id % 2 == 0:
                return capacity_cls(caps, dict(JBOD_DISKS))
            return capacity_cls(caps)
    return Jbod()


class Side:
    """One package's simulated cluster and monitor on a virtual clock."""

    def __init__(self, jax: bool, **kwargs):
        Sim, TP = (JSim, JTP) if jax else (PSim, PTP)
        self.sim = sim = Sim()
        for b in range(6):
            sim.add_broker(b, rack=f"rack{b % 3}",
                           logdirs=("/d0", "/d1") if b % 2 == 0
                           else ("/d0",))
        sim.create_topic("t0", [[(p + i) % 6 for i in range(3)]
                                for p in range(20)], size_bytes=1e4)
        for p in range(20):
            sim.set_partition_load(TP("t0", p), leader_cpu=2.0 + p * 0.1,
                                   nw_in=100.0 + p, nw_out=300.0)
        sim.fail_disk(0, "/d0")
        self.clock = {"now": 10_000.0}
        self.Req = JReq if jax else PReq
        self.NotEnough = JNotEnough if jax else PNotEnough
        settings = dict(SETTINGS, time_fn=lambda: self.clock["now"],
                        **kwargs)
        if jax:
            self.mon = JMonitor(sim, JSampler(sim),
                                resolver(JR, JBrokerCapacity), **settings)
        else:
            self.mon = LoadMonitor(sim, PSampler(sim),
                                   resolver(PR, PBrokerCapacity),
                                   device="cpu", **settings)
        self.mon.start_up(do_sampling=False)
        self.jax = jax

    def sample(self, rounds=1, step=5.0):
        for _ in range(rounds):
            self.mon.task_runner.sample_once()
            self.sim.advance(step)
            self.clock["now"] += step


def gen(g) -> tuple:
    return (g.cluster_generation, g.load_generation, g.delta_generation)


def model(side, *args, **kwargs):
    """The built model, or the error's class name and text."""
    try:
        return side.mon.cluster_model(*args, **kwargs)
    except side.NotEnough as exc:
        return ("NotEnoughValidWindowsError", str(exc))


def assert_same_model(j, p):
    if isinstance(j, tuple) and isinstance(j[0], str):
        assert p == j
        return
    (js, jt), (ps, pt) = j, p
    assert_states_equal(js, ps)
    assert pt.broker_ids == jt.broker_ids and pt.topics == jt.topics
    assert pt.rack_ids == jt.rack_ids and pt.host_names == jt.host_names
    assert pt.disk_names == jt.disk_names
    assert ([(x.topic, x.partition) for x in pt.partitions]
            == [(x.topic, x.partition) for x in jt.partitions])


def state_of(side) -> tuple:
    return tuple(dataclasses.astuple(side.mon.get_state()))


@pytest.fixture()
def pair():
    j, p = Side(True), Side(False)
    yield j, p
    j.mon.shutdown()
    p.mon.shutdown()


def both(pair, fn):
    """fn(side) on each; the answers must be equal."""
    j, p = pair
    a, b = fn(j), fn(p)
    assert b == a
    return b


def test_sampled_model_equals_reference(pair):
    j, p = pair
    for s in pair:
        s.sample(6)
    built = []
    for req in (None, (1, 0.0, False), (2, 0.5, False), (2, 1.0, True),
                (3, 1.0, True)):
        jm = model(j, None if req is None else j.Req(*req))
        pm = model(p, None if req is None else p.Req(*req))
        assert_same_model(jm, pm)
        built.append(pm)
    assert built[-1][0] == "NotEnoughValidWindowsError"
    ps, _ = built[0]
    # the failed logdir: offline replicas and a bad disk
    assert bool(ps.replica_offline.any()) and bool(ps.broker_bad_disks.any())
    assert ps.num_partitions == 20 and ps.num_brokers == 6
    assert p.mon.last_build_seconds["aggregate"] >= 0.0


def test_completeness_errors_and_state_equal_reference(pair):
    j, p = pair
    log = []

    def step(side):
        out = [state_of(side), gen(side.mon.model_generation())]
        for req in (None, (1, 0.0, False), (2, 0.0, False),
                    (1, 1.0, False)):
            r = None if req is None else side.Req(*req)
            m = model(side, r)
            out.append(m if isinstance(m[0], str) else "built")
            if r is not None:
                out.append(side.mon.meet_completeness_requirements(r))
        return out
    log.append(both(pair, step))      # no sample yet
    for rounds in (1, 1, 2, 2):
        for s in pair:
            s.sample(rounds)
        log.append(both(pair, step))
    # the TTL cache: within 2 s the state is the cached one
    both(pair, lambda s: s.sample(1, step=0.5))
    log.append(both(pair, state_of))
    both(pair, lambda s: s.mon.pause_metric_sampling("an execution"))
    both(pair, lambda s: s.clock.__setitem__("now", s.clock["now"] + 3.0))
    log.append(both(pair, state_of))
    both(pair, lambda s: s.mon.resume_metric_sampling("done"))
    both(pair, lambda s: s.clock.__setitem__("now", s.clock["now"] + 3.0))
    log.append(both(pair, state_of))
    assert log[0][2][0] == "NotEnoughValidWindowsError"
    assert "built" in log[-4] and log[-2][0] == "PAUSED"
    assert (both(pair, lambda s: s.mon.num_quarantined_samples) == 0)


def test_train_then_rebuild_equals_reference(pair):
    j, p = pair
    for s in pair:
        s.sample(8)
    g0 = both(pair, lambda s: gen(s.mon.model_generation()))
    for s in pair:
        s.mon.train()
    g1 = both(pair, lambda s: gen(s.mon.model_generation()))
    assert g1[2] == g0[2] + 1
    coefs = both(pair, lambda s: dataclasses.astuple(
        s.mon.cpu_model.coefficients))
    assert both(pair, lambda s: s.mon.cpu_model.training_error()) is not None
    assert_same_model(model(j), model(p))
    # the trained attribution reaches the followers
    assert any(c != 0.0 for c in coefs)
    f = p.mon.follower_cpu_estimator()
    jf = j.mon.follower_cpu_estimator()
    for args in ((2.0, 100.0, 300.0), (0.1, 1e4, 1.0)):
        assert f(*args) == jf(*args)


def test_dead_broker_sampled_equals_reference(pair):
    j, p = pair
    for s in pair:
        s.sample(4)
        s.sim.kill_broker(3)
        s.sample(3)
    jm, pm = model(j), model(p)
    assert_same_model(jm, pm)
    assert not bool(pm[0].broker_alive[3])


def test_generation_sequence_equals_reference(pair):
    j, p = pair
    seq = []

    def rec():
        seq.append(both(pair, lambda s: gen(s.mon.model_generation())))
    rec()
    for s in pair:
        s.sample(4)
    rec()
    deltas = (JD.ModelDelta(capacity_overrides={2: {"disk": 5e5}}),
              JD.ModelDelta(load_updates=(JD.PartitionLoadUpdate(
                  "t0", 5, (6.0, 140.0, 420.0, 3e4)),)),
              JD.ModelDelta(demote_brokers=(4,)))
    starts = []
    for d in deltas:
        starts.append((j.mon.model_generation(), p.mon.model_generation()))
        j.mon.apply_model_delta(d)
        p.mon.apply_model_delta(port_delta(d))
        rec()
        assert_same_model(model(j), model(p))
    jc = j.mon.deltas_between(starts[0][0], j.mon.model_generation())
    pc = p.mon.deltas_between(starts[0][1], p.mon.model_generation())
    assert [(r.seq, gen(r.from_generation), gen(r.to_generation))
            for r in pc] == [(r.seq, gen(r.from_generation),
                              gen(r.to_generation)) for r in jc]
    assert len(pc) == 3
    # fresh samples supersede the load override
    for s in pair:
        s.sample(1)
    rec()
    assert_same_model(model(j), model(p))
    assert both(pair, lambda s: len(s.mon._overlay_loads)) == 0
    for s in pair:
        s.mon.train()
    rec()
    for s in pair:
        s.mon.clear_model_overlay()
    rec()
    for s in pair:
        s.sim.kill_broker(5)
    rec()       # the metadata's TTL has not run out: the same generation
    for s in pair:
        s.clock["now"] += 6.0
    rec()
    assert_same_model(model(j), model(p))
    # every other step moved the generation
    assert [a != b for a, b in zip(seq, seq[1:])] == [True] * 7 + [False,
                                                                    True]
    assert p.mon.deltas_between(starts[0][1], p.mon.model_generation()) \
        is None


def test_training_makes_the_store_rebuild():
    """Training moves the generation unlogged: the facade's next model
    is a rebuild, counted as a generation gap, and equals a fresh build."""
    side = Side(False)
    try:
        side.sample(8)
        cc = CruiseControl(load_monitor=side.mon, device="cpu")
        cc._model_for_solve()
        side.mon.train()
        state, _ = cc._model_for_solve()
        store = cc.model_store.to_json()
        assert store["fallbacks"] == 1 and store["deltaApplies"] == 0
        assert store["lastFallbackReason"] == "generation-gap"
        fresh, _ = side.mon.cluster_model()
        for f in ("replica_base_load", "partition_leader_bonus"):
            assert np.array_equal(getattr(state, f).numpy(),
                                  getattr(fresh, f).numpy())
    finally:
        side.mon.shutdown()
    side = Side(False, num_fetchers=2)
    side.mon.task_runner.shutdown()
    runner = type(side.mon.task_runner)(
        side.mon.metadata, side.mon._fetcher, 5_000)
    side.mon.task_runner = runner
    runner.start(do_sampling=True)
    side.mon.shutdown()
    assert not runner._thread.is_alive()
    assert side.mon._fetcher._pool._shutdown
