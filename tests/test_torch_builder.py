"""The PyTorch port's model builder (cruise_control_tpu_torch/model/
builder.py) and the two state functions it adds (`partition_broker_count`,
`move_replica`) against the JAX reference, on the CPU.

The same description goes through both builders: the builder calls of
the seven fixtures of cruise_control_tpu/testing/fixtures.py, recorded
from the reference's own fixture functions and replayed on the port's
builder; a random 24-broker description with racks, shared hosts, JBOD
logdirs (one dead), a dead broker, replicas marked offline, explicit and
derived follower loads, a reloaded replica and replica-axis padding; and
descriptions split by custom follower-CPU estimators, one of which the
[0, leader CPU] clamp must bound.  Every state field must equal the
reference's exactly (dtype, shape and bits) and so must the static sizes
and the topology.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.model import builder as JB
from cruise_control_tpu.model import state as JS
from cruise_control_tpu.testing import fixtures as JF
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.model import builder as B
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model.state import STATE_FIELDS

FIXTURES = ("small_cluster", "unbalanced_cluster", "rack_aware_satisfiable",
            "rack_aware_unsatisfiable", "dead_broker_cluster",
            "jbod_cluster", "reference_small_cluster")
STATIC = ("num_racks", "num_hosts", "num_topics")


class _Recorder:
    """Stands in for the reference's ClusterModelBuilder inside a fixture
    function: forwards every call to a real one and logs it."""

    log = None

    def __init__(self, *args, **kwargs):
        self._real = JB.ClusterModelBuilder(*args, **kwargs)
        _Recorder.log = [("__init__", args, kwargs)]

    def __getattr__(self, name):
        real = getattr(self._real, name)

        def call(*args, **kwargs):
            _Recorder.log.append((name, args, kwargs))
            return real(*args, **kwargs)
        return call


def _replay(log, device="cpu"):
    """The port's build of a recorded description."""
    (_, args, kwargs), *calls = log
    b = B.ClusterModelBuilder(*args, **kwargs)
    out = None
    for name, args, kwargs in calls:
        if name == "build":
            kwargs = dict(kwargs, device=device)
        out = getattr(b, name)(*args, **kwargs)
    return out


def assert_builds_equal(j_out, p_out):
    (js, jt), (ps, pt) = j_out, p_out
    for f in STATE_FIELDS:
        want = np.asarray(getattr(js, f))
        got = getattr(ps, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), f
    for f in STATIC:
        assert getattr(ps, f) == getattr(js, f), f
    assert pt.broker_ids == jt.broker_ids
    assert pt.rack_ids == jt.rack_ids
    assert pt.host_names == jt.host_names
    assert pt.topics == jt.topics
    assert ([(p.topic, p.partition) for p in pt.partitions]
            == [(p.topic, p.partition) for p in jt.partitions])
    assert pt.disk_names == jt.disk_names


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_descriptions(name, monkeypatch):
    monkeypatch.setattr(JF, "ClusterModelBuilder", _Recorder)
    j_out = getattr(JF, name)()
    log = list(_Recorder.log)
    assert log[-1][0] == "build"
    assert_builds_equal(j_out, _replay(log))


def _describe(b, rng, *, jbod=True):
    """A random 24-broker description on builder `b`: 4 racks, two
    brokers a host, JBOD logdirs on even brokers (broker 2's /d1 dead),
    broker 5 dead, 60 partitions of rf 3 (every 7th with explicit
    follower loads, every 11th with a replica marked offline), then a
    rack and a broker holding nothing."""
    cap = [100.0, 5e4, 5e4, 1e6]
    for i in range(24):
        disks = None
        if jbod and i % 2 == 0:
            disks = {"/d0": 4e5, "/d1": 0.0 if i == 2 else 6e5}
        b.add_broker(i, f"r{i % 4}", cap, host=f"h{i // 2}",
                     alive=i != 5, new=i == 7, demoted=i == 9, disks=disks)
    loads = rng.random((60, 4)) * [10.0, 400.0, 500.0, 2e3]
    for p in range(60):
        topic = f"t{p % 5}"
        brokers = rng.choice(24, size=3, replace=False).tolist()
        if p % 7 == 0:
            follower = [[1.0 + p, 2.0, 0.0, 3.0], [2.0, 3.0, 0.0, 4.0 + p]]
            b.add_partition(topic, p, brokers[0], brokers[1:], loads[p],
                            follower_loads=follower)
            continue
        lead = {0: loads[p, 0], 1: loads[p, 1], 2: loads[p, 2],
                3: loads[p, 3]}
        for k, br in enumerate(brokers):
            logdir = ("/d1" if p % 2 else "/d0") if (jbod and br % 2 == 0) \
                else None
            load = (lead if k == 0 else
                    {0: loads[p, 0] / 4, 1: loads[p, 1], 2: 0.0,
                     3: loads[p, 3]})
            b.add_replica(topic, p, br, k == 0, load,
                          offline=(p % 11 == 0 and k == 2), logdir=logdir)
    b.add_rack("r-empty")
    b.add_broker(30, "r-empty", cap)


def _leader_of(b, topic, partition):
    """The broker of a described partition's leader (the builders keep
    the same private records)."""
    p = b._partitions[type(b._partition_list[0])(topic, partition)]
    return next(r.broker for r in b._replicas
                if r.partition == p and r.is_leader)


@pytest.mark.parametrize("jbod", (True, False), ids=("jbod", "no-jbod"))
@pytest.mark.parametrize("pad", (None, 250), ids=("unpadded", "padded"))
def test_random_description(jbod, pad):
    built = []
    for mod in (JB, B):
        b = mod.ClusterModelBuilder()
        _describe(b, np.random.default_rng(7), jbod=jbod)
        # a reloaded replica: partition 1's leader
        b.set_replica_load("t1", 1, _leader_of(b, "t1", 1),
                           [7.0, 70.0, 80.0, 900.0])
        built.append(b.build(pad_replicas_to=pad) if mod is JB
                     else b.build(pad_replicas_to=pad, device="cpu"))
    js, ps = built[0][0], built[1][0]
    assert bool(np.asarray(js.replica_offline).any())
    assert not bool(np.asarray(js.broker_alive).all())
    if jbod:
        assert not bool(np.asarray(js.disk_alive).all())
    assert_builds_equal(*built)


ESTIMATORS = {
    # array-compatible and inside [0, leader CPU]
    "weights": lambda cpu, nin, nout: JB.estimate_follower_cpu(
        cpu, nin, nout, leader_in_weight=0.5, leader_out_weight=0.3,
        follower_in_weight=0.4),
    # above the leader's CPU and below zero: the clamp bounds both
    "out of range": lambda cpu, nin, nout: 2.0 * cpu - 3.0,
}


@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_custom_follower_estimator(name):
    est = ESTIMATORS[name]
    built = []
    for mod in (JB, B):
        b = mod.ClusterModelBuilder(follower_cpu_estimator=est)
        _describe(b, np.random.default_rng(11))
        built.append(b.build() if mod is JB else b.build(device="cpu"))
    assert_builds_equal(*built)
    if name == "out of range":
        bonus = built[1][0].partition_leader_bonus[:, 0]
        assert bool((bonus >= 0).all())


def test_estimate_follower_cpu_scalar_and_array():
    cpu, nin, nout = np.array([5.0, 0.0, 3.0]), np.array([10.0, 0.0, 0.0]), \
        np.array([4.0, 0.0, 0.0])
    for args in ((5.0, 10.0, 4.0), (cpu, nin, nout)):
        got = B.estimate_follower_cpu(*args, leader_in_weight=0.6)
        want = JB.estimate_follower_cpu(*args, leader_in_weight=0.6)
        assert np.array_equal(np.asarray(got), np.asarray(want))


def test_build_raises_without_a_card_unless_cpu():
    b = B.ClusterModelBuilder()
    b.add_broker(0, "r", [1.0, 1.0, 1.0, 1.0])
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        b.build()


@pytest.fixture(scope="module")
def jbod_state():
    js, jt = JF.jbod_cluster()
    fields = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    ps = convert.state_from_numpy(
        fields, num_racks=js.num_racks, num_hosts=js.num_hosts,
        num_topics=js.num_topics, device="cpu")
    return js, ps


def test_partition_broker_count(jbod_state):
    js, ps = jbod_state
    want = np.asarray(JS.partition_broker_count(js))
    got = S.partition_broker_count(ps).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("replica,dest,disk", [
    (0, 2, None),   # an offline replica (dead logdir) onto a live broker
    (1, 0, 1),      # onto a logdir of the destination
    (2, 2, 4),
    (3, 1, None),
])
def test_move_replica(jbod_state, replica, dest, disk):
    js, ps = jbod_state
    want = JS.move_replica(js, jnp.int32(replica), jnp.int32(dest),
                           None if disk is None else jnp.int32(disk))
    got = S.move_replica(ps, replica, dest, disk)
    for f in STATE_FIELDS:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    # the input is left as it was
    assert np.array_equal(ps.replica_broker.numpy(),
                          np.asarray(js.replica_broker))
