"""Parity of the PyTorch port's model layer with the JAX reference.

The random-cluster generator, the model queries, the statistics, the
batched move commit and the sanity checker of `cruise_control_tpu_torch`
against `cruise_control_tpu` on identical inputs (made from a seed with
numpy and carried across as numpy arrays).  Integers and booleans must
match exactly; float tolerances are stated where a reduction order
differs between the two frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.model import state as JS
from cruise_control_tpu.model import stats as JST
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model import stats as ST
from cruise_control_tpu_torch.model.sanity import sanity_check
from cruise_control_tpu_torch.model.state import STATE_FIELDS
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)

SPECS = [
    dict(num_brokers=16, num_partitions=400, replication_factor=3,
         num_racks=4, num_topics=8, seed=3, skew_fraction=0.3),
    dict(num_brokers=70, num_partitions=900, replication_factor=2,
         num_racks=5, num_topics=6, seed=9, skew_fraction=0.2,
         dead_brokers=2, new_brokers=3, jbod_disks=2, dead_disks=2),
]


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module", params=range(len(SPECS)))
def pair(request):
    spec = SPECS[request.param]
    js, jt = j_random_cluster(JSpec(**spec))
    ps, pt = random_cluster(RandomClusterSpec(**spec), device="cpu")
    return js, jt, ps, pt


def test_generator_is_bit_identical(pair):
    js, jt, ps, pt = pair
    for f in STATE_FIELDS:
        a, b = _np(getattr(js, f)), getattr(ps, f).numpy()
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    assert (js.num_racks, js.num_hosts, js.num_topics) == (
        ps.num_racks, ps.num_hosts, ps.num_topics)
    assert [str(p) for p in jt.partitions] == [str(p) for p in pt.partitions]
    assert jt.broker_ids == pt.broker_ids and jt.disk_names == pt.disk_names


def test_convert_round_trip(pair):
    js, _, _, _ = pair
    fields = {f: _np(getattr(js, f)) for f in STATE_FIELDS}
    st = convert.state_from_numpy(fields, num_racks=js.num_racks,
                                  num_hosts=js.num_hosts,
                                  num_topics=js.num_topics, device="cpu")
    back = convert.state_to_numpy(st)
    for f in STATE_FIELDS:
        assert np.array_equal(back[f], fields[f]), f


def test_queries_match(pair):
    js, _, ps, _ = pair
    # segment sums add in replica order on both sides: exact
    for name in ("broker_load", "replica_current_load",
                 "potential_leadership_load", "broker_replica_count",
                 "broker_leader_count", "broker_topic_replica_count",
                 "partition_rack_count", "self_healing_eligible",
                 "utilization_matrix"):
        a = _np(getattr(JS, name)(js))
        b = getattr(S, name)(ps).numpy()
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    # plain reductions follow XLA's summation order (ops.sum_f32): exact
    for name in ("average_utilization_percentage", "cluster_load",
                 "cluster_capacity"):
        assert np.array_equal(_np(getattr(JS, name)(js)),
                              getattr(S, name)(ps).numpy()), name


def test_stats_match(pair):
    js, _, ps, _ = pair
    a = JST.compute_stats(js)
    b = ST.compute_stats(ps)
    # every reduction follows XLA's summation order: exact, sqrt included
    for f in ST.ClusterModelStats.__dataclass_fields__:
        assert np.array_equal(_np(getattr(a, f)), getattr(b, f).numpy()), f


def test_apply_moves_matches(pair):
    js, _, ps, _ = pair
    rng = np.random.default_rng(5)
    k = 64
    reps = rng.choice(js.num_replicas, size=k, replace=False).astype(
        np.int32)
    dests = rng.integers(0, js.num_brokers, size=k).astype(np.int32)
    valid = rng.random(k) < 0.8
    dests[:4] = _np(js.replica_broker)[reps[:4]]      # no-op moves
    ja = JS.apply_moves(js, jnp.asarray(reps), jnp.asarray(dests),
                        jnp.asarray(valid))
    pa = S.apply_moves(ps, torch.from_numpy(reps), torch.from_numpy(dests),
                       torch.from_numpy(valid))
    for f in ("replica_broker", "replica_disk", "replica_offline"):
        assert np.array_equal(_np(getattr(ja, f)),
                              getattr(pa, f).numpy()), f


def test_sanity_check_agrees(pair):
    _, _, ps, _ = pair
    sanity_check(ps)
    bad = ps.replace(replica_is_leader=torch.zeros_like(
        ps.replica_is_leader))
    with pytest.raises(AssertionError, match="leader"):
        sanity_check(bad)


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
