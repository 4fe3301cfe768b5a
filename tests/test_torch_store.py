"""The dirty-region pieces of the PyTorch port against the JAX reference,
on the CPU: `apply_delta` and `set_broker_capacities` (model/store.py,
model/state.py), `restrict_context_to_dirty` (analyzer/context.py) and
the segment plans of analyzer/fusion.py.

Each delta kind of tests/test_incremental.py (a capacity override, two
partitions' loads, a demoted broker, a broker marked new, a removed
broker), one delta of every kind at once and a chain of two deltas are
applied in both packages to the same seeded cluster, which carries a dead
broker and so offline replicas already.  The plans are built from numpy
as the reference's store builds them, with power-of-two padding rows
that name no broker or partition.  The state and the dirty-broker mask
must be byte-equal to the reference's (`jax.jit(apply_delta)`, as the
store runs it).
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import context as JC
from cruise_control_tpu.analyzer import fusion as JF
from cruise_control_tpu.analyzer.goals import registry as JR
from cruise_control_tpu.model import state as JS
from cruise_control_tpu.model import store as JStore
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer import fusion as F
from cruise_control_tpu_torch.analyzer.goals import registry as R
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model import store as ST
from cruise_control_tpu_torch.model.state import STATE_FIELDS
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)

SPEC = dict(num_brokers=16, num_partitions=400, replication_factor=3,
            num_racks=4, num_topics=8, seed=3, skew_fraction=0.3,
            dead_brokers=1)
_rng = np.random.default_rng(5)


def _load_row():
    """(leader base, follower base, leadership bonus) of one partition."""
    lb = _rng.random(4).astype(np.float32) * 50
    fb = lb * np.float32(0.25)
    return lb, fb, lb - fb


#: plan_arrays keyword arguments of each delta
DELTAS = {
    "capacity": dict(capacities={2: {Resource.DISK: 5e5,
                                     Resource.CPU: 80.0}}),
    "load": dict(loads={5: _load_row(), 11: _load_row()}),
    "demote": dict(demoted=(4,)),
    "add-new": dict(new=(1,)),
    "remove": dict(removed=(5,)),
    "every kind, padded to 8": dict(
        capacities={0: {Resource.NW_IN: 3e5}, 7: {Resource.DISK: 1e6}},
        loads={p: _load_row() for p in (2, 40, 41, 99, 300)},
        demoted=(1, 9), new=(3,), removed=(12, 13, 14, 15, 0)),
}
#: a chain of two deltas (the second on the first's result)
CHAIN = (dict(capacities={0: {Resource.NW_IN: 3e5}}),
         dict(loads={2: _load_row()}, demoted=(1,)))


@pytest.fixture(scope="module")
def clusters():
    js, jt = j_random_cluster(JSpec(**SPEC))
    ps, pt = random_cluster(RandomClusterSpec(**SPEC), device="cpu")
    assert ps.replica_offline.any()
    return js, jt, ps, pt


_j_apply = jax.jit(JStore.apply_delta)


def _apply_both(js, ps, kw):
    arrays = ST.plan_arrays(ps.num_brokers, ps.num_partitions, **kw)
    jstate, jdirty = _j_apply(js, JStore.DeltaPlan(
        **{k: jnp.asarray(v) for k, v in arrays.items()}))
    pstate, pdirty = ST.apply_delta(ps, ST.plan_from_numpy(arrays, "cpu"))
    return jstate, jdirty, pstate, pdirty


def _assert_states_equal(js, ps):
    for f in STATE_FIELDS:
        a, b = np.asarray(getattr(js, f)), getattr(ps, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    for f in ("num_racks", "num_hosts", "num_topics"):
        assert getattr(js, f) == getattr(ps, f)


@pytest.mark.parametrize("delta", list(DELTAS))
def test_apply_delta_byte_equal(delta, clusters):
    js, _, ps, _ = clusters
    jstate, jdirty, pstate, pdirty = _apply_both(js, ps, DELTAS[delta])
    _assert_states_equal(jstate, pstate)
    assert np.array_equal(np.asarray(jdirty), pdirty.numpy())
    assert pdirty.dtype == torch.bool and pdirty.any()
    assert not _states_same(pstate, ps)


def _states_same(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in STATE_FIELDS)


def test_apply_delta_chain_byte_equal(clusters):
    js, _, ps, _ = clusters
    dirty = []
    for kw in CHAIN:
        js, jd, ps, pd = _apply_both(js, ps, kw)
        assert np.array_equal(np.asarray(jd), pd.numpy())
        dirty.append(pd)
    _assert_states_equal(js, ps)
    union = dirty[0] | dirty[1]
    assert union[[0, 1]].all()


def test_apply_delta_dirty_mask_parts(clusters):
    """Every broker holding a replica of a reloaded partition is dirty;
    a broker that holds no replica is not (the integer minimum of an
    empty segment max), nor is a padding row's."""
    _, _, ps, _ = clusters
    kw = dict(loads={7: _load_row()})
    _, dirty = ST.apply_delta(ps, ST.plan_from_numpy(
        ST.plan_arrays(ps.num_brokers, ps.num_partitions, **kw), "cpu"))
    holders = ps.replica_broker[(ps.replica_partition == 7)
                                & ps.replica_valid]
    want = torch.zeros(ps.num_brokers, dtype=torch.bool)
    want[holders.long()] = True
    assert torch.equal(dirty, want)
    empty = ps.replace(replica_valid=torch.zeros_like(ps.replica_valid))
    _, dirty = ST.apply_delta(empty, ST.plan_from_numpy(
        ST.plan_arrays(ps.num_brokers, ps.num_partitions, **kw), "cpu"))
    assert not dirty.any()


@pytest.mark.parametrize("rows", [[3], [0, 15], [6, 2, 11], [15, 16, 16, 16]],
                         ids=["one", "ends", "unsorted", "padded"])
def test_set_broker_capacities_matches(rows, clusters):
    js, _, ps, _ = clusters
    g = np.random.default_rng(len(rows))
    mask = g.random((len(rows), 4)) < 0.6
    values = (g.random((len(rows), 4)) * 1e5).astype(np.float32)
    jout = JS.set_broker_capacities(js, np.asarray(rows, np.int32), mask,
                                    values)
    pout = S.set_broker_capacities(ps, np.asarray(rows, np.int32), mask,
                                   values)
    assert (np.asarray(jout.broker_capacity).tobytes()
            == pout.broker_capacity.numpy().tobytes())
    assert not pout.broker_capacity.data_ptr() == ps.broker_capacity.data_ptr()


DIRTY = {
    "all": lambda n: np.ones(n, bool),
    "none": lambda n: np.zeros(n, bool),
    "one": lambda n: np.arange(n) == 2,
    "random": lambda n: np.random.default_rng(9).random(n) < 0.3,
}


@pytest.mark.parametrize("options", [
    {}, dict(excluded_brokers_for_replica_move=frozenset({2, 7}),
             excluded_topics=frozenset({"topic-1"}))],
    ids=["default options", "exclusions"])
@pytest.mark.parametrize("dirty", list(DIRTY))
def test_restrict_context_to_dirty_matches(dirty, options, clusters):
    js, jt, ps, pt = clusters
    mask = DIRTY[dirty](ps.num_brokers)
    jctx = JC.restrict_context_to_dirty(
        js, JC.make_context(js, JC.BalancingConstraint(),
                            JC.OptimizationOptions(**options), jt),
        jnp.asarray(mask))
    pctx0 = C.make_context(ps, C.BalancingConstraint(),
                           C.OptimizationOptions(**options), pt)
    pctx = C.restrict_context_to_dirty(ps, pctx0, torch.from_numpy(mask))
    for f in ("replica_movable", "broker_dest_ok"):
        assert np.array_equal(np.asarray(getattr(jctx, f)),
                              getattr(pctx, f).numpy()), f
    for f in C.CONTEXT_FIELDS:
        if f not in ("replica_movable", "broker_dest_ok"):
            assert torch.equal(getattr(pctx, f), getattr(pctx0, f)), f
    if dirty == "all":
        assert torch.equal(pctx.replica_movable, pctx0.replica_movable)
        assert torch.equal(pctx.broker_dest_ok, pctx0.broker_dest_ok)


def test_fusion_groups_equal_the_reference():
    assert F.GOAL_FUSION_GROUPS == JF.GOAL_FUSION_GROUPS
    assert F.GROUP_OF == JF.GROUP_OF
    assert set(F.GROUP_OF) == set(R.GOAL_CLASSES) == set(JR.GOAL_CLASSES)


def _goal_lists():
    names = sorted(R.GOAL_CLASSES)
    g = np.random.default_rng(0)
    lists = [[], list(R.DEFAULT_GOAL_ORDER), names, names[::-1],
             ["Custom", "Other"] + list(R.DEFAULT_GOAL_ORDER[:4])
             + ["Third"] + list(R.DEFAULT_GOAL_ORDER[4:])]
    lists += [[n] for n in names]
    lists += [list(g.permutation(names)) for _ in range(6)]
    lists += [list(p) for p in itertools.permutations(names[:4])]
    return lists


@pytest.mark.parametrize("fused", [False, True], ids=["fixed", "fused"])
@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 0])
def test_plan_segments_matches(width, fused):
    for names in _goal_lists():
        want = JF.plan_segments(names, width, fused)
        got = F.plan_segments(names, width, fused)
        assert got == want, (names, width, fused)
        assert [i for s, e in got for i in range(s, e)] == list(
            range(len(names)))


def test_plan_arrays_pad_as_the_store_does():
    arrays = ST.plan_arrays(16, 400, new=(3, 1), removed=tuple(range(5)),
                            loads={7: _load_row()})
    assert arrays["new_brokers"].tolist() == [1, 3] + [16] * 6
    assert arrays["removed_brokers"].tolist() == [0, 1, 2, 3, 4] + [16] * 3
    assert arrays["demoted_brokers"].tolist() == [16] * 8
    assert arrays["load_parts"].tolist() == [7, 400, 400, 400]
    assert arrays["cap_rows"].tolist() == [16] * 4
    assert [ST._pad_pow2(n) for n in (0, 4, 5, 9)] == [
        JStore._pad_pow2(n) for n in (0, 4, 5, 9)] == [4, 4, 8, 16]
    plan = ST.plan_from_numpy(arrays, "cpu")
    assert [f.name for f in dataclasses.fields(plan)] == list(ST.PLAN_FIELDS)
    assert list(ST.PLAN_FIELDS) == [
        f.name for f in dataclasses.fields(JStore.DeltaPlan)]
