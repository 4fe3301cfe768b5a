"""The port's exact-order float primitives against JAX on the CPU.

`ops.segment_sum` / `segment_sum_plain` (K12's plain version) against
`jax.ops.segment_sum`, `ops.scatter_add_seq` / `scatter_add_seq_plain`
against `arr.at[idx].add`, `ops.sum_f32` / `sum_f32_plain` (K13) against
`jnp.sum(axis=0)`, `cumsum_f32_plain` (the scan of K14's plain gate)
against `jnp.cumsum(axis=1)`, and the stats built on them against the
reference's `compute_stats`.  Inputs are made with numpy from a seed; every float
must match bit for bit (the uint32 views are compared).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.model import stats as JST
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu_torch import ops
from cruise_control_tpu_torch.model import stats as ST
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)


def _bits_equal(a, b) -> bool:
    a = np.asarray(a)
    b = np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint32), b.view(np.uint32)))


def _values(rng, shape):
    """Lognormal magnitudes of both signs (so the order of the adds shows
    in the rounding) with some +0.0 and -0.0."""
    x = rng.lognormal(0, 3, size=shape).astype(np.float32)
    x *= np.where(rng.random(shape) < 0.3, -1, 1).astype(np.float32)
    x[rng.random(shape) < 0.02] = 0.0
    x[rng.random(shape) < 0.02] = -0.0
    return x


SEGMENT_CASES = ("random", "dropped ids", "one segment", "signed zeros")


def _segment_inputs(case, num, n, rest, seed):
    rng = np.random.default_rng(seed)
    x = _values(rng, (num,) + rest)
    # the last tenth of the segments stays empty
    ids = rng.integers(0, max(1, n - n // 10), size=num).astype(np.int32)
    if case in ("dropped ids", "spilled ids"):
        # `.at[idx]` wraps negative ids (the port's callers spill to n)
        drop = [n, n + 3, 2 ** 30] + ([-1, -7] if case == "dropped ids"
                                      else [])
        pick = rng.random(num) < 0.05
        ids[pick] = rng.choice(np.array(drop, dtype=np.int32),
                               size=int(pick.sum()))
    elif case == "one segment":
        ids[:] = n // 2
    elif case == "signed zeros":
        x[rng.random(x.shape) < 0.5] = -0.0
        x[rng.random(x.shape) < 0.2] = 0.0
    return x, ids


@pytest.mark.parametrize("case", SEGMENT_CASES)
@pytest.mark.parametrize("rest,n", [((4,), 200), ((), 800)],
                         ids=["R x 4 into 200", "R into 800"])
def test_segment_sum_matches_jax(case, rest, n):
    x, ids = _segment_inputs(case, 60_000, n, rest, seed=len(case) + n)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(ids),
                                          num_segments=n))
    xt, it = torch.from_numpy(x), torch.from_numpy(ids)
    assert _bits_equal(want, ops.segment_sum(xt, it, n).numpy())
    assert _bits_equal(want, ops.segment_sum_plain(xt, it, n).numpy())
    # int64 ids, as some callers pass them
    assert _bits_equal(want, ops.segment_sum(xt, it.long(), n).numpy())


@pytest.mark.parametrize("case", ("random", "spilled ids", "signed zeros"))
def test_scatter_add_matches_jax(case):
    n = 200
    x, ids = _segment_inputs(case, 6_000, n, (4,), seed=7 + len(case))
    arr = _values(np.random.default_rng(3), (n, 4))
    want = np.asarray(jnp.asarray(arr).at[jnp.asarray(ids)].add(
        jnp.asarray(x), mode="drop"))
    at, xt, it = (torch.from_numpy(a) for a in (arr, x, ids))
    assert _bits_equal(want, ops.scatter_add_seq(at, it, xt).numpy())
    assert _bits_equal(want, ops.scatter_add_seq_plain(at, it, xt).numpy())


@pytest.mark.parametrize("m", [1, 4, 100])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 200, 2600])
def test_sum_matches_jax(n, m):
    rng = np.random.default_rng(n * 1000 + m)
    x = _values(rng, (n, m))
    # a -0.0 at the first term of a window (padding before the data is
    # (windows * 32 - n) // 2)
    if n > 32:
        w = -(-n // 32)
        x[32 - (w * 32 - n) // 2] = -0.0
    x[0, 0] = -0.0
    want = np.asarray(jnp.sum(jnp.asarray(x), axis=0))
    xt = torch.from_numpy(x)
    assert _bits_equal(want, ops.sum_f32(xt).numpy())
    assert _bits_equal(want, ops.sum_f32_plain(xt).numpy())
    # the 1-d sum of a column is that column of the 2-d sum
    want1 = np.asarray(jnp.sum(jnp.asarray(x[:, -1])))
    assert _bits_equal(want1, ops.sum_f32(xt[:, -1].contiguous()).numpy())


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("n", [1_025, 32_769, 32_770])
def test_sum_window_levels_match_jax(n, m):
    """The offsets of the second windowed level (more than 1,024 and more
    than 32,768 rows): -0.0 at the first row and at the start of a first-
    and a second-level window."""
    rng = np.random.default_rng(n + m)
    x = _values(rng, (n, m))
    w0 = -(-n // 32)
    lo0 = (w0 * 32 - n) // 2
    w1 = -(-w0 // 32)
    lo1 = (w1 * 32 - w0) // 2
    x[0] = -0.0
    x[32 - lo0] = -0.0
    x[(32 - lo1) * 32 - lo0] = -0.0
    want = np.asarray(jnp.sum(jnp.asarray(x), axis=0))
    xt = torch.from_numpy(x)
    assert _bits_equal(want, ops.sum_f32(xt).numpy())
    assert _bits_equal(want, ops.sum_f32_plain(xt).numpy())


#: segment lengths in turn around K12's walk stage (128 rows of 4 floats,
#: 512 of one): one below, at, one above, and several stages
STAGE_LENGTHS = (127, 128, 129, 511, 512, 513, 1029)


@pytest.mark.parametrize("rest", [(4,), ()], ids=["R x 4", "R"])
@pytest.mark.parametrize("case", ["one segment of 100,000", "stage lengths"])
def test_segment_sum_long_and_staged_segments_match_jax(case, rest):
    """One segment of 100,000 entries, and 140 segments whose lengths run
    through STAGE_LENGTHS (58,980 entries in a random order)."""
    rng = np.random.default_rng(len(case) + len(rest))
    if case == "stage lengths":
        n = 140
        ids = np.concatenate([np.full(STAGE_LENGTHS[s % 7], s, np.int32)
                              for s in range(n)])
        ids = ids[rng.permutation(ids.size)]
    else:
        n = 8
        ids = np.full(100_000, 3, np.int32)
    x = _values(rng, (ids.size,) + rest)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(ids),
                                          num_segments=n))
    xt, it = torch.from_numpy(x), torch.from_numpy(ids)
    assert _bits_equal(want, ops.segment_sum(xt, it, n).numpy())
    assert _bits_equal(want, ops.segment_sum_plain(xt, it.long(), n).numpy())


def test_ordered_sum_counter_sets_by_stream(monkeypatch):
    """K13's spread path takes one counter set per stream of a device, the
    same set again for the same stream, and raises when a device's sets
    run out."""
    from cruise_control_tpu_torch import cuda_kernels as ck
    monkeypatch.setattr(ck, "_ORDERED_SLOTS", {})
    monkeypatch.setattr(ck, "ORDERED_COUNTER_SLOTS", 3)
    assert [ck._ordered_slot(0, s) for s in (11, 22, 11, 33)] == [0, 1, 0, 2]
    assert ck._ordered_slot(1, 22) == 0
    with pytest.raises(RuntimeError, match="more than 3 streams"):
        ck._ordered_slot(0, 44)
    assert ck._ordered_slot(0, 33) == 2


@pytest.mark.parametrize("shape,lead_neg_zero",
                         [((200, 4), False), ((200, 8), False),
                          ((200, 8), True), ((3, 40), True), ((5, 1), True)])
def test_cumsum_matches_jax(shape, lead_neg_zero):
    rng = np.random.default_rng(shape[1])
    x = _values(rng, shape)
    if lead_neg_zero:
        x[:, 0] = -0.0
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=1))
    xt = torch.from_numpy(x)
    got = ops.cumsum_f32_plain(xt, 1).numpy()
    assert _bits_equal(want, got)
    if lead_neg_zero:
        # XLA scans from +0.0, but copies a row of one
        assert (np.signbit(got[:, 0]) == (shape[1] == 1)).all()


def test_stats_std_is_correctly_rounded():
    """Utilizations whose second column's variance has its root just
    above a float32 midpoint, where torch's CPU sqrt rounds down: the
    port's st.dev is the reference's, bit for bit."""
    spec = dict(num_brokers=4, num_partitions=40, replication_factor=2,
                num_racks=2, num_topics=2, seed=1)
    js, _ = j_random_cluster(JSpec(**spec))
    ps, _ = random_cluster(RandomClusterSpec(**spec), device="cpu")
    util = (np.random.default_rng(9).random((4, 4)) * 8).astype(np.float32)
    var = float(np.var(util[:, 1], dtype=np.float64))
    assert float(torch.sqrt(torch.tensor(np.float32(var)))) != float(
        np.sqrt(np.float32(var)))
    counts = np.arange(4, dtype=np.float32)
    topics = np.stack([counts, counts[::-1]], 1)
    a = JST._stats_from(js, jnp.asarray(util), jnp.asarray(counts),
                        jnp.asarray(counts), jnp.asarray(topics),
                        jnp.asarray(counts))
    b = ST._stats_from(ps, torch.from_numpy(util), torch.from_numpy(counts),
                       torch.from_numpy(counts), torch.from_numpy(topics),
                       torch.from_numpy(counts))
    for f in ST.ClusterModelStats.__dataclass_fields__:
        assert _bits_equal(getattr(a, f), getattr(b, f).numpy()), f


def test_stats_match_jax_bit_for_bit():
    spec = dict(num_brokers=40, num_partitions=600, replication_factor=3,
                num_racks=4, num_topics=9, seed=5, skew_fraction=0.3,
                dead_brokers=2)
    js, _ = j_random_cluster(JSpec(**spec))
    ps, _ = random_cluster(RandomClusterSpec(**spec), device="cpu")
    a = JST.compute_stats(js)
    b = ST.compute_stats(ps)
    for f in ST.ClusterModelStats.__dataclass_fields__:
        assert _bits_equal(getattr(a, f), getattr(b, f).numpy()), f
