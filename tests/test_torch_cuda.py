"""The port's CUDA kernels against their plain PyTorch versions on the
card, at the slice's shapes (marker `torch_cuda`).

K7 (`forced_select`) and K3's table-less mode are held here too, K2 at
the forced-move round's 4,096 candidates, K8 (`rank_accept`) on both of
its paths, and a short default-stack solve against the port's CPU path.

Each test decides inside itself whether a card is present and skips
with a reason when none is; run them on a machine with the card with
``JAX_PLATFORMS=cpu python -m pytest --noconftest -m torch_cuda
tests/test_torch_cuda.py`` (the suite's conftest needs JAX, which such a
machine may lack; JAX, where present, stays on the CPU).  Integers
and booleans must match exactly, and so must K3's float aggregates (the
kernel adds in the plain version's order).
"""
import numpy as np
import pytest
import torch

try:
    import jax
except ImportError:  # the card's machine carries no JAX
    jax = None

from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer import kernels as K
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)

pytestmark = pytest.mark.torch_cuda

SLICE = dict(num_brokers=200, num_partitions=20_000, replication_factor=3,
             num_racks=8, num_topics=10, seed=4, skew_fraction=0.2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m torch_cuda)")
    from cruise_control_tpu_torch import cuda_kernels
    cuda_kernels.build()
    return cuda_kernels


def _same(a, b):
    return a.dtype == b.dtype and bool(torch.equal(a, b))


@pytest.mark.parametrize("k", [1, 4, 8])
def test_row_topk_matches_plain(k):
    ck = _card()
    rng = np.random.default_rng(k)
    sc = np.round(rng.random((200, 1152)) * 40).astype(np.float32)
    sc[rng.random(sc.shape) < 0.3] = K.NEG
    sc[3] = K.NEG
    sc[4] = 1.0
    sc_t = torch.from_numpy(sc).cuda()
    table = torch.from_numpy(rng.permutation(200 * 1152).astype(
        np.int32).reshape(200, 1152)).cuda()
    got = ck.row_topk(sc_t, table, k)
    want = K.row_topk_plain(sc_t, table, k)
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("kk,k", [(256, 0), (256, 3), (200, 0), (200, 5)])
def test_assign_pass_matches_plain(kk, k):
    ck = _card()
    rng = np.random.default_rng(kk + k)
    c = 2048
    pref = -rng.random((c, kk)).astype(np.float32)
    pref[rng.random(pref.shape) < 0.3] = K.NEG
    pref[:, 7] = pref[:, 2]
    args = [torch.from_numpy(x).cuda() for x in (
        pref, rng.random(kk) < 0.8, rng.random(c) < 0.2, rng.random(c) < 0.9)]
    amp = torch.tensor(0.35 * 1.0 + 1e-6, dtype=torch.float32).cuda()
    got = ck.assign_pass(*args, k, amp)
    want = K.assign_pass_plain(*args, k, amp)
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, want))


def test_commit_moves_matches_plain_bit_for_bit():
    ck = _card()
    state, _ = random_cluster(RandomClusterSpec(**SLICE), device="cuda")
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    cache = C.make_round_cache(state, ctx.table_slots, ctx)
    rng = np.random.default_rng(0)
    n = 2048
    r = torch.from_numpy(rng.choice(state.num_replicas, size=n,
                                    replace=False).astype(np.int32)).cuda()
    dst = torch.from_numpy((rng.integers(0, 64, size=n) * 3 % 200).astype(
        np.int32)).cuda()
    valid = (torch.from_numpy(rng.random(n) < 0.9).cuda()
             & (state.replica_broker[r.long()] != dst))
    rank = C.arrival_rank(dst, valid, state.num_brokers)
    got = ck.commit_moves(state, cache, r, dst, valid, rank)
    want = C.commit_moves_plain(state, cache, r, dst, valid, rank)
    torch.cuda.synchronize()
    for f in want:
        assert _same(got[f], want[f]), f


def test_reference_stays_on_the_cpu():
    """The port's tests run JAX on the CPU beside the card's torch."""
    if jax is None:
        pytest.skip("JAX is not installed here")
    assert jax.default_backend() == "cpu"


@pytest.mark.parametrize("k", [16, 64])
def test_row_topk_deep_matches_plain(k):
    """The warp path of K1 (8 < k <= 64) with its slot output."""
    ck = _card()
    rng = np.random.default_rng(k)
    sc = np.round(rng.random((200, 1152)) * 40).astype(np.float32)
    sc[rng.random(sc.shape) < 0.3] = K.NEG
    sc[3] = K.NEG
    sc[4] = 1.0
    sc[5, 70:] = K.NEG                  # fewer eligible slots than k
    sc_t = torch.from_numpy(sc).cuda()
    table = torch.from_numpy(rng.permutation(200 * 1152).astype(
        np.int32).reshape(200, 1152)).cuda()
    got = ck.row_topk(sc_t, table, k)
    want = K.row_topk_plain(sc_t, table, k)
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("k", [0, 3])
def test_leader_assign_pass_matches_plain(multi, k):
    ck = _card()
    rng = np.random.default_rng(10 * k + multi)
    c, rf, nb = 2048, 3, 200
    pref = -rng.random((c, rf)).astype(np.float32)
    pref[rng.random(pref.shape) < 0.3] = K.NEG
    pref[:, 2] = pref[:, 0]
    args = [torch.from_numpy(x).cuda() for x in (
        pref, rng.integers(0, nb, (c, rf)).astype(np.int32),
        rng.integers(0, 10 ** 6, (c, rf)).astype(np.int32),
        rng.integers(0, nb, c).astype(np.int32),
        (rng.integers(0, 3, nb) * (32 if multi else 1)).astype(np.int32),
        rng.integers(0, 2, nb).astype(np.int32),
        rng.random(c) < 0.2, rng.random(c) < 0.9)]
    amp = torch.tensor(0.35 + 1e-6, dtype=torch.float32).cuda()
    got = ck.leader_assign_pass(*args, k, amp, multi)
    want = K.leader_assign_pass_plain(*args, k, amp, multi)
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, want))


def _transfer_batch(state, ctx, n, rng):
    from cruise_control_tpu_torch.model import state as S
    rows = ctx.partition_replicas.cpu().numpy()
    cur = S.partition_leader_replica(state).cpu().numpy()
    parts = rng.choice(rows.shape[0], size=n, replace=False)
    src = cur[parts].astype(np.int32)
    dst = np.array([[r for r in rows[p] if r >= 0 and r != s][0]
                    for p, s in zip(parts, src)], dtype=np.int32)
    return [torch.from_numpy(x).cuda()
            for x in (src, dst, rng.random(n) < 0.8)]


@pytest.mark.parametrize("table", [False, True])
def test_commit_leadership_matches_plain_bit_for_bit(table):
    ck = _card()
    state, _ = random_cluster(RandomClusterSpec(**SLICE), device="cuda")
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    cache = C.make_round_cache(state, ctx.table_slots if table else 0, ctx)
    sr, dr, valid = _transfer_batch(state, ctx, 4096 if not table else 3200,
                                    np.random.default_rng(int(table)))
    want = C.commit_leadership_plain(state, cache, sr, dr, valid)
    got = ck.commit_leadership(state, cache, sr, dr, valid)
    torch.cuda.synchronize()
    for f in want:
        assert _same(got[f], want[f]), f
    # donated: the cache's own planes carry the result
    donated = ck.commit_leadership(state, cache, sr, dr, valid, donate=True)
    torch.cuda.synchronize()
    assert donated["replica_load"].data_ptr() == \
        cache.replica_load.data_ptr()
    for f in want:
        assert _same(donated[f], want[f]), f


@pytest.mark.parametrize("improve_gate", [False, True])
def test_sweep_pick_matches_plain(improve_gate):
    ck = _card()
    from cruise_control_tpu_torch.analyzer import leadership as L
    state, _ = random_cluster(RandomClusterSpec(**SLICE), device="cuda")
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    cache = C.make_round_cache(state, 0, ctx)
    rng = np.random.default_rng(int(improve_gate))
    rows = ctx.partition_replicas
    num_p, rf = rows.shape
    sel = torch.from_numpy(rng.choice(num_p, 4096, replace=False).astype(
        np.int32)).cuda()
    cur = torch.clamp_min(rows[sel.long(), 0], 0).contiguous()
    has_in = torch.from_numpy(rng.random(4096) < 0.9).cuda()
    value = state.partition_leader_bonus[state.replica_partition.long(), 2]
    cap = state.broker_capacity[:, 2]
    upper = (ctx.balance_upper_pct[2] * cap).contiguous()
    fill_to = ((upper + ctx.balance_lower_pct[2] * cap) / 2).contiguous()
    tb = torch.rand(state.num_brokers, device="cuda") if improve_gate \
        else None
    args = (sel, has_in, cur, rows, K._pairwise_jitter(num_p, rf,
                                                       device="cuda"),
            state.replica_broker, value.contiguous(),
            C.replica_static_ok(state, ctx), state.broker_alive,
            ctx.broker_leader_ok, cache.broker_load[:, 2].contiguous(),
            fill_to, upper, tb, 1.11, improve_gate)
    got = ck.sweep_pick(*args)
    want = L.sweep_pick_plain(*args)
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("kk", [256, 2600])
def test_assign_pass_at_4096_candidates(kk):
    """K2 at the forced-move round's C = 4096 (self-healing's candidates),
    against the shortlist and the escalated all-broker width."""
    ck = _card()
    rng = np.random.default_rng(kk)
    c = 4096
    pref = -rng.random((c, kk)).astype(np.float32)
    pref[rng.random(pref.shape) < 0.3] = K.NEG
    pref[:, 9] = pref[:, 4]
    args = [torch.from_numpy(x).cuda() for x in (
        pref, rng.random(kk) < 0.8, rng.random(c) < 0.2, rng.random(c) < 0.9)]
    amp = torch.tensor(0.35 + 1e-6, dtype=torch.float32).cuda()
    for k in (0, 5):
        got = ck.assign_pass(*args, k, amp)
        want = K.assign_pass_plain(*args, k, amp)
        torch.cuda.synchronize()
        assert all(_same(a, b) for a, b in zip(got, want))


def test_commit_moves_tableless_matches_plain_bit_for_bit():
    """K3's table-less mode (self-healing's commits): the aggregates only,
    equal to the plain aggregates bit for bit."""
    ck = _card()
    state, _ = random_cluster(RandomClusterSpec(**SLICE), device="cuda")
    cache = C.make_round_cache(state)
    rng = np.random.default_rng(3)
    n = 4096
    r = torch.from_numpy(rng.choice(state.num_replicas, size=n,
                                    replace=False).astype(np.int32)).cuda()
    dst = torch.from_numpy(rng.integers(0, 40, size=n).astype(
        np.int32)).cuda()
    valid = (torch.from_numpy(rng.random(n) < 0.9).cuda()
             & (state.replica_broker[r.long()] != dst))
    got = ck.commit_moves(state, cache, r, dst, valid, None)
    want = C._aggregates_plain(state, cache, r.long(), dst.long(), valid)
    torch.cuda.synchronize()
    assert set(got) == set(want)
    for f in want:
        assert _same(got[f], want[f]), f


@pytest.mark.parametrize("case", ["sparse", "ties", "tail", "all"])
def test_forced_select_matches_plain(case):
    """K7 against its plain version: about 0.5 % forced, many equal
    weights, fewer forced than k (the -inf tail), every replica forced;
    and its guard-only mode (k = 0)."""
    ck = _card()
    spec = dict(SLICE, num_brokers=24, num_partitions=3000)
    state, _ = random_cluster(RandomClusterSpec(**spec), device="cuda")
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    rng = np.random.default_rng(len(case))
    num_r = state.num_replicas
    share = {"sparse": 0.005, "ties": 0.5, "tail": 0.3, "all": 1.0}[case]
    forced = torch.from_numpy(rng.random(num_r) < share).cuda()
    w = state.replica_base_load[:, 3].contiguous()
    if case == "ties":
        w = torch.round(w / w.max() * 3.0)
    dest_ok = torch.from_numpy(rng.random(state.num_brokers) < 0.7).cuda()
    inf_room = torch.full((state.num_brokers,), float("inf"), device="cuda")
    top_b, top_h = K.top_headroom(dest_ok, inf_room,
                                  ctx.partition_replicas.shape[1])
    top_b = top_b.to(torch.int32).contiguous()
    for k in (4096, 0):
        got = ck.forced_select(forced, w, state.replica_partition,
                               state.replica_broker, ctx.partition_replicas,
                               top_b, top_h, k)
        want = K.forced_select_plain(forced, w, state.replica_partition,
                                     state.replica_broker,
                                     ctx.partition_replicas, top_b, top_h, k)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert _same(a, b)
    if case == "tail":
        assert 0 < int(want[2].sum()) < 4096


@pytest.mark.parametrize("c", [17, 2048, 4096, 10_400])
@pytest.mark.parametrize("t", [0, 3, 6])
def test_rank_accept_matches_plain(c, t):
    """K8 (one block up to C = 4096, the multi-launch path beyond) against
    the plain version, exactly, with ties and mid-segment failures."""
    _card()
    rng = np.random.default_rng(c + t)
    b = 2600 if c > 4096 else 200
    dest = rng.integers(0, min(b, c // 8 + 1), c).astype(np.int32)
    gain = (np.round(rng.random(c) * 8.0) / 4.0).astype(np.float32)
    has = rng.random(c) < 0.85
    taken = np.where(rng.random(b) < 0.7, 0,
                     rng.integers(1, 4, b)).astype(np.int32)
    cap = rng.integers(24, 65, b).astype(np.int32)
    d_w = (np.round(rng.random((t, c)) * 64.0) / 16.0).astype(np.float32)
    cum = (np.round(rng.random((t, b)) * 16.0) / 4.0).astype(np.float32)
    hr = (cum + rng.random((t, b)) * 30.0).astype(np.float32)
    cu = [torch.from_numpy(x).cuda() for x in (dest, gain, has, taken, cap,
                                               cum, d_w, hr)]
    args = cu[:3] + [b] + cu[3:5] + [list(cu[5]), list(cu[6]), list(cu[7])]
    got = K.rank_accept(*args)
    want = K.rank_accept_plain(*args)
    torch.cuda.synchronize()
    assert _same(got, want)
    assert bool(got.any())


def test_default_stack_solve_on_the_card_equals_the_cpu_path():
    """A short default-stack solve (the 15 goals, 16 rounds) on a
    48-broker cluster: the card's proposals and final leader flags equal
    the port's CPU path's."""
    _card()
    from cruise_control_tpu_torch.analyzer.goals.registry import \
        default_goals
    from cruise_control_tpu_torch.analyzer.optimizer import (GoalOptimizer,
                                                             proposal_set)
    spec = dict(num_brokers=48, num_partitions=1500, replication_factor=3,
                num_racks=8, num_topics=8, seed=4, skew_fraction=0.2)
    out = {}
    for dev in ("cuda", "cpu"):
        st, topo = random_cluster(RandomClusterSpec(**spec), device=dev)
        out[dev] = GoalOptimizer(default_goals(16)).optimizations(
            st, topo, device=dev)
    assert proposal_set(out["cuda"]) == proposal_set(out["cpu"])
    assert torch.equal(out["cuda"].final_state.replica_is_leader.cpu(),
                       out["cpu"].final_state.replica_is_leader)
    assert out["cuda"].rounds_by_goal == out["cpu"].rounds_by_goal
