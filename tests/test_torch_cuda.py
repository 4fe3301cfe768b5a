"""The port's CUDA kernels against their plain PyTorch versions on the
card, at the slice's shapes (marker `torch_cuda`).

K3 (`commit_moves`, with and without a table) and K5
(`commit_leadership`) at their edges (no move, every move dropped, one
bucket of the whole batch, a row pushed past its end, no-ops, 2,600
brokers), K3 in place and K5 donated and not, and K3's in-kernel
arrival ranks against `arrival_rank`; K6 (`sweep_window`, one sweep
round's window, first round and fold, at P = 3,000, 20,000 and
200,000); K7 (`forced_select`, on the top-k select it shares with K6,
also at k = R) is held here too,
K2 (`assign_pass`) on both commit modes with its fold and its amplitude,
also at the forced-move round's 4,096 candidates, and whole
`assign_destinations` calls against the CPU path, K8 (`rank_accept`) on
both of its paths, without and with the pass commit, K9
(`segment_argmax`, its dense and keep entries, each call leaving its key
scratch zero; its grid path under each fold, and no scratch growth
inside a graph capture), K10 (`swap_shortlist` and `swap_pair` at 100,
200 and 2,600 brokers) and K11 (`dest_feasibility`:
the preference plane on broadcast acceptance planes, with and without the
sibling test, and the guard that selects its own top brokers), the
ordered sums K12
(`segment_sum`, also with `init`), K13 (`ordered_sum`) and K14
(`cumsum_blocks`, the prefix gate `prefix_gate`, at 200 and 2,600
brokers) bit for bit with signed zeros and dropped ids, the
slice's stats, a short default-stack solve and the demote,
kafka-assigner and intra-broker solves against the port's CPU path; and
the dirty-region functions (`apply_delta` with padded id arrays,
`set_broker_capacities`, `restrict_context_to_dirty`) and a 16-broker
add-broker request solve (rack-aware first, then the default stack with
the new brokers as the only destinations) against the CPU path; the
model builder's state placed on the card, and requests served through
the facade over the monitor (a cold solve, a delta fast-forwarded on the
card, its restricted warm solve, a broker removal) against the CPU
path.

Each test decides inside itself whether a card is present and skips
with a reason when none is; run them on a machine with the card with
``JAX_PLATFORMS=cpu python -m pytest --noconftest -m torch_cuda
tests/test_torch_cuda.py`` (the suite's conftest needs JAX, which such a
machine may lack; JAX, where present, stays on the CPU).  Integers
and booleans must match exactly, and so must K3's float aggregates (the
kernel adds in the plain version's order).
"""
import functools

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


def _row_inputs(rng, b, s):
    """A [B, S] plane of quantised scores (ties), a third NEG, with a -0.0
    beside +0.0 in every row, a row of NEG, a row of pure ties, a row with
    fewer eligible slots than 64, and a permutation table."""
    sc = np.round(rng.random((b, s)) * 40).astype(np.float32)
    sc[rng.random(sc.shape) < 0.3] = K.NEG
    sc[:, 1] = -0.0
    sc[:, 6] = 0.0
    sc[3] = K.NEG
    sc[4] = 1.0
    sc[5, 40:] = K.NEG
    table = rng.permutation(b * s).astype(np.int32).reshape(b, s)
    return torch.from_numpy(sc).cuda(), torch.from_numpy(table).cuda()


def _check_row_topk(ck, launch, plain, k):
    """Every K1 path (the block and warp selects, the register path at k
    <= 8) and the wrapper's choice against the plain version."""
    for path in [0, 2] + ([1] if k <= 8 else []) + [None]:
        saved = ck.ROW_TOPK_PATH
        ck.ROW_TOPK_PATH = path
        try:
            got = launch()
        finally:
            ck.ROW_TOPK_PATH = saved
        want = plain()
        torch.cuda.synchronize()
        assert len(got) == len(want) == 5
        for a, b, what in zip(got, want, ("cand", "has", "top", "slot",
                                          "any")):
            assert _same(a, b), (what, k, path)
            if what == "top":
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("k", [1, 4, 8])
def test_row_topk_matches_plain(k):
    """K1's plane source on both of its paths, and the table source."""
    ck = _card()
    rng = np.random.default_rng(k)
    sc, table = _row_inputs(rng, 200, 1152)
    _check_row_topk(ck, lambda: ck.row_topk(sc, table, k),
                    lambda: K.row_topk_plain(sc, table, k), k)


@pytest.mark.parametrize("k", [16, 64])
def test_row_topk_deep_matches_plain(k):
    """K1 at the leadership round's k = 16 and the deep pick's 64, at 200
    and 2,600 brokers, and on rows too wide for the keys in registers."""
    ck = _card()
    rng = np.random.default_rng(k)
    for b, s in ((200, 1152), (2600, 1024), (40, 3000)):
        sc, table = _row_inputs(rng, b, s)
        _check_row_topk(ck, lambda: ck.row_topk(sc, table, k),
                        lambda: K.row_topk_plain(sc, table, k), k)


@pytest.mark.parametrize("k", [1, 4, 16, 64])
def test_table_topk_matches_plain(k):
    """K1's table source: per-replica scores read at a stride through the
    table (pad ids R, invalid replicas, ties and -0.0) against
    table_topk_plain (_table_rows, then the plain top-k)."""
    ck = _card()
    rng = np.random.default_rng(100 + k)
    b, s = 200, 1152
    num_r = b * s - 5000
    load = np.round(rng.random((num_r, 4)) * 30).astype(np.float32)
    load[rng.random(num_r) < 0.05, 1] = -0.0
    ids = np.full(b * s, num_r, np.int32)
    ids[rng.permutation(b * s)[:num_r]] = np.arange(num_r, dtype=np.int32)
    table = torch.from_numpy(ids.reshape(b, s)).cuda()
    table[7] = num_r                     # a row of pads
    score = torch.from_numpy(load).cuda()[:, 1]   # stride 4
    valid = torch.from_numpy(rng.random(num_r) < 0.7).cuda()
    _check_row_topk(ck, lambda: ck.table_topk(table, score, valid, k),
                    lambda: K.table_topk_plain(table, score, valid, k), k)


def test_row_topk_takes_every_slot():
    """k = S: the whole row in order, both sources."""
    ck = _card()
    rng = np.random.default_rng(7)
    sc, table = _row_inputs(rng, 50, 64)
    _check_row_topk(ck, lambda: ck.row_topk(sc, table, 64),
                    lambda: K.row_topk_plain(sc, table, 64), 64)
    score = torch.round(torch.rand(50 * 64, device="cuda") * 3)
    valid = torch.rand(50 * 64, device="cuda") < 0.5
    _check_row_topk(ck, lambda: ck.table_topk(table, score, valid, 64),
                    lambda: K.table_topk_plain(table, score, valid, 64), 64)


def _assign_inputs(rng, c, kk, num_b, multi, fold):
    """K2's inputs on the card: a [C, K] plane (30 % NEG, two tied slots),
    shortlist ids, arrival counts and (multi) caps, the rows' flags and,
    with `fold`, a previous pass's keep and broker ids to fold."""
    pref = -rng.random((c, kk)).astype(np.float32)
    pref[rng.random(pref.shape) < 0.3] = K.NEG
    pref[:, min(7, kk - 1)] = pref[:, min(2, kk - 1)]
    ids = rng.permutation(num_b)[:kk].astype(np.int32)
    taken = rng.integers(0, 3, num_b).astype(np.int32)
    taken[rng.random(num_b) < 0.5] = 0
    cap = rng.integers(1, 4, num_b).astype(np.int32) if multi else None
    assigned = rng.random(c) < 0.2
    keep = (rng.random(c) < 0.3) & ~assigned if fold else None
    prev = rng.integers(0, num_b, c).astype(np.int32) if fold else None
    return dict(pref=pref, dest_ids=ids, taken_cnt=taken, cap=cap,
                cand_has=rng.random(c) < 0.9, assigned=assigned,
                dest=rng.integers(0, num_b, c).astype(np.int32), keep=keep,
                prev_best=prev)


def _check_assign_pass(ck, inputs, k, amp_value):
    """K2 against assign_pass_plain on the card: best, has, the folded
    dest and assigned, and pass 0's amp, all exactly."""
    outs = []
    for launch in (ck.assign_pass, K.assign_pass_plain):
        t = {n: None if v is None else torch.from_numpy(v.copy()).cuda()
             for n, v in inputs.items()}
        amp = torch.tensor(amp_value, dtype=torch.float32).cuda()
        best, has = launch(t["pref"], t["dest_ids"], t["taken_cnt"],
                           t["cap"], t["cand_has"], k, amp, t["assigned"],
                           t["dest"], t["keep"], t["prev_best"])
        outs.append((best, has, t["dest"], t["assigned"], amp))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert _same(a, b)


@pytest.mark.parametrize("kk,k", [(256, 0), (256, 3), (200, 0), (200, 5)])
def test_assign_pass_matches_plain(kk, k):
    """K2 at the slice's C = 2048 on both commit modes, with and without
    the previous pass's fold."""
    ck = _card()
    for multi in (False, True):
        for fold in (False, True):
            rng = np.random.default_rng(kk + k + 2 * multi + fold)
            _check_assign_pass(ck, _assign_inputs(rng, 2048, kk,
                                                  max(kk, 200), multi, fold),
                               k, 0.35 + 1e-6)


#: the 2,600-broker cluster of K3's and K5's wide cases, cut to 60,000
#: partitions
WIDE = dict(SLICE, num_brokers=2600, num_partitions=60_000, num_racks=26,
            num_topics=100)
COMMIT_CASES = ["random", "empty", "all invalid", "one destination",
                "source and destination", "overflow", "no-ops",
                "2600 brokers"]


def _move_batch(state, cache, case, rng):
    """K3's batches at its edges (r, dst, valid on the card): 2,048 moves
    into 64 destinations; none; every move dropped; every move into one
    broker (one bucket of 2,048, past the row's end); one broker the
    source of all its replicas and the destination of as many; a row
    pushed 40 past its end among random moves; a third of the moves
    no-ops (the kernel drops them itself); 4 B moves at 2,600 brokers."""
    rb = state.replica_broker.cpu().numpy()
    num_b = state.num_brokers
    n = 4 * num_b if case == "2600 brokers" else 2048
    r = rng.choice(state.num_replicas, size=n, replace=False)
    dst = (rng.integers(0, 64, size=n) * 3 % num_b
           if case != "2600 brokers" else rng.integers(0, num_b, size=n))
    valid = rng.random(n) < 0.9
    if case == "empty":
        r, dst, valid = r[:0], dst[:0], valid[:0]
    elif case == "all invalid":
        valid[:] = False
    elif case == "one destination":
        r = rng.choice(np.nonzero(rb != 7)[0], size=n, replace=False)
        dst[:] = 7
    elif case == "source and destination":
        out = np.nonzero(rb == 9)[0]
        into = rng.choice(np.nonzero(rb != 9)[0], size=out.size,
                          replace=False)
        r = np.stack([out, into], 1).reshape(-1)
        dst = np.where(rb[r] == 9, (r % 150) + 10, 9)
        valid = np.ones(r.size, dtype=bool)
    elif case == "overflow":
        fill = cache.table_fill.cpu().numpy()
        room = cache.broker_table.shape[1] - int(fill[11]) + 40
        pick = rng.choice(np.nonzero(rb != 11)[0], size=room, replace=False)
        keep = ~np.isin(r, pick)
        r = np.concatenate([pick, r[keep][:n - room]])
        dst = np.concatenate([np.full(room, 11), dst[keep][:n - room]])
        valid = np.concatenate([np.ones(room, bool), valid[keep][:n - room]])
    elif case == "no-ops":
        dst[::3] = rb[r[::3]]
    return [torch.from_numpy(np.ascontiguousarray(x).astype(dt)).cuda()
            for x, dt in ((r, np.int32), (dst, np.int32), (valid, bool))]


def _donatable(cache):
    """A copy of the cache whose planes an in-place commit may update."""
    return cache.replace(**{f: getattr(cache, f).clone()
                            for f in C.CACHE_FIELDS})


def _check_commit_moves(ck, state, cache, r, dst, valid):
    """K3 against its plain version bit for bit, committed in place into
    a copy of the cache (the returned planes are that copy's own
    tensors), and its in-kernel arrival ranks against `arrival_rank`."""
    counted = valid & (state.replica_broker[r.long()] != dst)
    table = cache.broker_table.shape[1] > 0
    rank = (C.arrival_rank(dst, counted, state.num_brokers) if table
            else None)
    want = C.commit_moves_plain(state, cache, r, dst, counted, rank)
    ranks = torch.full_like(r, 7)
    donor = _donatable(cache)
    got = ck.commit_moves(state, donor, r, dst, valid, rank_out=ranks)
    torch.cuda.synchronize()
    assert set(got) == set(want)
    for f in want:
        assert _same(got[f], want[f]), f
        assert got[f].data_ptr() == getattr(donor, f).data_ptr(), f
    want_rank = C.arrival_rank(dst, counted, state.num_brokers)
    assert _same(ranks, torch.where(counted, want_rank, -1))


#: (brokers, the largest batch the shared bucketing takes there): the
#: limits stated in csrc/commit_bucket.cuh
BUCKET_LIMITS = [(200, 1_048_576), (5_120, 1_048_576), (5_121, 917_504),
                 (10_400, 262_144), (17_066, 131_072), (17_067, 0)]


@pytest.mark.parametrize("kernel", ["commit_moves", "commit_leadership"])
@pytest.mark.parametrize("num_b,most", BUCKET_LIMITS)
def test_commit_bucketing_limits(kernel, num_b, most):
    """K3 and K5 size their one scratch allocation up to the stated
    limits and raise (no fallback) one move past them."""
    ck = _card()
    if most:
        assert ck._commit_scratch_bytes(kernel, most, num_b) > 0
    with pytest.raises(ValueError, match="cannot bucket"):
        ck._commit_scratch_bytes(kernel, most + 1 if most else 1, num_b)


@pytest.mark.parametrize("case", COMMIT_CASES)
def test_commit_moves_matches_plain_bit_for_bit(case):
    ck = _card()
    spec = WIDE if case == "2600 brokers" else SLICE
    state, _ = random_cluster(RandomClusterSpec(**spec), device="cuda")
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    cache = C.make_round_cache(state, ctx.table_slots, ctx)
    r, dst, valid = _move_batch(state, cache, case, np.random.default_rng(0))
    _check_commit_moves(ck, state, cache, r, dst, valid)


def test_reference_stays_on_the_cpu():
    """The port's tests run JAX on the CPU beside the card's torch."""
    if jax is None:
        pytest.skip("JAX is not installed here")
    assert jax.default_backend() == "cpu"


def _leader_tail(x: dict, dev):
    """A LeaderTail on `dev` over the option inputs `x` (numpy)."""
    import types
    t = {n: None if v is None else torch.from_numpy(np.array(v)).to(dev)
         for n, v in x.items()}
    state = types.SimpleNamespace(replica_broker=t["replica_broker"],
                                  replica_offline=t["replica_offline"])
    return K.leader_tail(state, t["rows"], t["sib"], t["accept"],
                         t["cand_has"], t["leader_ok"], t["bonus_w"],
                         t["dest_headroom"], t["dest_pref"], t["t_ws"])


def _leader_inputs(rng, c, nb, num_r, multi, rf=3):
    """K4's pass-0 inputs: candidate rows, sibling rows (-1 pads, the row
    itself among them), an acceptance plane, per-replica brokers, offline
    flags and bonuses, per-broker flags, headrooms and preferences (two
    brokers tied, one NEG), and (multi-commit) three weight rows."""
    rows = rng.integers(0, num_r, c).astype(np.int64)
    sib = rng.integers(0, num_r, (c, rf)).astype(np.int32)
    sib[:, 0] = rows
    sib[rng.random((c, rf)) < 0.1] = -1
    pref = -np.round(rng.random(nb) * 8).astype(np.float32)
    pref[3] = K.NEG
    return dict(
        rows=rows, sib=sib, accept=rng.random((c, rf)) < 0.85,
        cand_has=rng.random(c) < 0.9,
        replica_broker=rng.integers(0, nb, num_r).astype(np.int32),
        replica_offline=rng.random(num_r) < 0.05,
        leader_ok=rng.random(nb) < 0.9,
        bonus_w=np.round(rng.random(num_r) * 4).astype(np.float32),
        dest_headroom=(rng.random(nb) * 5).astype(np.float32),
        dest_pref=pref,
        t_ws=rng.random((3, num_r)).astype(np.float32) if multi else None)


def _tail_fields(t):
    return {f: getattr(t, f) for f in (
        "pref", "sib_broker", "sib_replica", "src", "gain", "amp",
        "taken_cnt", "dep_cnt", "assigned", "dest_replica", "d_w")
            if getattr(t, f) is not None}


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("k", [0, 3])
def test_leader_assign_pass_matches_plain(multi, k):
    """K4 against its plain version pass by pass up to pass k: pass 0's
    plane, amplitude and zeroed state, then each later pass with the fold
    of a keep mask (a random third of the rows with an option), its
    counts and K8's weights, every output and buffer exactly."""
    ck = _card()
    rng = np.random.default_rng(10 * k + multi)
    for c, nb, num_r in ((2048, 200, 60_000), (2048, 2600, 600_000)):
        x = _leader_inputs(rng, c, nb, num_r, multi)
        tk, tp = _leader_tail(x, "cuda"), _leader_tail(x, "cuda")
        keep = db = dr = None
        for p in range(k + 1):
            got = ck.leader_assign_pass(tk, p, multi, keep, db, dr)
            want = K.leader_assign_pass_plain(tp, p, multi, keep, db, dr)
            torch.cuda.synchronize()
            for a, b, what in zip(got, want, ("db", "dr", "has")):
                assert _same(a, b), (what, p, c, nb)
            for f, a in _tail_fields(tk).items():
                assert _same(a, getattr(tp, f)), (f, p, c, nb)
            db, dr = want[0], want[1]
            keep = want[2] & (torch.rand(c, device="cuda") < 0.3)


LEADERSHIP_CASES = ["random", "empty", "all invalid", "one destination",
                    "source and destination", "2600 brokers"]


def _transfer_batch(state, ctx, case, rng, n):
    """Transfers on distinct partitions, the leader to another replica:
    n random ones, a fifth dropped; none; all dropped; every one into
    broker 7; broker 9 the source of every other one and the destination
    of the rest."""
    from cruise_control_tpu_torch.model import state as S
    rows = ctx.partition_replicas.cpu().numpy()
    rb = state.replica_broker.cpu().numpy()
    cur = S.partition_leader_replica(state).cpu().numpy()
    if case in ("one destination", "source and destination"):
        b = 7 if case == "one destination" else 9
        led, into = [], []
        for p in range(rows.shape[0]):
            others = [r for r in rows[p] if r >= 0 and r != cur[p]]
            to = [r for r in others if rb[r] == b]
            if case != "one destination" and rb[cur[p]] == b:
                led.append((cur[p], others[0]))
            elif to:
                into.append((cur[p], to[0]))
        pairs = (into if case == "one destination" else
                 [x for two in zip(led, into) for x in two])
        src, dst = (np.array(x, dtype=np.int32) for x in zip(*pairs))
        valid = np.ones(src.size, dtype=bool)
    else:
        parts = rng.choice(rows.shape[0], size=n if case != "empty" else 0,
                           replace=False)
        src = cur[parts].astype(np.int32)
        dst = np.array([[r for r in rows[p] if r >= 0 and r != s][0]
                        for p, s in zip(parts, src)], dtype=np.int32)
        valid = (rng.random(src.size) < 0.8) & (case != "all invalid")
    return [torch.from_numpy(x).cuda() for x in (src, dst, valid)]


@pytest.mark.parametrize("case", LEADERSHIP_CASES)
@pytest.mark.parametrize("table", [False, True])
def test_commit_leadership_matches_plain_bit_for_bit(table, case):
    """K5 against its plain version bit for bit, undonated and donated
    (the donated planes are the cache's own tensors)."""
    ck = _card()
    spec = WIDE if case == "2600 brokers" else SLICE
    state, _ = random_cluster(RandomClusterSpec(**spec), device="cuda")
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    cache = C.make_round_cache(state, ctx.table_slots if table else 0, ctx)
    n = (16 * state.num_brokers if case == "2600 brokers"
         else 3200 if table else 4096)
    sr, dr, valid = _transfer_batch(state, ctx, case,
                                    np.random.default_rng(int(table)), n)
    want = C.commit_leadership_plain(state, cache, sr, dr, valid)
    got = ck.commit_leadership(state, cache, sr, dr, valid)
    donor = _donatable(cache)
    donated = ck.commit_leadership(state, donor, sr, dr, valid, donate=True)
    torch.cuda.synchronize()
    assert set(got) == set(want) == set(donated)
    for f in want:
        assert _same(got[f], want[f]), f
        assert _same(donated[f], want[f]), f
        assert donated[f].data_ptr() == getattr(donor, f).data_ptr(), f


@functools.lru_cache(maxsize=None)
def _sweep_cluster(spec: str):
    """The card cluster, context and round cache of a SWEEP_SPECS entry
    (built once: the tests only read them)."""
    state, _ = random_cluster(RandomClusterSpec(**SWEEP_SPECS[spec]),
                              device="cuda")
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    return state, ctx, C.make_round_cache(state, 0, ctx)


def _sweep_inputs(spec, improve_gate, tiebreak, case, rng):
    """K6's inputs: a resource's leader bonus as the value, the goals'
    bounds (mean mode: the average read through stride 0), a strided
    column of the broker loads; `case` plants quantized values with
    signed zeros, few or no live partitions, or every partition failed."""
    from cruise_control_tpu_torch.model import state as S
    state, ctx, cache = _sweep_cluster(spec)
    rows = ctx.partition_replicas
    num_p, rf = rows.shape
    nb = state.num_brokers
    value = (state.partition_leader_bonus[state.replica_partition.long(), 2]
             * state.replica_valid)
    if case == "ties and signed zeros":
        value = torch.round(value * 4.0) / 4.0
        r = torch.from_numpy(rng.random(value.shape[0])).cuda()
        value = torch.where(r < 0.05, torch.full_like(value, -0.0), value)
        value = torch.where((r >= 0.05) & (r < 0.1),
                            torch.zeros_like(value), value)
    cap = state.broker_capacity[:, 2]
    W = cache.broker_load[:, 2]
    up = (ctx.balance_upper_pct[2] * cap).contiguous()
    if improve_gate:
        avg = W.mean()
        shed_to = avg.reshape(1).expand(nb)
        fill_to = torch.minimum(shed_to, up)
    else:
        shed_to = torch.minimum(up, torch.quantile(W, 0.6)).contiguous()
        fill_to = ((up + ctx.balance_lower_pct[2] * cap) / 2.0).contiguous()
    if case == "few live partitions":
        shed_to = torch.quantile(W, 0.97).expand(nb)
    if case == "no live partition":
        shed_to = torch.full((nb,), float("inf"), device="cuda")
    failed = (torch.ones(num_p, device="cuda") if case == "all failed"
              else torch.from_numpy((rng.random(num_p) < 0.1).astype(
                  np.float32)).cuda())
    tb = None
    if tiebreak:
        tb = -cache.leader_bytes_in.clone()
        tb[::9] = 0.0
    fixed = (rows, K._pairwise_jitter(num_p, rf, device="cuda"),
             state.replica_broker, state.replica_partition,
             value.contiguous(), C.replica_static_ok(state, ctx),
             state.broker_alive, ctx.broker_leader_ok, W, shed_to, fill_to,
             up, tb, float(np.float32(3) * np.float32(0.37)), improve_gate,
             1.0 if improve_gate else 0.35)
    return S.partition_leader_replica(state), failed, fixed


SWEEP_SPECS = {"P=20000": SLICE,
               "P=200000": dict(SLICE, num_brokers=2600,
                                num_partitions=200_000, num_racks=26,
                                num_topics=100),
               "P=3000": dict(SLICE, num_partitions=3000)}


@pytest.mark.parametrize("case", ["random", "ties and signed zeros",
                                  "few live partitions", "no live partition",
                                  "all failed"])
@pytest.mark.parametrize("improve_gate,tiebreak",
                         [(False, False), (False, True), (True, False),
                          (True, True)])
@pytest.mark.parametrize("spec", list(SWEEP_SPECS))
def test_sweep_pick_matches_plain(spec, improve_gate, tiebreak, case):
    """K6, one sweep round's window, against sweep_window_plain: the first
    round, then a round folding a random acceptance of the first's picks
    into the carried leader index and failure marks; every output and the
    folded tensors exactly."""
    ck = _card()
    from cruise_control_tpu_torch.analyzer import leadership as L
    rng = np.random.default_rng(len(case) + 2 * improve_gate + tiebreak)
    cur, failed, fixed = _sweep_inputs(spec, improve_gate, tiebreak, case,
                                       rng)
    kc, kf, pc, pf = cur.clone(), failed.clone(), cur.clone(), failed.clone()
    got = L.SweepWindow(*ck.sweep_window(kc, kf, None, *fixed))
    want = L.sweep_window_plain(pc, pf, None, *fixed)
    torch.cuda.synchronize()
    assert all(a.dtype == b.dtype and _same(a, b)
               for a, b in zip(got, want))
    assert (int(want.live_w.sum()) == 0) == (case == "no live partition")
    valid = want.has & torch.from_numpy(
        rng.random(want.has.shape[0]) < 0.6).cuda()
    got2 = L.SweepWindow(*ck.sweep_window(kc, kf, (got, valid), *fixed))
    want2 = L.sweep_window_plain(pc, pf, (want, valid), *fixed)
    torch.cuda.synchronize()
    assert all(a.dtype == b.dtype and _same(a, b)
               for a, b in zip(got2, want2))
    assert _same(kc, pc) and _same(kf, pf)


@pytest.mark.parametrize("kk", [256, 2600])
def test_assign_pass_at_4096_candidates(kk):
    """K2 at the forced-move round's C = 4096 (self-healing's candidates),
    against the shortlist and the escalated all-broker width; a row width
    that is not a multiple of 4 takes the scalar walk."""
    ck = _card()
    for width in (kk, kk - 1):
        for k in (0, 5):
            rng = np.random.default_rng(width + k)
            _check_assign_pass(ck, _assign_inputs(rng, 4096, width, 2600,
                                                  True, k > 0), k,
                               0.35 + 1e-6)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("c,kk,num_b", [(2048, 256, 2600), (4096, 200, 200),
                                        (3, 1, 200)])
def test_assign_destinations_on_the_card_equals_the_cpu(c, kk, num_b,
                                                        multi):
    """All eight passes of assign_destinations on the card (K2 and K8, or
    K2 and the single-commit conflict resolution) against the CPU path."""
    ck = _card()
    rng = np.random.default_rng(c + kk + multi)
    pref = -rng.random((c, kk)).astype(np.float32)
    pref[rng.random(pref.shape) < 0.3] = K.NEG
    gain = np.round(rng.random(c) * 8).astype(np.float32)
    has = rng.random(c) < 0.9
    ids = rng.permutation(num_b)[:kk].astype(np.int32)
    terms = [(rng.random(c).astype(np.float32),
              (rng.random(num_b) * 6).astype(np.float32)) for _ in range(3)]
    cap = rng.integers(1, 8, num_b).astype(np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        def on(x):
            return torch.from_numpy(x).to(dev)
        kw = (dict(dest_terms=[(on(w), on(h)) for w, h in terms],
                   dest_cap=on(cap)) if multi else {})
        ck.reset_launches()
        out[dev] = K.assign_destinations(on(pref), on(gain), on(has), num_b,
                                         on(ids), **kw)
        if dev == "cuda":
            assert ck.LAUNCHES["assign_pass"] == K.ASSIGN_PASSES
    for a, b in zip(out["cuda"], out["cpu"]):
        assert _same(a.cpu(), b)


@pytest.mark.parametrize("case", COMMIT_CASES)
def test_commit_moves_tableless_matches_plain_bit_for_bit(case):
    """K3's table-less mode (self-healing's commits): the aggregates only,
    equal to the plain aggregates bit for bit."""
    ck = _card()
    spec = WIDE if case == "2600 brokers" else SLICE
    state, _ = random_cluster(RandomClusterSpec(**spec), device="cuda")
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    table_cache = C.make_round_cache(state, ctx.table_slots, ctx)
    r, dst, valid = _move_batch(state, table_cache, case,
                                np.random.default_rng(3))
    _check_commit_moves(ck, state, C.make_round_cache(state), r, dst, valid)


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


@pytest.mark.parametrize("share", [0.01, 0.5, 1.0])
def test_forced_select_k_equals_r_on_a_small_cluster(share):
    """K7 with k = R (every replica a candidate): the guarded replicas by
    score, then every other replica in index order; and with fewer
    guarded than k, the shortcut that runs no select."""
    ck = _card()
    spec = dict(SLICE, num_brokers=12, num_partitions=400)
    state, _ = random_cluster(RandomClusterSpec(**spec), device="cuda")
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    rng = np.random.default_rng(int(share * 100))
    num_r = state.num_replicas
    forced = torch.from_numpy(rng.random(num_r) < share).cuda()
    w = torch.round(state.replica_base_load[:, 3] * 4.0).contiguous()
    dest_ok = torch.ones(state.num_brokers, dtype=torch.bool, device="cuda")
    inf_room = torch.full((state.num_brokers,), float("inf"), device="cuda")
    top_b, top_h = K.top_headroom(dest_ok, inf_room,
                                  ctx.partition_replicas.shape[1])
    args = (forced, w, state.replica_partition, state.replica_broker,
            ctx.partition_replicas, top_b.to(torch.int32).contiguous(),
            top_h)
    got = ck.forced_select(*args, num_r)
    want = K.forced_select_plain(*args, num_r)
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, want))
    assert 0 < int(want[2].sum()) <= num_r


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


@pytest.mark.parametrize("case", ["random", "one destination",
                                  "signed zeros"])
@pytest.mark.parametrize("t", [0, 1, 3, 6])
@pytest.mark.parametrize("c,b", [(1, 200), (17, 200), (2048, 200),
                                 (4096, 200), (4097, 200), (17, 2600),
                                 (2048, 2600), (4096, 2600), (4097, 2600),
                                 (10_400, 2600)])
def test_rank_accept_commit_matches_plain(c, b, t, case):
    """K8 with the pass commit (one launch up to C = 4096; above, the
    multi-launch path and its follow-on commit) against
    rank_accept_commit_plain: keep, the arrival counts and the cumulants
    bit for bit, with weights whose sums change with the order of the
    adds."""
    _check_rank_accept_commit(c, b, t, case)


@pytest.mark.parametrize("c,b", [(4096, 200), (10_400, 2600)])
def test_rank_accept_commit_above_eight_terms(c, b):
    """K8 with the commit at T = 9: the multi-launch path's commit walks
    the candidates once for each eight terms."""
    _check_rank_accept_commit(c, b, 9, "random")


def _check_rank_accept_commit(c, b, t, case):
    _card()
    rng = np.random.default_rng(c + b + 10 * t + len(case))
    dest = rng.integers(0, min(b, c // 8 + 1), c).astype(np.int32)
    gain = (np.round(rng.random(c) * 8.0) / 4.0).astype(np.float32)
    has = rng.random(c) < 0.85
    taken = np.where(rng.random(b) < 0.7, 0,
                     rng.integers(1, 4, b)).astype(np.int32)
    cap = rng.integers(24, 65, b).astype(np.int32)
    scale = rng.choice(np.array([1.0, 0.1, 3.0, 1.5e7], np.float32), (t, c))
    d_w = (scale * (np.round(rng.random((t, c)) * 3.0) + 1.0) / 3.0).astype(
        np.float32)
    cum = (np.round(rng.random((t, b)) * 16.0) * 250.0).astype(np.float32)
    hr = np.full((t, b), 3e9, np.float32)
    if case == "one destination":
        dest[:] = b // 2
        cap[:] = 1 << 20
    elif case == "signed zeros":
        gain = np.where(rng.random(c) < 0.5, np.float32(0.0),
                        np.float32(-0.0)).astype(np.float32)
    cu = [torch.from_numpy(x).cuda() for x in (dest, gain, has, cap, d_w, hr)]
    taken_k, cum_k = (torch.from_numpy(taken).cuda(),
                      torch.from_numpy(cum).cuda())
    taken_p, cum_p = taken_k.clone(), cum_k.clone()
    got = K.rank_accept_commit(cu[0], cu[1], cu[2], b, taken_k, cu[3], cum_k,
                               cu[4], cu[5])
    want = K.rank_accept_commit_plain(cu[0], cu[1], cu[2], b, taken_p, cu[3],
                                      cum_p, cu[4], cu[5])
    torch.cuda.synchronize()
    assert _same(got, want)
    assert _same(taken_k, taken_p)
    assert torch.equal(cum_k.view(torch.int32), cum_p.view(torch.int32))
    # headrooms and caps leave room: a candidate with a destination lands
    assert bool(got.any()) == bool(has.any())


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


def _argmax_case(n, s, seed):
    """K9's inputs: quantized scores with -0.0, NEG and -inf, ids with
    out-of-range values, an all-invalid segment (1)."""
    rng = np.random.default_rng(seed)
    score = (np.round(rng.random(n) * 6.0) / 2.0 - 1.0).astype(np.float32)
    score[rng.random(n) < 0.1] = -0.0
    score[rng.random(n) < 0.05] = K.NEG
    score[:3] = [-np.inf, K.NEG / 2, K.NEG / 4]
    seg = rng.integers(-2, s // 2 + 2, n).astype(np.int32)
    valid = (rng.random(n) < 0.8) & (seg != 1)
    return [torch.from_numpy(x).cuda() for x in (score, seg, valid)]


def _scratch_is_zero(ck):
    torch.cuda.synchronize()
    buf = ck.argmax_scratch(torch.cuda.current_device(),
                            torch.cuda.current_stream().cuda_stream)
    return not bool(torch.count_nonzero(buf))


@pytest.mark.parametrize("ids", ["int32", "int64"])
@pytest.mark.parametrize("n,s", [(2048, 200), (4096, 4096), (60_000, 800),
                                 (600_000, 10_400), (2048, 20_000)])
def test_segment_argmax_matches_plain(n, s, ids):
    """K9's dense entry with ties, -0.0 against +0.0, empty and
    all-invalid segments, scores at or below NEG/2 and out-of-range ids:
    one block and the grid path (n > 4096 or S > 1024, the wrapper's
    fold); the key scratch is zero after the call."""
    ck = _card()
    score, seg, valid = _argmax_case(n, s, n + s)
    seg = seg.to(getattr(torch, ids))
    got = ck.segment_argmax(score, seg, valid, s)
    want = K.per_segment_argmax_plain(score, seg, s, valid)
    torch.cuda.synchronize()
    assert _same(got[0], want[0]) and _same(got[2], want[2])
    assert bool(torch.equal(got[1], want[1]))    # == : -0.0 equals +0.0
    assert bool(got[2].any()) and not bool(got[2].all())
    assert _scratch_is_zero(ck)


@pytest.mark.parametrize("n,s", [(2048, 200), (2048, 20_000),
                                 (2048, 200_000), (128, 200),
                                 (41_600, 2600), (600_000, 2600)])
def test_segment_keep_matches_plain(n, s):
    """K9's keep entry (resolve_dest_conflicts on the card) against
    resolve_dest_conflicts_plain: one block with shared and with global
    keys (20,000 and 200,000 segments), and the grid path; the key
    scratch is zero after each call, and two calls in a row agree."""
    ck = _card()
    score, seg, valid = _argmax_case(n, s, n * 7 + s)
    dest = torch.clamp(seg, 0, s - 1).long()
    want = K.resolve_dest_conflicts_plain(dest, score, valid, s)
    for _ in range(2):
        got = ck.segment_keep(score, dest, valid, s)
        torch.cuda.synchronize()
        assert _same(got, want)
        assert _scratch_is_zero(ck)
    assert bool(got.any()) and not bool(got.all())
    assert _same(K.resolve_dest_conflicts(dest, score, valid, s), want)


@pytest.mark.parametrize("fold", [0, 0.25, 1, 4])
@pytest.mark.parametrize("entry,n,s", [("dense", 60_000, 800),
                                       ("dense", 600_000, 10_400),
                                       ("keep", 41_600, 2600)])
def test_segment_argmax_grid_folds_match_plain(entry, n, s, fold,
                                               monkeypatch):
    """K9's cooperative grid path under each fold: straight into the
    global scratch (0) and into shared keys at shares of S/4, S and 4 S
    elements a block (opt-in shared memory: 10,400 keys are 83 KB); the
    key scratch is zero after each call."""
    ck = _card()
    monkeypatch.setattr(ck, "ARGMAX_SHARE_PER_KEY", fold)
    monkeypatch.setattr(ck, "ARGMAX_SHARED_MIN_AVG", 0)
    assert (ck.argmax_share(n, s) > 0) == (fold > 0)
    score, seg, valid = _argmax_case(n, s, n + s + int(4 * fold))
    if entry == "dense":
        got = ck.segment_argmax(score, seg, valid, s)
        want = K.per_segment_argmax_plain(score, seg, s, valid)
        torch.cuda.synchronize()
        assert _same(got[0], want[0]) and _same(got[2], want[2])
        assert bool(torch.equal(got[1], want[1]))
    else:
        dest = torch.clamp(seg, 0, s - 1).long()
        got = ck.segment_keep(score, dest, valid, s)
        want = K.resolve_dest_conflicts_plain(dest, score, valid, s)
        torch.cuda.synchronize()
        assert _same(got, want)
    assert _scratch_is_zero(ck)


def test_segment_argmax_scratch_not_grown_in_capture():
    """A CUDA graph capture that would need a larger key scratch raises
    (the graph would keep a freed address); after one call of that width
    on the stream, the capture records and its replays stay exact."""
    ck = _card()
    score, seg, valid = _argmax_case(60_000, 50_000, 5)
    want = K.per_segment_argmax_plain(score, seg, 50_000, valid)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="before the capture"):
            with torch.cuda.graph(graph, stream=side):
                ck.segment_argmax(score, seg, valid, 50_000)
        ck.segment_argmax(score, seg, valid, 50_000)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            got = ck.segment_argmax(score, seg, valid, 50_000)
        for _ in range(2):
            graph.replay()
        torch.cuda.synchronize()
        assert _same(got[0], want[0]) and _same(got[2], want[2])
        assert _scratch_is_zero(ck)
    torch.cuda.current_stream().wait_stream(side)


def test_segment_argmax_scratch_per_stream():
    """Two streams each get their own key scratch, zero after their
    calls."""
    ck = _card()
    score, seg, valid = _argmax_case(60_000, 20_000, 3)
    want = K.per_segment_argmax_plain(score, seg, 20_000, valid)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = ck.segment_argmax(score, seg, valid, 20_000)
        assert _scratch_is_zero(ck)
    torch.cuda.current_stream().wait_stream(side)
    main = ck.segment_argmax(score, seg, valid, 20_000)
    torch.cuda.synchronize()
    for a in (got, main):
        assert _same(a[0], want[0]) and _same(a[2], want[2])
    assert _scratch_is_zero(ck)


@functools.lru_cache(maxsize=None)
def _swap_cluster(spec: str):
    """The card cluster and its sibling index of a SWAP_SPECS entry."""
    state, _ = random_cluster(RandomClusterSpec(**SWAP_SPECS[spec]),
                              device="cuda")
    return state, torch.from_numpy(C.partition_replica_index(state)).cuda()


def _swap_inputs(rng, spec, case, from_util):
    """K10's inputs: picks on every broker (some missing; in-picks pairwise
    replicas of one partition and out-picks of their partitions for
    partition conflicts), quantized weights and deviations (tied
    improvements, cold-broker conflicts) with signed zeros, the
    deviations given or as util - target."""
    state, pr = _swap_cluster(spec)
    nb, num_r = state.num_brokers, state.num_replicas
    out_r = rng.integers(0, num_r, nb).astype(np.int32)
    in_r = rng.integers(0, num_r, nb).astype(np.int32)
    prn = pr.cpu().numpy()
    sib = prn[rng.integers(0, prn.shape[0], nb // 8 + 1)]
    for j in range(nb // 8):
        in_r[8 * j], in_r[8 * j + 4] = sib[j, 0], sib[j, 1]
        out_r[8 * j + 2] = sib[j, 2]
    out_r[rng.random(nb) < 0.05] = -1
    in_r[rng.random(nb) < 0.05] = -1
    dev = (np.round(rng.random(nb) * 16.0) - 8.0).astype(np.float32)
    zero = dev == 0
    dev[zero & (rng.random(nb) < 0.5)] = -0.0
    util = (rng.random(nb) * 50.0).astype(np.float32)
    target = None
    if from_util:
        util = np.where(zero, dev, util).astype(np.float32)
        target = np.where(zero, 0.0, util - dev).astype(np.float32)

    def t(x):
        return None if x is None else torch.from_numpy(x).cuda()
    w = torch.from_numpy(np.round(rng.random(num_r) * 8.0).astype(
        np.float32)).cuda()
    hot, cold = (torch.from_numpy(rng.random(nb) < 0.6).cuda()
                 for _ in range(2))
    util_t = t(util)
    lower = util_t - 20.0 if case in ("band", "lower band") else None
    upper = util_t + 20.0 if case in ("band", "upper band") else None
    picks = (t(out_r), t(in_r), t(out_r) >= 0, t(in_r) >= 0)
    return state, pr, w, hot, cold, picks, (None if from_util else t(dev)), \
        util_t, t(target), lower, upper


SWAP_SPECS = {"B=200": SLICE,
              "B=2600": dict(SLICE, num_brokers=2600, num_partitions=20_000,
                             num_racks=26),
              "B=100": dict(SLICE, num_brokers=100, num_partitions=10_000)}


@pytest.mark.parametrize("from_util", [False, True])
@pytest.mark.parametrize("case", ["no band", "band", "lower band",
                                  "upper band", "refuse all"])
@pytest.mark.parametrize("spec", list(SWAP_SPECS))
def test_swap_pair_matches_plain(spec, case, from_util):
    """K10's shortlist entry against swap_shortlist_plain (signed-zero
    ranks, the deviations given and as util - target) and its pair entry
    against swap_pair_plain (tied improvements, conflicts on a cold broker
    and on a partition, with no band, each band and an all-False
    acceptance plane), exactly; with fewer brokers than the shortlist
    too."""
    ck = _card()
    rng = np.random.default_rng(len(case) + 10 * from_util)
    (state, pr, w, hot, cold, (out_r, in_r, out_has, in_has), dev_u, util,
     target, lower, upper) = _swap_inputs(rng, spec, case, from_util)
    h = min(K.SWAP_SHORTLIST, state.num_brokers)
    sargs = (hot, cold, out_r, in_r, out_has, in_has, dev_u, util, target, h)
    got = ck.swap_shortlist(*sargs)
    want = K.swap_shortlist_plain(*sargs)
    torch.cuda.synchronize()
    assert all(a.dtype == b.dtype and _same(a, b) for a, b in zip(got, want))
    accept = torch.from_numpy(rng.random((h, h)) < (
        0.0 if case == "refuse all" else 0.8)).cuda()
    pargs = (want[0], want[1], out_r, in_r, out_has, in_has, hot, cold, w,
             want[4], util, lower, upper, accept, state.replica_partition,
             pr, state.replica_broker)
    got2 = ck.swap_pair(*pargs)
    want2 = K.swap_pair_plain(*pargs)
    torch.cuda.synchronize()
    assert all(a.dtype == b.dtype and _same(a, b)
               for a, b in zip(got2, want2))
    n_valid = int(want2[1].sum())
    assert n_valid == 0 if case == "refuse all" else n_valid > 0


def _plane_inputs(k, c=2048, spec=SLICE):
    rng = np.random.default_rng(k)
    state, _ = random_cluster(RandomClusterSpec(**spec), device="cuda")
    pr = torch.from_numpy(C.partition_replica_index(state)).cuda()
    pr[::3, -1] = -1
    nb = state.num_brokers
    cand = torch.from_numpy(rng.choice(state.num_replicas, c,
                                       replace=False)).cuda()
    dest_ok = torch.from_numpy(rng.random(nb) < 0.8).cuda()
    dest_ids = torch.from_numpy(rng.choice(nb, min(k, nb),
                                           replace=False)).cuda()
    return rng, state, pr, cand, dest_ok, dest_ids


@pytest.mark.parametrize("ids", ["int32", "int64"])
@pytest.mark.parametrize("siblings", [True, False])
@pytest.mark.parametrize("accept", ["[C, K]", "[C, 1]", "[1, K]", "0-d",
                                    "none"])
@pytest.mark.parametrize("k", [256, 200, 199])
def test_dest_pref_matches_plain(k, accept, siblings, ids):
    """K11's preference entry against dest_pref_plain on a shortlist, on
    every broker and on an odd width (no vector path), candidate and
    destination ids int32 and int64, with and without the sibling test,
    with the fit test and the candidates' flags and without, on broadcast
    acceptance planes (read through their strides) and strided float
    vectors."""
    ck = _card()
    rng, state, pr, cand, dest_ok, dest_ids = _plane_inputs(k)
    c, nb = cand.shape[0], state.num_brokers
    pr = pr if siblings else None
    cand, dest_ids = (x.to(getattr(torch, ids)) for x in (cand, dest_ids))
    full = torch.from_numpy(rng.random((c, dest_ids.shape[0])) < 0.9).cuda()
    acc = {"[C, K]": full, "[C, 1]": full[:, :1], "[1, K]": full[:1],
           "0-d": torch.ones((), dtype=torch.bool, device="cuda"),
           "none": None}[accept]
    two = torch.from_numpy(np.round(rng.random((nb, 2)) * 16.0 - 8.0)
                           .astype(np.float32)).cuda()
    pref_b, room = two[:, 0], two[:, 1] * 40.0
    w = state.replica_base_load[:, 3]
    ch = torch.from_numpy(rng.random(c) < 0.9).cuda()
    for kw in (dict(cand_has=ch, w_c=w[cand.long()], dest_headroom=room),
               {}):
        got = ck.dest_pref(cand, dest_ids, dest_ok, state.replica_broker,
                           state.replica_partition, pr, kw.get("cand_has"),
                           kw.get("w_c"), kw.get("dest_headroom"), acc,
                           pref_b)
        want = K.dest_pref_plain(state, cand, dest_ids, dest_ok, pref_b,
                                 True if acc is None else acc, pr, **kw)
        torch.cuda.synchronize()
        assert _same(got, want)
        assert bool((got > K.NEG / 2).any())


@pytest.mark.parametrize("spec", ["slice", "2600"])
def test_dest_has_matches_plain(spec):
    """K11's guard entry, which selects its top brokers itself, against
    dest_has_plain (top_headroom in lax.top_k's order): tied headrooms,
    -0.0, headrooms of +0.0 and -0.0 at the top brokers' cut, +inf (the
    forced rounds' room), ineligible brokers, no eligible broker at all,
    candidates as int32 and int64 and every replica."""
    ck = _card()
    sp = SLICE if spec == "slice" else dict(
        SLICE, num_brokers=2600, num_partitions=20_000, num_racks=26)
    rng, state, pr, cand, dest_ok, _ = _plane_inputs(7, spec=sp)
    nb = state.num_brokers
    w = state.replica_base_load[:, 3].contiguous()
    rooms = {"ties": torch.from_numpy(np.round(rng.random(nb) * 6.0).astype(
                 np.float32)).cuda() * float(torch.median(w)) / 3.0,
             "inf": torch.full((nb,), float("inf"), device="cuda")}
    rooms["ties"][:4] = -0.0
    zeros = torch.zeros(nb, device="cuda")
    zeros[: nb // 2] = -0.0
    zeros[nb - 2:] = 1.0
    rooms["signed zeros"] = zeros
    for label, room in rooms.items():
        for ok in (torch.zeros_like(dest_ok), dest_ok):
            for c in (cand, cand.to(torch.int32), None):
                w_c = w if c is None else w[c.long()].contiguous()
                args = (c, w_c, ok, room, state.replica_broker,
                        state.replica_partition, pr)
                got = ck.dest_has(*args)
                want = K.dest_has_plain(*args)
                torch.cuda.synchronize()
                assert _same(got, want), (label, c is None)
        # the last case: every replica against the eligible brokers (the
        # signed zeros' room may fit none of them)
        assert label == "signed zeros" or bool(got.any())


@pytest.mark.parametrize("mode", ["demote", "kafka assigner", "intra broker"])
def test_mode_solve_on_the_card_equals_the_cpu_path(mode):
    """The three request modes on a 48-broker cluster: the card's
    proposals (with logdirs) and final leader flags equal the port's CPU
    path's."""
    _card()
    from cruise_control_tpu_torch.analyzer.goals import registry as R
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.model import state as S
    spec = dict(num_brokers=48, num_partitions=1500, replication_factor=3,
                num_racks=8, num_topics=8, seed=4, skew_fraction=0.2)
    if mode == "intra broker":
        spec.update(skew_fraction=0.0, jbod_disks=4)
    out = {}
    for dev in ("cuda", "cpu"):
        st, topo = random_cluster(RandomClusterSpec(**spec), device=dev)
        if mode == "demote":
            st = S.set_broker_state(st, 0, demoted=True)
            goals = [R.make_goal("PreferredLeaderElectionGoal")]
        elif mode == "kafka assigner":
            goals = R.default_goals(names=R.KAFKA_ASSIGNER_GOAL_ORDER)
        else:
            goals = R.default_goals(names=R.INTRA_BROKER_GOALS)
        out[dev] = GoalOptimizer(goals).optimizations(st, topo, device=dev)

    def props(res):
        return {(p.partition,
                 tuple((r.broker_id, r.logdir) for r in p.old_replicas),
                 tuple((r.broker_id, r.logdir) for r in p.new_replicas),
                 p.new_leader) for p in res.proposals}
    assert props(out["cuda"]) == props(out["cpu"])
    assert out["cuda"].proposals
    assert torch.equal(out["cuda"].final_state.replica_is_leader.cpu(),
                       out["cpu"].final_state.replica_is_leader)
    assert out["cuda"].rounds_by_goal == out["cpu"].rounds_by_goal


def _bits(a, b):
    """Bit for bit: floats through their int32 views (-0.0 is not +0.0)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and bool(torch.equal(a.view(torch.int32), b.view(torch.int32))))


def _signed(rng, shape):
    """Lognormal magnitudes of both signs with +0.0 and -0.0 in them."""
    x = rng.lognormal(0, 3, size=shape).astype(np.float32)
    x *= np.where(rng.random(shape) < 0.3, -1, 1).astype(np.float32)
    x[rng.random(shape) < 0.05] = -0.0
    x[rng.random(shape) < 0.02] = 0.0
    return x


#: segment lengths in turn around K12's walk stage (128 rows of 4 floats,
#: 512 of one): one below, at, one above, and several stages
STAGE_LENGTHS = (127, 128, 129, 511, 512, 513, 1029)


def _segment_ids(rng, case, num, n):
    ids = rng.integers(0, n - n // 10, num).astype(np.int32)
    if case == "dropped ids":
        pick = rng.random(num) < 0.05
        ids[pick] = rng.choice(np.array([-1, -9, n, n + 5], dtype=np.int32),
                               int(pick.sum()))
    elif case == "all dropped":
        ids = rng.choice(np.array([-1, -9, n, n + 5, 2 ** 30],
                                  dtype=np.int32), num)
    elif case == "one segment":
        ids[:] = n // 2
    elif case == "stage lengths":
        # runs of STAGE_LENGTHS in turn, cut at num entries; entries past
        # the last segment are dropped
        runs = np.concatenate([np.full(STAGE_LENGTHS[s % 7], s, np.int32)
                               for s in range(n)])[:num]
        ids = np.concatenate([runs, np.full(num - runs.size, n, np.int32)])
        ids = ids[rng.permutation(num)]
    return ids


@pytest.mark.parametrize("case", ["random", "dropped ids", "signed zeros",
                                  "one segment", "stage lengths",
                                  "all dropped"])
@pytest.mark.parametrize("num,width,n", [(60_000, 4, 200),
                                         (60_000, None, 800),
                                         (800, None, 200),
                                         (60_000, 4, 57_344),
                                         (0, 4, 200),
                                         (6_000, 40, 200)],
                         ids=["broker_load", "disk_load", "logdirs",
                              "n = SEGMENT_MAX", "N = 0", "wide rows"])
def test_segment_sum_matches_plain(num, width, n, case):
    """K12 against segment_sum_plain bit for bit (and through the
    dispatch with int64 ids), and with `init` (int32 and int64 ids)
    against scatter_add_seq_plain."""
    from cruise_control_tpu_torch import ops
    ck = _card()
    rng = np.random.default_rng(num + n + len(case))
    x = _signed(rng, (num,) if width is None else (num, width))
    ids = _segment_ids(rng, case, num, n)
    if case == "signed zeros":
        x[rng.random(x.shape) < 0.5] = -0.0
    xt, it = torch.from_numpy(x).cuda(), torch.from_numpy(ids).cuda()
    want = ops.segment_sum_plain(xt, it, n)
    assert _bits(ck.segment_sum(xt, it, n), want)
    assert _bits(ops.segment_sum(xt, it.long(), n), want)
    init = torch.from_numpy(_signed(rng, tuple(want.shape))).cuda()
    spill = torch.where(it < 0, torch.full_like(it, n), it)
    want_i = ops.scatter_add_seq_plain(init, spill, xt)
    assert _bits(ck.segment_sum(xt, spill, n, init=init), want_i)
    assert _bits(ck.segment_sum(xt, spill.long(), n, init=init), want_i)
    assert _bits(ops.scatter_add_seq(init, spill, xt), want_i)


#: K12's two walks, forced by the wrapper's threshold (average entries a
#: segment): a thread per (segment, column) or a warp per segment
SEGMENT_WALKS = {"lane": 2 ** 31, "warp": 0}


@pytest.mark.parametrize("walk", list(SEGMENT_WALKS))
@pytest.mark.parametrize("num,width,n", [(800, None, 200), (60_000, 4, 5000),
                                         (60_000, None, 2600),
                                         (60_000, 4, 800)])
def test_segment_sum_walks_match_plain(num, width, n, walk, monkeypatch):
    """Both of K12's walks, whichever the wrapper would pick, at 4 to 75
    entries a segment, against segment_sum_plain bit for bit (with `init`
    too)."""
    from cruise_control_tpu_torch import ops
    ck = _card()
    monkeypatch.setattr(ck, "SEGMENT_WARP_WALK_AVG", SEGMENT_WALKS[walk])
    rng = np.random.default_rng(num + n)
    x = _signed(rng, (num,) if width is None else (num, width))
    xt = torch.from_numpy(x).cuda()
    it = torch.from_numpy(_segment_ids(rng, "dropped ids", num, n)).cuda()
    assert _bits(ck.segment_sum(xt, it, n), ops.segment_sum_plain(xt, it, n))
    init = torch.from_numpy(_signed(rng, (n,) + x.shape[1:])).cuda()
    spill = torch.where(it < 0, torch.full_like(it, n), it)
    assert _bits(ck.segment_sum(xt, spill, n, init=init),
                 ops.scatter_add_seq_plain(init, spill, xt))


def _ordered_input(rng, n, m):
    """Signed values with a -0.0 in the first row and at the start of a
    first- and a second-level window."""
    x = _signed(rng, (n, m))
    x[0] = -0.0
    if n > 32:
        w0 = -(-n // 32)
        lo0 = (w0 * 32 - n) // 2
        x[32 - lo0] = -0.0
        if w0 > 32:
            w1 = -(-w0 // 32)
            x[(32 - (w1 * 32 - w0) // 2) * 32 - lo0] = -0.0
    return x


@pytest.mark.parametrize("n,m", [(200, 4), (200, 17), (2600, 4),
                                 (2600, 100), (60_000, 4), (1, 4), (33, 3),
                                 (1_025, 4), (32_769, 4), (600_000, 1)])
def test_ordered_sum_matches_plain(n, m):
    """K13 against sum_f32_plain bit for bit, with a -0.0 in the first
    row and at window starts (a single -0.0 is copied)."""
    from cruise_control_tpu_torch import ops
    ck = _card()
    rng = np.random.default_rng(n * 7 + m)
    xt = torch.from_numpy(_ordered_input(rng, n, m)).cuda()
    want = ops.sum_f32_plain(xt)
    assert _bits(ck.ordered_sum(xt), want)
    assert _bits(ops.sum_f32(xt), want)
    assert _bits(ops.sum_f32(xt[:, 0].contiguous()), want[0])


#: K13's two paths, forced by the wrapper's spread threshold (rows)
ORDERED_PATHS = {"column": 2 ** 31, "spread": 1024}


@pytest.mark.parametrize("path", list(ORDERED_PATHS))
@pytest.mark.parametrize("n,m", [(1_025, 4), (2600, 4), (2600, 100),
                                 (32_770, 4), (60_000, 9)])
def test_ordered_sum_paths_match_plain(n, m, path, monkeypatch):
    """Both of K13's paths, whichever the wrapper would pick for the
    shape, against sum_f32_plain bit for bit (the spread path runs two
    column tiles at m = 9)."""
    from cruise_control_tpu_torch import ops
    ck = _card()
    rows = ORDERED_PATHS[path]
    monkeypatch.setattr(ck, "ORDERED_SPREAD_ROWS", rows)
    assert ck._ordered_plan(n, m, rows)[0] == (path == "spread")
    rng = np.random.default_rng(n + m)
    xt = torch.from_numpy(_ordered_input(rng, n, m)).cuda()
    assert _bits(ck.ordered_sum(xt), ops.sum_f32_plain(xt))


def test_ordered_sum_spread_on_two_streams():
    """K13's spread path on two streams at once, 20 launches each without a
    synchronize between them: each stream keeps its own last-block
    counters, so every sum equals sum_f32_plain bit for bit."""
    from cruise_control_tpu_torch import ops
    ck = _card()
    rng = np.random.default_rng(8)
    planes = [torch.from_numpy(_ordered_input(rng, n, m)).cuda()
              for n, m in ((600_000, 4), (60_000, 9))]
    assert all(ck._ordered_plan(*x.shape, ck.ORDERED_SPREAD_ROWS)[0]
               for x in planes)
    wants = [ops.sum_f32_plain(x) for x in planes]
    streams = [torch.cuda.Stream() for _ in planes]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for k, (x, st) in enumerate(zip(planes, streams)):
            with torch.cuda.stream(st):
                outs[k].append(ck.ordered_sum(x))
    torch.cuda.synchronize()
    slots = {ck._ordered_slot(0, st.cuda_stream) for st in streams}
    assert len(slots) == 2
    for k, want in enumerate(wants):
        assert all(_bits(got, want) for got in outs[k])


def _gate_inputs(rng, num_b, k, n_terms):
    """A [B, k] candidate table on quarter steps (sums exact, bounds hit),
    its excess and `n_terms` terms: columns of a [R, 4] plane, the count
    term (weights 1.0) and a plain [R] vector, against columns of a [B, 4]
    plane and a [B] vector."""
    num_r = 60_000
    n = num_b * k
    q = lambda hi, shape: (rng.integers(0, hi, shape) * 0.25).astype(
        np.float32)
    has = rng.random(n) < 0.85
    w = q(9, n)
    w[::k] = -0.0
    cand = rng.integers(0, num_r, n).astype(np.int32)
    cand[rng.random(n) < 0.1] = -1
    excess = q(4 * k + 2, num_b)
    loads, room = q(9, (num_r, 4)), q(3 * k + 2, (num_b, 4))
    vec, hr = q(5, num_r), q(3 * k + 2, num_b)
    excess[0] = np.sum(w[:k - 1])      # before == excess on row 0
    t = [torch.from_numpy(x).cuda() for x in (loads, room, vec, hr)]
    terms = [(t[0][:, 1], t[1][:, 2]), (None, t[3]), (t[2], t[1][:, 0]),
             (t[0][:, 3], t[1][:, 1]), (t[0][:, 0], t[1][:, 3])]
    return ([torch.from_numpy(x).cuda() for x in (has, w, excess, cand)],
            terms[:n_terms])


@pytest.mark.parametrize("n_terms", [0, 1, 3, 5])
@pytest.mark.parametrize("k", [1, 4, 8, 16])
@pytest.mark.parametrize("num_b", [200, 2600])
def test_prefix_gate_matches_plain(num_b, k, n_terms):
    """K14 against prefix_gate_plain on the card, exactly."""
    ck = _card()
    rng = np.random.default_rng(num_b + 17 * k + n_terms)
    args, terms = _gate_inputs(rng, num_b, k, n_terms)
    got = ck.prefix_gate(*args, terms, k)
    want = K.prefix_gate_plain(*args, terms, k)
    assert _same(got, want)
    assert _same(K.prefix_gate(*args, terms, k), want)


def test_stats_on_the_card_equal_the_cpu_path():
    """compute_stats of the slice cluster on the card (K12, K13) against
    the CPU path, every field bit for bit."""
    import dataclasses
    from cruise_control_tpu_torch.model import stats as ST
    ck = _card()
    out = {}
    for dev in ("cuda", "cpu"):
        state, _ = random_cluster(RandomClusterSpec(**SLICE), device=dev)
        ck.reset_launches()
        out[dev] = ST.compute_stats(state).cpu()
        if dev == "cuda":
            assert ck.LAUNCHES["segment_sum"] > 0
            assert ck.LAUNCHES["ordered_sum"] > 0
    for f in dataclasses.fields(out["cpu"]):
        a, b = getattr(out["cuda"], f.name), getattr(out["cpu"], f.name)
        assert bool(torch.equal(a.view(torch.int32), b.view(torch.int32))), f


#: 16 brokers with one dead (offline replicas already), as
#: tests/test_torch_store.py
STORE_SPEC = dict(num_brokers=16, num_partitions=400, replication_factor=3,
                  num_racks=4, num_topics=8, seed=3, skew_fraction=0.3,
                  dead_brokers=1)
STORE_DELTAS = {
    "capacity": dict(capacities={2: {3: 5e5, 0: 80.0}}),
    "load": dict(loads={5: ([4.0, 90.0, 120.0, 3e4], [1.0, 90.0, 0.0, 3e4],
                            [3.0, 0.0, 120.0, 0.0])}),
    "demote, new and removed": dict(demoted=(1, 9), new=(3,),
                                    removed=(12, 13, 14, 15, 0)),
}


@pytest.mark.parametrize("delta", list(STORE_DELTAS))
def test_apply_delta_on_the_card_equals_the_cpu_path(delta):
    """`apply_delta` (with padded id arrays) and `set_broker_capacities`
    on the card give the CPU path's state and dirty mask, byte for
    byte."""
    _card()
    from cruise_control_tpu_torch.model import state as S
    from cruise_control_tpu_torch.model import store as ST
    out = {}
    for dev in ("cuda", "cpu"):
        st, _ = random_cluster(RandomClusterSpec(**STORE_SPEC), device=dev)
        arrays = ST.plan_arrays(st.num_brokers, st.num_partitions,
                                **STORE_DELTAS[delta])
        new, dirty = ST.apply_delta(st, ST.plan_from_numpy(arrays, dev))
        new = S.set_broker_capacities(
            new, np.asarray([15, 16, 7], np.int32),
            np.asarray([[1, 0, 1, 0], [1, 1, 1, 1], [0, 0, 0, 1]], bool),
            np.full((3, 4), 7.5, np.float32))
        out[dev] = (new, dirty)
    for f in S.STATE_FIELDS:
        assert _same(getattr(out["cuda"][0], f).cpu(),
                     getattr(out["cpu"][0], f)), f
    assert _same(out["cuda"][1].cpu(), out["cpu"][1])
    assert out["cpu"][1].any()


@pytest.mark.parametrize("dirty", ["all", "one", "random"])
def test_restrict_context_on_the_card_equals_the_cpu_path(dirty):
    _card()
    out = {}
    mask = {"all": np.ones(16, bool), "one": np.arange(16) == 2,
            "random": np.random.default_rng(9).random(16) < 0.3}[dirty]
    for dev in ("cuda", "cpu"):
        st, topo = random_cluster(RandomClusterSpec(**STORE_SPEC),
                                  device=dev)
        ctx = C.make_context(st, C.BalancingConstraint(),
                             C.OptimizationOptions(), topo)
        out[dev] = C.restrict_context_to_dirty(st, ctx,
                                               torch.from_numpy(mask))
    for f in ("replica_movable", "broker_dest_ok"):
        assert _same(getattr(out["cuda"], f).cpu(), getattr(out["cpu"], f))


def test_add_broker_request_on_the_card_equals_the_cpu_path():
    """The add-broker request at 16 brokers (14 and 2 new): RackAwareGoal
    alone with the new brokers excluded from its moves, then the default
    stack with the new brokers as the only requested destinations; the
    card's proposals, leader flags, rounds and counts equal the CPU
    path's."""
    _card()
    from cruise_control_tpu_torch.analyzer.goals.registry import \
        default_goals
    from cruise_control_tpu_torch.analyzer.optimizer import (GoalOptimizer,
                                                             proposal_set)
    spec = dict(num_brokers=14, num_partitions=400, replication_factor=3,
                num_racks=4, num_topics=8, seed=0, skew_fraction=0.3,
                new_brokers=2)
    new = frozenset({14, 15})
    out = {}
    for dev in ("cuda", "cpu"):
        st, topo = random_cluster(RandomClusterSpec(**spec), device=dev)
        st = GoalOptimizer(default_goals(32, ["RackAwareGoal"])
                           ).optimizations(
            st, topo, C.OptimizationOptions(
                excluded_brokers_for_replica_move=new),
            device=dev).final_state
        out[dev] = GoalOptimizer(default_goals(32)).optimizations(
            st, topo, C.OptimizationOptions(
                requested_destination_broker_ids=new), device=dev)
    assert proposal_set(out["cuda"]) == proposal_set(out["cpu"])
    assert torch.equal(out["cuda"].final_state.replica_is_leader.cpu(),
                       out["cpu"].final_state.replica_is_leader)
    assert out["cuda"].rounds_by_goal == out["cpu"].rounds_by_goal
    assert (out["cuda"].violated_broker_counts
            == out["cpu"].violated_broker_counts)
    held = torch.bincount(out["cpu"].final_state.replica_broker.long(),
                          minlength=16)
    assert (held[[14, 15]] > 0).all()


def test_builder_places_the_state_on_the_card():
    """The builder's state on the card holds the CPU build's values, and
    every field lives on the card."""
    _card()
    from cruise_control_tpu_torch.model.builder import ClusterModelBuilder
    from cruise_control_tpu_torch.model.state import STATE_FIELDS
    built = {}
    for dev in ("cuda", "cpu"):
        b = ClusterModelBuilder()
        for i in range(8):
            b.add_broker(i, f"r{i % 3}", [100.0, 1e4, 1e4, 1e6],
                         disks={"/d0": 5e5, "/d1": 0.0 if i == 2 else 5e5})
        for p in range(40):
            b.add_partition(f"t{p % 3}", p, p % 8, [(p + 1) % 8, (p + 3) % 8],
                            [1.0 + p, 10.0 * p, 20.0, 300.0])
        built[dev] = b.build(pad_replicas_to=128, device=dev)
    for f in STATE_FIELDS:
        got = getattr(built["cuda"][0], f)
        assert got.is_cuda, f
        assert _same(got.cpu(), getattr(built["cpu"][0], f)), f


def test_served_requests_on_the_card_equal_the_cpu_path():
    """A cold default-stack request, a delta the store fast-forwards on
    the card (equal to a rebuild there), the restricted warm request and
    a broker removal, served through the facade over the monitor: the
    card's proposals, placements and store counters equal the CPU
    path's."""
    _card()
    from cruise_control_tpu_torch.facade import CruiseControl
    from cruise_control_tpu_torch.model.state import STATE_FIELDS
    from cruise_control_tpu_torch.monitor.deltas import (ModelDelta,
                                                         PartitionLoadUpdate)
    from cruise_control_tpu_torch.monitor.load_monitor import \
        SnapshotLoadMonitor
    from cruise_control_tpu_torch.testing.random_cluster import served_inputs
    goals = ["RackAwareGoal", "DiskCapacityGoal", "ReplicaDistributionGoal",
             "DiskUsageDistributionGoal"]
    st, topo = random_cluster(RandomClusterSpec(**dict(
        STORE_SPEC, dead_brokers=0)), device="cpu")
    snap, loads, caps = served_inputs(st, topo)
    p0 = snap.partitions[0]
    delta = ModelDelta(
        capacity_overrides={2: {"cpu": caps[2].capacity[0] * 1.5}},
        load_updates=(PartitionLoadUpdate(p0.tp.topic, p0.tp.partition, tuple(
            loads[(p0.tp.topic, p0.tp.partition)] * 1.25)),))
    out = {}
    for dev in ("cuda", "cpu"):
        mon = SnapshotLoadMonitor(snap, loads, caps, device=dev)
        cc = CruiseControl(load_monitor=mon, device=dev, goal_names=goals,
                           max_optimization_rounds=32)
        cold = cc.optimizations()
        mon.apply_model_delta(delta)
        warm = cc.optimizations()
        resident = cc.model_store._state
        rebuilt, _ = mon.cluster_model()
        for f in STATE_FIELDS:
            assert _same(getattr(resident, f), getattr(rebuilt, f)), f
        removed = cc.remove_brokers([0]).optimizer_result
        out[dev] = (cold, warm, removed, cc.model_store.to_json())
    from cruise_control_tpu_torch.analyzer.optimizer import proposal_set
    for i in range(3):
        card, cpu = out["cuda"][i], out["cpu"][i]
        assert proposal_set(card) == proposal_set(cpu)
        assert torch.equal(card.final_state.replica_is_leader.cpu(),
                           cpu.final_state.replica_is_leader)
    assert out["cuda"][3] == out["cpu"][3]
    assert out["cpu"][3]["deltaApplies"] == 1
