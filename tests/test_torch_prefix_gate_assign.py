"""The plain versions of K14 (the prefix gate) and of K2 against the JAX
package on the CPU.

`prefix_gate_plain` (analyzer/kernels.py) against the source-side prefix
gate as the reference writes it with `jnp.cumsum` (cruise_control_tpu/
analyzer/kernels.py move_round and leadership_round, analyzer/
prebalance.py's round body): k = 1, 4, 8, 16 candidates a row and 0, 1
and 3 terms, with values exactly on each bound, a leading -0.0, rows where
rank 0 alone passes and a term that closes a candidate a later term would
have kept.  `assign_pass_plain` chained through `assign_destinations`
against the reference's `assign_destinations` in both commit modes, and
the jitter amplitude `amp` of pass 0 against the reference's expression,
bit for bit, both compiled as the reference's goal programs are (XLA:CPU
contracts the amplitude and the jittered preference into FMAs; two cases
where rounding twice would pick another slot).  Integers and booleans
must match exactly.  The inputs are made with numpy from a seed.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import kernels as JK
from cruise_control_tpu_torch.analyzer import kernels as K

NUM_B = 6


@functools.partial(jax.jit, static_argnums=5)
def _jax_gate(has, w, excess, cand, terms, k):
    """The reference's gate: its move_round / prebalance lines, compiled
    as the reference's round bodies are."""
    num_b = excess.shape[0]
    w_bk = jnp.where(has, w, 0.0).reshape(num_b, k)
    cum_before = jnp.cumsum(w_bk, axis=1) - w_bk
    has = has & (cum_before < excess[:, None]).reshape(-1)
    rank = jnp.arange(k, dtype=jnp.int32)[None, :]
    safe = jnp.maximum(cand, 0)
    for t_w, t_hr in terms:
        tw = jnp.where(has, 1.0 if t_w is None else t_w[safe],
                       0.0).reshape(num_b, k)
        cum_incl = jnp.cumsum(tw, axis=1)
        has &= ((rank == 0) | (cum_incl <= t_hr[:, None])).reshape(-1)
    return has


def _gate_inputs(k, n_terms, seed):
    """Random rows (0, 1) and crafted rows (2-5) of a [6, k] table."""
    rng = np.random.default_rng(seed)
    num_r = 64
    n = NUM_B * k
    # quarter steps: every sum below is exact, so bounds can be hit
    w = (rng.integers(0, 9, n) * 0.25).astype(np.float32)
    has = rng.random(n) < 0.85
    cand = rng.integers(0, num_r, n).astype(np.int32)
    cand[rng.random(n) < 0.1] = -1
    excess = (rng.integers(1, 4 * k + 2, NUM_B) * 0.25).astype(np.float32)
    loads = (rng.integers(0, 9, (num_r, 4)) * 0.25).astype(np.float32)
    term_w = [loads[:, 1], None, (rng.integers(0, 5, num_r)
                                  * 0.5).astype(np.float32)][:n_terms]
    hrs = [(rng.integers(0, 3 * k + 2, NUM_B) * 0.25).astype(np.float32)
           for _ in range(n_terms)]

    def row(b):
        return slice(b * k, (b + 1) * k)

    # row 2: a leading -0.0 in the weights, and the row's excess exactly
    # the before-sum of its last candidate (before == excess fails)
    w[row(2)][0] = -0.0
    has[row(2)] = True
    cand[row(2)] = np.arange(k)
    excess[2] = np.float32(np.sum(w[row(2)][:-1])) if k > 1 else 0.0
    for t, t_w in enumerate(term_w):
        if t_w is not None:
            t_w[0] = -0.0
    # row 3: every headroom below the first weight: rank 0 alone passes
    has[row(3)] = True
    cand[row(3)] = np.arange(8, 8 + k)
    w[row(3)] = 1.0
    excess[3] = 100.0
    for t_w, hr in zip(term_w, hrs):
        if t_w is not None:
            t_w[8:8 + k] = 1.0
        hr[3] = 0.5
    # row 4: each headroom exactly the inclusive sum at the middle
    # candidate (incl == hr passes, the next one fails)
    has[row(4)] = True
    cand[row(4)] = np.arange(20, 20 + k)
    excess[4] = 100.0
    mid = k // 2
    for t_w, hr in zip(term_w, hrs):
        weights = (np.ones(k, np.float32) if t_w is None
                   else t_w[20:20 + k])
        hr[4] = np.float32(np.sum(weights[:mid + 1]))
    # row 5: term 0 closes candidate 1 (its -1.5 after it keeps candidate
    # 2 within term 0's headroom), which frees room that the last term
    # would otherwise have denied to candidate 2
    has[row(5)] = True
    cand[row(5)] = np.arange(40, 40 + k)
    w[row(5)] = 0.25
    excess[5] = 100.0
    if n_terms and k > 2:
        if term_w[0] is not None:
            term_w[0][40:40 + k] = [0.5, 2.0, -1.5] + [0.5] * (k - 3)
            hrs[0][5] = 1.0
        for hr in hrs[1:-1]:
            hr[5] = 100.0
        if term_w[-1] is not None:
            term_w[-1][40:40 + k] = 1.0
            hrs[-1][5] = 2.0
    terms = list(zip(term_w, hrs))
    return has, w, excess, cand, terms


@pytest.mark.parametrize("n_terms", [0, 1, 3])
@pytest.mark.parametrize("k", [1, 4, 8, 16])
def test_prefix_gate_plain_matches_the_reference(k, n_terms):
    has, w, excess, cand, terms = _gate_inputs(k, n_terms, seed=k * 10
                                               + n_terms)
    want = np.asarray(_jax_gate(
        jnp.asarray(has), jnp.asarray(w), jnp.asarray(excess),
        jnp.asarray(cand),
        [(None if t_w is None else jnp.asarray(t_w), jnp.asarray(hr))
         for t_w, hr in terms], k))
    t_terms = [(None if t_w is None else torch.from_numpy(t_w),
                torch.from_numpy(hr)) for t_w, hr in terms]
    args = (torch.from_numpy(has), torch.from_numpy(w),
            torch.from_numpy(excess), torch.from_numpy(cand))
    got = K.prefix_gate_plain(*args, t_terms, k)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(K.prefix_gate(*args, t_terms, k).numpy(),
                                  want)
    rows = want.reshape(NUM_B, k)
    if k > 1:
        # before == excess is not < excess: the last candidate of row 2
        # is gated off, the ones before it are not by the excess
        assert not rows[2, -1]
    if n_terms and any(t_w is not None for t_w, _ in terms) and k > 1:
        assert rows[3, 0] and not rows[3, 1:].any()
    if n_terms == 3 and k > 2:
        # term 0 closes candidate 1; candidate 2 then still fits the last
        # term (1.0 + 1.0 <= 2.0), which it would not have behind 1
        assert not rows[5, 1] and rows[5, 2]


def test_prefix_gate_takes_strided_terms():
    """The pre-balance's terms: columns of the [R, 4] load plane against
    columns of a [B, 4] headroom plane, then the count term (weights
    1.0)."""
    k = 8
    has, w, excess, cand, _ = _gate_inputs(k, 0, seed=5)
    rng = np.random.default_rng(6)
    loads = (rng.integers(0, 9, (64, 4)) * 0.25).astype(np.float32)
    room = (rng.integers(0, 20, (NUM_B, 4)) * 0.25).astype(np.float32)
    counts = rng.integers(0, 6, NUM_B).astype(np.float32)
    want = np.asarray(_jax_gate(
        jnp.asarray(has), jnp.asarray(w), jnp.asarray(excess),
        jnp.asarray(cand),
        [(jnp.asarray(loads)[:, r], jnp.asarray(room)[:, r])
         for r in range(4)] + [(None, jnp.asarray(counts))], k))
    lt, rt = torch.from_numpy(loads), torch.from_numpy(room)
    got = K.prefix_gate(torch.from_numpy(has), torch.from_numpy(w),
                        torch.from_numpy(excess), torch.from_numpy(cand),
                        [(lt[:, r], rt[:, r]) for r in range(4)]
                        + [(None, torch.from_numpy(counts))], k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefix_gate_refuses_wide_rows():
    has, w, excess, cand, _ = _gate_inputs(16, 0, seed=1)
    with pytest.raises(ValueError):
        K.prefix_gate(torch.from_numpy(has), torch.from_numpy(w),
                      torch.from_numpy(excess[:3]), torch.from_numpy(cand),
                      (), 32)


@jax.jit
def _jax_amp(pref):
    """The reference's amplitude lines of assign_destinations, compiled
    as its goal programs are (XLA:CPU contracts them into one FMA)."""
    finite = pref > JK.NEG / 2
    pmax = jnp.max(jnp.where(finite, pref, -jnp.inf))
    pmin = jnp.min(jnp.where(finite, pref, jnp.inf))
    spread = jnp.where(jnp.isfinite(pmax - pmin), pmax - pmin, 0.0)
    return 0.35 * spread + 1e-6


#: the reference's assign_destinations compiled as its goal programs
#: compile it: every case below shares one [16, 16] shape (and K = 1 its
#: own), so each commit mode compiles twice
_j_assign = jax.jit(JK.assign_destinations, static_argnums=(3,))

C, KK, NB = 16, 16, 20


def _assign_case(case, seed):
    """(pref f32[C, K], gain, has, dest_ids or None for the identity)."""
    rng = np.random.default_rng(seed)
    pref = -rng.random((C, KK)).astype(np.float32)
    pref[rng.random((C, KK)) < 0.3] = JK.NEG
    pref[:, 4] = pref[:, 2]
    gain = np.round(rng.random(C) * 4).astype(np.float32)
    has = rng.random(C) < 0.85
    dest_ids = rng.permutation(NB)[:KK].astype(np.int32)
    if case == "identity ids":
        return pref, gain, has, None
    if case == "no finite entry":
        pref[:] = JK.NEG
    elif case == "one slot":
        pref, dest_ids = pref[:, :1].copy(), dest_ids[:1]
    elif case == "all assigned in pass 0":
        # each candidate's own best destination, distinct: every row is
        # kept in pass 0 and the later passes see only assigned rows
        pref = -np.abs(np.arange(KK)[None, :]
                       - np.arange(C)[:, None]).astype(np.float32)
        has = np.ones(C, bool)
    return pref, gain, has, dest_ids


def _pass0_amp(pref, dest_ids, has):
    """Pass 0's amplitude from the port's plain K2."""
    c, kk = pref.shape
    amp = torch.empty(())
    ids = (torch.arange(kk, dtype=torch.int32) if dest_ids is None
           else torch.from_numpy(dest_ids))
    K.assign_pass_plain(torch.from_numpy(pref), ids,
                        torch.zeros(NB, dtype=torch.int32), None,
                        torch.from_numpy(has), 0, amp,
                        torch.zeros(c, dtype=torch.bool),
                        torch.zeros(c, dtype=torch.int32))
    return amp.numpy()


def _both(pref, gain, has, dest_ids, kw_j=None, kw_t=None):
    """(reference, port) assign_destinations on the same inputs; the
    reference gets the identity shortlist as ids when `dest_ids` is
    None, the port gets None."""
    j_ids = np.arange(pref.shape[1], dtype=np.int32) if dest_ids is None \
        else dest_ids
    jd, jv = _j_assign(jnp.asarray(pref), jnp.asarray(gain),
                       jnp.asarray(has), NB, jnp.asarray(j_ids),
                       **(kw_j or {}))
    pd, pv = K.assign_destinations(
        torch.from_numpy(pref), torch.from_numpy(gain), torch.from_numpy(has),
        NB, None if dest_ids is None else torch.from_numpy(dest_ids),
        **(kw_t or {}))
    return (np.asarray(jd), np.asarray(jv)), (pd, pv)


ASSIGN_CASES = ["permuted ids", "identity ids", "no finite entry",
                "one slot", "all assigned in pass 0"]


@pytest.mark.parametrize("case", ASSIGN_CASES)
@pytest.mark.parametrize("multi", [False, True])
def test_assign_destinations_chains_the_plain_passes(multi, case):
    pref, gain, has, dest_ids = _assign_case(case, seed=3)
    rng = np.random.default_rng(7)
    kw_j, kw_t = {}, {}
    if multi:
        terms = [(rng.random(C).astype(np.float32),
                  (rng.random(NB) * 3).astype(np.float32))
                 for _ in range(2)]
        cap = rng.integers(1, 6, size=NB).astype(np.int32)
        kw_j = dict(dest_terms=[(jnp.asarray(w), jnp.asarray(h))
                                for w, h in terms],
                    dest_cap=jnp.asarray(cap))
        kw_t = dict(dest_terms=[(torch.from_numpy(w), torch.from_numpy(h))
                                for w, h in terms],
                    dest_cap=torch.from_numpy(cap))
    (jd, jv), (pd, pv) = _both(pref, gain, has, dest_ids, kw_j, kw_t)
    assert pd.dtype == torch.int32 and pv.dtype == torch.bool
    np.testing.assert_array_equal(pv.numpy(), jv)
    np.testing.assert_array_equal(pd.numpy(), jd)
    if case == "all assigned in pass 0":
        assert pv.all()
    if case == "no finite entry":
        assert not pv.any()

    # pass 0's amplitude, bit for bit with the reference's compiled lines
    amp = _pass0_amp(pref, dest_ids, has)
    want = np.asarray(_jax_amp(jnp.asarray(pref)), np.float32)
    assert amp.view(np.int32) == want.view(np.int32)
    if case == "no finite entry":
        assert amp == np.float32(1e-6)


def _f32(bits):
    return np.array(bits, np.uint32).view(np.float32)[()]


#: (S, p1, p2) as float32 bits: candidate 1 ties candidate 0 on slot 0,
#: loses it on gain, and in pass 1 picks between slots 1 and 2, where
#: p + amp * jitter rounded once and rounded twice order differently.  In
#: the first case the amplitude 0.35 * S + 1e-6 differs too
FMA_CASES = {"amplitude and preference": (0x3FA315CE, 0xBE2FD186,
                                          0xBE44B368),
             "preference alone": (0x3FD0ACAD, 0xBEDA39D8, 0xBEE795FD)}


@pytest.mark.parametrize("case", sorted(FMA_CASES))
def test_jitter_is_rounded_once_as_the_compiled_reference(case):
    """XLA:CPU contracts the reference's `0.35 * spread + 1e-6` and `pref
    + amp * jitter` into FMAs in its compiled program; the port rounds
    both once (ops.fma_f32), and picks the compiled reference's slot
    where rounding twice picks the other."""
    s, p1, p2 = (_f32(b) for b in FMA_CASES[case])
    pref = np.full((C, KK), JK.NEG, np.float32)
    pref[0, :3] = [0.0, -s, -s]
    pref[1, :3] = [0.0, p1, p2]
    gain = np.zeros(C, np.float32)
    gain[:2] = [2.0, 1.0]
    has = np.zeros(C, bool)
    has[:2] = True
    (jd, jv), (pd, pv) = _both(pref, gain, has, None)
    np.testing.assert_array_equal(pv.numpy(), jv)
    np.testing.assert_array_equal(pd.numpy(), jd)
    amp = _pass0_amp(pref, None, has)
    assert amp.view(np.int32) == np.asarray(
        _jax_amp(jnp.asarray(pref))).view(np.int32)
    # rounding each product and sum on its own picks the other slot
    f = np.float32
    twice = f(f(f(0.35) * s) + f(1e-6))
    assert (twice != amp) == (case == "amplitude and preference")
    jit = K._pairwise_jitter(2, 3, salt=1).numpy()[1]
    p = [f(x + f(twice * jit[j])) for j, x in ((1, p1), (2, p2))]
    assert jd[1] == (2 if p[0] >= p[1] else 1)


def test_assign_pass_plain_folds_the_pass_before():
    """The fold of the previous pass's keep into dest and assigned, the
    open mask from the counts and the cap, and a row already assigned
    answering slot 0's broker with has False."""
    pref = torch.tensor([[-1.0, -2.0, -3.0], [-3.0, -1.0, -2.0],
                         [-2.0, -3.0, -1.0], [-1.0, -1.0, -1.0]])
    ids = torch.tensor([7, 3, 5], dtype=torch.int32)
    taken = torch.tensor([0, 0, 0, 2, 0, 1, 0, 0], dtype=torch.int32)
    cap = torch.tensor([1, 1, 1, 2, 1, 4, 1, 1], dtype=torch.int32)
    has = torch.ones(4, dtype=torch.bool)
    assigned = torch.tensor([False, False, True, False])
    dest = torch.tensor([0, 0, 9, 0], dtype=torch.int32)
    keep = torch.tensor([True, False, False, False])
    prev = torch.tensor([5, 1, 1, 1], dtype=torch.int32)
    amp = torch.tensor(0.5)
    best, got = K.assign_pass_plain(pref, ids, taken, cap, has, 2, amp,
                                    assigned, dest, keep, prev)
    assert dest.tolist() == [5, 0, 9, 0]
    assert assigned.tolist() == [True, False, True, False]
    # broker 3 is full (2 of 2), so row 1 takes slot 2 (broker 5)
    assert best[:3].tolist() == [7, 5, 7] and best[3] in (7, 5)
    assert got.tolist() == [False, True, False, True]
    # without a cap, one arrival a destination: brokers 3 and 5 are taken
    best, got = K.assign_pass_plain(pref, ids, taken, None, has, 0, amp,
                                    assigned, dest)
    assert best.tolist() == [7, 7, 7, 7]
    assert got.tolist() == [False, True, False, True]
    assert amp.item() == np.float32(np.float32(0.35) * np.float32(2.0)
                                    + np.float32(1e-6))
