"""The five `a * b + c` sites of the leadership and count goals against
the compiled reference, each on a crafted near-tie.

XLA:CPU contracts a product and the sum it feeds into one FMA when both
sit in one fused loop of a compiled program, and the reference runs its
goals compiled (`jax.jit`).  For each site the test
  * compiles the reference function that holds it (`leadership_round`,
    `global_leadership_sweep`) and finds, in the optimised HLO, the fused
    computation where the site's product feeds its sum: the product is
    picked out by its constant factor (0.35, 0.1, 0.5; the jitter's
    `m / 2**24` is folded into 0.35 * 2**-24 by the compiler);
  * compiles the reference's lines from the site to the choice it drives
    (a window top-k, a sibling argmax), checks that they fuse the same
    way, and runs them on an input where the product and the sum rounded
    once and rounded twice give float32 values that order two
    candidates differently;
  * asserts that the port's function gives the compiled reference's value
    bit for bit and makes its choice, and that rounding twice would have
    made the other one.
The count goal's mover weight `1 + 0.25 * jitter` cannot round apart: a
jitter is a multiple of 2**-24, so its product with 0.25 is exact; the
test pins that over every jitter value and holds the port's weights to
the compiled reference's.  Inputs are made with numpy from a seed.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import context as JC
from cruise_control_tpu.analyzer import kernels as JK
from cruise_control_tpu.analyzer import leadership as JL
from cruise_control_tpu.analyzer.goals import base as JB
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu_torch.analyzer import kernels as K
from cruise_control_tpu_torch.analyzer import leadership as L
from cruise_control_tpu_torch.analyzer.goals.count_distribution import \
    mover_weights

f32 = np.float32
#: the jitter's scale folded into the selection amplitude's constant
JITTER_035 = float(f32(0.35)) * 2.0 ** -24
#: 130 brokers x 16 table candidates > CAND_COMPACT and 4,200 partitions
#: > SWEEP_COMPACT: both windows compact, so both sites stay in the program
SPEC = dict(num_brokers=130, num_partitions=4200, replication_factor=3,
            num_racks=4, num_topics=8, seed=5, skew_fraction=0.4)
NW_OUT = 2


# ---------------------------------------------------------------------------
# the optimised HLO: a product scaled by a constant, feeding a sum, inside
# one fused computation
# ---------------------------------------------------------------------------

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(\([^=]*?\)|\S+)\s+"
                    r"([a-z][\w\-]*)\((.*?)\)(.*)$")


def _fused_computations(hlo: str) -> dict:
    """{name: {instruction: (type, opcode, operands, attributes)}} of the
    computations that a fusion instruction calls."""
    comps, called, cur = {}, set(), None
    for line in hlo.splitlines():
        head = re.match(r"^(?:ENTRY\s+)?%([\w.\-]+)\s.*\{\s*$", line)
        if head:
            cur = comps.setdefault(head.group(1), {})
        elif line.startswith("}"):
            cur = None
        elif cur is not None and (m := _INSTR.match(line)):
            name, typ, op, args, rest = m.groups()
            cur[name] = (typ, op, args, rest)
            if op == "fusion":
                called.add(re.search(r"calls=%([\w.\-]+)", rest).group(1))
    return {k: v for k, v in comps.items() if k in called}


def _operands(args: str) -> list:
    return re.findall(r"%([\w.\-]+)", args)


def _scaled_by(comp: dict, name: str, const: float, depth: int = 3) -> bool:
    """Is `name` constant(const), or a broadcast or product of it?"""
    if depth < 0 or name not in comp:
        return False
    _, op, args, _ = comp[name]
    if op == "constant":
        try:
            return f32(float(args)) == f32(const)
        except ValueError:
            return False
    return op in ("broadcast", "bitcast", "multiply") and any(
        _scaled_by(comp, o, const, depth - 1) for o in _operands(args))


def fused_product_sum(hlo: str, const: float):
    """The fused computation in which a non-scalar product with a factor
    scaled by constant(const) is an operand of an add or a subtract (the
    pair LLVM contracts into one FMA), or None."""
    for cname, comp in _fused_computations(hlo).items():
        for typ, op, args, _ in comp.values():
            if op not in ("add", "subtract"):
                continue
            for o in _operands(args):
                while o in comp and comp[o][1] in ("bitcast", "copy"):
                    o = _operands(comp[o][2])[0]
                if (o in comp and comp[o][1] == "multiply"
                        and re.search(r"\[\d", comp[o][0])
                        and any(_scaled_by(comp, x, const)
                                for x in _operands(comp[o][2]))):
                    return cname
    return None


def _hlo(fn, *args) -> str:
    return fn.lower(*args).compile().as_text()


# ---------------------------------------------------------------------------
# the reference functions that hold the sites, compiled
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    js, jt = j_random_cluster(JSpec(**SPEC))
    jctx = JC.make_context(js, JC.BalancingConstraint(),
                           JC.OptimizationOptions(), jt)
    return js, jctx


@pytest.fixture(scope="module")
def sweep_hlo(cluster):
    """`global_leadership_sweep` in mean mode on leader counts with the
    improvement gate, a destination tiebreak and the value-weighted
    window amplitude, compiled."""
    js, jctx = cluster
    cap = jnp.full((js.num_brokers,), 1e9, jnp.float32)

    def sweep(st, cache):
        return JL.global_leadership_sweep(
            st, jctx, [], measure=lambda c: c.leader_count.astype(
                jnp.float32),
            value_r=st.replica_valid.astype(jnp.float32),
            bounds=JL.mean_bounds(lambda s, W: cap), improve_gate=True,
            dest_tiebreak=lambda c: -c.leader_bytes_in, cache0=cache,
            select_jitter=JL.VALUE_WEIGHTED_SELECT_JITTER)
    return _hlo(jax.jit(sweep), js, JC.make_round_cache(js, 0, jctx))


@pytest.fixture(scope="module")
def table_round_hlo(cluster):
    """`leadership_round` with resident candidate rows (the NW_OUT goal's
    phase a), compiled."""
    js, jctx = cluster
    res = NW_OUT

    def round_(st, cache):
        cap = st.broker_capacity[:, res]
        upper = jctx.balance_upper_pct[res] * cap
        bonus = (st.partition_leader_bonus[st.replica_partition, res]
                 * st.replica_valid)
        W = cache.broker_load[:, res]
        value_rows = cache.table_bonus[:, :, res]
        rows = JB.leader_shed_rows(cache, value_rows, W > upper, W - upper)
        return JK.leadership_round(
            st, bonus, W - upper, JC.replica_static_ok(st, jctx),
            jctx.broker_leader_ok, upper - W,
            lambda s, d: jnp.ones(jnp.broadcast_shapes(s.shape, d.shape),
                                  bool),
            -W / jnp.maximum(cap, 1e-9), jctx.partition_replicas,
            cache=cache, bonus_rows=rows, value_rows=value_rows)
    return _hlo(jax.jit(round_), js,
                JC.make_round_cache(js, jctx.table_slots, jctx))


# ---------------------------------------------------------------------------
# crafting a near-tie
# ---------------------------------------------------------------------------

def _once(a, b, c):
    """a * b + c rounded once: the product (48 bits) and the sum are exact
    in the x87 extended format, then one rounding to float32."""
    ld = np.longdouble
    return f32(ld(f32(a)) * ld(f32(b)) + ld(f32(c)))


def _twice(a, b, c):
    return f32(f32(f32(a) * f32(b)) + f32(c))


def _ulps(x, k):
    """x moved k float32 steps (k may be negative)."""
    for _ in range(abs(k)):
        x = np.nextafter(x, f32(np.inf if k > 0 else -np.inf),
                         dtype=np.float32)
    return x


def _near_tie(rng, sample, j_b, a_above: bool):
    """(g_a, amp, j_a, g_b), with (g_a, amp, j_a) drawn by sample(rng):
    g_a + amp * j_a rounded once lies one step above (a_above) or below
    its value rounded twice, and g_b + amp * j_b is that twice-rounded
    value however it is rounded; g_b > g_a."""
    assert np.finfo(np.longdouble).nmant >= 63
    for _ in range(20000):
        g_a, amp, j_a = sample(rng)
        once, twice = _once(amp, j_a, g_a), _twice(amp, j_a, g_a)
        if once == twice or (once > twice) != a_above:
            continue
        g0 = f32(twice - f32(amp * f32(j_b)))
        for k in range(-3, 4):
            g_b = _ulps(g0, k)
            if (g_b > g_a and _twice(amp, j_b, g_b) == twice
                    and _once(amp, j_b, g_b) == twice):
                return g_a, amp, j_a, g_b
    raise AssertionError("no near-tie found")


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# site 1: leadership_round's window gain (reference kernels.py:1080)
# ---------------------------------------------------------------------------

@jax.jit
def _j_table_window(cand_bonus_b, cand_has, salt_r):
    """The reference's leadership_round lines from the bonus spread to the
    compaction (analyzer/kernels.py:1073-1083)."""
    c_full = cand_bonus_b.shape[0]
    g_lo = jnp.min(jnp.where(cand_has, cand_bonus_b, jnp.inf))
    g_hi = jnp.max(jnp.where(cand_has, cand_bonus_b, -jnp.inf))
    spread_g = jnp.where(g_hi > g_lo, g_hi - g_lo,
                         jnp.maximum(jnp.abs(g_hi), 1.0))
    gain_sel = cand_bonus_b + 0.35 * spread_g * JK.salted_jitter(
        c_full, salt_r)
    sel, _, _ = JK.compact_candidates(JK.CAND_COMPACT, gain_sel, cand_has)
    return gain_sel, sel


def _window_case(seed, n, top, salt_jitter, amp_of):
    """n candidates: n - 2 at `top` and two near-tied at the window's cut
    among the last eight, ordered so that the tie rule (the lower index
    wins) and the once-rounded order keep different ones."""
    rng = np.random.default_rng(seed)
    a_above = bool(seed % 2)
    # rounded twice a and b tie and the lower index stays; rounded once
    # the larger stays: a sits above b when it rounds up.  b's jitter is
    # the smaller, so b's gain is the larger and a's sets the spread
    i_a, i_b = next((i, j) for i in range(n - 8, n) for j in range(n - 8, n)
                    if (i > j) == a_above
                    and salt_jitter[j] < salt_jitter[i])
    def sample(rng):
        g_a = f32(rng.uniform(0.5, 1.5))
        return g_a, amp_of(g_a), salt_jitter[i_a]
    g_a, _, _, g_b = _near_tie(rng, sample, salt_jitter[i_b], a_above)
    gain = np.full(n, top, np.float32)
    gain[i_a], gain[i_b] = g_a, g_b
    return gain, i_a, i_b


@pytest.mark.parametrize("seed", [0, 1])
def test_table_round_window_gain_is_one_fma(table_round_hlo, seed):
    assert fused_product_sum(table_round_hlo, JITTER_035)
    n, salt, top = JK.CAND_COMPACT + 1, 7, f32(8.0)
    jit = np.asarray(JK.salted_jitter(n, jnp.int32(salt)))

    def amp_of(g_lo):
        return f32(f32(0.35) * f32(top - g_lo))
    gain, i_a, i_b = _window_case(seed, n, top, jit, amp_of)
    has = np.ones(n, bool)
    args = (jnp.asarray(gain), jnp.asarray(has), jnp.int32(salt))
    assert fused_product_sum(_hlo(_j_table_window, *args), JITTER_035)
    j_gain, j_sel = (np.asarray(x) for x in _j_table_window(*args))
    p_gain = K.table_window_gain(torch.from_numpy(gain),
                                 torch.from_numpy(has),
                                 torch.tensor(salt, dtype=torch.int32))
    p_sel = K.compact_candidates(K.CAND_COMPACT, p_gain,
                                 torch.from_numpy(has))[0]
    np.testing.assert_array_equal(_bits(p_gain.numpy()), _bits(j_gain))
    np.testing.assert_array_equal(p_sel.numpy(), j_sel)
    # rounded twice, the window keeps the other one of the two
    twice = gain + f32(amp_of(gain[i_a]) * jit)
    dropped = {i_a, i_b} - set(j_sel.tolist())
    # rounded twice the two tie and the window drops the higher index;
    # rounded once it drops the lower
    assert twice[i_a] == twice[i_b] and dropped == {min(i_a, i_b)}


# ---------------------------------------------------------------------------
# site 2: the sweep's window gain (reference leadership.py:227)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=4)
def _j_sweep_window(gain0, live, failed, salt, select_jitter):
    """The reference's sweep round lines from the gains' spread to the
    window compaction (analyzer/leadership.py:210-233)."""
    g_lo = jnp.min(jnp.where(live, gain0, jnp.inf))
    g_hi = jnp.max(jnp.where(live, gain0, -jnp.inf))
    spread0 = jnp.where(g_hi > g_lo, g_hi - g_lo, 1.0)
    amp = spread0 * select_jitter
    gain_sel = (gain0
                + amp * JK.salted_jitter(
                    gain0.shape[0], (salt * 100.0).astype(jnp.int32))
                - failed * (spread0 + amp))
    sel, _, _ = JK.compact_candidates(JL.SWEEP_COMPACT, gain_sel, live)
    return gain_sel, sel


@pytest.mark.parametrize("seed", [2, 3])
def test_sweep_window_gain_is_one_fma(sweep_hlo, seed):
    assert fused_product_sum(sweep_hlo, JITTER_035)
    n, top = JL.SWEEP_COMPACT + 1, f32(8.0)
    sj = JL.VALUE_WEIGHTED_SELECT_JITTER
    salt = f32(3.0) * f32(0.37)              # round 3's salt
    jit = np.asarray(JK.salted_jitter(
        n, (jnp.float32(salt) * 100.0).astype(jnp.int32)))

    def amp_of(g_lo):
        return f32(f32(top - g_lo) * f32(sj))
    gain, i_a, i_b = _window_case(seed, n, top, jit, amp_of)
    live = np.ones(n, bool)
    failed = np.zeros(n, np.float32)
    args = (jnp.asarray(gain), jnp.asarray(live), jnp.asarray(failed),
            jnp.float32(salt), sj)
    assert fused_product_sum(_hlo(_j_sweep_window, *args), JITTER_035)
    j_gain, j_sel = (np.asarray(x) for x in _j_sweep_window(*args))
    p_gain = L.sweep_window_gain(torch.from_numpy(gain),
                                 torch.from_numpy(live),
                                 torch.from_numpy(failed), float(salt), sj)
    p_sel = K.compact_candidates(L.SWEEP_COMPACT, p_gain,
                                 torch.from_numpy(live))[0]
    np.testing.assert_array_equal(_bits(p_gain.numpy()), _bits(j_gain))
    np.testing.assert_array_equal(p_sel.numpy(), j_sel)
    twice = gain + f32(amp_of(gain[i_a]) * jit)
    dropped = {i_a, i_b} - set(j_sel.tolist())
    # rounded twice the two tie and the window drops the higher index;
    # rounded once it drops the lower
    assert twice[i_a] == twice[i_b] and dropped == {min(i_a, i_b)}


# ---------------------------------------------------------------------------
# sites 3 and 4: the sweep's sibling score and its tiebreak term
# (reference leadership.py:255 and :266; K6's plain version)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=5)
def _j_sweep_pick(deficit, ok, jit, salt, tb_norm_c, tiebreak):
    """The reference's sweep round lines from the spread to the sibling
    argmax (analyzer/leadership.py:254-269), on the window's gathered
    [W, RF] planes."""
    spread = jnp.maximum(jnp.max(jnp.abs(deficit)), 1e-6)
    score = deficit + 0.1 * spread * ((jit + salt) % 1.0)
    if tiebreak:
        score = score + 0.5 * spread * tb_norm_c
    score = jnp.where(ok, score, -jnp.inf)
    return jnp.argmax(score, axis=1)


def _p_sweep_pick(deficit, jit, tb):
    """K6's plain version on one window row: partition 0's replicas 0, 1
    and 2 on brokers 0, 1 and 2, the leader replica 0; loads 0, so each
    broker's deficit is its fill target."""
    t = torch.tensor
    i32 = torch.int32
    ones = torch.ones(3, dtype=torch.bool)
    dst_r, has = L.sweep_pick_plain(
        t([0], dtype=i32), t([True]), t([0], dtype=i32),
        t([[0, 1, 2]], dtype=i32), torch.from_numpy(jit[None]),
        t([0, 1, 2], dtype=i32), torch.zeros(3), ones, ones, ones,
        torch.zeros(3), t(deficit, dtype=torch.float32),
        torch.full((3,), 1e9), None if tb is None else t(
            tb, dtype=torch.float32), 0.0, False)
    assert bool(has[0])
    return int(dst_r[0])


@pytest.mark.parametrize("tiebreak", [False, True],
                         ids=["score", "tiebreak"])
@pytest.mark.parametrize("seed", [4, 5])
def test_sweep_sibling_score_is_one_fma(sweep_hlo, tiebreak, seed):
    """Site 3 (tiebreak=False): deficit + 0.1 * spread * frac; site 4: +
    0.5 * spread * tb_norm with frac 0.  Option 0 is the leader's (the
    spread, never a pick); of options 1 and 2, one has a crafted term
    and the other a term of 0 at its twice-rounded value."""
    const = 0.5 if tiebreak else 0.1
    assert fused_product_sum(sweep_hlo, const)
    rng = np.random.default_rng(seed)
    spread = f32(13.37)
    amp = f32(f32(const) * spread)
    a_above = bool(seed % 2)
    g_a, _, term, g_b = _near_tie(
        rng, lambda r: (f32(r.uniform(1.0, 8.0)), amp,
                        f32(r.uniform(0.05, 0.95))), f32(0.0), a_above)
    # rounded twice the two tie and the argmax takes option 1; rounded
    # once it takes option 2: the crafted one when it rounds up
    j_a, j_b = (2, 1) if a_above else (1, 2)
    deficit = np.array([spread, 0, 0], np.float32)
    deficit[j_a], deficit[j_b] = g_a, g_b
    term_row = np.zeros(3, np.float32)
    term_row[j_a] = term
    jit_row, tb = (np.zeros(3, np.float32), term_row) if tiebreak else (
        term_row, None)
    args = (jnp.asarray(deficit[None]), jnp.asarray([[False, True, True]]),
            jnp.asarray(jit_row[None]), jnp.float32(0.0),
            jnp.asarray((tb if tiebreak else np.zeros(3, np.float32))[None]),
            tiebreak)
    assert fused_product_sum(_hlo(_j_sweep_pick, *args), const)
    want = int(np.asarray(_j_sweep_pick(*args))[0])
    assert want == 2
    assert _p_sweep_pick(deficit, jit_row, tb) == want
    assert _twice(amp, term, g_a) == g_b


# ---------------------------------------------------------------------------
# site 5: the count goal's mover weight (reference
# goals/count_distribution.py:482)
# ---------------------------------------------------------------------------

def test_count_goal_mover_weight_rounds_alike_once_or_twice():
    """Every jitter value is m / 2**24 with m < 2**24, so 0.25 * jitter =
    m / 2**26 is exact and 1 + 0.25 * jitter rounds once however it is
    computed: no near-tie exists, and the port's weights (rounded twice)
    equal the compiled reference's."""
    for lo in range(0, 1 << 24, 1 << 21):
        j = np.arange(lo, lo + (1 << 21), dtype=np.float32) / f32(1 << 24)
        prod = f32(0.25) * j
        np.testing.assert_array_equal(prod.astype(np.float64),
                                      0.25 * j.astype(np.float64))
    n = 4096
    weights = jax.jit(lambda salt: 1.0 + 0.25 * JK.salted_jitter(n, salt))
    for salt in (0, 3, 2 ** 31 - 1):
        want = np.asarray(weights(jnp.int32(salt)))
        got = mover_weights(n, salt, "cpu").numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))
