"""Self-healing in the PyTorch port against the JAX reference, on the CPU.

Function by function: the broker and logdir state changes
(`set_broker_state`, `mark_disk_dead`), K7's plain version
(`forced_select_plain`) against the reference's guard and `jax.lax.top_k`
expression, `forced_move_round` on each of its branches, and
`heal_offline_replicas` on dead-broker and dead-disk clusters.  Then whole
solves: the config-5 shape (JBOD logdirs with broken disks, Disk capacity +
Disk usage distribution), the re-run after a broker-table overflow, the
"could not relocate" failure, and the stats-regression waiver on a model
that carries offline replicas on alive brokers.

Integers and booleans must match exactly; the solves' final placement,
offline flags, logdirs, proposals, rounds, converged-at rounds and
violated-broker counts too.  No float tolerance is used: the compared
floats are the inputs' own or pass through the same ordered sums.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import context as JC
from cruise_control_tpu.analyzer import kernels as JK
from cruise_control_tpu.analyzer.goals.base import (
    OptimizationFailure as JFailure,
    compose_move_acceptance as j_compose_move,
    move_commit_terms as j_move_terms)
from cruise_control_tpu.analyzer.goals.registry import (
    DEFAULT_HARD_GOALS as JR_HARD, default_goals as j_default_goals)
from cruise_control_tpu.analyzer.goals.resource_distribution import \
    DiskUsageDistributionGoal as JDisk
from cruise_control_tpu.analyzer.optimizer import (
    GoalOptimizer as JOptimizer, heal_offline_replicas as j_heal)
from cruise_control_tpu.model import state as JS
from cruise_control_tpu.testing import fixtures as jfix
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu.testing.verifier import verify_result as j_verify
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer import kernels as K
from cruise_control_tpu_torch.analyzer.goals.base import (
    OptimizationFailure, compose_move_acceptance, move_commit_terms)
from cruise_control_tpu_torch.analyzer.goals.registry import default_goals
from cruise_control_tpu_torch.analyzer.goals.resource_distribution import \
    DiskUsageDistributionGoal
from cruise_control_tpu_torch.analyzer.optimizer import (
    GoalOptimizer, heal_offline_replicas)
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model.state import STATE_FIELDS
from cruise_control_tpu_torch.testing import checks
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)

DISK = 3
#: the config-5 shape of tests/test_goal_stack.py
CONFIG5 = dict(num_brokers=12, num_partitions=120, replication_factor=3,
               num_racks=4, num_topics=5, seed=13, jbod_disks=3,
               dead_disks=4)
DEAD = dict(num_brokers=16, num_partitions=400, replication_factor=3,
            num_racks=4, num_topics=8, seed=0, skew_fraction=0.3,
            dead_brokers=2)
#: 24 brokers, 6,000 replicas: more than K7's 4,096 candidates
WIDE = dict(num_brokers=24, num_partitions=2000, replication_factor=3,
            num_racks=6, num_topics=8, seed=5, skew_fraction=0.3)
C5_GOALS = ["DiskCapacityGoal", "DiskUsageDistributionGoal"]


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    assert np.array_equal(a, b), what


def _both(spec):
    js, jt = j_random_cluster(JSpec(**spec))
    ps, pt = random_cluster(RandomClusterSpec(**spec), device="cpu")
    return js, jt, ps, pt


def _port_state(js):
    """The reference's ClusterState carried across to the port."""
    return convert.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS},
        num_racks=js.num_racks, num_hosts=js.num_hosts,
        num_topics=js.num_topics, device="cpu")


def _assert_states_equal(js, ps, fields=STATE_FIELDS):
    for f in fields:
        _eq(getattr(js, f), getattr(ps, f), f)


def _proposals(result):
    return {(str(p.partition), tuple(r.broker_id for r in p.old_replicas),
             tuple(r.broker_id for r in p.new_replicas))
            for p in result.proposals}


def _assert_same_solve(jres, pres):
    _assert_states_equal(jres.final_state, pres.final_state,
                         ("replica_broker", "replica_is_leader",
                          "replica_disk", "replica_offline"))
    assert _proposals(jres) == _proposals(pres)
    assert jres.violated_broker_counts == pres.violated_broker_counts
    assert jres.entry_broker_counts == pres.entry_broker_counts
    assert jres.rounds_by_goal == pres.rounds_by_goal
    assert jres.converged_at_by_goal == pres.converged_at_by_goal
    assert jres.violated_goals_after == pres.violated_goals_after
    assert jres.regressed_goals == pres.regressed_goals
    assert jres.balancedness_score() == pres.balancedness_score()


# ---------------------------------------------------------------------------
# model state changes
# ---------------------------------------------------------------------------

def test_set_broker_state_matches():
    spec = dict(CONFIG5, dead_disks=3)
    js, _, ps, _ = _both(spec)
    _assert_states_equal(js, ps)
    bad = int(np.nonzero(np.asarray(js.broker_bad_disks))[0][0])
    steps = [(3, dict(alive=False)), (bad, dict(alive=False)),
             (bad, dict(alive=True)), (5, dict(new=True)),
             (6, dict(demoted=True)), (7, dict(bad_disks=True)),
             (3, dict(alive=True))]
    for broker, kw in steps:
        js = JS.set_broker_state(js, broker, **kw)
        ps = S.set_broker_state(ps, broker, **kw)
        _assert_states_equal(js, ps)
    # reviving the broker with a broken logdir keeps those replicas offline
    on_dead = (np.asarray(js.replica_disk) >= 0) & ~np.asarray(
        js.disk_alive)[np.maximum(np.asarray(js.replica_disk), 0)]
    assert on_dead.any()
    assert ps.replica_offline.numpy()[on_dead].all()


def test_mark_disk_dead_and_replication_factor_match():
    js, _, ps, _ = _both(dict(CONFIG5, dead_disks=0))
    for disk in (0, 7, 7, 20):
        js = JS.mark_disk_dead(js, disk)
        ps = S.mark_disk_dead(ps, disk)
        _assert_states_equal(js, ps)
    assert ps.replica_offline.any()
    _eq(JS.partition_replication_factor(js),
        S.partition_replication_factor(ps))


# ---------------------------------------------------------------------------
# K7's plain version against the reference's selection expression
# ---------------------------------------------------------------------------

def _selection_inputs(case, spec):
    """(state pair, forced, w, dest_ok, headroom) for a selection case."""
    js, _, ps, _ = _both(spec)
    rng = np.random.default_rng(len(case))
    num_r, num_b = ps.num_replicas, ps.num_brokers
    w = np.asarray(js.replica_base_load)[:, DISK].copy()
    share = {"sparse": 0.005, "ties": 0.3, "tail": 2000 / num_r,
             "all": 1.0, "small_r": 0.4}[case]
    forced = rng.random(num_r) < share
    if case == "ties":
        w = np.round(w / np.max(w) * 3.0).astype(np.float32)
    dest_ok = rng.random(num_b) < 0.7
    return js, ps, forced, w.astype(np.float32), dest_ok


@pytest.mark.parametrize("headroom", ["inf", "finite"])
@pytest.mark.parametrize("case", ["sparse", "ties", "tail", "all",
                                  "small_r"])
def test_forced_select_plain_matches_reference(case, headroom):
    spec = DEAD if case == "small_r" else WIDE
    js, ps, forced, w, dest_ok = _selection_inputs(case, spec)
    num_b = ps.num_brokers
    if headroom == "inf":
        room = np.full(num_b, np.inf, np.float32)
    else:
        room = (np.random.default_rng(3).random(num_b) * 2.0
                * float(np.max(w))).astype(np.float32)
    pr = C.partition_replica_index(ps)
    k = min(4096, ps.num_replicas)
    # the reference: the guard, then top_k of the masked score
    j_ok = jnp.asarray(forced) & JK.feasible_dest_exists(
        js, jnp.asarray(w), jnp.asarray(dest_ok), jnp.asarray(room),
        jnp.asarray(pr))
    _, j_idx = jax.lax.top_k(jnp.where(j_ok, jnp.asarray(w) + 1.0,
                                       -jnp.inf), k)
    top_b, top_h = K.top_headroom(torch.from_numpy(dest_ok),
                                  torch.from_numpy(room), pr.shape[1])
    cand, has, ok = K.forced_select_plain(
        torch.from_numpy(forced), torch.from_numpy(w), ps.replica_partition,
        ps.replica_broker, torch.from_numpy(pr), top_b, top_h, k)
    _eq(j_ok, ok, "forced_ok")
    _eq(j_idx, cand, "cand_r")
    _eq(np.asarray(j_ok)[np.asarray(j_idx)], has, "cand_has")
    n_ok = int(ok.sum())
    if case == "tail":
        assert 0 < n_ok < k          # the -inf tail is in play
    if case == "small_r":
        assert ps.num_replicas < 4096
    # guard-only mode
    _, _, ok0 = K.forced_select_plain(
        torch.from_numpy(forced), torch.from_numpy(w), ps.replica_partition,
        ps.replica_broker, torch.from_numpy(pr), top_b, top_h, 0)
    _eq(j_ok, ok0, "guard only")


# ---------------------------------------------------------------------------
# forced_move_round, branch by branch
# ---------------------------------------------------------------------------

def _heal_inputs(lib, st, ctx, cache):
    """The self-healing round's arguments (capacity-only acceptance over
    every resource, least disk-utilized destination first)."""
    w = cache.replica_load[:, DISK]
    cap = st.broker_capacity * ctx.capacity_threshold[None, :]
    room = cap - cache.broker_load
    if lib is JK:
        def accept(r, d):
            return jnp.all(cache.replica_load[r] <= room[d], axis=-1)
        util = cache.broker_load[:, DISK] / jnp.maximum(
            st.broker_capacity[:, DISK], 1e-9)
    else:
        def accept(r, d):
            return torch.all(cache.replica_load[r] <= room[d], -1)
        util = cache.broker_load[:, DISK] / torch.clamp_min(
            st.broker_capacity[:, DISK], 1e-9)
    return w, st.broker_alive & ctx.broker_dest_ok, accept, -util


@pytest.fixture(scope="module")
def dead_setup():
    js, jt, ps, pt = _both(DEAD)
    jctx = JC.make_context(js, JC.BalancingConstraint(),
                           JC.OptimizationOptions(), jt)
    pctx = C.make_context(ps, C.BalancingConstraint(),
                          C.OptimizationOptions(), pt)
    return js, ps, jctx, pctx


def _assert_round_equal(j_out, p_out):
    (jr, jd, jv), (pr, pd, pv) = j_out, p_out
    _eq(jr, pr, "cand_r")
    _eq(jv, pv, "valid")
    _eq(np.where(np.asarray(jv), jd, 0), torch.where(pv, pd, 0), "dest")
    assert bool(pv.any())


@pytest.mark.parametrize("cap_alive", [False, True])
def test_forced_move_round_tableless(dead_setup, cap_alive):
    """The heal's branch: K7's selection (4,096 of R), single commit."""
    js, ps, jctx, pctx = dead_setup
    outs = []
    for lib, st, ctx, mk in ((JK, js, jctx, JC.make_round_cache),
                             (K, ps, pctx, C.make_round_cache)):
        cache = mk(st)
        w, dest_ok, accept, pref = _heal_inputs(lib, st, ctx, cache)
        outs.append(lib.forced_move_round(
            st, st.replica_valid & st.replica_offline, w, dest_ok, accept,
            pref, ctx.partition_replicas, cap_alive_sources=cap_alive))
    _assert_round_equal(*outs)


def _table_round(lib, st, ctx, cache, forced, cap_alive, terms, prev):
    """A rack-awareness style round on the table branch."""
    compose = j_compose_move if lib is JK else compose_move_acceptance
    move_terms = j_move_terms if lib is JK else move_commit_terms
    w = cache.replica_load[:, DISK]
    dest_ok = ctx.broker_dest_ok & st.broker_alive
    mt_d = move_terms(prev, st, ctx, cache)[0] if terms else None
    mid = ((ctx.balance_upper_pct[DISK] + ctx.balance_lower_pct[DISK])
           / 2.0 * st.broker_capacity[:, DISK])
    return lib.forced_move_round(
        st, forced, w, dest_ok, compose(prev, st, ctx, cache),
        -cache.broker_util[:, DISK], ctx.partition_replicas,
        cap_alive_sources=cap_alive, cache=cache, dest_terms=mt_d,
        dest_stack_headroom=mid - cache.broker_load[:, DISK])


@pytest.mark.parametrize("cap_alive,terms,prev", [
    (False, True, False),     # rack awareness first: k = 4, multi-commit
    (True, False, True),      # k = 1, single commit after a source-side goal
    (False, True, True)])     # multi-commit with the prior goal's terms
def test_forced_move_round_table_branch(cap_alive, terms, prev):
    js, jt, ps, pt = _both(dict(WIDE, num_partitions=600))
    jctx = JC.make_context(js, JC.BalancingConstraint(),
                           JC.OptimizationOptions(), jt)
    pctx = C.make_context(ps, C.BalancingConstraint(),
                          C.OptimizationOptions(), pt)
    jcache = JC.make_round_cache(js, jctx.table_slots, jctx)
    pcache = C.make_round_cache(ps, pctx.table_slots, pctx)
    forced = np.random.default_rng(9).random(ps.num_replicas) < 0.2
    forced &= ~np.asarray(js.replica_is_leader)
    j_out = _table_round(JK, js, jctx, jcache, jnp.asarray(forced),
                         cap_alive, terms, [JDisk()] if prev else [])
    p_out = _table_round(K, ps, pctx, pcache, torch.from_numpy(forced),
                         cap_alive, terms,
                         [DiskUsageDistributionGoal()] if prev else [])
    _assert_round_equal(j_out, p_out)


def test_forced_move_round_guarded_pick():
    """Every table candidate is blocked (its partition already sits on
    both eligible destinations), so the round re-picks among the guarded
    replicas (K7's guard, then K1)."""
    js, jt, ps, pt = _both(dict(WIDE, num_partitions=600))
    part = np.asarray(js.replica_partition)
    rb = np.asarray(js.replica_broker)
    # p: a replica whose partition also sits on brokers a and b
    p = 0
    x = int(rb[p])
    a, b = (int(v) for v in rb[part == part[p]] if v != x)
    on_ab = np.isin(rb, [a, b])
    parts_on_ab = set(part[on_ab].tolist())
    q = next(r for r in np.nonzero(rb == x)[0]
             if part[r] not in parts_on_ab)
    forced = np.zeros(ps.num_replicas, bool)
    forced[[p, q]] = True
    w = np.zeros(ps.num_replicas, np.float32)
    w[p], w[q] = 100.0, 1.0
    dest_ok = np.zeros(ps.num_brokers, bool)
    dest_ok[[a, b]] = True
    outs = []
    for lib, st, ctx_mod, topo in ((JK, js, JC, jt), (K, ps, C, pt)):
        ctx = ctx_mod.make_context(st, ctx_mod.BalancingConstraint(),
                                   ctx_mod.OptimizationOptions(), topo)
        cache = ctx_mod.make_round_cache(st, ctx.table_slots, ctx)
        arr = jnp.asarray if lib is JK else torch.from_numpy
        pref = -cache.broker_util[:, DISK]

        def accept(r, d, lib=lib):
            shape = (r.shape[0], d.shape[1])
            return (jnp.ones(shape, bool) if lib is JK
                    else torch.ones(shape, dtype=torch.bool))
        outs.append(lib.forced_move_round(
            st, arr(forced), arr(w), arr(dest_ok), accept, pref,
            ctx.partition_replicas, cap_alive_sources=True, cache=cache))
    _assert_round_equal(*outs)
    pr, _, pv = outs[1]
    assert pr.numpy()[pv.numpy()].tolist() == [q]


# ---------------------------------------------------------------------------
# heal_offline_replicas
# ---------------------------------------------------------------------------

def _heal_both(js, jt, ps):
    jctx = JC.make_context(js, JC.BalancingConstraint(),
                           JC.OptimizationOptions(), jt)
    pctx = C.make_context(ps, C.BalancingConstraint(),
                          C.OptimizationOptions())
    healed_j = j_heal(js, jctx)
    healed_p, rounds, moved = heal_offline_replicas(ps, pctx)
    _assert_states_equal(healed_j, healed_p,
                         ("replica_broker", "replica_offline",
                          "replica_disk", "replica_is_leader"))
    offline0 = ps.replica_offline.numpy()
    assert offline0.any() and not healed_p.replica_offline.numpy().any()
    moved_mask = (healed_p.replica_broker.numpy()
                  != ps.replica_broker.numpy())
    assert moved == int(moved_mask.sum()) and rounds >= 1
    assert (healed_p.replica_disk.numpy()[moved_mask] == -1).all()
    alive = healed_p.broker_alive.numpy()
    assert alive[healed_p.replica_broker.numpy()].all()
    return healed_p


@pytest.mark.parametrize("which", ["dead_brokers", "dead_disks"])
def test_heal_matches_on_random_clusters(which):
    spec = DEAD if which == "dead_brokers" else dict(CONFIG5,
                                                     num_partitions=240)
    js, jt, ps, _ = _both(spec)
    _heal_both(js, jt, ps)


@pytest.mark.parametrize("fixture", ["dead_broker_cluster", "jbod_cluster"])
def test_heal_matches_on_reference_fixtures(fixture):
    js, jt = getattr(jfix, fixture)()
    if fixture == "jbod_cluster":
        # its broken logdir holds no replica: break the one replica 0 is on
        js = JS.mark_disk_dead(js, int(js.replica_disk[0]))
    _heal_both(js, jt, _port_state(js))


# ---------------------------------------------------------------------------
# whole solves
# ---------------------------------------------------------------------------

def test_config5_shape_solve_matches():
    """JBOD logdirs with four broken disks, healed, then Disk capacity and
    Disk usage distribution (BASELINE config 5's shape)."""
    js, jt, ps, pt = _both(CONFIG5)
    assert bool(S.self_healing_eligible(ps).any())
    jres = JOptimizer(j_default_goals(max_rounds=32, names=C5_GOALS)
                      ).optimizations(js, jt)
    pres = GoalOptimizer(default_goals(max_rounds=32, names=C5_GOALS)
                         ).optimizations(ps, pt, device="cpu")
    _assert_same_solve(jres, pres)
    assert pres.heal_rounds > 0 and pres.heal_moves > 0
    assert pres.proposals
    jres._topology = jt
    j_verify(js, jres)
    checks.verify_result(ps, pres, pt)
    ctx = C.make_context(ps, C.BalancingConstraint(),
                         C.OptimizationOptions(), pt)
    assert checks.cache_mismatches(pres.final_state, ctx,
                                   pres.final_cache) == []


def test_table_overflow_rerun_matches(caplog):
    """A broker table narrower than the largest row re-runs the solve with
    the width the reference computes, in both packages."""
    js, jt, ps, pt = _both(CONFIG5)
    jres = JOptimizer(j_default_goals(max_rounds=32, names=C5_GOALS)
                      ).optimizations(js, jt, _table_slots_override=16)
    with caplog.at_level(logging.WARNING):
        pres = GoalOptimizer(default_goals(max_rounds=32, names=C5_GOALS)
                             ).optimizations(ps, pt, device="cpu",
                                             _table_slots_override=16)
    assert any("re-running with width 128" in r.getMessage()
               for r in caplog.records)
    _assert_same_solve(jres, pres)
    assert pres.final_cache.broker_table.shape[1] == 128
    checks.verify_result(ps, pres, pt)


def test_could_not_relocate_fails_alike():
    """No alive broker has headroom: both packages fail the solve with the
    same count of offline replicas left."""
    spec = dict(DEAD, num_partitions=200)
    js, jt, ps, pt = _both(spec)
    tight = dict(capacity_threshold=(0.01, 0.01, 0.01, 0.01))
    with pytest.raises(JFailure, match="could not relocate") as j_err:
        JOptimizer([JDisk()], JC.BalancingConstraint(**tight)
                   ).optimizations(js, jt)
    with pytest.raises(OptimizationFailure,
                       match="could not relocate") as p_err:
        GoalOptimizer([DiskUsageDistributionGoal()],
                      C.BalancingConstraint(**tight)
                      ).optimizations(ps, pt, device="cpu")
    assert str(j_err.value) == str(p_err.value)
    assert str(int(S.self_healing_eligible(ps).sum())) in str(p_err.value)


class _JRegressing(JDisk):
    def stats_not_worse(self, before, after):
        return False


class _PRegressing(DiskUsageDistributionGoal):
    def stats_not_worse(self, before, after):
        return False


@pytest.mark.parametrize("offline", [False, True])
def test_offline_replicas_waive_the_regression_abort(offline):
    """`broken` includes "an offline replica exists": with offline
    replicas on alive brokers and disks the regression abort is waived
    in both packages; without them both abort."""
    spec = dict(DEAD, dead_brokers=0, num_partitions=200)
    js, jt, ps, pt = _both(spec)
    if offline:
        mask = np.zeros(ps.num_replicas, bool)
        mask[::37] = True
        js = js.replace(replica_offline=jnp.asarray(mask))
        ps = ps.replace(replica_offline=torch.from_numpy(mask))
        assert bool(torch.all(ps.broker_alive))
        assert bool(torch.all(ps.disk_alive))
    j_opt = JOptimizer([_JRegressing()])
    p_opt = GoalOptimizer([_PRegressing()])
    if not offline:
        with pytest.raises(JFailure, match="worse than before"):
            j_opt.optimizations(js, jt)
        with pytest.raises(OptimizationFailure, match="worse than before"):
            p_opt.optimizations(ps, pt, device="cpu")
        return
    jres = j_opt.optimizations(js, jt)
    pres = p_opt.optimizations(ps, pt, device="cpu")
    assert pres.regressed_goals == ["DiskUsageDistributionGoal"]
    _assert_same_solve(jres, pres)
    assert not pres.final_state.replica_offline.any()


@pytest.mark.slow
@pytest.mark.parametrize("which", ["config5", "hard"])
def test_slice_geometry_heal_solves_match(which):
    """The 200-broker solves of chip_smoke.py phase 3 on the CPU against
    the reference: config 5 (4 logdirs per broker, 4 broken; Disk
    capacity + Disk usage distribution) and the remove-broker drain
    (brokers 0 and 100 killed) under the six hard goals.  Marked slow:
    the reference takes minutes for them on a CPU."""
    spec = dict(num_brokers=200, num_partitions=20_000,
                replication_factor=3, num_racks=8, num_topics=10, seed=4,
                skew_fraction=0.2)
    if which == "config5":
        spec.update(jbod_disks=4, dead_disks=4)
        names, kill = C5_GOALS, ()
    else:
        names, kill = JR_HARD, (0, 100)
    js, jt, ps, pt = _both(spec)
    for b in kill:
        js = JS.set_broker_state(js, b, alive=False)
        ps = S.set_broker_state(ps, b, alive=False)
    jres = JOptimizer(j_default_goals(max_rounds=192, names=names)
                      ).optimizations(js, jt)
    pres = GoalOptimizer(default_goals(max_rounds=192, names=names)
                         ).optimizations(ps, pt, device="cpu")
    _assert_same_solve(jres, pres)
    checks.verify_result(ps, pres, pt)
