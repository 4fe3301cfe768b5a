"""The intra-broker (JBOD) path of the PyTorch port against the JAX
reference, on the CPU.

Function by function: `disk_load`, `apply_disk_moves` (same-broker check,
no-op rows, offline flags) and one `_disk_move_round`; each intra-broker
goal alone on the reference's `jbod_skewed` fixture; then both goals
through `GoalOptimizer` on a 16-broker cluster with 4 logdirs per broker,
without and with a broken logdir (self-healing first).  The random
clusters carry no load skew: with skewed brokers above 0.8 of their whole
logdir capacity no intra-broker move can satisfy the hard capacity goal,
and the reference aborts the solve.

Integers and booleans must match exactly (logdirs, offline flags,
placements, proposals with logdirs, rounds, violated counts); the logdir
loads bit for bit (the same ordered sums); per-goal statistics within
1e-6 relative (about 8 float32 ulps: inside the reference's fused goal
programs XLA may order a small reduction differently, as in
tests/test_torch_slice.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_intra_broker import jbod_skewed

from cruise_control_tpu.analyzer import context as JC
from cruise_control_tpu.analyzer.goals import intra_broker as JI
from cruise_control_tpu.analyzer.goals import registry as JR
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.model import state as JS
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu.testing.verifier import verify_result as j_verify
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer.goals import intra_broker as I
from cruise_control_tpu_torch.analyzer.goals import registry as R
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model.state import STATE_FIELDS
from cruise_control_tpu_torch.testing import checks
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)

JBOD = dict(num_brokers=16, num_partitions=400, replication_factor=3,
            num_racks=4, num_topics=8, seed=0, skew_fraction=0.0,
            jbod_disks=4)


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    assert np.array_equal(a, b), what


def _port_state(js):
    return convert.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS},
        num_racks=js.num_racks, num_hosts=js.num_hosts,
        num_topics=js.num_topics, device="cpu")


def _contexts(js, jt, ps):
    jctx = JC.make_context(js, JC.BalancingConstraint(),
                           JC.OptimizationOptions(), jt)
    pctx = C.make_context(ps, C.BalancingConstraint(),
                          C.OptimizationOptions())
    return jctx, pctx


@pytest.fixture(scope="module")
def jbod():
    js, jt = j_random_cluster(JSpec(**JBOD))
    ps, pt = random_cluster(RandomClusterSpec(**JBOD), device="cpu")
    return js, jt, ps, pt


def test_disk_load_matches(jbod):
    js, _, ps, _ = jbod
    _eq(JS.disk_load(js), S.disk_load(ps), "disk_load")
    js2 = JS.mark_disk_dead(js, 5)
    ps2 = S.mark_disk_dead(ps, 5)
    _eq(JS.disk_load(js2), S.disk_load(ps2), "disk_load, a dead logdir")


def test_apply_disk_moves_matches(jbod):
    js, _, ps, _ = jbod
    js = JS.mark_disk_dead(JS.set_broker_state(js, 3, alive=False), 9)
    ps = S.mark_disk_dead(S.set_broker_state(ps, 3, alive=False), 9)
    rng = np.random.default_rng(2)
    n = 200
    reps = rng.choice(ps.num_replicas, n, replace=False).astype(np.int32)
    # half the targets on the replica's own broker (dead logdirs, its own
    # logdir and dead brokers among them), half anywhere
    disks_per_b = ps.num_disks // ps.num_brokers
    own = (np.asarray(js.replica_broker)[reps] * disks_per_b
           + rng.integers(0, disks_per_b, n))
    anywhere = rng.integers(0, ps.num_disks, n)
    dest = np.where(rng.random(n) < 0.5, own, anywhere).astype(np.int32)
    valid = rng.random(n) < 0.8
    jout = JS.apply_disk_moves(js, jnp.asarray(reps), jnp.asarray(dest),
                               jnp.asarray(valid))
    pout = S.apply_disk_moves(ps, torch.from_numpy(reps),
                              torch.from_numpy(dest), torch.from_numpy(valid))
    for f in STATE_FIELDS:
        _eq(getattr(jout, f), getattr(pout, f), f)
    moved = pout.replica_disk != ps.replica_disk
    assert moved.any() and (pout.replica_offline != ps.replica_offline).any()


@pytest.mark.parametrize("goal", ["capacity", "distribution"])
def test_disk_move_round_matches(jbod, goal):
    js, jt, ps, _ = jbod
    jctx, pctx = _contexts(js, jt, ps)
    if goal == "capacity":
        j_lim = js.disk_capacity * 0.8
        p_lim = ps.disk_capacity * 0.8
        j_over, j_bound = JS.disk_load(js) - j_lim, j_lim
        p_over, p_bound = S.disk_load(ps) - p_lim, p_lim
    else:
        jd, ju, jl = JI.IntraBrokerDiskUsageDistributionGoal()._bounds(js)
        pd, pu, pl = I.IntraBrokerDiskUsageDistributionGoal()._bounds(ps)
        _eq(jd, pd, "dload")
        _eq(ju, pu, "upper")
        _eq(jl, pl, "lower")
        j_over, j_bound = jd - (ju + jl) / 2.0, ju
        p_over, p_bound = pd - (pu + pl) / 2.0, pu
    j_st, j_any = JI._disk_move_round(js, jctx, j_over, j_bound)
    p_st, p_any = I._disk_move_round(ps, pctx, p_over, p_bound)
    assert bool(j_any) and bool(p_any)
    for f in ("replica_disk", "replica_offline", "replica_broker"):
        _eq(getattr(j_st, f), getattr(p_st, f), f)


@pytest.mark.parametrize("name,kwargs,sizes", [
    ("IntraBrokerDiskCapacityGoal", dict(capacity_threshold=0.8),
     (400.0, 300.0, 200.0)),
    ("IntraBrokerDiskUsageDistributionGoal", dict(balance_margin=0.2),
     (300.0, 280.0, 260.0, 240.0))])
def test_goal_alone_on_jbod_skewed_matches(name, kwargs, sizes):
    js, jt = jbod_skewed(sizes=sizes)
    ps = _port_state(js)
    jctx, pctx = _contexts(js, jt, ps)
    jgoal = JR.GOAL_CLASSES[name](**kwargs)
    pgoal = R.GOAL_CLASSES[name](**kwargs)
    jcache = JC.make_round_cache(js)
    pcache = C.make_round_cache(ps)
    _eq(jgoal.violated_brokers(js, jctx, jcache),
        pgoal.violated_brokers(ps, pctx, pcache), "violated before")
    jout = jgoal.optimize(js, jctx, ())
    pout, cache = pgoal.optimize_cached(ps, pctx, (), pcache)
    assert cache is None            # optimize-only: the optimizer rebuilds
    for f in STATE_FIELDS:
        _eq(getattr(jout, f), getattr(pout, f), f)
    _eq(JS.disk_load(jout), S.disk_load(pout), "disk_load after")
    _eq(jgoal.violated_brokers(jout, jctx, JC.make_round_cache(jout)),
        pgoal.violated_brokers(pout, pctx, C.make_round_cache(pout)),
        "violated after")
    assert (pout.replica_disk != ps.replica_disk).any()


def _proposals(result):
    return {(str(p.partition),
             tuple((r.broker_id, r.logdir) for r in p.old_replicas),
             tuple((r.broker_id, r.logdir) for r in p.new_replicas),
             p.new_leader)
            for p in result.proposals}


@pytest.mark.parametrize("dead_disks", [0, 1])
def test_intra_broker_solve_matches(dead_disks):
    spec = dict(JBOD, dead_disks=dead_disks)
    names = R.INTRA_BROKER_GOALS
    js, jt = j_random_cluster(JSpec(**spec))
    jres = JOptimizer(JR.default_goals(names=names)).optimizations(js, jt)
    jres._topology = jt
    ps, pt = random_cluster(RandomClusterSpec(**spec), device="cpu")
    pres = GoalOptimizer(R.default_goals(names=names)).optimizations(
        ps, pt, device="cpu")
    for f in ("replica_broker", "replica_is_leader", "replica_disk",
              "replica_offline"):
        _eq(getattr(jres.final_state, f), getattr(pres.final_state, f), f)
    assert _proposals(jres) == _proposals(pres)
    assert jres.violated_broker_counts == pres.violated_broker_counts
    assert jres.entry_broker_counts == pres.entry_broker_counts
    assert jres.rounds_by_goal == pres.rounds_by_goal
    assert jres.converged_at_by_goal == pres.converged_at_by_goal
    assert jres.violated_goals_after == pres.violated_goals_after
    assert jres.balancedness_score() == pres.balancedness_score()
    for g, stats in pres.stats_by_goal.items():
        for f, v in vars(stats).items():
            a = np.asarray(getattr(jres.stats_by_goal[g], f))
            if v.dtype.is_floating_point:
                np.testing.assert_allclose(v.numpy(), a, rtol=1e-6,
                                           err_msg=f"{g} {f}")
            else:
                assert np.array_equal(a, v.numpy()), (g, f)
    j_verify(js, jres)
    checks.verify_result(ps, pres, pt)
    # logdir moves only (and self-healing's moves off the broken logdir)
    assert pres.heal_moves == 0 if not dead_disks else pres.heal_moves > 0
    before, own, _ = pres.violated_broker_counts[names[0]]
    assert before > 0 and own == 0
    dl = S.disk_load(pres.final_state)
    cap = pres.final_state.disk_capacity
    assert not bool(torch.any(pres.final_state.disk_alive
                              & (dl > 0.8 * cap)))
    intra = [p for p in pres.proposals if not p.has_replica_action
             and any(o.logdir != n.logdir
                     for o, n in zip(p.old_replicas, p.new_replicas))]
    assert intra
