"""Non-default `OptimizationOptions` of the PyTorch port against the JAX
reference, on the CPU, and the options generator.

Config 2's four usage-distribution goals (Disk, NwIn, NwOut, Cpu) on the
16-broker `SPEC` of tests/test_torch_hard_goals.py, with each option
alone and in the combinations the facade sends: the add-broker request
(`requested_destination_broker_ids` = the new brokers), the self-healing
request for a goal violation (brokers excluded from leadership and from
replica moves, `is_triggered_by_goal_violation`), and the excluded-topics
pattern of the options generator over that triple.
`only_move_immigrant_replicas` runs on a cluster with new and dead
brokers, where the offline replicas and nothing else may move.  One
reference optimizer serves every case of the same static context, so the
reference compiles its goal programs once, and once more for
`fast_mode`, which is static in the reference.

Placement, leader flags, proposals, per-goal violated counts, rounds,
converged-at rounds and balancedness must be equal, the per-goal
statistics within 1e-6 relative (`_assert_same_solve`); each case also
checks that the option held in the port's solve.
"""
import dataclasses

import numpy as np
import pytest

from cruise_control_tpu.analyzer import context as JC
from cruise_control_tpu.analyzer import options_generator as JG
from cruise_control_tpu.analyzer.goals import registry as JR
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu.testing.verifier import verify_result as j_verify
from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer import options_generator as G
from cruise_control_tpu_torch.analyzer.goals import registry as R
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.testing import checks
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)
from test_torch_hard_goals import SPEC, _assert_same_solve

FOUR_GOALS = ["DiskUsageDistributionGoal",
              "NetworkInboundUsageDistributionGoal",
              "NetworkOutboundUsageDistributionGoal",
              "CpuUsageDistributionGoal"]
MAX_ROUNDS = 32
#: 14 brokers and 2 new (the same shapes as SPEC)
ADD = dict(SPEC, num_brokers=14, new_brokers=2)
#: the same with two dead brokers: their replicas are offline, so
#: immigrant-only requests have replicas to move
ADD_DEAD = dict(ADD, dead_brokers=2)
HEAL = dict(excluded_brokers_for_leadership=frozenset({3, 11}),
            excluded_brokers_for_replica_move=frozenset({6, 13}),
            is_triggered_by_goal_violation=True)
#: (spec, options) of each case; "new" stands for the spec's new brokers
CASES = {
    "excluded topics": (SPEC, dict(
        excluded_topics=frozenset({"topic-0", "topic-3"}))),
    "excluded for leadership": (SPEC, dict(
        excluded_brokers_for_leadership=frozenset({0, 5, 9}))),
    "excluded for replica moves": (SPEC, dict(
        excluded_brokers_for_replica_move=frozenset({2, 9}))),
    "requested destinations": (SPEC, dict(
        requested_destination_broker_ids=frozenset({1, 4, 7, 12}))),
    "triggered by goal violation": (SPEC, dict(
        is_triggered_by_goal_violation=True)),
    "self-healing triple": (SPEC, HEAL),
    "excluded topics over the triple": (SPEC, dict(
        HEAL, excluded_topics=frozenset({"topic-0", "topic-3"}))),
    "add-broker request": (ADD, dict(
        requested_destination_broker_ids="new")),
    "immigrant replicas only": (ADD_DEAD, dict(
        only_move_immigrant_replicas=True)),
    "immigrants to the new brokers": (ADD_DEAD, dict(
        only_move_immigrant_replicas=True,
        requested_destination_broker_ids="new")),
}


def _options(module, spec: dict, kw: dict):
    kw = dict(kw)
    if kw.get("requested_destination_broker_ids") == "new":
        kw["requested_destination_broker_ids"] = frozenset(
            range(spec["num_brokers"],
                  spec["num_brokers"] + spec["new_brokers"]))
    return module.OptimizationOptions(**kw)


def solve_both(j_opt, spec: dict, kw: dict, goals=FOUR_GOALS):
    """(js, jres, ps, pt, pres, options) of one request in both
    packages."""
    js, jt = j_random_cluster(JSpec(**spec))
    jres = j_opt.optimizations(js, jt, _options(JC, spec, kw))
    jres._topology = jt
    ps, pt = random_cluster(RandomClusterSpec(**spec), device="cpu")
    opts = _options(C, spec, kw)
    pres = GoalOptimizer(R.default_goals(MAX_ROUNDS, goals)).optimizations(
        ps, pt, opts, device="cpu")
    return js, jres, ps, pt, pres, opts


@pytest.fixture(scope="module")
def j_optimizer():
    return JOptimizer(JR.default_goals(max_rounds=MAX_ROUNDS,
                                       names=FOUR_GOALS))


def _moved(ps, pres) -> np.ndarray:
    return (pres.final_state.replica_broker.numpy()
            != ps.replica_broker.numpy()) & ps.replica_valid.numpy()


def _check_destinations(ps, pres, opts) -> None:
    """Replicas arrive only on allowed brokers, but for a swap's reverse
    leg: a swap round holds its cold side to the destination mask and
    hands the cold broker's replica to the hot broker unchecked
    (`swap_round` in both packages), so a broker that may not receive
    replicas may still take one for each replica it gives away."""
    num_b = ps.num_brokers
    allowed = np.ones(num_b, dtype=bool)
    allowed[sorted(opts.excluded_brokers_for_replica_move)] = False
    if opts.requested_destination_broker_ids:
        req = np.zeros(num_b, dtype=bool)
        req[sorted(opts.requested_destination_broker_ids)] = True
        allowed &= req
    moved = _moved(ps, pres)
    before = ps.replica_broker.numpy()[moved]
    after = pres.final_state.replica_broker.numpy()[moved]
    arrivals = np.bincount(after, minlength=num_b)
    departures = np.bincount(before, minlength=num_b)
    assert (arrivals[~allowed] <= departures[~allowed]).all()


def _check_option_held(ps, pt, pres, opts) -> None:
    """The request's own constraints on the port's final state."""
    before = ps.replica_broker.numpy()
    after = pres.final_state.replica_broker.numpy()
    moved = _moved(ps, pres)
    topic_of_r = ps.partition_topic.numpy()[ps.replica_partition.numpy()]
    for name in opts.excluded_topics:
        assert not moved[topic_of_r == pt.topics.index(name)].any(), name
    _check_destinations(ps, pres, opts)
    lead_before = ps.replica_is_leader.numpy()
    lead_after = pres.final_state.replica_is_leader.numpy()
    # leadership transfers (a replica that stayed and became leader); a
    # leader replica may still move onto such a broker, in both packages
    gained = lead_after & ~lead_before & ~moved
    excl = np.asarray(sorted(opts.excluded_brokers_for_leadership))
    assert not np.isin(after[gained], excl).any()
    if opts.only_move_immigrant_replicas:
        offline = ps.replica_offline.numpy()
        on_new = ps.broker_new.numpy()[before]
        assert not moved[~(offline | on_new)].any()
    checks.verify_result(ps, pres, pt)


@pytest.mark.parametrize("case", list(CASES))
def test_option_matches_reference(case, j_optimizer):
    spec, kw = CASES[case]
    js, jres, ps, pt, pres, opts = solve_both(j_optimizer, spec, kw)
    _assert_same_solve(jres, pres)
    assert jres.violated_goals_before == pres.violated_goals_before
    assert jres.regressed_goals == pres.regressed_goals
    assert _moved(ps, pres).any(), "the request moved no replica"
    j_verify(js, jres)
    _check_option_held(ps, pt, pres, opts)


def test_immigrant_request_moves_only_offline_replicas(j_optimizer):
    """On ADD_DEAD no replica sits on a new broker, so an immigrant-only
    solve moves the offline replicas and nothing else; it differs from
    the unrestricted solve."""
    spec, kw = CASES["immigrant replicas only"]
    _, _, ps, _, pres, _ = solve_both(j_optimizer, spec, kw)
    moved = _moved(ps, pres)
    offline = ps.replica_offline.numpy()
    assert offline.any() and moved[offline].all()
    assert not moved[~offline].any()
    assert pres.heal_moves == int(offline.sum())


def test_fast_mode_matches_reference():
    """`fast_mode` (static in the reference: its own compile) quarters
    the soft goals' round budget and skips the swap fallback: fewer
    rounds than the same solve without it."""
    j_opt = JOptimizer(JR.default_goals(max_rounds=MAX_ROUNDS,
                                        names=FOUR_GOALS))
    js, jres, ps, pt, pres, opts = solve_both(j_opt, SPEC,
                                              dict(fast_mode=True))
    _assert_same_solve(jres, pres)
    j_verify(js, jres)
    _check_option_held(ps, pt, pres, opts)
    full = GoalOptimizer(R.default_goals(MAX_ROUNDS, FOUR_GOALS)
                         ).optimizations(ps, pt, device="cpu")
    assert (sum(pres.rounds_by_goal[g] for g in FOUR_GOALS)
            < sum(full.rounds_by_goal[g] for g in FOUR_GOALS))


@pytest.mark.parametrize("pattern", ["topic-[03]", "topic-1.*", "", "none"])
@pytest.mark.parametrize("given", [frozenset(), frozenset({"topic-5"})])
def test_options_generator_matches_reference(pattern, given):
    """The same options out of both generators: the pattern's whole
    matches over the topology's topics, merged into the request's own."""
    _, jt = j_random_cluster(JSpec(**SPEC))
    _, pt = random_cluster(RandomClusterSpec(**SPEC), device="cpu")
    jo = JG.DefaultOptimizationOptionsGenerator(pattern).generate(
        JC.OptimizationOptions(excluded_topics=given), jt)
    po = G.DefaultOptimizationOptionsGenerator(pattern).generate(
        C.OptimizationOptions(excluded_topics=given), pt)
    assert dataclasses.asdict(jo) == dataclasses.asdict(po)
    assert G.OptimizationOptionsGenerator().generate(po, pt) is po
    assert G.DefaultOptimizationOptionsGenerator(pattern).generate(po) is po
    if pattern == "topic-[03]":
        assert po.excluded_topics == given | {"topic-0", "topic-3"}
