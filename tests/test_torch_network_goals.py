"""The network goals of the PyTorch port against the JAX reference, on the
CPU: `PotentialNwOutGoal` and `LeaderBytesInDistributionGoal`
(cruise_control_tpu_torch/analyzer/goals/network.py).

Each goal alone from the same start state, then behind a prefix of prior
goals whose acceptance and headroom terms compose with it, then its
function-level methods on random inputs, with the equalities of
tests/test_torch_count_goals.py.  Last, a forced self-regression in
`LeaderBytesInDistributionGoal`: every step that changes a leader flag
counts as a regression, so the sweep's first round and the first
leadership round are both rejected; the state and the cache must come
back exactly as the goal got them, and the cache must equal a rebuild.
"""
import pytest
import torch

from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer import kernels as K
from cruise_control_tpu_torch.analyzer.goals import base as B
from cruise_control_tpu_torch.analyzer.goals.network import \
    LeaderBytesInDistributionGoal
from cruise_control_tpu_torch.testing import checks
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)
from test_torch_count_goals import (SPEC, TIGHT_NW_OUT,
                                    assert_predicates_match, _check_solve,
                                    predicate_setup)  # noqa: F401
from test_torch_hard_goals import _solve_both

#: goal -> (prior goals, spec, constraint)
BEHIND = {
    "PotentialNwOutGoal": (["ReplicaDistributionGoal"], SPEC, TIGHT_NW_OUT),
    "LeaderBytesInDistributionGoal": (
        ["NetworkOutboundUsageDistributionGoal",
         "LeaderReplicaDistributionGoal"], SPEC, {}),
}


@pytest.mark.parametrize("name", list(BEHIND))
def test_network_goal_alone_matches(name):
    js, jres, ps, pt, pres = _solve_both(SPEC, [name])
    _check_solve(js, jres, ps, pt, pres, name)
    before, own, _ = pres.violated_broker_counts[name]
    assert before > 0 and own == 0
    if name == "LeaderBytesInDistributionGoal":
        assert pres.num_leadership_movements > 0
    else:
        assert pres.num_replica_movements > 0


@pytest.mark.parametrize("name", list(BEHIND))
def test_network_goal_behind_prior_goals_matches(name):
    prior, spec, constraint = BEHIND[name]
    js, jres, ps, pt, pres = _solve_both(spec, prior + [name], constraint)
    _check_solve(js, jres, ps, pt, pres, name)


@pytest.mark.parametrize("name", list(BEHIND))
def test_network_goal_predicates_match(predicate_setup, name):  # noqa: F811
    assert_predicates_match(predicate_setup, name)


class _RegressOnAnyTransfer(LeaderBytesInDistributionGoal):
    """Counts 1000 more violated brokers for every leader flag that
    differs from the goal's input, so every committing step regresses."""

    def optimize_cached(self, state, ctx, prev_goals, cache=None):
        self._entry = state.replica_is_leader.clone()
        return super().optimize_cached(state, ctx, prev_goals, cache)

    def _violated_count(self, st, ctx, cache):
        moved = int((st.replica_is_leader != self._entry).sum())
        return super()._violated_count(st, ctx, cache) + 1000 * moved


def test_rejected_rounds_leave_state_and_cache_intact(monkeypatch):
    ps, pt = random_cluster(RandomClusterSpec(**SPEC), device="cpu")
    ctx = C.make_context(ps, C.BalancingConstraint(),
                         C.OptimizationOptions(), pt)
    cache = C.ensure_full_cache(ps, ctx, None)
    snapshot = {f: getattr(cache, f).clone() for f in C.CACHE_FIELDS}
    leaders = ps.replica_is_leader.clone()
    committed = []
    real_commit = K.commit_leadership_cached

    def counting_commit(st, ca, cand_r, cand_f, cand_v, **kw):
        committed.append(int((cand_v & (cand_r >= 0)).sum()))
        return real_commit(st, ca, cand_r, cand_f, cand_v, **kw)

    monkeypatch.setattr(K, "commit_leadership_cached", counting_commit)
    goal = _RegressOnAnyTransfer()
    sink = []
    B.set_round_sink(sink)
    try:
        state, out = goal.optimize_cached(ps, ctx, [], cache)
    finally:
        B.set_round_sink(None)
    # the sweep's first round and the first leadership round both
    # committed transfers, and both were rejected
    (sweep_rounds, sweep_conv), (rounds, conv) = sink
    assert (sweep_rounds, sweep_conv) == (1, 0)
    assert (rounds, conv) == (1, 0)
    assert committed and committed[0] > 0
    assert torch.equal(state.replica_is_leader, leaders)
    for f in C.CACHE_FIELDS:
        assert torch.equal(getattr(out, f), snapshot[f]), f
        assert torch.equal(getattr(cache, f), snapshot[f]), f
    assert checks.cache_mismatches(state, ctx, out) == []
