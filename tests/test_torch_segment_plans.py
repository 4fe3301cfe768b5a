"""Segment plans and the host-side skip of the PyTorch port's
`GoalOptimizer` against the JAX reference, on the CPU.

The float aggregates of the round cache are refreshed at each segment's
entry, so the plan is part of a solve's result.  On the 8-broker cluster
of tests/test_torch_optimizer_args.py under `INCR_GOALS`: fixed-width
segments of 1, 2 and 4 goals, the fused plan (analyzer/fusion.py; here
the capacity pair, then the distribution pair) and the eager driver (one
goal a segment, every goal run with no no-work skip).  Each plan compiles
its own programs in the reference, so each case builds its own reference
optimizer.  Then the facade's fused solver with the host-side skip
(`solver.fusion.enabled`, `solver.host.skip.enabled`) re-solves a
converged placement: the capacity pair has no work, its segment is
skipped, and `skipped_goals`, rounds and stats must equal the
reference's.
"""
import pytest

from cruise_control_tpu.analyzer import optimizer as JO
from cruise_control_tpu.analyzer.goals import registry as JR
from cruise_control_tpu.testing.random_cluster import (
    RandomClusterSpec as JSpec, random_cluster as j_random_cluster)
from cruise_control_tpu_torch.analyzer import optimizer as O
from cruise_control_tpu_torch.analyzer.goals import registry as R
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)
from test_torch_hard_goals import _assert_same_solve
from test_torch_optimizer_args import INCR_GOALS, INCR_SPEC, MAX_ROUNDS

#: (constructor arguments, optimizations arguments, the plan)
PLANS = {
    "width 1": (dict(pipeline_segment_size=1), {},
                [(0, 1), (1, 2), (2, 3), (3, 4)]),
    "width 2": (dict(pipeline_segment_size=2), {}, [(0, 2), (2, 4)]),
    "width 4": (dict(pipeline_segment_size=4), {}, [(0, 4)]),
    "fused": (dict(fused_segments=True), {}, [(0, 2), (2, 4)]),
    "eager driver": ({}, dict(eager_driver=True),
                     [(0, 1), (1, 2), (2, 3), (3, 4)]),
}


@pytest.fixture(scope="module")
def clusters():
    js, jt = j_random_cluster(JSpec(**INCR_SPEC))
    ps, pt = random_cluster(RandomClusterSpec(**INCR_SPEC), device="cpu")
    return js, jt, ps, pt


@pytest.mark.parametrize("plan", list(PLANS))
def test_segment_plan_matches(plan, clusters):
    js, jt, ps, pt = clusters
    init_kw, call_kw, segments = PLANS[plan]
    p_opt = O.GoalOptimizer(R.default_goals(MAX_ROUNDS, INCR_GOALS),
                            **init_kw)
    assert p_opt._plan_segments(**call_kw) == segments
    jres = JO.GoalOptimizer(JR.default_goals(MAX_ROUNDS, INCR_GOALS),
                            **init_kw).optimizations(js, jt, **call_kw)
    jres._topology = jt
    pres = p_opt.optimizations(ps, pt, device="cpu", **call_kw)
    _assert_same_solve(jres, pres)
    assert pres.skipped_goals == jres.skipped_goals == []
    assert pres.num_replica_movements > 0


def test_host_side_skip_matches(clusters):
    """The fused plan with the host-side skip, on the converged placement
    of a first solve: the capacity segment is skipped in both packages."""
    js, jt, ps, pt = clusters
    kw = dict(fused_segments=True, host_side_skip=True)
    j_opt = JO.GoalOptimizer(JR.default_goals(MAX_ROUNDS, INCR_GOALS), **kw)
    p_opt = O.GoalOptimizer(R.default_goals(MAX_ROUNDS, INCR_GOALS), **kw)
    jfirst = j_opt.optimizations(js, jt)
    pfirst = p_opt.optimizations(ps, pt, device="cpu")
    assert pfirst.skipped_goals == jfirst.skipped_goals == []
    jres = j_opt.optimizations(jfirst.final_state, jt)
    jres._topology = jt
    pres = p_opt.optimizations(pfirst.final_state, pt, device="cpu")
    _assert_same_solve(jres, pres)
    assert pres.skipped_goals == jres.skipped_goals == INCR_GOALS[:2]
    for g in INCR_GOALS[:2]:
        assert pres.rounds_by_goal[g] == 0
        assert pres.entry_broker_counts[g] == 0
