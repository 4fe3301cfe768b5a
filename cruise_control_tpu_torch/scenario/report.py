"""Scenario ranking and the diff against the base solve (port of
cruise_control_tpu/scenario/report.py).

Turns a `ScenarioBatchResult` into the SCENARIOS response body: the
scenarios best first (feasible before infeasible, then fewer goals left
violated, then balancedness, then movement cost), each with its delta
against the base solve (the no-op scenario the facade puts first).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from cruise_control_tpu_torch.scenario.engine import (BASE_SCENARIO_NAME,
                                                      ScenarioBatchResult,
                                                      ScenarioOutcome)


def balancedness_score(goal_names: List[str], hard_goal_names: frozenset,
                       violated_after: List[str],
                       weights: Tuple[float, float]) -> float:
    """[0, 100]: `OptimizerResult.balancedness_score` over plain lists."""
    from cruise_control_tpu_torch.analyzer.goals.base import \
        balancedness_cost_by_goal
    if not goal_names:
        return 100.0
    pw, sw = weights
    costs = balancedness_cost_by_goal(goal_names, hard_goal_names, pw, sw)
    violated = set(violated_after)
    kept = sum(c for n, c in costs.items() if n not in violated)
    total = sum(costs.values())
    return 100.0 * kept / total if total else 100.0


def rank(outcomes: List[ScenarioOutcome]) -> List[ScenarioOutcome]:
    """Best first; the base scenario ranks with the rest."""
    def key(o: ScenarioOutcome):
        return (not o.feasible,
                len(o.violated_goals_after),
                -o.balancedness,
                o.data_to_move,
                o.num_replica_moves,
                o.spec.name)
    return sorted(outcomes, key=key)


def _stat(value) -> Optional[float]:
    if value is None:
        return None
    v = float(np.asarray(value))
    return None if not np.isfinite(v) else round(v, 6)


def _stats_json(stats) -> dict:
    if stats is None:
        return {}
    util_std = np.asarray(stats.util_std, dtype=float)
    util_max = np.asarray(stats.util_max, dtype=float)
    names = ("cpu", "nw_in", "nw_out", "disk")
    return {
        "utilStd": {n: _stat(util_std[i]) for i, n in enumerate(names)},
        "utilMax": {n: _stat(util_max[i]) for i, n in enumerate(names)},
        "replicaCountStd": _stat(stats.replica_count_std),
        "leaderCountStd": _stat(stats.leader_count_std),
        "numAliveBrokers": int(np.asarray(stats.num_alive_brokers)),
        "numOfflineReplicas": int(np.asarray(stats.num_offline_replicas)),
    }


def outcome_json(o: ScenarioOutcome, base: Optional[ScenarioOutcome],
                 verbose: bool = False) -> dict:
    out: dict = {
        "name": o.spec.name,
        "feasible": o.feasible,
        "rung": o.rung,
        "balancedness": round(o.balancedness, 3),
        "numReplicaMoves": o.num_replica_moves,
        "numLeadershipMoves": o.num_leadership_moves,
        "dataToMoveMB": round(o.data_to_move / 1e6, 3),
        "violatedGoalsBefore": list(o.violated_goals_before),
        "violatedGoalsAfter": list(o.violated_goals_after),
        "statsAfter": _stats_json(o.stats_after),
    }
    if not o.feasible:
        out["reason"] = o.reason
    if base is not None and base is not o:
        out["vsBase"] = {
            "balancednessDelta": round(o.balancedness - base.balancedness,
                                       3),
            "violatedGoalsAfterDelta": (len(o.violated_goals_after)
                                        - len(base.violated_goals_after)),
            "dataToMoveDeltaMB": round(
                (o.data_to_move - base.data_to_move) / 1e6, 3),
            "numReplicaMovesDelta": (o.num_replica_moves
                                     - base.num_replica_moves),
        }
    if verbose:
        out["violatedBrokerCounts"] = {
            g: list(c) for g, c in o.violated_broker_counts.items()}
        out["roundsByGoal"] = dict(o.rounds_by_goal)
        out["statsBefore"] = _stats_json(o.stats_before)
        out["proposals"] = [p.to_json() for p in o.proposals]
    else:
        out["numProposals"] = len(o.proposals)
    return out


def batch_report(result: ScenarioBatchResult,
                 verbose: bool = False) -> Dict:
    """The SCENARIOS response body (a dry-run analysis: never an
    execution id)."""
    base = result.outcome(BASE_SCENARIO_NAME)
    ranked = rank(result.outcomes)
    return {
        "scenarios": [outcome_json(o, base, verbose=verbose)
                      for o in ranked if o.spec.name != BASE_SCENARIO_NAME],
        "base": (outcome_json(base, None, verbose=verbose)
                 if base is not None else None),
        "batch": {
            "numScenarios": len(result.outcomes),
            "rung": result.rung,
            "oomHalvings": result.oom_halvings,
            "deviceBatchSizes": list(result.batch_sizes),
            "compileS": round(result.compile_s, 3),
            "solveS": round(result.solve_s, 3),
            "durationS": round(result.duration_s, 3),
        },
        "dryRun": True,
        "version": 1,
    }
