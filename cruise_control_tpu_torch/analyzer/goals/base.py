"""Goal SPI and acceptance stacking (port of cruise_control_tpu/analyzer/
goals/base.py).

A goal is a stateless object: `optimize_cached` runs its round loop (a
host-driven loop here, `run_phase_sweeps`), and `accept_move` /
`accept_swap` return boolean masks that other goals' searches AND
together (acceptance stacking).
"""
from __future__ import annotations

import abc
import threading
from typing import Callable, Optional, Sequence

import torch

from cruise_control_tpu_torch.analyzer.context import (OptimizationContext,
                                                       RoundCache,
                                                       make_round_cache)
from cruise_control_tpu_torch.model.state import ClusterState


class OptimizationFailure(Exception):
    """A hard goal could not be satisfied, or a goal regressed its
    statistic on a healthy cluster."""


def _ones(*shapes, device) -> torch.Tensor:
    return torch.ones(torch.broadcast_shapes(*shapes), dtype=torch.bool,
                      device=device)


class Goal(abc.ABC):
    """Pluggable optimization goal."""

    name: str = "goal"
    is_hard: bool = False
    max_rounds: int = 64
    #: whether accept_move depends on the replica's SOURCE broker
    source_side_acceptance: bool = True

    def rounds_for(self, ctx: OptimizationContext) -> int:
        """Round budget; fast mode quarters it for soft goals."""
        if ctx.fast_mode and not self.is_hard:
            return min(self.max_rounds, max(8, self.max_rounds // 4))
        return self.max_rounds

    def optimize(self, state: ClusterState, ctx: OptimizationContext,
                 prev_goals: Sequence["Goal"]) -> ClusterState:
        """Rebalance `state` for this goal.  A goal implements this or
        `optimize_cached`; each default bridges to the other."""
        return self.optimize_cached(state, ctx, prev_goals, None)[0]

    def optimize_cached(self, state: ClusterState, ctx: OptimizationContext,
                        prev_goals: Sequence["Goal"],
                        cache: Optional[RoundCache] = None):
        """(state', cache') — optimize with RoundCache threading.  The
        default bridges to `optimize` and returns cache' None, which
        tells the optimizer to rebuild the cache."""
        if type(self).optimize is Goal.optimize:
            raise TypeError(f"{type(self).__name__} implements neither "
                            "optimize nor optimize_cached")
        return self.optimize(state, ctx, prev_goals), None

    def accept_move(self, state, ctx, cache, replica, dest_broker):
        """bool mask (broadcast of the two index shapes): would this goal
        still accept moving `replica` to `dest_broker`?"""
        return _ones(replica.shape, dest_broker.shape, device=replica.device)

    def accept_leadership(self, state, ctx, cache, src_replica,
                          dest_replica):
        """bool mask: acceptance of a leadership transfer src -> dest
        replica."""
        return _ones(src_replica.shape, dest_replica.shape,
                     device=src_replica.device)

    def accept_swap(self, state, ctx, cache, out_replica, in_replica):
        """bool mask: acceptance of exchanging the two replicas; by
        default both directions must pass accept_move."""
        b_in = state.replica_broker[in_replica]
        b_out = state.replica_broker[out_replica]
        return (self.accept_move(state, ctx, cache, out_replica, b_in)
                & self.accept_move(state, ctx, cache, in_replica, b_out))

    def move_headroom_terms(self, state, ctx, cache):
        """`(key, w f32[R], dest_headroom f32[B], src_headroom | None)`
        terms of the strict acceptance branch for cumulative multi-commit
        gating; `[]` means no cross-action accumulation, None (default)
        means inexpressible (single commit per broker)."""
        return None

    def leadership_headroom_terms(self, state, ctx, cache):
        """Like move_headroom_terms, for leadership transfers: `w` f32[R]
        is the load that arrives with leadership of a replica's
        partition, indexed by the promoted replica on the destination
        side and the demoted leader on the source side.  None (default)
        switches the leadership search to single-commit mode."""
        return None

    def violated_brokers(self, state, ctx, cache) -> torch.Tensor:
        """bool[B] — brokers currently violating this goal."""
        return torch.zeros(state.num_brokers, dtype=torch.bool,
                           device=state.device)

    def no_work(self, state, ctx, cache) -> Optional[torch.Tensor]:
        """bool 0-d — True when optimize_cached would be an identity that
        reports 0 rounds; None means "always run"."""
        return None

    def stats_not_worse(self, before, after):
        """Did optimization avoid regressing this goal's statistic?"""
        return True

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return f"<{type(self).__name__} {self.name}>"


# ---------------------------------------------------------------------------
# Round-count instrumentation
# ---------------------------------------------------------------------------

_ROUND_SINK = threading.local()


def set_round_sink(sink) -> None:
    """Install `sink` (a list) to collect round counters; None removes."""
    _ROUND_SINK.value = sink


def note_rounds(rounds: int, converged_at: Optional[int] = None) -> None:
    """Report a goal loop's round count and the round index at which it
    last committed work (defaults to `rounds`)."""
    sink = getattr(_ROUND_SINK, "value", None)
    if sink is not None:
        sink.append((int(rounds), int(rounds if converged_at is None
                                      else converged_at)))


def collapse_sink(sink):
    """(total_rounds, converged_at) over a goal's sink entries, loops run
    in sequence: a later loop that committed nothing does not advance
    convergence past an earlier loop's last commit."""
    total = 0
    conv = 0
    for entry in sink:
        r, c = entry if isinstance(entry, tuple) else (entry, entry)
        if c > 0:
            conv = total + c
        total += r
    return total, conv


def run_phase_sweeps(state: ClusterState, phases, max_rounds: int,
                     table_slots: int = 0,
                     ctx: Optional[OptimizationContext] = None,
                     cache: Optional[RoundCache] = None):
    """Run a goal's phases as progress-gated sub-loops inside an outer
    sweep loop, driven from the host.  `phases` holds `(body,
    work_exists[, per_sweep_cap])`; `body(state, cache) -> (state, cache,
    committed)`.  Each phase loops while it commits, its work predicate
    holds and its cap allows; the sweep repeats while any phase
    committed; `max_rounds` caps the total.  Returns (state, cache)."""
    if cache is None:
        cache = make_round_cache(state, table_slots, ctx)
    rounds = 0
    last_commit = 0
    sweep_again = True
    while sweep_again and rounds < max_rounds:
        sweep_again = False
        for entry in phases:
            body_fn, work_fn = entry[0], entry[1]
            cap = entry[2] if len(entry) > 2 else None
            local = 0
            progressed = True
            while (progressed and rounds < max_rounds
                   and (cap is None or local < cap)
                   and bool(work_fn(state, cache))):
                state, cache, committed = body_fn(state, cache)
                progressed = bool(committed)
                rounds += 1
                local += 1
                if progressed:
                    last_commit = rounds
                    sweep_again = True
    note_rounds(rounds, converged_at=last_commit)
    return state, cache


def run_rounds(state: ClusterState, cache: RoundCache, round_body,
               work_exists, max_rounds: int):
    """A goal's single round loop, driven from the host: `round_body`
    (state, cache) -> (state, cache, committed) runs while the previous
    round committed, `work_exists(state, cache)` holds and the budget
    allows; the rounds are reported.  Returns (state, cache)."""
    rounds = last_commit = 0
    progressed = True
    while (progressed and rounds < max_rounds
           and bool(work_exists(state, cache))):
        state, cache, progressed = round_body(state, cache)
        rounds += 1
        if progressed:
            last_commit = rounds
    note_rounds(rounds, converged_at=last_commit)
    return state, cache


def shed_rows(cache: RoundCache, w_rows, src_ok_b, excess_b,
              require_positive: bool = True,
              strict: bool = False) -> torch.Tensor:
    """[B, S] NEG-masked shed-score plane from the resident aux tables."""
    from cruise_control_tpu_torch.analyzer import kernels
    ok = cache.table_ok & src_ok_b[:, None]
    if require_positive:
        ok = ok & (w_rows > 0.0)
    if strict:
        ok = ok & (w_rows <= excess_b[:, None])
    sc = torch.where(w_rows <= excess_b[:, None], w_rows, -w_rows)
    return torch.where(ok, sc, torch.full((), kernels.NEG,
                                          device=w_rows.device))


def leader_shed_rows(cache: RoundCache, value_rows, src_ok_b,
                     excess_b) -> torch.Tensor:
    """[B, S] NEG-masked plane of leadership-transfer candidates: leaders
    with a positive transferable value on source brokers, shed-scored
    against the row's excess."""
    from cruise_control_tpu_torch.analyzer import kernels
    ok = (cache.table_ok & cache.table_leader & src_ok_b[:, None]
          & (value_rows > 0.0))
    sc = torch.where(value_rows <= excess_b[:, None], value_rows,
                     -value_rows)
    return torch.where(ok, sc, torch.full((), kernels.NEG,
                                          device=value_rows.device))


def balancedness_cost_by_goal(ordered_names: Sequence[str], hard_names,
                              priority_weight: float = 1.1,
                              strictness_weight: float = 1.5) -> dict:
    """{goal name: cost} summing to 100 — the rank-weighted balancedness
    cost; `ordered_names` is highest-priority first."""
    if not ordered_names:
        return {}
    if priority_weight <= 0 or strictness_weight <= 0:
        raise ValueError("balancedness weights must be positive")
    hard = set(hard_names)
    costs = {}
    prev = 1.0 / priority_weight
    for name in reversed(list(ordered_names)):
        cur = priority_weight * prev
        costs[name] = cur * (strictness_weight if name in hard else 1.0)
        prev = cur
    total = sum(costs.values())
    return {n: 100.0 * c / total for n, c in costs.items()}


def dest_side_only(prev_goals: Sequence[Goal]) -> bool:
    """True when every previously-optimized goal's move acceptance is
    destination-side."""
    return all(not g.source_side_acceptance for g in prev_goals)


def new_broker_dest_mask(state: ClusterState,
                         base: torch.Tensor) -> torch.Tensor:
    """When new brokers exist, balancing actions target only them."""
    any_new = torch.any(state.broker_new)
    return torch.where(any_new, base & state.broker_new, base)


def compose_move_acceptance(goals: Sequence[Goal], state, ctx, cache
                            ) -> Callable:
    """AND of accept_move over `goals`."""
    def fn(replica, dest_broker):
        ok = _ones(replica.shape, dest_broker.shape, device=replica.device)
        for goal in goals:
            ok = ok & goal.accept_move(state, ctx, cache, replica,
                                       dest_broker)
        return ok
    return fn


def compose_swap_acceptance(goals: Sequence[Goal], state, ctx, cache
                            ) -> Callable:
    """AND of accept_swap over `goals`."""
    def fn(out_replica, in_replica):
        ok = _ones(out_replica.shape, in_replica.shape,
                   device=out_replica.device)
        for goal in goals:
            ok = ok & goal.accept_swap(state, ctx, cache, out_replica,
                                       in_replica)
        return ok
    return fn


def _merge_terms(term_lists):
    """Merge `(key, w, dest_hr, src_hr)` terms across goals by key with
    the elementwise-min headroom; None if any goal opted out."""
    merged = {}
    order = []
    for terms in term_lists:
        if terms is None:
            return None
        for key, w, d_hr, s_hr in terms:
            if key not in merged:
                merged[key] = [w, d_hr, s_hr]
                order.append(key)
            else:
                ent = merged[key]
                ent[1] = torch.minimum(ent[1], d_hr)
                if s_hr is not None:
                    ent[2] = (s_hr if ent[2] is None
                              else torch.minimum(ent[2], s_hr))
    return [(merged[k][0], merged[k][1], merged[k][2]) for k in order]


def compose_move_headrooms(goals: Sequence[Goal], state, ctx, cache):
    """Merged move_headroom_terms over `goals`."""
    return _merge_terms([g.move_headroom_terms(state, ctx, cache)
                         for g in goals])


def move_commit_terms(goals: Sequence[Goal], state, ctx, cache):
    """(dest_terms, src_terms) for move_round's multi-commit mode, or
    (None, None) when any prior goal's acceptance is not quantitative."""
    terms = compose_move_headrooms(goals, state, ctx, cache)
    if terms is None:
        return None, None
    return ([(w, d) for (w, d, s) in terms],
            [(w, s) for (w, d, s) in terms if s is not None])


def compose_leadership_headrooms(goals: Sequence[Goal], state, ctx, cache):
    """Merged leadership_headroom_terms over `goals`."""
    return _merge_terms([g.leadership_headroom_terms(state, ctx, cache)
                         for g in goals])


def leadership_commit_terms(goals: Sequence[Goal], state, ctx, cache):
    """(dest_terms, src_terms) for leadership_round's multi-commit mode,
    or (None, None) when any prior goal's leadership acceptance is not
    quantitative."""
    terms = compose_leadership_headrooms(goals, state, ctx, cache)
    if terms is None:
        return None, None
    return ([(w, d) for (w, d, s) in terms],
            [(w, s) for (w, d, s) in terms if s is not None])


def compose_leadership_acceptance(goals: Sequence[Goal], state, ctx, cache
                                  ) -> Callable:
    """AND of accept_leadership over `goals`."""
    def fn(src_replica, dest_replica):
        ok = _ones(src_replica.shape, dest_replica.shape,
                   device=src_replica.device)
        for goal in goals:
            ok = ok & goal.accept_leadership(state, ctx, cache, src_replica,
                                             dest_replica)
        return ok
    return fn
