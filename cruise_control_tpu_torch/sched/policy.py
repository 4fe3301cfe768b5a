"""Scheduling policy: priority classes, per-class admission caps,
deadline budgets and weighted anti-starvation aging (port of
cruise_control_tpu/sched/policy.py).

Four request classes share the one device, in strict base-priority order
with aging on top:

* ``ANOMALY_HEAL`` — self-healing solves (a broker just died);
* ``USER_INTERACTIVE`` — requests a user or their automation waits on;
* ``PRECOMPUTE`` — the background proposal precompute, preemptible at
  goal-segment boundaries;
* ``SCENARIO_SWEEP`` — what-if batches: preemptible, and foldable
  (compatible queued sweeps merge into one engine batch).

Effective priority = base class value minus aging credit: a request of
class *c* that has waited ``w`` seconds scores
``c - weight_c * (w / deadline_budget_c)`` (lower dispatches first), so a
class earns one class of credit per deadline budget waited, scaled by
its weight: sustained urgent traffic delays the background classes but
never starves them.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Sequence


class SchedulerClass(enum.IntEnum):
    """Base dispatch priority (lower value = more urgent)."""

    ANOMALY_HEAL = 0
    USER_INTERACTIVE = 1
    PRECOMPUTE = 2
    SCENARIO_SWEEP = 3


#: classes the dispatch loop may preempt at segment boundaries; the
#: interactive classes always run to completion once dispatched
PREEMPTIBLE_CLASSES = frozenset({SchedulerClass.PRECOMPUTE,
                                 SchedulerClass.SCENARIO_SWEEP})

#: defaults, in SchedulerClass order (heal, user, precompute, sweep).
#: The USER_INTERACTIVE cap sits below the width of the reference's
#: REST worker pool (8): each worker holds at most one queued solve, so a
#: cap at the pool width could never fill and the 429 backpressure would
#: turn into invisible pool queueing
DEFAULT_WEIGHTS = (8.0, 4.0, 2.0, 1.0)
DEFAULT_QUEUE_CAPS = (8, 6, 2, 8)
DEFAULT_DEADLINE_BUDGETS_S = (5.0, 30.0, 120.0, 300.0)


@dataclasses.dataclass(frozen=True)
class ClassPolicy:
    """One class's knobs."""

    weight: float            #: aging-credit multiplier (anti-starvation)
    queue_cap: int           #: queued requests admitted before 429
    deadline_budget_s: float  #: wait that earns one class of credit


@dataclasses.dataclass(frozen=True)
class SchedulerPolicy:
    """The whole policy: per-class knobs + preemption switch."""

    classes: Dict[SchedulerClass, ClassPolicy]
    preemption_enabled: bool = True

    @staticmethod
    def default(preemption_enabled: bool = True) -> "SchedulerPolicy":
        return SchedulerPolicy.from_lists(preemption_enabled=
                                          preemption_enabled)

    @staticmethod
    def from_lists(weights: Optional[Sequence[float]] = None,
                   queue_caps: Optional[Sequence[int]] = None,
                   deadline_budgets_s: Optional[Sequence[float]] = None,
                   preemption_enabled: bool = True) -> "SchedulerPolicy":
        """Build from the config-file form: one value per class in
        SchedulerClass order (scheduler.class.weights /
        scheduler.class.queue.caps / scheduler.class.deadline.budget.ms).
        """
        weights = list(weights or DEFAULT_WEIGHTS)
        caps = list(queue_caps or DEFAULT_QUEUE_CAPS)
        budgets = list(deadline_budgets_s or DEFAULT_DEADLINE_BUDGETS_S)
        n = len(SchedulerClass)
        for name, lst in (("weights", weights), ("queue caps", caps),
                          ("deadline budgets", budgets)):
            if len(lst) != n:
                raise ValueError(
                    f"scheduler {name} need exactly {n} values "
                    f"(one per class {[c.name for c in SchedulerClass]}), "
                    f"got {len(lst)}")
        classes = {}
        for c in SchedulerClass:
            w = float(weights[c.value])
            cap = int(caps[c.value])
            budget = float(budgets[c.value])
            if w <= 0 or cap < 1 or budget <= 0:
                raise ValueError(
                    f"scheduler policy for {c.name}: weight and deadline "
                    f"budget must be > 0 and the queue cap >= 1")
            classes[c] = ClassPolicy(weight=w, queue_cap=cap,
                                     deadline_budget_s=budget)
        return SchedulerPolicy(classes=classes,
                               preemption_enabled=preemption_enabled)

    # ------------------------------------------------------------------
    def effective_priority(self, klass: SchedulerClass,
                           waited_s: float) -> float:
        """Dispatch score (lower runs first): base class value minus the
        aging credit earned while waiting."""
        cp = self.classes[klass]
        return klass.value - cp.weight * (max(0.0, waited_s)
                                          / cp.deadline_budget_s)

    def queue_cap(self, klass: SchedulerClass) -> int:
        return self.classes[klass].queue_cap

    def is_preemptible(self, klass: SchedulerClass) -> bool:
        return klass in PREEMPTIBLE_CLASSES

    def to_json(self) -> dict:
        return {
            "preemptionEnabled": self.preemption_enabled,
            "classes": {c.name: {
                "weight": cp.weight,
                "queueCap": cp.queue_cap,
                "deadlineBudgetS": cp.deadline_budget_s,
                "preemptible": self.is_preemptible(c),
            } for c, cp in self.classes.items()},
        }
