"""Service-level objectives over the scheduler's per-class histograms
(port of cruise_control_tpu/obs/slo.py).

The scheduler records per-class queue-wait and device-time histograms
(`sched-wait-hist-<class>`, `sched-device-busy-hist-<class>`,
utils/metrics.Histogram); this module turns them into objectives: a
latency threshold per class and an error budget, with the **burn rate**
(the fraction of the error budget the last window consumed) computed
from the histograms' cumulative bucket counts.

Two burns per class:

* **queue-wait burn** (`sched-wait-hist-<class>` against the class's
  `queue_wait_s`): the device cannot keep up with the offered load;
* **device-time burn** (`sched-device-busy-hist-<class>` against
  `latency_s`): the solves themselves got slower.

`burn = (observations over threshold / observations) / error_budget`
over a sliding window of histogram snapshots: 1.0 means the window
consumed its budget exactly, and `alert_threshold` (2x by default) is a
breach.  A threshold between two bucket bounds rounds down to the lower
bound, counting borderline observations as over: conservative.

Surfaces: the facade's `state()["sloStatus"]` and the `slo-*` gauges on
the facade's registry (`cc_tpu_slo_*` on the OpenMetrics page).
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time as _time
from typing import Callable, Dict, List, Optional, Tuple

_LOG = logging.getLogger(__name__)

#: SchedulerClass name -> the dashed suffix of its sched-* histograms.
#: Hardcoded strings instead of importing sched.policy: obs/ imports
#: nothing from the package (the same zero-dependency rule as trace.py)
CLASS_SENSOR_SUFFIX = {
    "ANOMALY_HEAL": "anomaly-heal",
    "USER_INTERACTIVE": "user-interactive",
    "PRECOMPUTE": "precompute",
    "SCENARIO_SWEEP": "scenario-sweep",
}

#: status ladder, worst last
STATUS_OK = "ok"
STATUS_BURNING = "burning"      # budget consumed faster than earned
STATUS_BREACH = "breach"        # burn at/over the alert threshold


@dataclasses.dataclass(frozen=True)
class ClassObjective:
    """One scheduler class's objective (config `slo.<class>.*`)."""

    latency_s: float        # device-time threshold (slo.<class>.latency.ms)
    queue_wait_s: float     # admission threshold (slo.<class>.queue.wait.ms)
    error_budget: float     # allowed fraction over threshold

    def to_json(self) -> dict:
        return {"latencyMs": round(self.latency_s * 1e3, 3),
                "queueWaitMs": round(self.queue_wait_s * 1e3, 3),
                "errorBudget": self.error_budget}


#: the reference's defaults (its slo.<class>.* configuration keys)
DEFAULT_OBJECTIVES: Dict[str, ClassObjective] = {
    "ANOMALY_HEAL": ClassObjective(5.0, 1.0, 0.01),
    "USER_INTERACTIVE": ClassObjective(2.0, 0.5, 0.02),
    "PRECOMPUTE": ClassObjective(30.0, 10.0, 0.05),
    "SCENARIO_SWEEP": ClassObjective(60.0, 30.0, 0.05),
}


def over_threshold(hist_json: dict, threshold_s: float) -> Tuple[int, int]:
    """(total observations, observations OVER the threshold) from a
    Histogram.to_json() dict.  The threshold rounds DOWN to the nearest
    bucket boundary, so in-between observations count as over —
    conservative (alarms early, never late)."""
    count = int(hist_json.get("count", 0))
    if not count:
        return 0, 0
    best_le = 0
    for bound_repr, cum in hist_json.get("buckets", {}).items():
        if bound_repr == "+Inf":
            continue
        try:
            bound = float(bound_repr)
        except ValueError:
            continue
        if bound <= threshold_s:
            best_le = max(best_le, int(cum))
    return count, max(0, count - best_le)


class SloEvaluator:
    """Windowed burn rates over a facade's sched-* histograms.

    Snapshots of (count, over-threshold) per class/dimension are taken
    at most every `min_refresh_s` (gauges scrape freely without
    re-walking histograms) and retained for `window_s`; burn is the
    delta between the newest and oldest retained snapshot, so a breach
    ages out of the status once the window rolls past it."""

    def __init__(self, registry,
                 objectives: Optional[Dict[str, ClassObjective]] = None,
                 enabled: bool = True,
                 window_s: float = 300.0,
                 alert_threshold: float = 2.0,
                 min_refresh_s: float = 1.0,
                 time_fn: Optional[Callable[[], float]] = None) -> None:
        self._registry = registry
        self.objectives = dict(objectives or DEFAULT_OBJECTIVES)
        unknown = set(self.objectives) - set(CLASS_SENSOR_SUFFIX)
        if unknown:
            raise ValueError(f"unknown scheduler classes in SLO "
                             f"objectives: {sorted(unknown)}")
        self.enabled = enabled
        self.window_s = max(1.0, float(window_s))
        self.alert_threshold = max(1.0, float(alert_threshold))
        self._min_refresh_s = max(0.0, float(min_refresh_s))
        self._time = time_fn or _time.time
        self._lock = threading.Lock()
        #: [(t, {"wait.<CLASS>"|"dev.<CLASS>": (count, over)})]
        self._snapshots: List[Tuple[float, Dict[str, Tuple[int, int]]]] = []
        self._last_status: dict = self._empty_status()
        self.evaluations = 0
        self.evaluation_errors = 0

    # ------------------------------------------------------------------
    def _take_snapshot(self) -> Dict[str, Tuple[int, int]]:
        snap: Dict[str, Tuple[int, int]] = {}
        for klass, objective in self.objectives.items():
            suffix = CLASS_SENSOR_SUFFIX[klass]
            for dim, sensor, threshold in (
                    ("wait", f"sched-wait-hist-{suffix}",
                     objective.queue_wait_s),
                    ("dev", f"sched-device-busy-hist-{suffix}",
                     objective.latency_s)):
                hist = self._registry.peek(sensor)
                snap[f"{dim}.{klass}"] = (
                    over_threshold(hist.to_json(), threshold)
                    if hist is not None else (0, 0))
        return snap

    @staticmethod
    def _burn(newest: Tuple[int, int], oldest: Tuple[int, int],
              budget: float) -> Tuple[int, float]:
        """(window observations, burn) between two snapshots."""
        d_count = max(0, newest[0] - oldest[0])
        d_over = max(0, newest[1] - oldest[1])
        if not d_count:
            return 0, 0.0
        bad_fraction = d_over / d_count
        return d_count, bad_fraction / max(budget, 1e-9)

    def _empty_status(self) -> dict:
        return {
            "enabled": self.enabled,
            "windowS": self.window_s,
            "alertThreshold": self.alert_threshold,
            "status": STATUS_OK,
            "worstBurn": 0.0,
            "worstClass": None,
            "classes": {
                klass: {
                    "objective": obj.to_json(),
                    "windowSolves": 0,
                    "queueWaitBurn": 0.0,
                    "deviceTimeBurn": 0.0,
                    "burn": 0.0,
                    "budgetRemaining": 1.0,
                    "status": STATUS_OK,
                } for klass, obj in sorted(self.objectives.items())},
        }

    # ------------------------------------------------------------------
    def evaluate(self, force: bool = False) -> dict:
        """Refresh (rate-limited unless `force`) and return the
        sloStatus block.  Never raises — SLO math must not break STATE
        or a scrape."""
        if not self.enabled:
            return self._empty_status()
        try:
            return self._evaluate(force)
        except Exception as exc:  # noqa: BLE001 - status is telemetry
            self.evaluation_errors += 1
            _LOG.warning("SLO evaluation failed (serving the last "
                         "status): %s: %s", type(exc).__name__, exc)
            return self._last_status

    def _evaluate(self, force: bool) -> dict:
        now = self._time()
        with self._lock:
            fresh = (self._snapshots
                     and now - self._snapshots[-1][0] < self._min_refresh_s)
            if fresh and not force:
                return self._last_status
            self._snapshots.append((now, self._take_snapshot()))
            # retain the window plus ONE older snapshot as the base, so
            # a window that just rolled still has a full-width delta
            cutoff = now - self.window_s
            while (len(self._snapshots) > 2
                   and self._snapshots[1][0] <= cutoff):
                self._snapshots.pop(0)
            newest = self._snapshots[-1][1]
            oldest = self._snapshots[0][1]
            status = self._empty_status()
            worst = (0.0, None)
            for klass, objective in self.objectives.items():
                n_wait, wait_burn = self._burn(
                    newest[f"wait.{klass}"], oldest[f"wait.{klass}"],
                    objective.error_budget)
                n_dev, dev_burn = self._burn(
                    newest[f"dev.{klass}"], oldest[f"dev.{klass}"],
                    objective.error_budget)
                burn = max(wait_burn, dev_burn)
                cls = status["classes"][klass]
                cls.update({
                    "windowSolves": max(n_wait, n_dev),
                    "queueWaitBurn": round(wait_burn, 4),
                    "deviceTimeBurn": round(dev_burn, 4),
                    "burn": round(burn, 4),
                    "budgetRemaining": round(max(0.0, 1.0 - burn), 4),
                    "status": (STATUS_BREACH
                               if burn >= self.alert_threshold
                               else STATUS_BURNING if burn >= 1.0
                               else STATUS_OK),
                })
                if burn > worst[0]:
                    worst = (burn, klass)
            status["worstBurn"] = round(worst[0], 4)
            status["worstClass"] = worst[1]
            status["status"] = (
                STATUS_BREACH if worst[0] >= self.alert_threshold
                else STATUS_BURNING if worst[0] >= 1.0 else STATUS_OK)
            self._last_status = status
            self.evaluations += 1
            return status

    # ------------------------------------------------------------------
    def burn(self, klass: str) -> float:
        """Latest computed burn for one class (refreshes rate-limited)."""
        return float(self.evaluate()["classes"]
                     .get(klass, {}).get("burn", 0.0))

    def status_level(self) -> float:
        """Overall status as a number for the slo-status gauge:
        0 ok, 1 burning, 2 breach."""
        return float({STATUS_OK: 0, STATUS_BURNING: 1,
                      STATUS_BREACH: 2}[self.evaluate()["status"]])

    def attach_metrics(self, registry) -> None:
        """Register the slo-* gauges (→ `cc_tpu_slo_*` on /metrics)."""
        registry.gauge("slo-status", self.status_level)
        registry.gauge("slo-worst-burn",
                       lambda: float(self.evaluate()["worstBurn"]))
        for klass in self.objectives:
            suffix = CLASS_SENSOR_SUFFIX[klass]
            registry.gauge(f"slo-burn-rate-{suffix}",
                           lambda k=klass: self.burn(k))
            registry.gauge(
                f"slo-budget-remaining-{suffix}",
                lambda k=klass: float(
                    self.evaluate()["classes"][k]["budgetRemaining"]))
