"""Scheduler telemetry: the SchedulerState of `state()` and the sched-*
sensors (port of cruise_control_tpu/sched/stats.py).

Per-class queue depth and wait, device-busy seconds and occupancy, and
counts of coalesced, folded, preempted and rejected requests.  The
numbers live here (one lock, plain counters); scheduler.py records into
them and `attach_metrics` exports the gauges through the facade's
MetricRegistry.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from cruise_control_tpu_torch.sched.policy import SchedulerClass

#: EWMA smoothing for per-class queue-wait seconds
_WAIT_ALPHA = 0.3


class SchedulerStats:
    """Counters + per-class wait EWMAs; thread-safe."""

    def __init__(self, time_fn: Callable[[], float]) -> None:
        self._time = time_fn
        self._lock = threading.Lock()
        self._started_at = time_fn()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.coalesced = 0
        self.folded = 0
        self.preemptions = 0
        self.rejections = 0
        self.busy_s = 0.0
        self._wait_ewma_s: Dict[SchedulerClass, float] = {}
        self._dispatched: Dict[SchedulerClass, int] = {
            c: 0 for c in SchedulerClass}

    # ------------------------------------------------------------------
    def record_submitted(self) -> None:
        with self._lock:
            self.submitted += 1

    def record_coalesced(self) -> None:
        with self._lock:
            self.coalesced += 1

    def record_rejected(self) -> None:
        with self._lock:
            self.rejections += 1

    def record_preempted(self, n: int = 1,
                         busy_s: float = 0.0) -> None:
        """`busy_s` is the device time the job consumed BEFORE yielding:
        preempted segments really ran on the device, so they count
        toward busy/occupancy (else preemption thrash reads as an idle
        device) — but not toward the solve-latency EWMA (a partial
        solve is not a latency sample)."""
        with self._lock:
            self.preemptions += n
            self.busy_s += max(0.0, busy_s)

    def record_folded(self, n: int) -> None:
        with self._lock:
            self.folded += n

    def record_dispatch(self, klass: SchedulerClass,
                        wait_s: float) -> None:
        with self._lock:
            self._dispatched[klass] += 1
            prev = self._wait_ewma_s.get(klass)
            self._wait_ewma_s[klass] = (wait_s if prev is None
                                        else _WAIT_ALPHA * wait_s
                                        + (1 - _WAIT_ALPHA) * prev)

    def record_done(self, duration_s: float, failed: bool) -> None:
        with self._lock:
            self.busy_s += max(0.0, duration_s)
            if failed:
                self.failed += 1
            else:
                self.completed += 1

    # ------------------------------------------------------------------
    def occupancy(self) -> float:
        """Fraction of wall-clock the device spent solving since the
        scheduler started (device-busy-seconds / elapsed)."""
        with self._lock:
            elapsed = self._time() - self._started_at
            return self.busy_s / elapsed if elapsed > 0 else 0.0

    def busy_seconds(self) -> float:
        with self._lock:
            return self.busy_s

    def wait_ewma_s(self, klass: SchedulerClass) -> float:
        with self._lock:
            return self._wait_ewma_s.get(klass, 0.0)

    def to_json(self) -> dict:
        with self._lock:
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "coalesced": self.coalesced,
                "folded": self.folded,
                "preemptions": self.preemptions,
                "rejections": self.rejections,
                "deviceBusySeconds": round(self.busy_s, 3),
                "dispatchedByClass": {c.name: n for c, n
                                      in self._dispatched.items()},
                "waitEwmaSByClass": {
                    c.name: round(self._wait_ewma_s.get(c, 0.0), 3)
                    for c in SchedulerClass},
            }


def attach_metrics(registry, scheduler) -> Optional[object]:
    """Register the sched-* gauges on the facade's MetricRegistry (the
    event meters are marked by the scheduler as events happen)."""
    if registry is None:
        return None
    stats = scheduler.stats
    queue = scheduler.queue
    for c in SchedulerClass:
        name = c.name.lower().replace("_", "-")
        registry.gauge(f"sched-queue-depth-{name}",
                       lambda c=c: queue.depth(c))
        registry.gauge(f"sched-wait-ewma-s-{name}",
                       lambda c=c: stats.wait_ewma_s(c))
    registry.gauge("sched-queue-depth", lambda: queue.depth())
    registry.gauge("sched-device-busy-seconds",
                   lambda: stats.busy_seconds())
    registry.gauge("sched-occupancy", lambda: stats.occupancy())
    registry.gauge("sched-latency-ewma-s",
                   lambda: queue.latency_ewma_s())
    registry.gauge("sched-oldest-wait-s", lambda: queue.oldest_wait_s())
    return registry
