"""Metric registry: counters, gauges, meters, timers and histograms
(port of cruise_control_tpu/utils/metrics.py).

Cruise Control exports a dropwizard MetricRegistry over JMX with sensors
such as `proposal-computation-timer` and `cluster-model-creation-timer`;
here the registry is process-local, exported as JSON through the
facade's `state()` ("Sensors") and as an OpenMetrics page
(obs/export.py).
"""
from __future__ import annotations

import logging
import math
import re
import threading
import time as _time
from typing import Callable, Dict, List, Optional, Tuple

LOG = logging.getLogger(__name__)

#: prefix of every exported OpenMetrics family
OPENMETRICS_PREFIX = "cc_tpu_"

_INVALID_METRIC_CHARS = re.compile(r"[^a-zA-Z0-9_]")


def canonical_sensor_name(name: str) -> str:
    """THE canonical mapping from an internal sensor name (dashed,
    dotted, mixed-case — `proposal-computation-timer`,
    `REBALANCE-request-rate`) to its OpenMetrics family name
    (`cc_tpu_proposal_computation_timer`).  Dots and dashes would export
    as invalid (or silently colliding) Prometheus names; this mapping is
    applied ONCE, here, and checked for collisions at registry-register
    time — export and scrape docs always agree with it."""
    out = _INVALID_METRIC_CHARS.sub("_", name.strip()).lower()
    out = out.strip("_") or "sensor"
    if out[0].isdigit():
        out = "_" + out
    return OPENMETRICS_PREFIX + out


def openmetrics_sensor(name: str) -> Tuple[str, Dict[str, str]]:
    """(canonical family name, labels) for an export-side sensor key: a
    `cluster.<id>.<sensor>` key (the reference's fleet tags tenant
    sensors so) becomes a `cluster` label on one family."""
    labels: Dict[str, str] = {}
    if name.startswith("cluster."):
        # split on the LAST dot: registry sensor names are dashed and
        # never dotted (the register-time canonical check would flag a
        # dotted twin), while fleet tenant ids MAY contain dots
        # ("kafka.prod.eu") — a first-dot split would truncate the
        # cluster label and corrupt the family name
        rest = name[len("cluster."):]
        cluster_id, _, bare = rest.rpartition(".")
        if cluster_id and bare:
            labels["cluster"] = cluster_id
            name = bare
    return canonical_sensor_name(name), labels


class Counter:
    def __init__(self) -> None:
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def count(self) -> int:
        return self._v

    def to_json(self) -> dict:
        return {"type": "counter", "count": self._v}


class Meter:
    """Event rate: count + events/s over the process lifetime and a
    sliding recent window."""

    def __init__(self, time_fn: Callable[[], float] = _time.time,
                 window_s: float = 300.0) -> None:
        self._time = time_fn
        self._window_s = window_s
        self._lock = threading.Lock()
        self._count = 0
        self._start = time_fn()
        self._recent: List[float] = []

    def mark(self, n: int = 1) -> None:
        now = self._time()
        with self._lock:
            self._count += n
            self._recent.extend([now] * min(n, 100))
            cutoff = now - self._window_s
            while self._recent and self._recent[0] < cutoff:
                self._recent.pop(0)

    def to_json(self) -> dict:
        now = self._time()
        with self._lock:
            lifetime = max(now - self._start, 1e-9)
            recent = [t for t in self._recent if t >= now - self._window_s]
            return {"type": "meter", "count": self._count,
                    "meanRate": self._count / lifetime,
                    "recentRate": len(recent) / self._window_s}


class Timer:
    """Duration stats (count, mean, max, last, approximate p99 via a
    bounded reservoir)."""

    RESERVOIR = 256

    def __init__(self, time_fn: Callable[[], float] = _time.time) -> None:
        self._time = time_fn
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._last = 0.0
        self._samples: List[float] = []

    def update(self, duration_s: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += duration_s
            self._max = max(self._max, duration_s)
            self._last = duration_s
            if len(self._samples) < self.RESERVOIR:
                self._samples.append(duration_s)
            else:
                # deterministic reservoir: overwrite cyclically
                self._samples[self._count % self.RESERVOIR] = duration_s

    def time(self) -> "_TimerContext":
        return _TimerContext(self)

    def to_json(self) -> dict:
        with self._lock:
            if not self._count:
                return {"type": "timer", "count": 0}
            ordered = sorted(self._samples)
            p99 = ordered[min(len(ordered) - 1,
                              math.ceil(0.99 * len(ordered)) - 1)]
            return {"type": "timer", "count": self._count,
                    "meanMs": 1e3 * self._sum / self._count,
                    "maxMs": 1e3 * self._max, "lastMs": 1e3 * self._last,
                    "p99Ms": 1e3 * p99}


class _TimerContext:
    def __init__(self, timer: Timer) -> None:
        self._timer = timer

    def __enter__(self) -> "_TimerContext":
        self._t0 = self._timer._time()
        return self

    def __exit__(self, *exc) -> None:
        self._timer.update(self._timer._time() - self._t0)


class Histogram:
    """Fixed-bucket latency histogram (seconds).  Cumulative bucket
    counts in `to_json` so the OpenMetrics exporter (obs/export.py) can
    render a real `_bucket{le=...}` family; the STATE endpoint shows the
    same JSON.  Buckets are fixed at construction — scrapes must never
    see a histogram whose bucket boundaries move."""

    #: default boundaries (seconds) spanning sub-ms queue waits to
    #: multi-minute cold solves
    DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                       1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

    def __init__(self, buckets: Optional[Tuple[float, ...]] = None) -> None:
        bounds = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        if not bounds or any(b <= 0 for b in bounds):
            raise ValueError("histogram buckets must be positive")
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)     # +Inf tail
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value_s: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += value_s
            for i, bound in enumerate(self._bounds):
                if value_s <= bound:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def to_json(self) -> dict:
        with self._lock:
            cumulative = {}
            running = 0
            for bound, n in zip(self._bounds, self._counts):
                running += n
                cumulative[repr(float(bound))] = running
            cumulative["+Inf"] = running + self._counts[-1]
            return {"type": "histogram", "count": self._count,
                    "sum": self._sum, "buckets": cumulative}


class Gauge:
    def __init__(self, fn: Callable[[], float],
                 on_error: Optional[Callable] = None,
                 name: str = "") -> None:
        self._fn = fn
        self._on_error = on_error
        self._name = name

    def to_json(self) -> dict:
        try:
            return {"type": "gauge", "value": self._fn()}
        except Exception as exc:  # noqa: BLE001 - never break export
            # a broken gauge callable must not break the whole sensor
            # export, but silence hid real wiring bugs: the registry
            # counts it (sensor-export-errors meter) and logs once per
            # gauge name
            if self._on_error is not None:
                self._on_error(self._name, exc)
            return {"type": "gauge", "value": None}


class MetricRegistry:
    """Named sensors; one registry per CruiseControl instance."""

    def __init__(self, time_fn: Callable[[], float] = _time.time,
                 bucket_overrides: Optional[
                     Dict[str, Tuple[float, ...]]] = None) -> None:
        self._time = time_fn
        self._lock = threading.Lock()
        #: per-sensor histogram bucket boundaries (seconds), keyed by
        #: sensor name or name PREFIX (the facade's
        #: metrics_bucket_overrides): `sched-wait-hist` covers every per-class
        #: `sched-wait-hist-<class>` histogram.  Applied at histogram
        #: CREATION only — a live histogram's boundaries never move
        #: under a scrape (set overrides before the first observation).
        self._bucket_overrides: Dict[str, Tuple[float, ...]] = dict(
            bucket_overrides or {})
        self._sensors: Dict[str, object] = {}
        #: canonical OpenMetrics family -> the raw sensor name that
        #: claimed it (collision check at register time: `a-b` and `a.b`
        #: would silently merge on the /metrics page otherwise)
        self._canonical: Dict[str, str] = {}
        #: gauge names whose export failure was already logged (log once
        #: per gauge — a broken gauge fires on EVERY export)
        self._gauge_errors_logged: set = set()

    def _check_canonical_locked(self, name: str) -> None:
        """Caller holds the lock with `name` not yet registered: reject
        a sensor whose canonical export name collides with a DIFFERENT
        already-registered sensor."""
        canonical = canonical_sensor_name(name)
        claimed = self._canonical.get(canonical)
        if claimed is not None and claimed != name:
            raise ValueError(
                f"sensor {name!r} collides with {claimed!r}: both "
                f"export as OpenMetrics family {canonical!r} — rename "
                f"one (utils/metrics.canonical_sensor_name)")
        self._canonical[canonical] = name

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def meter(self, name: str) -> Meter:
        return self._get(name, lambda: Meter(self._time))

    def timer(self, name: str) -> Timer:
        return self._get(name, lambda: Timer(self._time))

    def update_timer(self, name: str, duration_s: float) -> None:
        """Record one duration sample into the named timer, for
        instrumentation that measures outside a with-block."""
        self.timer(name).update(duration_s)

    def set_bucket_overrides(
            self, overrides: Dict[str, Tuple[float, ...]]) -> None:
        """Install per-sensor histogram bucket boundaries (seconds).
        Only affects histograms created AFTER the call — existing
        histograms keep their boundaries (scrapes must never see a
        histogram whose bucket edges move)."""
        with self._lock:
            self._bucket_overrides.update(
                {k: tuple(sorted(float(b) for b in v))
                 for k, v in overrides.items()})

    def buckets_for(self, name: str) -> Optional[Tuple[float, ...]]:
        """The configured bucket boundaries for a histogram name: an
        exact-name override wins, else the LONGEST override key that
        prefixes the name (so `sched-wait-hist` covers
        `sched-wait-hist-user-interactive`), else None (defaults)."""
        with self._lock:
            overrides = dict(self._bucket_overrides)
        exact = overrides.get(name)
        if exact is not None:
            return exact
        best = None
        for key, bounds in overrides.items():
            if name.startswith(key) and (best is None
                                         or len(key) > len(best[0])):
                best = (key, bounds)
        return best[1] if best is not None else None

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None
                  ) -> Histogram:
        # resolve overrides BEFORE _get: the factory runs under the
        # registry lock and buckets_for takes it too (non-reentrant)
        resolved = buckets or self.buckets_for(name)
        return self._get(name, lambda: Histogram(resolved))

    def update_histogram(self, name: str, value_s: float) -> None:
        """Record one observation (seconds) into the named histogram —
        e.g. the scheduler's per-class queue-wait and solve-duration
        histograms exported through /metrics."""
        self.histogram(name).observe(value_s)

    def gauge(self, name: str, fn: Callable[[], float]) -> Gauge:
        with self._lock:
            g = self._sensors.get(name)
            if not isinstance(g, Gauge):
                if name not in self._sensors:
                    self._check_canonical_locked(name)
                g = Gauge(fn, on_error=self._on_gauge_error, name=name)
                self._sensors[name] = g
            return g

    def _on_gauge_error(self, name: str, exc: BaseException) -> None:
        """A gauge callable raised during export: meter it
        (`sensor-export-errors`) and log once per gauge name."""
        self.meter("sensor-export-errors").mark()
        first = False
        with self._lock:
            if name not in self._gauge_errors_logged:
                self._gauge_errors_logged.add(name)
                first = True
        if first:
            LOG.warning("gauge %r failed to export (%s: %s); exporting "
                        "null and counting into sensor-export-errors "
                        "(logged once per gauge)",
                        name, type(exc).__name__, exc)

    def peek(self, name: str):
        """The named sensor, or None WITHOUT creating it — read-side
        consumers (the SLO evaluator polling histograms that may not
        have observed anything yet) must not materialize empty sensors
        as a side effect of looking."""
        with self._lock:
            return self._sensors.get(name)

    def _get(self, name: str, factory):
        with self._lock:
            s = self._sensors.get(name)
            if s is None:
                self._check_canonical_locked(name)
                s = factory()
                self._sensors[name] = s
            return s

    def to_json(self) -> Dict[str, dict]:
        with self._lock:
            items = list(self._sensors.items())
        return {name: s.to_json() for name, s in sorted(items)}
