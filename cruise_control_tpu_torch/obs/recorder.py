"""Flight recorder: the last N finished solve traces, incident-proof
(port of cruise_control_tpu/obs/recorder.py).

A fixed-size ring holds every finished trace (obs/trace.py hands them
over in `finish`).  A trace whose outcome is anything but "ok" or
"rejected" — failed, degraded, fallback, preempted — is also pinned: it
survives ring eviction until a query returns it (exports it), so an
incident's evidence cannot be washed out by the healthy traffic after
it.  `dump()` writes the whole recorder as one structured JSON log line;
the facade calls it when its solver degrades.

`query` filters by trace id, cluster tag, outcome, start time and
duration.  The recorder is a process-wide singleton (`get_recorder()`).
"""
from __future__ import annotations

import json
import logging
import statistics
import threading
from typing import Dict, List, Optional

LOG = logging.getLogger(__name__)

#: the incident dump goes to its own logger so deployments can route it
#: to durable storage separately from the chatty service log
DUMP_LOG = logging.getLogger("flightRecorder")

DEFAULT_CAPACITY = 256
DEFAULT_MAX_PINNED = 256

#: outcomes pinned past ring eviction until exported.  "rejected"
#: (queue-cap backpressure, HTTP 429) is deliberately absent: a
#: rejection storm is hundreds of traces a minute, and pinning them
#: would FIFO-flush the real incident evidence
PINNED_OUTCOMES = frozenset(("failed", "degraded", "fallback",
                             "preempted"))


class FlightRecorder:
    """See module docstring.  Stores finished traces as JSON dicts (the
    tree is assembled once at record time; queries never touch live
    Trace objects)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 max_pinned: int = DEFAULT_MAX_PINNED) -> None:
        self.capacity = max(1, int(capacity))
        self.max_pinned = max(0, int(max_pinned))
        self._lock = threading.Lock()
        #: ring of completed traces, oldest first
        self._ring: List[dict] = []
        #: trace_id -> pinned trace (bad outcomes awaiting export)
        self._pinned: Dict[str, dict] = {}
        #: insertion order of pins (oldest evicted at max_pinned)
        self._pin_order: List[str] = []
        self.recorded = 0
        self.pinned_total = 0
        self.exported_pins = 0
        #: OK traces dropped by obs.trace.sample.rate before reaching
        #: the ring (obs/trace.py `_sampled_in`): a quiet ring and a
        #: thinned one read differently
        self.sampled_out = 0

    def record_sampled_out(self) -> None:
        with self._lock:
            self.sampled_out += 1

    # ------------------------------------------------------------------
    def record(self, trace) -> None:
        """Accept a finished obs.trace.Trace (or a pre-rendered dict)."""
        doc = trace if isinstance(trace, dict) else trace.to_json()
        with self._lock:
            self.recorded += 1
            self._ring.append(doc)
            if len(self._ring) > self.capacity:
                del self._ring[:len(self._ring) - self.capacity]
            if doc.get("outcome", "ok") in PINNED_OUTCOMES \
                    and self.max_pinned:
                tid = doc.get("traceId", "")
                if tid and tid not in self._pinned:
                    self._pinned[tid] = doc
                    self._pin_order.append(tid)
                    self.pinned_total += 1
                    while len(self._pin_order) > self.max_pinned:
                        old = self._pin_order.pop(0)
                        self._pinned.pop(old, None)

    # ------------------------------------------------------------------
    def query(self, trace_id: Optional[str] = None,
              cluster: Optional[str] = None,
              outcome: Optional[str] = None,
              limit: Optional[int] = None,
              export: bool = True,
              since_ms: Optional[float] = None,
              min_duration_ms: Optional[float] = None) -> List[dict]:
        """Matching traces, newest first.  Pinned traces a query RETURNS
        count as exported and drop their pin (they remain in the ring
        subject to normal eviction); pass export=False to peek.

        `since_ms` keeps only traces that started at or after the given
        epoch-milliseconds; `min_duration_ms` only traces at least that
        slow."""
        with self._lock:
            seen = set()
            docs: List[dict] = []
            # pinned first (they may have been evicted from the ring),
            # then the ring newest-first
            for tid in reversed(self._pin_order):
                docs.append(self._pinned[tid])
                seen.add(tid)
            for doc in reversed(self._ring):
                tid = doc.get("traceId", "")
                if tid not in seen:
                    seen.add(tid)
                    docs.append(doc)
        out = []
        for doc in docs:
            if trace_id is not None \
                    and doc.get("traceId") != trace_id:
                continue
            if cluster is not None \
                    and doc.get("tags", {}).get("cluster") != cluster:
                continue
            if outcome is not None and doc.get("outcome") != outcome:
                continue
            if since_ms is not None \
                    and doc.get("startMs", 0.0) < since_ms:
                continue
            if min_duration_ms is not None \
                    and doc.get("durationMs", 0.0) < min_duration_ms:
                continue
            out.append(doc)
            if limit is not None and len(out) >= max(1, limit):
                break
        if export and out:
            with self._lock:
                for doc in out:
                    tid = doc.get("traceId", "")
                    if tid in self._pinned:
                        self._pinned.pop(tid, None)
                        self._pin_order.remove(tid)
                        self.exported_pins += 1
        return out

    def get(self, trace_id: str) -> Optional[dict]:
        hits = self.query(trace_id=trace_id, limit=1)
        return hits[0] if hits else None

    # ------------------------------------------------------------------
    def dump(self, reason: str = "", active: Optional[dict] = None
             ) -> int:
        """Write the recorder state (pinned + ring) as one structured
        JSON log line — called when the solver degrades, so the
        incident's traces are captured even if nobody queries them.
        `active` is the IN-FLIGHT trace of the solve that triggered the
        dump (its partial tree): the degradation fires mid-solve,
        before that trace reaches the ring, so without it the dump
        would exclude the very trace it announces.  Returns the number
        of traces dumped; never raises."""
        try:
            with self._lock:
                pinned = [self._pinned[t] for t in self._pin_order]
                recent = list(self._ring[-16:])
            DUMP_LOG.warning("%s", json.dumps({
                "flightRecorderDump": {
                    "reason": reason,
                    "active": active,
                    "pinned": pinned,
                    "recent": recent,
                }}, sort_keys=True, default=str))
            return len(pinned) + len(recent) + (1 if active else 0)
        except Exception as exc:  # noqa: BLE001 - the dump is a
            # best-effort courtesy: it must never mask the anomaly that
            # triggered it
            LOG.warning("flight-recorder dump failed: %s", exc)
            return 0

    # ------------------------------------------------------------------
    def snapshot(self) -> List[dict]:
        """Every retained trace (ring order, oldest first) without
        export side effects."""
        with self._lock:
            seen = {d.get("traceId") for d in self._ring}
            extra = [self._pinned[t] for t in self._pin_order
                     if t not in seen]
            return extra + list(self._ring)

    def to_json(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "retained": len(self._ring),
                "pinned": len(self._pinned),
                "recorded": self.recorded,
                "pinnedTotal": self.pinned_total,
                "exportedPins": self.exported_pins,
                "sampledOut": self.sampled_out,
            }


def phase_summary(traces: List[dict]) -> dict:
    """Per-phase latency attribution over a set of finished traces: the
    slowest and the median trace (by duration), each broken into its
    span durations."""
    done = [t for t in traces if t.get("durationMs") is not None]
    if not done:
        return {"numTraces": 0}

    def phases(doc: dict) -> dict:
        out: Dict[str, float] = {}

        def walk(node: dict) -> None:
            for child in node.get("children", []):
                name = child.get("name", "?")
                out[name] = out.get(name, 0.0) + child.get(
                    "durationMs", 0.0)
                walk(child)
        walk(doc.get("root", {}))
        return {k: round(v, 3) for k, v in sorted(out.items())}

    def entry(doc: dict) -> dict:
        return {"traceId": doc.get("traceId"),
                "outcome": doc.get("outcome"),
                "durationMs": doc.get("durationMs"),
                "phasesMs": phases(doc)}

    ordered = sorted(done, key=lambda t: t.get("durationMs", 0.0))
    durations = [t.get("durationMs", 0.0) for t in ordered]
    return {
        "numTraces": len(ordered),
        "p50Ms": round(statistics.median(durations), 3),
        "slowest": entry(ordered[-1]),
        "median": entry(ordered[len(ordered) // 2]),
    }


# ---------------------------------------------------------------------------
# process-wide singleton
# ---------------------------------------------------------------------------
_ACTIVE: Optional[FlightRecorder] = None
_ACTIVE_LOCK = threading.Lock()


def get_recorder() -> FlightRecorder:
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is None:
            _ACTIVE = FlightRecorder()
        return _ACTIVE


def install(recorder: Optional[FlightRecorder] = None) -> FlightRecorder:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = recorder or FlightRecorder()
        return _ACTIVE


def configure(capacity: Optional[int] = None,
              max_pinned: Optional[int] = None) -> FlightRecorder:
    """Resize the live recorder (the facade's obs_flight_recorder_*
    settings); retained traces survive a shrink up to the new
    capacity."""
    rec = get_recorder()
    with rec._lock:
        if capacity is not None:
            rec.capacity = max(1, int(capacity))
            if len(rec._ring) > rec.capacity:
                del rec._ring[:len(rec._ring) - rec.capacity]
        if max_pinned is not None:
            rec.max_pinned = max(0, int(max_pinned))
            while len(rec._pin_order) > rec.max_pinned:
                old = rec._pin_order.pop(0)
                rec._pinned.pop(old, None)
    return rec
