"""Request-scoped tracing (port of cruise_control_tpu/obs/trace.py).

A `Trace` is one request's span tree with its outcome flags.  The
current `TraceContext` (trace + parent span id) lives in a contextvar;
`activate` carries it across a thread hop.  Code below the facade records
against whatever context is active: `span()` opens a child span,
`record_span()` appends an already-timed one, `event()` attaches an
instantaneous event and `mark()` sets an outcome flag ("failed",
"degraded", ...; the worst wins).  Outside a trace every helper is a
no-op, so callers never guard.

Spans are capped per trace (`Trace.MAX_SPANS`, overflow counted), and
tracing touches no device.  `finish` stamps the trace, writes it as one
JSON line on the `traceLogger` logger when the trace log is on, and hands
it to the flight recorder (obs/recorder.py), thinned by `sample_rate`:
an "ok" trace is kept with that probability, any other outcome always.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import logging
import threading
import time as _time
import uuid as _uuid
from typing import Callable, Dict, List, NamedTuple, Optional

LOG = logging.getLogger(__name__)

#: structured JSON trace log (obs.trace.log.enabled): one line per
#: finished trace, logger name `traceLogger` so deployments route it to
#: its own file exactly like the NCSA access log
TRACE_LOG = logging.getLogger("traceLogger")

#: outcome precedence, worst first — a trace that both degraded and was
#: preempted reports "degraded".  "rejected" is queue-cap backpressure:
#: kept in the recorder's ring but never pinned (obs/recorder.py
#: PINNED_OUTCOMES), so a rejection storm cannot flush the failed and
#: degraded traces the recorder exists to keep
OUTCOME_ORDER = ("failed", "degraded", "fallback", "preempted",
                 "rejected", "ok")

_ENABLED = True
_TRACE_LOG_ENABLED = False
#: the fraction of "ok" traces handed to the flight recorder
#: (obs.trace.sample.rate); any other outcome is always kept.  The
#: decision hashes the trace id, so a trace's fate is reproducible
_SAMPLE_RATE = 1.0
_CONFIG_LOCK = threading.Lock()


def configure(enabled: Optional[bool] = None,
              trace_log_enabled: Optional[bool] = None,
              sample_rate: Optional[float] = None) -> None:
    """Process-wide switches (obs.tracing.enabled /
    obs.trace.log.enabled / obs.trace.sample.rate); None leaves a switch
    as found."""
    global _ENABLED, _TRACE_LOG_ENABLED, _SAMPLE_RATE
    with _CONFIG_LOCK:
        if enabled is not None:
            _ENABLED = bool(enabled)
        if trace_log_enabled is not None:
            _TRACE_LOG_ENABLED = bool(trace_log_enabled)
        if sample_rate is not None:
            _SAMPLE_RATE = min(1.0, max(0.0, float(sample_rate)))


def enabled() -> bool:
    return _ENABLED


def sample_rate() -> float:
    return _SAMPLE_RATE


def _sampled_in(trace_id: str) -> bool:
    """Keep decision for an "ok" trace: the trace id (random hex) hashes
    to a point in [0, 1) compared with the sample rate."""
    rate = _SAMPLE_RATE
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return (int(trace_id[:8], 16) / float(0x100000000)) < rate


@dataclasses.dataclass
class SpanRecord:
    """One finished span.  Made only by this module's helpers
    (`span()`, `record_span()`)."""

    span_id: int
    parent_id: Optional[int]
    name: str
    start_s: float
    end_s: float
    tags: Dict[str, object] = dataclasses.field(default_factory=dict)


class Trace:
    """One request's span tree plus its outcome flags.  Thread-safe:
    spans of one request may arrive from several threads (the caller's
    and the executor's)."""

    #: span cap per trace: a runaway instrumentation loop must degrade
    #: to dropped spans (counted), never to unbounded memory
    MAX_SPANS = 512

    def __init__(self, name: str, tags: Optional[dict] = None) -> None:
        self.trace_id = _uuid.uuid4().hex[:16]
        self.name = name
        self.tags: Dict[str, object] = dict(tags or {})
        self.started_s = _time.time()
        self.ended_s: Optional[float] = None
        self.dropped_spans = 0
        self._lock = threading.Lock()
        self._spans: List[SpanRecord] = []
        self._events: List[dict] = []
        self._flags: set = set()
        self._next_id = 1
        self.root_id = 0        # the root span always exists, id 0

    # -- span bookkeeping ----------------------------------------------
    def new_span_id(self) -> Optional[int]:
        with self._lock:
            if len(self._spans) >= self.MAX_SPANS:
                self.dropped_spans += 1
                return None
            sid = self._next_id
            self._next_id += 1
            return sid

    def add_span(self, record: SpanRecord) -> None:
        with self._lock:
            if len(self._spans) < self.MAX_SPANS:
                self._spans.append(record)
            else:
                self.dropped_spans += 1

    def add_event(self, span_id: Optional[int], name: str,
                  tags: dict) -> None:
        with self._lock:
            if len(self._events) < self.MAX_SPANS:
                self._events.append({"spanId": span_id, "name": name,
                                     "atS": _time.time(), **tags})

    def mark(self, flag: str) -> None:
        """Set an outcome flag ("failed", "degraded", "fallback",
        "preempted"); the worst one wins (OUTCOME_ORDER)."""
        with self._lock:
            self._flags.add(flag)

    @property
    def outcome(self) -> str:
        with self._lock:
            for o in OUTCOME_ORDER:
                if o in self._flags:
                    return o
            return "ok"

    # -- rendering -----------------------------------------------------
    def to_json(self) -> dict:
        with self._lock:
            spans = list(self._spans)
            events = list(self._events)
            dropped = self.dropped_spans
        ended = self.ended_s if self.ended_s is not None else _time.time()
        by_parent: Dict[Optional[int], List[SpanRecord]] = {}
        for s in spans:
            by_parent.setdefault(s.parent_id, []).append(s)
        ev_by_span: Dict[Optional[int], List[dict]] = {}
        for e in events:
            ev_by_span.setdefault(e["spanId"], []).append(
                {k: v for k, v in e.items() if k != "spanId"})

        def node(span_id: int, name: str, start: float, end: float,
                 tags: dict) -> dict:
            out = {
                "spanId": span_id,
                "name": name,
                "startMs": round(start * 1000.0, 3),
                "durationMs": round((end - start) * 1000.0, 3),
            }
            if tags:
                out["tags"] = dict(tags)
            evs = ev_by_span.get(span_id)
            if evs:
                out["events"] = evs
            children = [node(c.span_id, c.name, c.start_s, c.end_s,
                             c.tags)
                        for c in sorted(by_parent.get(span_id, []),
                                        key=lambda s: (s.start_s,
                                                       s.span_id))]
            # orphans (parent span hit the cap and was dropped) re-root
            # under the root so they stay visible
            if span_id == self.root_id:
                known = {s.span_id for s in spans} | {self.root_id}
                children += [node(c.span_id, c.name, c.start_s, c.end_s,
                                  c.tags)
                             for c in spans
                             if c.parent_id not in known]
            if children:
                out["children"] = children
            return out

        return {
            "traceId": self.trace_id,
            "name": self.name,
            "outcome": self.outcome,
            "tags": dict(self.tags),
            "startMs": round(self.started_s * 1000.0, 3),
            "durationMs": round((ended - self.started_s) * 1000.0, 3),
            "numSpans": len(spans) + 1,
            "droppedSpans": dropped,
            "root": node(self.root_id, self.name, self.started_s, ended,
                         self.tags),
        }


class TraceContext(NamedTuple):
    """What crosses a thread hop: the trace plus the span to parent
    under."""

    trace: Trace
    span_id: int

    @property
    def trace_id(self) -> str:
        return self.trace.trace_id


_CURRENT: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("cc_tpu_trace", default=None)


class _ActiveSpan:
    """Handle yielded by `span()` while the span is open."""

    __slots__ = ("trace", "span_id", "parent_id", "name", "start_s",
                 "tags")

    def __init__(self, trace: Trace, span_id: int,
                 parent_id: Optional[int], name: str,
                 tags: dict) -> None:
        self.trace = trace
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_s = _time.time()
        self.tags = tags

    def set_tag(self, key: str, value) -> None:
        self.tags[key] = value

    def event(self, name: str, **tags) -> None:
        self.trace.add_event(self.span_id, name, tags)


# ---------------------------------------------------------------------------
# context accessors
# ---------------------------------------------------------------------------
def current() -> Optional[Trace]:
    ctx = _CURRENT.get()
    return ctx.trace if ctx is not None else None


def current_context() -> Optional[TraceContext]:
    return _CURRENT.get()


def current_trace_id() -> Optional[str]:
    ctx = _CURRENT.get()
    return ctx.trace.trace_id if ctx is not None else None


@contextlib.contextmanager
def activate(ctx: Optional[TraceContext]):
    """Make `ctx` the current trace context for the duration — the
    cross-thread half of propagation (pool workers, the scheduler
    dispatch thread).  None is a valid scope (no-op)."""
    if ctx is None:
        yield
        return
    token = _CURRENT.set(ctx)
    try:
        yield
    finally:
        _CURRENT.reset(token)


# ---------------------------------------------------------------------------
# trace lifecycle
# ---------------------------------------------------------------------------
def start(name: str, **tags) -> Optional[Trace]:
    """Mint a trace and make it current (root span id 0).  Returns None
    when tracing is disabled."""
    if not _ENABLED:
        return None
    trace = Trace(name, tags)
    _CURRENT.set(TraceContext(trace, trace.root_id))
    return trace


def start_detached(name: str, **tags) -> Optional[Trace]:
    """Mint a trace without touching the current thread's context (a
    caller that hands the trace to another thread `activate`s it
    there)."""
    if not _ENABLED:
        return None
    return Trace(name, tags)


def finish(trace: Optional[Trace],
           error: Optional[BaseException] = None) -> None:
    """End a trace: stamp the end time, fold in a terminal error, (when
    obs.trace.log.enabled) emit one structured JSON log line, and hand
    the finished tree to the flight recorder unless sampled out."""
    if trace is None:
        return
    # a finished trace must not linger as the thread's current context
    # (the next solve on this thread would append spans to a dead trace
    # instead of minting its own)
    ctx = _CURRENT.get()
    if ctx is not None and ctx.trace is trace:
        _CURRENT.set(None)
    trace.ended_s = _time.time()
    if error is not None:
        # an exception class may declare its own outcome (duck-typed so
        # this module keeps zero package dependencies): QueueFullError
        # sets trace_outcome="rejected" — backpressure, not failure
        trace.mark(getattr(error, "trace_outcome", None) or "failed")
        trace.tags.setdefault("error",
                              f"{type(error).__name__}: {error}")
    from cruise_control_tpu_torch.obs import recorder as _recorder
    if _TRACE_LOG_ENABLED:
        # the trace log sees every finished trace: sampling thins the
        # flight recorder only
        try:
            TRACE_LOG.info("%s", json.dumps(trace.to_json(),
                                            sort_keys=True))
        except (TypeError, ValueError) as exc:
            LOG.warning("trace %s not JSON-serializable: %s",
                        trace.trace_id, exc)
    if trace.outcome == "ok" and not _sampled_in(trace.trace_id):
        # the recorder counts the drop: a quiet ring and a thinned one
        # read differently
        _recorder.get_recorder().record_sampled_out()
        return
    _recorder.get_recorder().record(trace)


def finishing(trace: Optional[Trace],
              op: Callable[[], object]) -> Callable[[], object]:
    """Wrap `op` so it runs under `trace` (activated on whatever thread
    executes it) and finishes the trace when it returns or raises: the
    REST layer's USER_TASKS pool carries a request's trace this way."""
    if trace is None:
        return op
    ctx = TraceContext(trace, trace.root_id)

    def run():
        with activate(ctx):
            try:
                result = op()
            except BaseException as exc:
                finish(trace, error=exc)
                raise
            finish(trace)
            return result
    return run


@contextlib.contextmanager
def solve_trace(name: str, **tags):
    """The facade's entry helper: reuse the active trace or mint and
    finish one around the solve.  Yields the trace (or None when tracing
    is off)."""
    existing = current()
    if existing is not None and existing.ended_s is None:
        for k, v in tags.items():
            existing.tags.setdefault(k, v)
        yield existing
        return
    trace = start_detached(name, **tags)
    if trace is None:
        yield None
        return
    token = _CURRENT.set(TraceContext(trace, trace.root_id))
    try:
        yield trace
    except BaseException as exc:
        finish(trace, error=exc)
        raise
    else:
        finish(trace)
    finally:
        # restore the PREVIOUS context (not just clear): a stale
        # finished trace from this thread's past must not shadow the
        # next solve
        _CURRENT.reset(token)


# ---------------------------------------------------------------------------
# span recording
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def span(name: str, **tags):
    """Open a child span of the current context for the duration.
    Yields the active-span handle (set_tag/event), or None outside a
    trace — callers never need to guard."""
    ctx = _CURRENT.get()
    if ctx is None or not _ENABLED:
        yield None
        return
    trace = ctx.trace
    sid = trace.new_span_id()
    if sid is None:
        yield None
        return
    handle = _ActiveSpan(trace, sid, ctx.span_id, name, dict(tags))
    token = _CURRENT.set(TraceContext(trace, sid))
    try:
        yield handle
    except BaseException as exc:
        handle.tags.setdefault("error", f"{type(exc).__name__}: {exc}")
        raise
    finally:
        _CURRENT.reset(token)
        trace.add_span(SpanRecord(sid, handle.parent_id, name,
                                  handle.start_s, _time.time(),
                                  handle.tags))


def record_span(name: str, start_s: float, end_s: float,
                ctx: Optional[TraceContext] = None, **tags) -> None:
    """Append an already-timed span (queue waits, profiler segments)
    under `ctx` (default: the current context).  No-op without one."""
    if not _ENABLED:
        return
    ctx = ctx if ctx is not None else _CURRENT.get()
    if ctx is None:
        return
    sid = ctx.trace.new_span_id()
    if sid is None:
        return
    ctx.trace.add_span(SpanRecord(sid, ctx.span_id, name, start_s,
                                  end_s, dict(tags)))


def event(name: str, ctx: Optional[TraceContext] = None, **tags) -> None:
    """Attach an instantaneous event to the current span (or `ctx`)."""
    if not _ENABLED:
        return
    ctx = ctx if ctx is not None else _CURRENT.get()
    if ctx is None:
        return
    ctx.trace.add_event(ctx.span_id, name, tags)


def mark(flag: str, ctx: Optional[TraceContext] = None) -> None:
    """Set an outcome flag on the current (or given) trace."""
    ctx = ctx if ctx is not None else _CURRENT.get()
    if ctx is not None:
        ctx.trace.mark(flag)


def set_tag(key: str, value, ctx: Optional[TraceContext] = None) -> None:
    ctx = ctx if ctx is not None else _CURRENT.get()
    if ctx is not None:
        ctx.trace.tags[key] = value
