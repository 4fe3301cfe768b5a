"""Bounded admission queue with backpressure and single-flight
coalescing (port of cruise_control_tpu/sched/queue.py).

Admission: each class owns a queue cap (policy.py); an offer beyond the
cap raises `QueueFullError` with a `retry_after_s` of the observed
solve-latency EWMA times the queue depth (a REST layer answers 429 with
it as `Retry-After`).

Single-flight coalescing: a job may carry a `coalesce_key` (the facade
keys request solves on goal list x model generation x options).  An offer
whose key matches a queued or in-flight ticket attaches to it instead of
admitting a second identical solve: N identical concurrent requests pay
one solve and share its result.  A more urgent waiter upgrades the
pending entry's dispatch class.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from cruise_control_tpu_torch.sched.policy import (SchedulerClass,
                                                   SchedulerPolicy)


class QueueFullError(RuntimeError):
    """Admission rejected: the class queue is at its cap.  `retry_after_s`
    is the backpressure hint (latency EWMA x queue depth), a REST
    layer's `Retry-After`."""

    #: obs/trace.py classification: backpressure, not failure — the
    #: trace records outcome "rejected" (visible in the flight-recorder
    #: ring, never pinned)
    trace_outcome = "rejected"

    def __init__(self, klass: SchedulerClass, depth: int, cap: int,
                 retry_after_s: float) -> None:
        super().__init__(
            f"solve queue full for class {klass.name}: {depth} queued "
            f">= cap {cap}; retry in ~{retry_after_s:.0f}s")
        self.klass = klass
        self.depth = depth
        self.cap = cap
        self.retry_after_s = retry_after_s


class SolveTicket:
    """One admitted solve, shared by every coalesced waiter."""

    def __init__(self, klass: SchedulerClass, enqueued_at: float,
                 queue: "AdmissionQueue") -> None:
        self.klass = klass
        self.enqueued_at = enqueued_at
        #: wall-clock when the dispatch loop picked the job up (None
        #: while still queued)
        self.started_at: Optional[float] = None
        #: requests that attached to this solve beyond the first
        self.attach_count = 0
        #: trace id of the job that created this ticket (obs/trace.py):
        #: coalesced waiters link their own trace to the leader's solve
        #: through it
        self.trace_id: Optional[str] = None
        self._queue = queue
        self._done = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None

    # -- resolution ----------------------------------------------------
    def resolve(self, result) -> None:
        self._result = result
        self._done.set()

    def fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("solve did not finish within the timeout")
        if self._exc is not None:
            raise self._exc
        return self._result

    # -- operator visibility (USER_TASKS QueuePosition / ETA) ----------
    def queue_position(self) -> Optional[int]:
        """0-based number of entries that would dispatch before this one;
        None once dispatched (running or finished)."""
        return self._queue.position_of(self)

    def estimated_start_ms(self) -> float:
        """Epoch-ms start estimate: actual start once dispatched,
        otherwise now + (position + 1) x the solve-latency EWMA (the +1
        accounts for the solve occupying the device right now)."""
        return self._queue.estimated_start_ms(self)


class _Entry:
    __slots__ = ("job", "ticket", "klass", "best_klass", "enqueued_at",
                 "last_queued_at", "seq")

    def __init__(self, job, ticket: SolveTicket, seq: int) -> None:
        self.job = job
        self.ticket = ticket
        self.klass = job.klass          #: admission class (cap accounting)
        self.best_klass = job.klass     #: dispatch class (upgraded by
        self.enqueued_at = ticket.enqueued_at  # coalesced waiters)
        #: last time the entry (re)entered the queue: aging uses
        #: enqueued_at (credit survives preemption), but the per-class
        #: wait metrics sample now - last_queued_at so a redispatch
        #: after preemption does not re-log the full original wait
        self.last_queued_at = ticket.enqueued_at
        self.seq = seq


class AdmissionQueue:
    """Thread-safe priority admission queue (see module docstring)."""

    #: EWMA smoothing for observed solve latency
    _ALPHA = 0.3

    def __init__(self, policy: SchedulerPolicy,
                 time_fn: Callable[[], float]) -> None:
        self._policy = policy
        self._time = time_fn
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._entries: List[_Entry] = []
        #: coalesce key -> ticket, held from admission until the solve
        #: RESOLVES (so in-flight solves keep attracting identical
        #: requests)
        self._by_key: Dict[tuple, Tuple[SolveTicket, Optional[_Entry]]] = {}
        self._depth: Dict[SchedulerClass, int] = {c: 0
                                                  for c in SchedulerClass}
        #: entries popped for service (take/take_fold_peers) but not
        #: yet settled (done_serving/requeue): counted under the same
        #: lock as the pop so idle() is race-free
        self._in_service = 0
        self._seq = 0
        self._latency_ewma_s = 0.0
        self._latency_samples = 0

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def offer(self, job) -> Tuple[SolveTicket, bool]:
        """Admit `job` (or attach to an identical queued/in-flight one).
        Returns (ticket, created); raises QueueFullError at the cap."""
        with self._cond:
            key = job.coalesce_key
            if key is not None:
                hit = self._by_key.get(key)
                if hit is not None and not hit[0].done():
                    ticket, entry = hit
                    ticket.attach_count += 1
                    if job.klass.value < ticket.klass.value:
                        # a more urgent waiter attached: the shared solve
                        # dispatches (and reports in USER_TASKS) at the
                        # best attached class, not the creator's
                        ticket.klass = job.klass
                    if entry is not None \
                            and job.klass.value < entry.best_klass.value:
                        entry.best_klass = job.klass
                    return ticket, False
            depth = self._depth[job.klass]
            cap = self._policy.queue_cap(job.klass)
            if depth >= cap:
                raise QueueFullError(job.klass, depth, cap,
                                     self._retry_after_locked(job.klass))
            ticket = SolveTicket(job.klass, self._time(), self)
            trace_ctx = getattr(job, "trace", None)
            if trace_ctx is not None:
                # duck-typed (obs.trace.TraceContext): this module keeps
                # zero obs dependencies, the id alone is what waiters
                # link against
                ticket.trace_id = getattr(trace_ctx, "trace_id", None)
            self._seq += 1
            entry = _Entry(job, ticket, self._seq)
            self._entries.append(entry)
            self._depth[job.klass] += 1
            if key is not None:
                self._by_key[key] = (ticket, entry)
            self._cond.notify()
            return ticket, True

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def take(self, stop: threading.Event,
             poll_s: float = 0.5) -> Optional[_Entry]:
        """Pop the best-effective-priority entry; blocks until one is
        available or `stop` is set (then returns None)."""
        with self._cond:
            while not self._entries:
                if stop.is_set():
                    return None
                self._cond.wait(poll_s)
            entry = min(self._entries, key=self._dispatch_key)
            self._pop_locked(entry)
            entry.ticket.started_at = self._time()
            return entry

    def _dispatch_key(self, e: _Entry):
        now = self._time()
        return (self._policy.effective_priority(e.best_klass,
                                                now - e.enqueued_at),
                e.seq)

    def _pop_locked(self, entry: _Entry) -> None:
        self._entries.remove(entry)
        self._depth[entry.klass] -= 1
        # popped-for-service under the SAME lock as the removal, so
        # depth()==0 can never race a just-taken entry past idle() (the
        # graceful-drain quiesce reads it); the scheduler settles the
        # count via done_serving()/requeue()
        self._in_service += 1
        # the _by_key mapping STAYS: identical requests attach to the
        # in-flight solve until finish() severs it

    def take_fold_peers(self, fold_key: tuple, limit: int) -> List[_Entry]:
        """Pop up to `limit` queued entries sharing `fold_key` (scenario
        folding: compatible sweeps merge into one engine batch)."""
        if limit <= 0:
            return []
        with self._cond:
            peers = [e for e in self._entries
                     if getattr(e.job, "fold_key", None) == fold_key]
            peers.sort(key=lambda e: e.seq)
            peers = peers[:limit]
            for e in peers:
                self._pop_locked(e)
                e.ticket.started_at = self._time()
            return peers

    def requeue(self, entry: _Entry) -> None:
        """Put a preempted entry back, keeping its original enqueue time
        (its aging credit keeps accruing across preemptions)."""
        with self._cond:
            entry.ticket.started_at = None
            entry.last_queued_at = self._time()
            self._entries.append(entry)
            self._depth[entry.klass] += 1
            self._in_service -= 1     # back to queued, atomically
            self._cond.notify()

    def done_serving(self, n: int = 1) -> None:
        """The scheduler finished (resolved or failed) `n` entries it
        had taken — the other half of _pop_locked's in-service count."""
        with self._cond:
            self._in_service -= n

    def idle(self) -> bool:
        """Nothing queued AND nothing taken-but-unfinished, read under
        one lock — the race-free predicate the drain path polls."""
        with self._cond:
            return not self._entries and self._in_service == 0

    def finish(self, entry: _Entry) -> None:
        """Sever the coalesce binding once the solve resolved (call
        BEFORE resolving the ticket so late arrivals start a fresh
        solve rather than attaching to a completed one)."""
        key = getattr(entry.job, "coalesce_key", None)
        if key is None:
            return
        with self._cond:
            hit = self._by_key.get(key)
            if hit is not None and hit[0] is entry.ticket:
                self._by_key.pop(key, None)

    def drain(self) -> List[_Entry]:
        """Remove and return everything queued (shutdown: fail their
        tickets)."""
        with self._cond:
            entries, self._entries = self._entries, []
            for c in SchedulerClass:
                self._depth[c] = 0
            self._by_key.clear()
            return entries

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def has_effective_better_than(self, effective: float) -> bool:
        """A queued entry whose LIVE effective priority (aging included)
        strictly beats `effective` — the preemption predicate consulted
        at segment checkpoints.  Comparing effective priorities on BOTH
        sides bounds preemption thrash: a running job's aging credit
        keeps accruing (requeue preserves enqueued_at), so sustained
        higher-class traffic delays it a bounded number of segments
        instead of livelocking it."""
        with self._lock:
            now = self._time()
            return any(
                self._policy.effective_priority(e.best_klass,
                                                now - e.enqueued_at)
                < effective
                for e in self._entries)

    def depth(self, klass: Optional[SchedulerClass] = None) -> int:
        with self._lock:
            if klass is not None:
                return self._depth[klass]
            return len(self._entries)

    def depths(self) -> Dict[SchedulerClass, int]:
        with self._lock:
            return dict(self._depth)

    def oldest_wait_s(self) -> float:
        with self._lock:
            if not self._entries:
                return 0.0
            now = self._time()
            return max(now - e.enqueued_at for e in self._entries)

    def position_of(self, ticket: SolveTicket) -> Optional[int]:
        with self._lock:
            ordered = sorted(self._entries, key=self._dispatch_key)
            for i, e in enumerate(ordered):
                if e.ticket is ticket:
                    return i
            return None

    def estimated_start_ms(self, ticket: SolveTicket) -> float:
        started = ticket.started_at
        if started is not None:
            return started * 1000.0
        pos = self.position_of(ticket)
        now = self._time()
        if pos is None:       # resolved before it ever dispatched
            return now * 1000.0
        with self._lock:
            per_solve = max(self._latency_ewma_s, 0.1)
        return (now + (pos + 1) * per_solve) * 1000.0

    # ------------------------------------------------------------------
    # latency EWMA -> Retry-After
    # ------------------------------------------------------------------
    def observe_latency(self, duration_s: float) -> None:
        with self._lock:
            if self._latency_samples == 0:
                self._latency_ewma_s = duration_s
            else:
                self._latency_ewma_s = (self._ALPHA * duration_s
                                        + (1 - self._ALPHA)
                                        * self._latency_ewma_s)
            self._latency_samples += 1

    def latency_ewma_s(self) -> float:
        with self._lock:
            return self._latency_ewma_s

    def _retry_after_locked(self, klass: SchedulerClass) -> float:
        """Caller holds the lock.  Depth x latency EWMA, clamped to
        [1s, 600s]: roughly when the rejected class's backlog will have
        drained."""
        per_solve = max(self._latency_ewma_s, 0.1)
        depth = self._depth[klass] + 1
        return min(600.0, max(1.0, depth * per_solve))
