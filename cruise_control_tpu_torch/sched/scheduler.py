"""The device-time scheduler: one dispatch loop owning the device (port
of cruise_control_tpu/sched/scheduler.py).

Every solve of the facade — requests, the proposal precompute, what-if
sweeps — is wrapped in a `SolveJob` and submitted here; submitters block
on a `SolveTicket` while the one dispatch thread runs jobs one at a time
in effective-priority order (policy.py).  That gives:

* **priority admission** — a heal never waits behind queued sweeps, and
  aging keeps the background classes from starving;
* **single-flight coalescing** — identical queued or in-flight requests
  attach to one solve (queue.py);
* **scenario folding** — compatible queued SCENARIO_SWEEP jobs merge into
  one engine batch, and the outcomes split back to each caller;
* **preemption** — a preemptible job (PRECOMPUTE, SCENARIO_SWEEP) yields
  at the next goal-segment boundary when a more urgent class queues
  (runtime.segment_checkpoint); it is re-queued with its aging intact and
  runs again from the start, the proposal cache and the warm seed
  untouched;
* **backpressure** — admission beyond a class's queue cap raises
  QueueFullError.

The solve itself is whatever the facade wrapped: the degradation ladder
and the scenario engine run unchanged inside the job.  The port has one
device and no mesh, so no job runs under a mesh token
(`runtime.current_mesh_token()` stays None) and every `SolvePreempted`
is a preemption.

Fault site: ``sched.dispatch`` fires before every job the dispatch
thread executes.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Any, Callable, List, Optional

from cruise_control_tpu_torch.obs import trace as obs_trace
from cruise_control_tpu_torch.sched import runtime
from cruise_control_tpu_torch.sched.policy import (SchedulerClass,
                                                   SchedulerPolicy)
from cruise_control_tpu_torch.sched.queue import (AdmissionQueue,
                                                  QueueFullError, SolveTicket)
from cruise_control_tpu_torch.sched.stats import SchedulerStats, attach_metrics
from cruise_control_tpu_torch.utils import faults

LOG = logging.getLogger(__name__)

__all__ = ["SolveJob", "DeviceTimeScheduler", "FoldedFailure",
           "QueueFullError", "SchedulerClass", "SolveTicket"]


class FoldedFailure:
    """Per-entry failure marker a `fold_run` may return IN PLACE of a
    result: that entry's ticket fails with `exc` while its fold peers
    still resolve normally.  Raising inside fold_run fails the whole
    fold."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


@dataclasses.dataclass
class SolveJob:
    """One unit of device work.

    `run` executes the solve and returns its result.  `coalesce_key`
    (optional) enables single-flight: identical keys share one
    execution.  Fold support (SCENARIO_SWEEP): jobs sharing a non-None
    `fold_key` may be merged — the scheduler calls `fold_run` with the
    list of every folded job's `fold_payload` and expects one result per
    payload, in order."""

    klass: SchedulerClass
    run: Callable[[], Any]
    label: str = ""
    coalesce_key: Optional[tuple] = None
    preemptible: bool = False
    fold_key: Optional[tuple] = None
    fold_payload: Any = None
    fold_run: Optional[Callable[[List[Any]], List[Any]]] = None
    #: obs.trace.TraceContext of the submitting request: the dispatch
    #: thread activates it around the solve so queue-wait, dispatch,
    #: fold and preemption land in the request's span tree.  Every
    #: facade submission carries one; None = untraced
    trace: Optional[object] = None


class SchedulerStoppedError(RuntimeError):
    """The scheduler shut down while this request was queued."""


class DeviceTimeScheduler:
    """See module docstring.  `enabled=False` degenerates to running
    every job inline on the submitting thread (still inside the gateway,
    so the single-gateway invariant holds either way) — the K=1
    single-client path is byte-identical in both modes because the job
    body is the same code."""

    def __init__(self, policy: Optional[SchedulerPolicy] = None,
                 enabled: bool = True,
                 max_fold: int = 8,
                 time_fn: Optional[Callable[[], float]] = None) -> None:
        import time as _time
        self.policy = policy or SchedulerPolicy.default()
        self.enabled = enabled
        self._max_fold = max(1, max_fold)
        #: INLINE jobs currently executing (disabled scheduler /
        #: nested dispatcher submits — they never touch the queue, so
        #: the queue's in-service count cannot see them): the drain
        #: path's quiesce() reads it alongside queue.idle()
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._time = time_fn or _time.time
        self.queue = AdmissionQueue(self.policy, self._time)
        self.stats = SchedulerStats(self._time)
        self._metrics = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._thread_lock = threading.Lock()

    # ------------------------------------------------------------------
    def attach_metrics(self, registry) -> None:
        self._metrics = registry
        attach_metrics(registry, self)

    def _mark(self, sensor: str, n: int = 1) -> None:
        if self._metrics is not None:
            self._metrics.meter(sensor).mark(n)

    # ------------------------------------------------------------------
    # submission (blocking: the caller's thread waits on the ticket)
    # ------------------------------------------------------------------
    def submit(self, job: SolveJob,
               timeout: Optional[float] = None) -> Any:
        """Run `job` under the scheduler and return its result (or raise
        what it raised).  Raises QueueFullError at the class queue cap.

        Inline execution (no queue) happens when the scheduler is
        disabled or when the DISPATCH THREAD itself submits (a scheduled
        job that submits nested device work must not deadlock waiting
        for the busy dispatcher).  A submission after stop() is rejected
        with SchedulerStoppedError — running it inline would race the
        rest of teardown with a full device solve (facade.shutdown
        relies on nothing new being admitted)."""
        if (self._stop.is_set() and self.enabled
                and threading.current_thread() is not self._thread):
            raise SchedulerStoppedError(
                "scheduler is stopped; not accepting new solves")
        self.stats.record_submitted()
        if (not self.enabled
                or threading.current_thread() is self._thread):
            t0 = self._time()
            failed = True
            with self._inflight_lock:
                self._inflight += 1
            try:
                with runtime.gateway():
                    result = job.run()
                failed = False
                return result
            finally:
                with self._inflight_lock:
                    self._inflight -= 1
                self.stats.record_done(self._time() - t0, failed)
        try:
            ticket, created = self.queue.offer(job)
        except QueueFullError:
            self.stats.record_rejected()
            self._mark("sched-rejected-requests")
            obs_trace.event("sched.rejected", klass=job.klass.name,
                            ctx=job.trace)
            raise
        if created:
            self._ensure_dispatcher()
        else:
            self.stats.record_coalesced()
            self._mark("sched-coalesced-requests")
            # the waiter's own trace links the leader's solve: a
            # coalesced request never runs its job, so this span is its
            # whole device story
            now = self._time()
            obs_trace.record_span("sched.coalesced", now, now,
                                  ctx=job.trace,
                                  leaderTraceId=ticket.trace_id,
                                  klass=job.klass.name)
        runtime.notify_submission(ticket)
        return ticket.wait(timeout)

    def _ensure_dispatcher(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        with self._thread_lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name="solve-scheduler", daemon=True)
                self._thread.start()

    # ------------------------------------------------------------------
    # dispatch loop
    # ------------------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            entry = self.queue.take(self._stop)
            if entry is None:
                continue
            entries = [entry]
            job = entry.job
            if job.fold_key is not None and job.fold_run is not None:
                entries += self.queue.take_fold_peers(job.fold_key,
                                                      self._max_fold - 1)
            self._execute(entries)
        for entry in self.queue.drain():
            self.queue.finish(entry)
            entry.ticket.fail(SchedulerStoppedError(
                "scheduler stopped while the request was queued"))

    def _execute(self, entries: List) -> None:
        job = entries[0].job
        now = self._time()
        best = min(e.best_klass for e in entries)
        lead_trace = getattr(job, "trace", None)
        lead_trace_id = (getattr(lead_trace, "trace_id", None)
                         if lead_trace is not None else None)
        for i, e in enumerate(entries):
            # wait sampled since the LAST (re)queue: a redispatch after
            # preemption logs only the incremental wait, not the full
            # original wait again
            self.stats.record_dispatch(e.best_klass,
                                       now - e.last_queued_at)
            if self._metrics is not None:
                name = e.best_klass.name.lower().replace("_", "-")
                self._metrics.update_timer(f"sched-wait-timer-{name}",
                                           now - e.last_queued_at)
                self._metrics.update_histogram(
                    f"sched-wait-hist-{name}", now - e.last_queued_at)
            tc = getattr(e.job, "trace", None)
            obs_trace.record_span("sched.queue-wait", e.last_queued_at,
                                  now, ctx=tc,
                                  klass=e.best_klass.name)
            if i > 0:
                # fold members: each folded tenant's trace records its
                # LANE in the shared dispatch plus the leader it rode
                obs_trace.record_span("sched.fold-member", now, now,
                                      ctx=tc, lane=i,
                                      leaderTraceId=lead_trace_id)
        if len(entries) > 1:
            obs_trace.event("sched.fold", ctx=lead_trace,
                            members=len(entries))
        check = None
        if (job.preemptible and self.policy.preemption_enabled):
            # evaluate BOTH sides LIVE at each checkpoint: a more urgent
            # request coalescing onto this in-flight solve upgrades
            # best_klass, and the running job's own aging credit keeps
            # accruing (requeue preserves enqueued_at) — so each
            # preemption raises the bar the queued traffic must clear,
            # and a repeatedly-preempted job eventually completes
            # instead of livelocking under sustained interactive load
            def check():
                now = self._time()
                running = min(self.policy.effective_priority(
                    e.best_klass, now - e.enqueued_at) for e in entries)
                return self.queue.has_effective_better_than(running)
        t0 = self._time()
        # every taken entry must be settled exactly once: requeued
        # entries settle inside queue.requeue (atomically with the
        # re-add), everything else through done_serving in the finally
        served = len(entries)
        try:
            faults.inject("sched.dispatch")
            with runtime.gateway(check, async_dispatch=True), \
                    obs_trace.activate(lead_trace):
                with obs_trace.span("sched.dispatch", klass=best.name,
                                    label=job.label,
                                    folded=len(entries)):
                    if len(entries) > 1:
                        results = job.fold_run(
                            [e.job.fold_payload for e in entries])
                        if len(results) != len(entries):
                            raise RuntimeError(
                                f"fold_run returned {len(results)} "
                                f"results for {len(entries)} folded "
                                f"jobs")
                    else:
                        results = [job.run()]
        except runtime.SolvePreempted:
            # the yielded segments really ran on the device: count them
            # busy (occupancy must not read idle under preemption
            # thrash), but not as a latency sample
            self.stats.record_preempted(len(entries),
                                        busy_s=self._time() - t0)
            self._mark("sched-preemptions", len(entries))
            LOG.info("preempted %s job %r at a segment boundary "
                     "(%d queued above it); re-queued",
                     best.name, job.label, self.queue.depth())
            for e in entries:
                tc = getattr(e.job, "trace", None)
                if tc is not None:
                    tc.trace.mark("preempted")
                obs_trace.record_span("sched.preempted", t0,
                                      self._time(), ctx=tc,
                                      klass=e.best_klass.name,
                                      meshRequeue=False)
            for e in entries:
                self.queue.requeue(e)
            served = 0
            return
        except BaseException as exc:  # noqa: BLE001 - resolve the waiters
            duration = self._time() - t0
            self.stats.record_done(duration, failed=True)
            # NOT a latency sample (same rule as preemption): a solve
            # failing fast — e.g. invalid model input raised in 0.1s —
            # would collapse the EWMA and have Retry-After tell rejected
            # clients to hammer the server every ~1s for the duration of
            # an incident, instead of backing off on the scale of a real
            # solve
            LOG.warning("scheduled %s job %r failed: %s: %s", best.name,
                        job.label, type(exc).__name__, exc)
            for e in entries:
                self.queue.finish(e)
                e.ticket.fail(exc)
            return
        finally:
            self.queue.done_serving(served)
        duration = self._time() - t0
        self.stats.record_done(duration, failed=False)
        self.queue.observe_latency(duration)
        self._mark("sched-dispatches")
        if self._metrics is not None:
            self._metrics.update_timer("sched-solve-timer", duration)
            self._metrics.update_histogram("sched-solve-hist", duration)
            busy = best.name.lower().replace("_", "-")
            self._metrics.update_histogram(
                f"sched-device-busy-hist-{busy}", duration)
        if len(entries) > 1:
            self.stats.record_folded(len(entries) - 1)
            self._mark("sched-folded-sweeps", len(entries) - 1)
        for e, result in zip(entries, results):
            self.queue.finish(e)
            if isinstance(result, FoldedFailure):
                e.ticket.fail(result.exc)
            else:
                e.ticket.resolve(result)

    # ------------------------------------------------------------------
    def quiesce(self, timeout_s: float, poll_s: float = 0.05) -> bool:
        """Bounded wait for the scheduler to go idle: no queued jobs
        and nothing in flight (dispatch thread or inline).  A graceful
        drain calls this after admission has stopped, so idleness is
        terminal.  Wall-clock
        bounded with real time — a wedged in-flight solve must not
        hold shutdown hostage (the same rule as the precompute
        watchdog); returns False when the timeout elapsed first."""
        import time as _real_time
        deadline = _real_time.monotonic() + max(0.0, timeout_s)
        while True:
            with self._inflight_lock:
                inline_busy = self._inflight
            # queue.idle() counts taken-but-unfinished entries under
            # the queue's own lock, so a job the dispatch loop has
            # popped but not yet started can never slip past the drain
            if self.queue.idle() and inline_busy == 0:
                return True
            if _real_time.monotonic() >= deadline:
                return False
            _real_time.sleep(poll_s)

    # ------------------------------------------------------------------
    def stop(self, join_timeout_s: float = 5.0) -> None:
        """Stop dispatching; pending tickets fail with
        SchedulerStoppedError.  A wedged in-flight solve cannot be
        aborted from Python — the daemon dispatch thread dies with the
        process, mirroring the precompute watchdog's shutdown rule."""
        self._stop.set()
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=join_timeout_s)
            if thread.is_alive():
                LOG.warning("solve-scheduler still running after %.0fs "
                            "join timeout; shutting down around it",
                            join_timeout_s)
        # the loop drains on exit; drain here too for the never-started
        # or wedged-thread cases
        for entry in self.queue.drain():
            self.queue.finish(entry)
            entry.ticket.fail(SchedulerStoppedError(
                "scheduler stopped while the request was queued"))

    # ------------------------------------------------------------------
    def to_json(self) -> dict:
        depths = self.queue.depths()
        return {
            "enabled": self.enabled,
            "mesh": {"devices": 1, "axis": None, "platform": None},
            "policy": self.policy.to_json(),
            "queueDepthByClass": {c.name: d for c, d in depths.items()},
            "queueDepth": sum(depths.values()),
            "oldestWaitS": round(self.queue.oldest_wait_s(), 3),
            "latencyEwmaS": round(self.queue.latency_ewma_s(), 3),
            "occupancy": round(self.stats.occupancy(), 4),
            **self.stats.to_json(),
        }
