"""User-task manager: async REST operation tracking (port of
cruise_control_tpu/api/user_tasks.py).

Reference CC/servlet/UserTaskManager.java:56-834 — every async request gets
a UUID (returned in the `User-Task-ID` response header); repeated requests
with the same task id (or same client + URL) attach to the in-flight
operation instead of starting a new one; completed tasks are retained for a
configurable time and listed by the USER_TASKS endpoint.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
import time as _time
import uuid as _uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

from cruise_control_tpu_torch.sched import runtime as sched_runtime

USER_TASK_ID_HEADER = "User-Task-ID"

#: endpoint -> task category (reference CruiseControlEndPoint.java:17-36
#: EndpointType: {KAFKA, CRUISE_CONTROL} x {ADMIN, MONITOR}); drives the
#: per-category completed-task retention/caps of UserTaskManagerConfig
ENDPOINT_CATEGORY: Dict[str, str] = {
    "BOOTSTRAP": "cruise.control.admin",
    "TRAIN": "cruise.control.admin",
    "LOAD": "kafka.monitor",
    "PARTITION_LOAD": "kafka.monitor",
    "PROPOSALS": "kafka.monitor",
    "STATE": "cruise.control.monitor",
    "ADD_BROKER": "kafka.admin",
    "REMOVE_BROKER": "kafka.admin",
    "FIX_OFFLINE_REPLICAS": "kafka.admin",
    "REBALANCE": "kafka.admin",
    "STOP_PROPOSAL_EXECUTION": "kafka.admin",
    "PAUSE_SAMPLING": "cruise.control.admin",
    "RESUME_SAMPLING": "cruise.control.admin",
    "KAFKA_CLUSTER_STATE": "kafka.monitor",
    "DEMOTE_BROKER": "kafka.admin",
    "USER_TASKS": "cruise.control.monitor",
    "REVIEW_BOARD": "cruise.control.monitor",
    "ADMIN": "cruise.control.admin",
    "REVIEW": "cruise.control.admin",
    "TOPIC_CONFIGURATION": "kafka.admin",
    "SCENARIOS": "kafka.monitor",
}


def body_fingerprint(body) -> str:
    """Stable short hash of a request body ("" for no body).  Dedup of
    async tasks keys on (client, endpoint+query, BODY): two scenario
    batches submitted with identical query strings but different JSON
    bodies are different operations and must not coalesce."""
    if body is None or body == "" or body == b"":
        return ""
    if isinstance(body, str):
        body = body.encode("utf-8", errors="replace")
    import hashlib
    return hashlib.sha256(body).hexdigest()[:16]


class TaskStatus(enum.Enum):
    ACTIVE = "Active"
    COMPLETED = "Completed"
    COMPLETED_WITH_ERROR = "CompletedWithError"


@dataclasses.dataclass
class UserTaskInfo:
    task_id: str
    endpoint: str
    query: str
    client_id: str
    start_ms: float
    future: Future
    status: TaskStatus = TaskStatus.ACTIVE
    end_ms: float = 0.0
    #: hash of the POST body this task was started with (dedup scope)
    body_hash: str = ""
    #: approximate JSON size of the completed result — large scenario
    #: reports are visible in USER_TASKS without fetching them
    result_bytes: Optional[int] = None
    #: scheduler ticket of the task's most recent solve submission
    #: (sched/queue.SolveTicket): surfaces WHY a task is waiting —
    #: class, queue position, estimated start
    sched_ticket: Optional[object] = None
    #: flight-recorder trace id of the operation (obs/trace.py): the
    #: same id the solve response body carries as `traceId`, so a
    #: USER_TASKS listing links straight into TRACES
    trace_id: str = ""
    #: which solver produced the completed result (portfolio/): the
    #: response body's solverProvenance block, lifted so a USER_TASKS
    #: listing shows portfolio wins without fetching each result
    solver_provenance: Optional[dict] = None

    def to_json(self) -> dict:
        out = {
            "UserTaskId": self.task_id,
            "RequestURL": f"{self.endpoint}?{self.query}" if self.query
                          else self.endpoint,
            "ClientIdentity": self.client_id,
            "StartMs": self.start_ms,
            "Status": self.status.value,
        }
        if self.trace_id:
            out["TraceId"] = self.trace_id
        if self.solver_provenance is not None:
            out["SolverProvenance"] = dict(self.solver_provenance)
        if self.body_hash:
            out["RequestBodySha"] = self.body_hash
        if self.result_bytes is not None:
            out["ResultSizeBytes"] = self.result_bytes
        ticket = self.sched_ticket
        if (ticket is not None and self.status == TaskStatus.ACTIVE
                and not ticket.done()):
            # device-time scheduler visibility: the class this task's
            # solve dispatches at (coalesced solves report the BEST
            # attached waiter's class), its 1-BASED place in the dispatch
            # order
            # (0 = on the device RIGHT NOW, never a queued state), and
            # the start estimate (actual start once dispatched,
            # queue-depth x latency-EWMA before).  Dropped once the
            # solve RESOLVES: a task still ACTIVE through a long
            # execution phase is no longer on (or waiting for) the
            # device, and reporting QueuePosition=0 for it would read
            # as a solve occupying the device
            out["SchedulerClass"] = ticket.klass.name
            position = ticket.queue_position()
            out["QueuePosition"] = 0 if position is None else position + 1
            out["EstimatedStartMs"] = round(ticket.estimated_start_ms(), 1)
        return out


class UserTaskManager:
    """Thread-safe registry of async operations."""

    def __init__(self, max_active_tasks: int = 25,
                 completed_retention_s: float = 24 * 3600.0,
                 max_cached_completed_tasks: Optional[int] = None,
                 attach_max_age_s: Optional[float] = None,
                 max_workers: int = 8,
                 category_retention_s: Optional[Dict[str, float]] = None,
                 category_max_cached: Optional[Dict[str, int]] = None,
                 time_fn: Optional[Callable[[], float]] = None) -> None:
        self._max_active = max_active_tasks
        self._retention_s = completed_retention_s
        #: completed-task cache cap (reference
        #: max.cached.completed.user.tasks): oldest evicted beyond this
        self._max_cached_completed = max_cached_completed_tasks
        #: per-category overrides (reference UserTaskManagerConfig
        #: completed.{kafka,cruise.control}.{admin,monitor}.* keys; the
        #: category of a task comes from ENDPOINT_CATEGORY)
        self._category_retention_s = category_retention_s or {}
        self._category_max_cached = category_max_cached or {}
        #: implicit same-client+URL resumption window (reference
        #: webserver.session.maxExpiryTimeMs session binding expiry)
        self._attach_max_age_s = attach_max_age_s
        self._time = time_fn or _time.time
        self._lock = threading.Lock()
        self._tasks: Dict[str, UserTaskInfo] = {}
        #: (client_id, endpoint+query, body hash) -> task id, for
        #: implicit resumption (body_fingerprint("")="" for body-less
        #: requests)
        self._by_request: Dict[Tuple[str, str, str], str] = {}
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="user-task")

    # ------------------------------------------------------------------
    def get_or_create(self, endpoint: str, query: str, client_id: str,
                      operation: Callable[[], Any],
                      task_id: Optional[str] = None,
                      body: Optional[str] = None,
                      trace_id: str = "") -> UserTaskInfo:
        """Attach to an existing task (by explicit id or same
        client+URL+body) or start `operation` on the pool.

        `body` is the raw POST body (endpoints like SCENARIOS carry
        their payload there): its hash joins the implicit dedup key so
        two different bodies behind identical query strings never
        coalesce into one task.  `trace_id` is the flight-recorder
        trace of the operation (used only when a NEW task starts;
        attaching re-polls report the original task's trace)."""
        now_ms = self._time() * 1000.0
        body_hash = body_fingerprint(body)
        key = (client_id, f"{endpoint}?{query}", body_hash)
        with self._lock:
            self._expire(now_ms)
            if task_id is not None:
                info = self._tasks.get(task_id)
                if info is None:
                    raise KeyError(f"unknown user task {task_id}")
                # compare PARSED params: clients may re-order or re-encode
                # the same query between polls
                import urllib.parse
                same = (info.endpoint == endpoint
                        and sorted(urllib.parse.parse_qsl(
                            info.query, keep_blank_values=True))
                        == sorted(urllib.parse.parse_qsl(
                            query, keep_blank_values=True)))
                if not same:
                    # a stale/reused header must not attach to a different
                    # operation (reference UserTaskManager scopes task ids
                    # to their request)
                    raise ValueError(
                        f"user task {task_id} belongs to "
                        f"{info.endpoint}?{info.query}, not "
                        f"{endpoint}?{query}")
                if body_hash and body_hash != info.body_hash:
                    # re-polls may omit the body (header-only long-poll);
                    # a DIFFERENT body under a reused header may not
                    # attach to the old operation
                    raise ValueError(
                        f"user task {task_id} was started with a "
                        f"different request body")
                return info
            existing = self._by_request.get(key)
            if existing is not None:
                info = self._tasks.get(existing)
                if info is not None and info.status == TaskStatus.ACTIVE:
                    return info
            active = sum(1 for t in self._tasks.values()
                         if t.status == TaskStatus.ACTIVE)
            if active >= self._max_active:
                raise RuntimeError(
                    f"too many active user tasks ({active}); retry later")
            new_id = str(_uuid.uuid4())

            def run() -> Any:
                # every scheduler submission the operation makes on this
                # worker thread lands back on the task, so USER_TASKS can
                # report QueuePosition/SchedulerClass/EstimatedStartMs
                sched_runtime.set_submission_listener(
                    lambda ticket: self._attach_ticket(new_id, ticket))
                try:
                    result = operation()
                    self._finish(new_id, TaskStatus.COMPLETED, result)
                    return result
                except BaseException:
                    self._finish(new_id, TaskStatus.COMPLETED_WITH_ERROR)
                    raise
                finally:
                    sched_runtime.clear_submission_listener()

            # submit while still holding the lock: the task must never be
            # visible with future=None (a concurrent identical request
            # attaches to it immediately)
            info = UserTaskInfo(new_id, endpoint, query, client_id, now_ms,
                                future=self._pool.submit(run),
                                body_hash=body_hash, trace_id=trace_id)
            self._tasks[new_id] = info
            self._by_request[key] = new_id
        return info

    @staticmethod
    def _result_size_bytes(result) -> Optional[int]:
        import json
        try:
            return len(json.dumps(result, default=str))
        except (TypeError, ValueError, RecursionError) as exc:
            # size is a courtesy note; an unserializable result is the
            # response layer's problem, not the task registry's
            import logging
            logging.getLogger(__name__).debug(
                "result size estimation failed: %s", exc)
            return None

    def _attach_ticket(self, task_id: str, ticket: object) -> None:
        with self._lock:
            info = self._tasks.get(task_id)
            if info is not None:
                info.sched_ticket = ticket

    def _finish(self, task_id: str, status: TaskStatus,
                result: Any = None) -> None:
        size = (self._result_size_bytes(result)
                if status is TaskStatus.COMPLETED else None)
        provenance = (result.get("solverProvenance")
                      if isinstance(result, dict) else None)
        with self._lock:
            info = self._tasks.get(task_id)
            if info is not None:
                info.status = status
                info.end_ms = self._time() * 1000.0
                info.result_bytes = size
                if provenance is not None:
                    info.solver_provenance = provenance

    def _retention_for(self, endpoint: str) -> float:
        cat = ENDPOINT_CATEGORY.get(endpoint)
        return self._category_retention_s.get(cat, self._retention_s)

    def _expire(self, now_ms: float) -> None:
        dead = [tid for tid, t in self._tasks.items()
                if t.status != TaskStatus.ACTIVE
                and t.end_ms < now_ms
                - self._retention_for(t.endpoint) * 1000.0]
        for tid in dead:
            info = self._tasks.pop(tid)
            self._by_request.pop(
                (info.client_id, f"{info.endpoint}?{info.query}",
                 info.body_hash), None)

        def evict_oldest_beyond(tasks, cap):
            done = sorted(tasks, key=lambda t: t.end_ms)
            for info in done[:max(0, len(done) - cap)]:
                self._tasks.pop(info.task_id, None)
                key = (info.client_id, f"{info.endpoint}?{info.query}",
                       info.body_hash)
                # only sever the binding if it still points at THIS task —
                # a newer ACTIVE task may have re-bound the same key
                if self._by_request.get(key) == info.task_id:
                    self._by_request.pop(key, None)

        for cat, cap in self._category_max_cached.items():
            evict_oldest_beyond(
                [t for t in self._tasks.values()
                 if t.status != TaskStatus.ACTIVE
                 and ENDPOINT_CATEGORY.get(t.endpoint) == cat], cap)
        if self._max_cached_completed is not None:
            evict_oldest_beyond([t for t in self._tasks.values()
                                 if t.status != TaskStatus.ACTIVE],
                                self._max_cached_completed)
        if self._attach_max_age_s is not None:
            attach_cutoff = now_ms - self._attach_max_age_s * 1000.0
            for key, tid in list(self._by_request.items()):
                info = self._tasks.get(tid)
                # ACTIVE tasks keep their binding — the implicit
                # same-client+URL resume flow must survive solves longer
                # than the session expiry
                if info is None or (info.status != TaskStatus.ACTIVE
                                    and info.start_ms < attach_cutoff):
                    self._by_request.pop(key, None)

    # ------------------------------------------------------------------
    def get(self, task_id: str) -> Optional[UserTaskInfo]:
        with self._lock:
            return self._tasks.get(task_id)

    def all_tasks(self) -> List[UserTaskInfo]:
        with self._lock:
            self._expire(self._time() * 1000.0)
            return sorted(self._tasks.values(), key=lambda t: -t.start_ms)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)
