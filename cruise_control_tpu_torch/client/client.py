"""Python client for the REST API (port of cruise_control_tpu/client/
client.py).

Reference cruise-control-client/ (~2K LoC): Endpoint classes with allowed
parameters, a Responder that long-polls async responses via the
`User-Task-ID` header, and the `cccli` CLI on top.  Stdlib urllib only.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Mapping, Optional, Sequence

from cruise_control_tpu_torch.api.parameters import (GET_ENDPOINTS,
                                                     VALID_PARAMS)
from cruise_control_tpu_torch.api.user_tasks import USER_TASK_ID_HEADER


class CruiseControlClientError(Exception):
    def __init__(self, status: int, message: str,
                 backpressure: bool = False) -> None:
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message
        #: True when the failure was GENUINE backpressure the client
        #: retried and gave up on (429, or 503 with a Retry-After
        #: drain hint) — a bare 503 is a server fault, not
        #: backpressure, and consumers like the load harness must not
        #: score it against the lenient rejected-rate cap
        self.backpressure = backpressure


class CruiseControlClient:
    """One method per endpoint; async responses are long-polled to
    completion (reference Responder.py / ExecutionContext)."""

    def __init__(self, base_url: str,
                 auth_header: Optional[str] = None,
                 poll_interval_s: float = 1.0,
                 timeout_s: float = 600.0,
                 wait_default: bool = True,
                 max_retries_429: int = 4,
                 retry_backoff_base_s: float = 1.0,
                 retry_backoff_max_s: float = 30.0,
                 retry_jitter_token: Optional[str] = None,
                 cluster: Optional[str] = None,
                 sleep_fn: Optional[Callable[[float], None]] = None,
                 on_retry: Optional[Callable[[str, int, int, float],
                                             None]] = None
                 ) -> None:
        self._base = base_url.rstrip("/")
        #: fleet tenant this client addresses: `cluster=<id>` rides on
        #: every request (server default tenant when None); an unknown
        #: tenant's 404 surfaces as CruiseControlClientError(404)
        self._cluster = cluster
        self._auth = auth_header
        self._poll_s = poll_interval_s
        self._timeout_s = timeout_s
        #: long-poll async operations to completion unless overridden
        self._wait_default = wait_default
        #: HTTP 429 (scheduler backpressure) retry policy: honor
        #: `Retry-After` with capped exponential backoff + deterministic
        #: jitter; 0 restores fail-fast
        self._max_retries_429 = max(0, max_retries_429)
        self._retry_base_s = retry_backoff_base_s
        self._retry_max_s = retry_backoff_max_s
        #: per-client jitter identity: each client hashes to its own
        #: point in the [0.5, 1.0) jitter window, so a fleet rejected
        #: together does not retry together; pass an explicit token for
        #: reproducible delays
        self._jitter_token = (retry_jitter_token
                              if retry_jitter_token is not None
                              else f"{os.getpid()}:{id(self):x}")
        self._sleep = sleep_fn or time.sleep
        #: backpressure observer hook: called with (endpoint, status,
        #: attempt, delay_s) BEFORE each 429/503-draining backoff sleep
        #: — the load harness counts rejections per request through it;
        #: exceptions are the caller's problem (None = no observer)
        self._on_retry = on_retry

    # ------------------------------------------------------------------
    def request(self, endpoint: str,
                params: Optional[Mapping[str, object]] = None,
                wait: Optional[bool] = None,
                body: Optional[dict] = None) -> dict:
        """`body` (a JSON-serializable dict) becomes the POST request
        body — SCENARIOS carries its spec list there.  Sent on the
        first request only; once a `User-Task-ID` is attached, re-polls
        go header-only (the server attaches by task id)."""
        if wait is None:
            wait = self._wait_default
        endpoint = endpoint.upper()
        legal = VALID_PARAMS.get(endpoint)
        if legal is None:
            raise ValueError(f"unknown endpoint {endpoint}")
        method = "GET" if endpoint in GET_ENDPOINTS else "POST"
        data = (json.dumps(body).encode() if body is not None else None)
        params = dict(params or {})
        if self._cluster is not None and "cluster" in legal \
                and "cluster" not in params:
            # thread the client's tenant through every subcommand
            # (FLEET spans the whole fleet and takes no cluster)
            params["cluster"] = self._cluster
        query = {}
        for k, v in params.items():
            if v is None:
                continue
            if k.lower() not in legal:
                raise ValueError(f"{endpoint} does not accept {k!r}; "
                                 f"legal: {sorted(legal)}")
            if isinstance(v, bool):
                v = "true" if v else "false"
            elif isinstance(v, (list, tuple)):
                v = ",".join(str(x) for x in v)
            elif isinstance(v, (set, frozenset)):
                v = ",".join(str(x) for x in sorted(v))
            query[k.lower()] = str(v)
        url = (f"{self._base}/{endpoint.lower()}"
               + (f"?{urllib.parse.urlencode(query)}" if query else ""))
        deadline = time.time() + self._timeout_s
        task_id: Optional[str] = None
        retries_429 = 0
        while True:
            # once a task id is attached, re-polls go header-only: the
            # server allows body-less re-polls, and re-uploading a large
            # spec body every poll interval is pure waste
            status, headers, body = self._http(
                method, url, task_id, data=None if task_id else data)
            task_id = headers.get(USER_TASK_ID_HEADER, task_id)
            if status == 200:
                return body
            if status == 429 or (status == 503
                                 and self._is_draining(headers, body)):
                # backpressure, both flavors: 429 = scheduler queue at
                # its cap, 503-draining = the process is shutting down
                # gracefully (api/server drain: Retry-After names when
                # the replacement should be up).  Same discipline for
                # both — honor Retry-After with capped exponential
                # backoff + deterministic jitter, then resubmit.  A
                # plain 503 WITHOUT a retry hint (e.g. a draining fleet
                # tenant mid-rebalance of tenants) still surfaces as an
                # error below.  The response carries the FAILED task's
                # User-Task-ID for diagnostics — drop it, or the retry
                # would attach to the dead task (and replay its cached
                # rejection) instead of resubmitting
                task_id = None
                delay = self._retry_delay_429(endpoint, retries_429,
                                              headers, body)
                if (retries_429 >= self._max_retries_429
                        or time.time() + delay > deadline):
                    raise CruiseControlClientError(
                        status, body.get(
                            "errorMessage",
                            "rejected: solve queue full" if status == 429
                            else "server draining")
                        + f" (gave up after {retries_429} retries)",
                        backpressure=True)
                retries_429 += 1
                if self._on_retry is not None:
                    self._on_retry(endpoint, status, retries_429, delay)
                self._sleep(delay)
                continue
            if status == 202 and "reviewResult" in body:
                # two-step verification parked the request — re-polling
                # would file duplicate reviews; hand the review back
                return body
            if status == 202 and wait:
                if time.time() > deadline:
                    raise CruiseControlClientError(
                        202, f"operation did not finish within "
                             f"{self._timeout_s}s (task {task_id})")
                time.sleep(self._poll_s)
                continue
            if status == 202:
                return body
            raise CruiseControlClientError(
                status, body.get("errorMessage", str(body)))

    @staticmethod
    def _is_draining(headers: Mapping[str, str], body: Mapping) -> bool:
        """A 503 is RETRYABLE only when the server says when to come
        back (Retry-After header or retryAfterSeconds in the body) —
        the graceful-drain signature.  A bare 503 (misconfigured
        proxy, tenant drained for good) stays a hard error: blind
        retries against those just hammer a server that never asked
        for patience."""
        if any(k.lower() == "retry-after" for k in headers):
            return True
        try:
            return float(body.get("retryAfterSeconds", 0.0)) > 0
        except (TypeError, ValueError, AttributeError):
            return False

    def _retry_delay_429(self, endpoint: str, attempt: int,
                         headers: Mapping[str, str], body: Mapping
                         ) -> float:
        """Backoff before resubmitting a 429-rejected request: the
        server's `Retry-After` (header, or `retryAfterSeconds` in the
        body) floors a capped exponential backoff, and BOTH terms are
        scaled by a DETERMINISTIC jitter — same client token +
        endpoint + attempt always waits the same time (reproducible),
        while distinct clients hash to distinct points in the jitter
        window.  Retry-After is jittered UPWARD (never below the
        server's floor): when it dominates the backoff, an unjittered
        max() would have every rejected client sleep exactly the
        server's value and re-stampede the queue in lockstep."""
        retry_after = 0.0
        for k, v in headers.items():
            if k.lower() == "retry-after":
                try:
                    retry_after = float(v)
                except ValueError:
                    retry_after = 0.0
        if not retry_after:
            try:
                retry_after = float(body.get("retryAfterSeconds", 0.0))
            except (TypeError, ValueError):
                retry_after = 0.0
        backoff = min(self._retry_max_s,
                      self._retry_base_s * (2 ** attempt))
        seed = hashlib.sha256(
            f"{self._jitter_token}:{endpoint}:{attempt}".encode()).digest()
        jitter = 0.5 + seed[0] / 512.0          # [0.5, 1.0)
        jitter_up = 1.0 + seed[1] / 512.0       # [1.0, 1.5)
        return max(retry_after * jitter_up, backoff * jitter)

    def _http(self, method: str, url: str, task_id: Optional[str],
              data: Optional[bytes] = None):
        req = urllib.request.Request(url, method=method, data=data)
        if data is not None:
            req.add_header("Content-Type", "application/json")
        if self._auth:
            req.add_header("Authorization", self._auth)
        if task_id:
            req.add_header(USER_TASK_ID_HEADER, task_id)
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return (resp.status, dict(resp.headers.items()),
                        json.loads(resp.read() or b"{}"))
        except urllib.error.HTTPError as exc:
            try:
                body = json.loads(exc.read() or b"{}")
            except json.JSONDecodeError:
                body = {"errorMessage": str(exc)}
            return exc.code, dict(exc.headers.items() if exc.headers
                                  else {}), body

    # ------------------------------------------------------------------
    # endpoint convenience wrappers (reference Endpoint.py classes)
    # ------------------------------------------------------------------
    def state(self, substates: Optional[Sequence[str]] = None) -> dict:
        return self.request("STATE", {"substates": substates})

    def fleet(self, verbose: bool = False) -> dict:
        """Fleet tenant listing (404 on a non-fleet server)."""
        return self.request("FLEET", {"verbose": verbose or None})

    def load(self) -> dict:
        return self.request("LOAD")

    def partition_load(self, resource: str = "disk",
                       entries: Optional[int] = None,
                       topic: Optional[str] = None) -> dict:
        return self.request("PARTITION_LOAD", {
            "resource": resource, "entries": entries, "topic": topic})

    def proposals(self, goals: Optional[Sequence[str]] = None,
                  verbose: bool = False,
                  ignore_proposal_cache: bool = False,
                  portfolio_width: Optional[int] = None) -> dict:
        return self.request("PROPOSALS", {
            "goals": goals, "verbose": verbose,
            "ignore_proposal_cache": ignore_proposal_cache,
            "portfolio_width": portfolio_width})

    def kafka_cluster_state(self) -> dict:
        return self.request("KAFKA_CLUSTER_STATE")

    def user_tasks(self) -> dict:
        return self.request("USER_TASKS")

    def rebalance(self, dryrun: bool = True,
                  goals: Optional[Sequence[str]] = None,
                  verbose: bool = False, **params) -> dict:
        return self.request("REBALANCE", {
            "dryrun": dryrun, "goals": goals, "verbose": verbose, **params})

    def add_broker(self, broker_ids: Sequence[int], dryrun: bool = True,
                   **params) -> dict:
        return self.request("ADD_BROKER", {
            "brokerid": list(broker_ids), "dryrun": dryrun, **params})

    def remove_broker(self, broker_ids: Sequence[int], dryrun: bool = True,
                      **params) -> dict:
        return self.request("REMOVE_BROKER", {
            "brokerid": list(broker_ids), "dryrun": dryrun, **params})

    def demote_broker(self, broker_ids: Sequence[int], dryrun: bool = True,
                      **params) -> dict:
        return self.request("DEMOTE_BROKER", {
            "brokerid": list(broker_ids), "dryrun": dryrun, **params})

    def fix_offline_replicas(self, dryrun: bool = True, **params) -> dict:
        return self.request("FIX_OFFLINE_REPLICAS",
                            {"dryrun": dryrun, **params})

    def stop_execution(self, force: bool = False) -> dict:
        return self.request("STOP_PROPOSAL_EXECUTION",
                            {"force_stop": force})

    def pause_sampling(self, reason: str = "") -> dict:
        return self.request("PAUSE_SAMPLING",
                            {"reason": reason} if reason else {})

    def resume_sampling(self, reason: str = "") -> dict:
        return self.request("RESUME_SAMPLING",
                            {"reason": reason} if reason else {})

    def admin(self, **params) -> dict:
        return self.request("ADMIN", params)

    def topic_configuration(self, topic: str, replication_factor: int,
                            dryrun: bool = True, **params) -> dict:
        return self.request("TOPIC_CONFIGURATION", {
            "topic": topic, "replication_factor": replication_factor,
            "dryrun": dryrun, **params})

    def review(self, approve: Optional[Sequence[int]] = None,
               discard: Optional[Sequence[int]] = None,
               reason: str = "") -> dict:
        return self.request("REVIEW", {
            "approve": list(approve) if approve else None,
            "discard": list(discard) if discard else None,
            "reason": reason or None})

    def review_board(self) -> dict:
        return self.request("REVIEW_BOARD")

    def traces(self, trace_id: Optional[str] = None,
               outcome: Optional[str] = None,
               limit: Optional[int] = None,
               verbose: bool = False,
               since_ms: Optional[float] = None,
               min_duration_ms: Optional[float] = None) -> dict:
        """Flight-recorder query (obs/): the span trees of recent
        solves.  Fetch the tree a solve response's `traceId` named with
        `trace_id=`, the pinned incident traces with
        `outcome="degraded"`.  `since_ms` (epoch ms) and
        `min_duration_ms` bound drill queries under load so a tail
        never pages the whole ring."""
        return self.request("TRACES", {
            "trace_id": trace_id, "outcome": outcome, "limit": limit,
            "verbose": verbose or None, "since": since_ms,
            "min_duration_ms": min_duration_ms})

    def slo_status(self) -> dict:
        """The per-class SLO burn block (obs/slo.py): STATE's
        `sloStatus` substate — burn rate, queue-wait vs device-time
        decomposition and budget remaining per scheduler class."""
        return self.state(substates=["slo"]).get("sloStatus", {})

    def portfolio_status(self) -> dict:
        """The portfolio-search block (portfolio/): STATE's `portfolio`
        substate — width/seed config, search + ladder telemetry, the
        improvement/stale-drop counters and the portfolio-vs-greedy
        fitness gap."""
        return self.state(substates=["portfolio"]).get(
            "PortfolioState", {})

    def metrics_text(self) -> str:
        """The raw OpenMetrics page (`/metrics`) — what a Prometheus
        scrape sees.  Served OUTSIDE the API prefix."""
        # /metrics lives one level above the API prefix: strip ONLY the
        # last path segment so a path-mounting reverse proxy
        # ("https://proxy/cc/kafkacruisecontrol" -> ".../cc/metrics")
        # keeps routing to the same backend
        parsed = urllib.parse.urlsplit(self._base)
        parent = parsed.path.rstrip("/").rsplit("/", 1)[0]
        root = urllib.parse.urlunsplit(
            (parsed.scheme, parsed.netloc, parent, "", ""))
        req = urllib.request.Request(f"{root}/metrics", method="GET")
        if self._auth:
            req.add_header("Authorization", self._auth)
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.read().decode("utf-8")

    def scenarios(self, scenarios: Sequence[dict],
                  goals: Optional[Sequence[str]] = None,
                  include_base: bool = True,
                  verbose: bool = False, **params) -> dict:
        """Batched what-if analysis (dry-run only).  `scenarios` is a
        list of scenario objects in the JSON form of
        scenario/spec.py::SCENARIO_SPEC_SCHEMA."""
        body: dict = {"scenarios": list(scenarios)}
        if goals:
            body["goals"] = list(goals)
        if not include_base:
            body["includeBase"] = False
        return self.request("SCENARIOS", {"verbose": verbose, **params},
                            body=body)
