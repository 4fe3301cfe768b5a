"""REST API server (port of cruise_control_tpu/api/server.py).

Reference CC/servlet/KafkaCruiseControlServlet.java:39-232 +
KafkaCruiseControlApp.java (Jetty wiring): 19 endpoints under
`/kafkacruisecontrol/...`, async POSTs tracked by the UserTaskManager with
`User-Task-ID` headers, optional two-step verification through the
purgatory, pluggable security.

The dispatch core (`handle_request`) is transport-free — the stdlib
ThreadingHTTPServer wrapper feeds it, and tests drive it directly.  Every
endpoint is served through the port's facade (facade.CruiseControl), so a
solve runs on the facade's device (the card unless it was built with
``device="cpu"``) behind its device-time scheduler; a kernel that fails to
build or launch raises through to a 500.  What the port does not have yet
answers as the reference's single-tenant server does (no fleet: every
`?cluster=` and FLEET answer 404), or raises the facade's
NotImplementedError naming the missing module (the ADMIN self-healing
switches need the anomaly detector, `portfolio_width > 1` portfolio
search): a 500.
"""
from __future__ import annotations

import json
import logging
import ssl
import threading
import time as _time
import urllib.parse
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Mapping, Optional, Tuple

from cruise_control_tpu_torch.analyzer.context import OptimizationOptions
from cruise_control_tpu_torch.api import responses as R
from cruise_control_tpu_torch.api.parameters import (GET_ENDPOINTS,
                                                     POST_ENDPOINTS,
                                                     VALID_PARAMS,
                                                     ParameterError,
                                                     QueryParams)
from cruise_control_tpu_torch.api.purgatory import Purgatory
from cruise_control_tpu_torch.api.security import (AuthenticationError,
                                                   AuthorizationError,
                                                   NoSecurityProvider,
                                                   SecurityProvider)
from cruise_control_tpu_torch.api.user_tasks import (USER_TASK_ID_HEADER,
                                                     UserTaskManager,
                                                     body_fingerprint)
from cruise_control_tpu_torch.executor.strategy import strategy_from_names
from cruise_control_tpu_torch.facade import (CruiseControl,
                                             OngoingExecutionError,
                                             _not_ported)
from cruise_control_tpu_torch.obs import export as obs_export
from cruise_control_tpu_torch.obs import recorder as obs_recorder
from cruise_control_tpu_torch.obs import trace as obs_trace
from cruise_control_tpu_torch.sched.queue import QueueFullError

LOG = logging.getLogger(__name__)
#: NCSA-style access log, one line per HTTP request (reference
#: KafkaCruiseControlApp NCSA access log)
ACCESS_LOG = logging.getLogger("accessLogger")
_NCSA_MONTHS = ("Jan", "Feb", "Mar", "Apr", "May", "Jun",
                "Jul", "Aug", "Sep", "Oct", "Nov", "Dec")

BASE_PATH = "/kafkacruisecontrol"

#: endpoints answered synchronously (no user task)
SYNC_ENDPOINTS = {"STATE", "KAFKA_CLUSTER_STATE", "USER_TASKS",
                  "REVIEW_BOARD", "REVIEW", "STOP_PROPOSAL_EXECUTION",
                  "PAUSE_SAMPLING", "RESUME_SAMPLING", "ADMIN", "FLEET",
                  "TRACES"}

#: the Prometheus scrape path, served OUTSIDE the API prefix (scrapers
#: conventionally hit bare /metrics); still behind authentication
METRICS_PATH = "/metrics"


class HttpError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status
        self.message = message


def make_server_ssl_context(certfile: str, keyfile: Optional[str] = None,
                            key_password: Optional[str] = None,
                            protocol: str = "TLS") -> ssl.SSLContext:
    """TLS context from PEM files (config keys `webserver.ssl.*`;
    reference KafkaCruiseControlApp SSL connector).  `certfile` may hold
    both certificate and key; pass `keyfile` when they are separate.
    `protocol` (webserver.ssl.protocol) floors the negotiated version:
    "TLS" (library default), "TLSv1.2" or "TLSv1.3"."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    floor = {"TLS": None, "TLSV1.2": ssl.TLSVersion.TLSv1_2,
             "TLSV1.3": ssl.TLSVersion.TLSv1_3}.get((protocol or
                                                     "TLS").upper())
    if floor is None and (protocol or "TLS").upper() != "TLS":
        raise ValueError(f"unsupported webserver.ssl.protocol "
                         f"{protocol!r}; use TLS, TLSv1.2 or TLSv1.3")
    if floor is not None:
        ctx.minimum_version = floor
    ctx.load_cert_chain(certfile, keyfile=keyfile or None,
                        password=key_password or None)
    return ctx


class CruiseControlApp:
    """Endpoint dispatch over a CruiseControl facade."""

    def __init__(self, cruise_control: CruiseControl,
                 security: Optional[SecurityProvider] = None,
                 two_step_verification: bool = False,
                 async_response_timeout_s: float = 1.0,
                 access_log: bool = True,
                 purgatory_kwargs: Optional[dict] = None,
                 user_task_kwargs: Optional[dict] = None,
                 cors_enabled: bool = False,
                 cors_origin: str = "*",
                 cors_allow_methods: str = "OPTIONS, GET, POST",
                 cors_expose_headers: str = USER_TASK_ID_HEADER,
                 url_prefix: Optional[str] = None,
                 endpoint_classes: Optional[dict] = None,
                 request_reason_required: bool = False,
                 session_path: str = "/",
                 ui_diskpath: str = "",
                 ui_urlprefix: str = "/ui",
                 time_fn: Optional[Callable[[], float]] = None,
                 fleet=None,
                 metrics_endpoint_enabled: bool = True) -> None:
        if fleet is not None:
            raise _not_ported("CruiseControlApp(fleet=...)",
                              "fleet/ package")
        self.cc = cruise_control
        self.security = security or NoSecurityProvider()
        #: per-endpoint (request class, parameters class) overrides
        #: (reference CruiseControlRequestConfig /
        #: CruiseControlParametersConfig; see api.request_registry)
        self._endpoint_classes = endpoint_classes or {}
        #: POSTs must carry a non-empty `reason` parameter (reference
        #: WebServerConfig `request.reason.required`)
        self._reason_required = request_reason_required
        #: cookie path for async-session tracking (reference
        #: `webserver.session.path`)
        self.session_path = session_path or "/"
        #: static UI serving (reference `webserver.ui.diskpath` /
        #: `webserver.ui.urlprefix`)
        self._ui_diskpath = ui_diskpath
        self._ui_urlprefix = (ui_urlprefix or "/ui").rstrip("/") or "/ui"
        self.purgatory = Purgatory(time_fn=time_fn,
                                   **(purgatory_kwargs or {})) \
            if two_step_verification else None
        self.user_tasks = UserTaskManager(time_fn=time_fn,
                                          **(user_task_kwargs or {}))
        self._async_timeout = async_response_timeout_s
        self._access_log = access_log
        #: CORS (reference webserver.http.cors.*): when enabled, every
        #: response carries the allow-origin header
        self._cors_headers = ({"Access-Control-Allow-Origin": cors_origin,
                               "Access-Control-Allow-Methods":
                               cors_allow_methods,
                               "Access-Control-Expose-Headers":
                               cors_expose_headers,
                               "Access-Control-Allow-Headers":
                               "Content-Type, Authorization, User-Task-ID"}
                              if cors_enabled else {})
        #: mount point (reference webserver.api.urlprefix)
        self.base_path = (url_prefix.rstrip("/") if url_prefix
                          else BASE_PATH)
        #: serve the OpenMetrics scrape page at /metrics
        #: (obs.metrics.endpoint.enabled)
        self._metrics_endpoint_enabled = metrics_endpoint_enabled
        #: graceful-drain state (main.py SIGTERM handler): Retry-After
        #: seconds while draining, None while serving normally.  Writes
        #: answer 503 + Retry-After (clients back off exactly like on a
        #: 429); reads keep working so operators can watch the drain.
        self._draining: Optional[float] = None
        self._http: Optional[ThreadingHTTPServer] = None

    # ------------------------------------------------------------------
    # graceful drain (SIGTERM path)
    # ------------------------------------------------------------------
    def drain(self, retry_after_s: float = 30.0) -> None:
        """Stop admitting WRITES: every POST answers 503 + Retry-After
        (the same backpressure contract as the scheduler's 429 — the
        client honors the hint and retries against the replacement
        process).  Reads stay up so STATE/TRACES remain queryable
        while the in-flight solve finishes."""
        self._draining = max(1.0, float(retry_after_s))

    @property
    def draining(self) -> bool:
        return self._draining is not None

    # ------------------------------------------------------------------
    # transport-free dispatch
    # ------------------------------------------------------------------
    def handle_request(self, method: str, path: str, query_string: str = "",
                       headers: Optional[Mapping[str, str]] = None,
                       client: str = "local",
                       body: Optional[str] = None
                       ) -> Tuple[int, Dict[str, str], dict]:
        """(status, response headers, json body).  `body` is the raw
        request body (SCENARIOS carries its spec list there); it joins
        the user-task dedup key for async POSTs."""
        headers = dict(headers or {})
        # peer address as a pseudo-header for providers that filter on it
        # (trusted.proxy.services.ip.regex) — OVERWRITE unconditionally: a
        # client-supplied value must never reach the address filter
        headers["X-Remote-Addr"] = client
        if (method == "GET" and path == METRICS_PATH
                and self._metrics_endpoint_enabled):
            # OpenMetrics scrape: the facade's sensor registry as one
            # page (obs/export.py).  Authenticated like everything else —
            # sensor names leak topology
            try:
                self.security.authenticate(headers)
            except AuthenticationError as exc:
                status, hdrs, err = self._error(401, exc)
                return status, {**hdrs,
                                **self.security.auth_challenge_headers()}, \
                    err
            text = obs_export.render_for(self.cc)
            return 200, {}, {"__raw__": text.encode("utf-8"),
                             "__content_type__": obs_export.CONTENT_TYPE}
        if (method == "GET" and self._ui_diskpath
                and (path == self._ui_urlprefix
                     or path.startswith(self._ui_urlprefix + "/"))):
            # static UI sits behind authentication like every endpoint
            # (reference: Jetty's security handler fronts the whole server)
            try:
                self.security.authenticate(headers)
            except AuthenticationError as exc:
                status, hdrs, body = self._error(401, exc)
                return status, {**hdrs,
                                **self.security.auth_challenge_headers()}, \
                    body
            return self._serve_ui(path)
        try:
            endpoint = self._endpoint_of(method, path)
            principal = self.security.authenticate(headers)
            self.security.authorize(principal, endpoint)
            if self._draining is not None and (
                    endpoint in POST_ENDPOINTS or endpoint == "REVIEW"):
                # graceful drain: no new mutations once shutdown began
                # — clients treat the 503 + Retry-After like a 429 and
                # resubmit to the replacement process.  REVIEW is a
                # write too (the authz layer's definition): approving a
                # purgatory request mutates state the exit would lose
                import math
                retry_after = max(1, int(math.ceil(self._draining)))
                return 503, {"Retry-After": str(retry_after)}, {
                    "errorMessage": "ServerDraining: shutting down; "
                                    "retry against the replacement "
                                    "process",
                    "retryAfterSeconds": retry_after, "version": 1}
            req_cls, par_cls = self._endpoint_classes.get(
                endpoint, (None, QueryParams))
            params = par_cls(
                endpoint, urllib.parse.parse_qs(query_string,
                                                keep_blank_values=True))
            # tenant resolution: any `?cluster=` answers 404 (no fleet),
            # resolved BEFORE metering as in the reference
            cc = self._cc_for(params)
            # per-endpoint request sensors (reference servlet meters/timers,
            # KafkaCruiseControlServlet.java:60-65)
            registry = getattr(cc, "metrics", None)
            if registry is not None:
                registry.meter(f"{endpoint}-request-rate").mark()
            if (self._reason_required and endpoint in POST_ENDPOINTS
                    and "reason" in VALID_PARAMS[endpoint]
                    and not params.get("reason")):
                raise ParameterError(
                    f"{endpoint} requires a reason parameter "
                    f"(request.reason.required=true)")
            request = req_cls(endpoint) if req_cls is not None else None
            if endpoint in SYNC_ENDPOINTS:
                if endpoint in POST_ENDPOINTS:
                    # sync mutating endpoints go through the purgatory too
                    parked = self._purgatory_gate(endpoint, params,
                                                  query_string, client)
                    if parked is not None:
                        return parked
                out = (request.handle_sync(self, params) if request
                       else self._handle_sync(endpoint, params, cc=cc))
                return 200, {}, out
            return self._handle_async(endpoint, params, query_string,
                                      client, headers, request=request,
                                      body=body, cc=cc)
        except (ParameterError, ValueError) as exc:
            return self._error(400, exc)
        except AuthenticationError as exc:
            status, hdrs, body = self._error(401, exc)
            # advertise the login provider (jwt.authentication.provider.url)
            return status, {**hdrs,
                            **self.security.auth_challenge_headers()}, body
        except AuthorizationError as exc:
            return self._error(403, exc)
        except KeyError as exc:
            return self._error(404, exc)
        except OngoingExecutionError as exc:
            return self._error(409, exc)
        except QueueFullError as exc:
            # scheduler backpressure: the class queue is at its cap —
            # 429 with a Retry-After derived from the solve-latency EWMA
            return self._rate_limited(exc)
        except HttpError as exc:
            return self._error(exc.status, exc)
        except Exception as exc:  # noqa: BLE001 - 500 with message
            LOG.exception("request failed")
            return self._error(500, exc)

    @staticmethod
    def _error(status: int, exc: Exception) -> Tuple[int, Dict[str, str],
                                                     dict]:
        return status, {}, {"errorMessage": f"{type(exc).__name__}: {exc}",
                            "version": 1}

    @staticmethod
    def _rate_limited(exc: "QueueFullError",
                      extra_headers: Optional[Dict[str, str]] = None
                      ) -> Tuple[int, Dict[str, str], dict]:
        """429 + Retry-After for scheduler queue-cap rejections.  The
        body repeats the hint as `retryAfterSeconds` for clients that
        cannot read headers."""
        import math
        retry_after = max(1, int(math.ceil(exc.retry_after_s)))
        return 429, {**(extra_headers or {}),
                     "Retry-After": str(retry_after)}, \
            {"errorMessage": f"{type(exc).__name__}: {exc}",
             "retryAfterSeconds": retry_after, "version": 1}

    def _serve_ui(self, path: str) -> Tuple[int, Dict[str, str], dict]:
        """Serve the bundled UI from disk (reference
        `webserver.ui.diskpath` / `webserver.ui.urlprefix`; Jetty static
        resource handler).  Bodies carry raw bytes via the `__raw__`
        sentinel the HTTP layer streams verbatim."""
        import mimetypes
        import os
        rel = path[len(self._ui_urlprefix):].lstrip("/") or "index.html"
        root = os.path.abspath(self._ui_diskpath)
        full = os.path.abspath(os.path.join(root, rel))
        if not full.startswith(root + os.sep) and full != root:
            return 403, {}, {"errorMessage": "forbidden", "version": 1}
        if not os.path.isfile(full):
            return 404, {}, {"errorMessage": f"no such UI file {rel}",
                             "version": 1}
        ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
        with open(full, "rb") as fh:
            return 200, {}, {"__raw__": fh.read(),
                             "__content_type__": ctype}

    # ------------------------------------------------------------------
    # tenant resolution
    # ------------------------------------------------------------------
    def _cc_for(self, params: QueryParams):
        """The facade: the reference's single-tenant answer, 404 for any
        `?cluster=` (the port has no fleet)."""
        cluster = params.get("cluster") if "cluster" in \
            VALID_PARAMS.get(params.endpoint, set()) else None
        if cluster is not None:
            raise HttpError(
                404, f"unknown cluster {cluster!r}: this server is "
                     f"not running a fleet (--fleet-config)")
        return self.cc

    # public delegates for configured Request classes
    # (api.request_registry.Request defaults call back into these)
    def default_sync_handler(self, endpoint: str, params) -> dict:
        return self._handle_sync(endpoint, params,
                                 cc=self._cc_for(params))

    def default_operation(self, endpoint: str, params, body=None):
        return self._operation_for(endpoint, params, body=body,
                                   cc=self._cc_for(params))

    def _endpoint_of(self, method: str, path: str) -> str:
        base = self.base_path
        if not path.startswith(base + "/"):
            raise HttpError(404, f"unknown path {path}; expected "
                                 f"{base}/<endpoint>")
        endpoint = path[len(base) + 1:].strip("/").upper()
        if endpoint not in GET_ENDPOINTS and endpoint not in POST_ENDPOINTS \
                and endpoint != "REVIEW":
            raise HttpError(404, f"unknown endpoint {endpoint}")
        if method == "GET" and endpoint not in GET_ENDPOINTS:
            raise HttpError(405, f"{endpoint} is not a GET endpoint")
        if method == "POST" and endpoint not in POST_ENDPOINTS \
                and endpoint != "REVIEW":
            raise HttpError(405, f"{endpoint} is not a POST endpoint")
        return endpoint

    def _purgatory_gate(self, endpoint: str, params: QueryParams,
                        query_string: str, client: str,
                        body: Optional[str] = None
                        ) -> Optional[Tuple[int, Dict[str, str], dict]]:
        """Two-step verification: park unreviewed POSTs, consume approvals.
        Returns a parked-response triple, or None to proceed.

        For body-carrying endpoints (SCENARIOS) the BODY HASH joins the
        reviewed request identity: an approval must not be replayable
        with a different payload behind the same query string."""
        if self.purgatory is None or endpoint not in POST_ENDPOINTS:
            return None
        if body:
            sep = "&" if query_string else ""
            query_string = (f"{query_string}{sep}"
                            f"body_sha={body_fingerprint(body)}")
        review_id = params.get_int("review_id")
        if review_id is None:
            req = self.purgatory.submit(endpoint, query_string, client)
            return 202, {}, {"reviewResult": req.to_json(), "version": 1}
        self.purgatory.take_approved(review_id, endpoint, query_string)
        return None

    def _re_arming(self, op: Callable[[], dict], endpoint: str,
                   params: QueryParams) -> Callable[[], dict]:
        """Wrap a gated operation so a scheduler queue-cap rejection
        rolls the consumed one-shot approval back to APPROVED.  The
        rollback runs INSIDE the task (worker thread, exactly once,
        before the failed future resolves) rather than in the poll
        handler: the rejection may surface on the initial request, on a
        later re-poll carrying the task id, or on no poll at all — and a
        stale poll of a dead task must never re-arm an approval a
        successful retry has since re-consumed."""
        if self.purgatory is None or endpoint not in POST_ENDPOINTS:
            return op
        review_id = params.get_int("review_id")
        if review_id is None:
            return op

        def gated_op() -> dict:
            try:
                return op()
            except QueueFullError:
                self.purgatory.re_arm(review_id)
                raise
        return gated_op

    # ------------------------------------------------------------------
    # async machinery (reference handler/async + UserTaskManager)
    # ------------------------------------------------------------------
    def _handle_async(self, endpoint: str, params: QueryParams,
                      query_string: str, client: str,
                      headers: Mapping[str, str],
                      request=None, body: Optional[str] = None,
                      cc=None) -> Tuple[int, Dict[str, str], dict]:
        task_id = None
        for k, v in headers.items():
            if k.lower() == USER_TASK_ID_HEADER.lower():
                task_id = v
        # purgatory gate — skipped when re-polling an in-flight task (the
        # review id was already consumed when the task started)
        if task_id is None:
            parked = self._purgatory_gate(endpoint, params, query_string,
                                          client, body=body)
            if parked is not None:
                return parked
        trace = None
        if task_id is not None:
            # attach-only: get_or_create never runs the operation when a
            # task id is given (and a body-less re-poll must not trip
            # body validation in the operation builder)
            op: Callable[[], dict] = lambda: {}  # noqa: E731
        else:
            op = (request.operation(self, params) if request is not None
                  else self._operation_for(endpoint, params, body=body,
                                           cc=cc))
            op = self._re_arming(op, endpoint, params)
            # mint the request's TraceContext HERE — the transport edge
            # (obs/trace.py).  The operation runs on a USER_TASKS pool
            # worker, so the context crosses the thread hop inside
            # `finishing`; the trace finishes (and lands in the flight
            # recorder) when the OPERATION does, not when this poll
            # returns
            trace = obs_trace.start_detached(
                f"rest.{endpoint}", endpoint=endpoint, client=client,
                **({"cluster": params.get("cluster")}
                   if params.get("cluster") else {}))
            op = obs_trace.finishing(trace, op)
        info = self.user_tasks.get_or_create(
            endpoint, query_string, client, op, task_id=task_id,
            body=body,
            trace_id=trace.trace_id if trace is not None else "")
        # attach re-polls report the ORIGINAL operation's trace id
        trace_id = info.trace_id
        hdrs = {USER_TASK_ID_HEADER: info.task_id,
                # async session cookie scoped to the configured path
                # (reference webserver.session.path; the reference tracks
                # async requests per servlet session)
                "Set-Cookie": (f"CCSESSION={info.task_id}; "
                               f"Path={self.session_path}")}
        if trace_id:
            hdrs["Trace-Id"] = trace_id

        def with_trace(payload: dict) -> dict:
            # COPY instead of mutating: the payload may be the task's
            # cached result dict, shared with a concurrent poll of the
            # same (coalesced) task that is mid-serialization on
            # another handler thread
            if trace_id and isinstance(payload, dict) \
                    and "__raw__" not in payload \
                    and "traceId" not in payload:
                return {**payload, "traceId": trace_id}
            return payload

        try:
            result = info.future.result(timeout=self._async_timeout)
            return 200, hdrs, with_trace(result)
        except FutureTimeout:
            return 202, hdrs, with_trace(
                {"progress": [{"operation": endpoint,
                               "status": "InProgress"}],
                 "version": 1})
        except Exception as exc:  # noqa: BLE001 - operation failed
            LOG.warning("async %s operation failed: %s: %s", endpoint,
                        type(exc).__name__, exc)
            if isinstance(exc, QueueFullError):
                # the solve was rejected at the scheduler's queue cap:
                # backpressure, not failure — 429 + Retry-After (the
                # task id headers still ride along for diagnostics).
                # The consumed two-step approval was already re-armed
                # inside the task itself (_re_arming): the rejection may
                # surface on ANY poll of the task — or on none, if the
                # client gives up — so the rollback cannot live here
                status, rl_hdrs, rl_body = self._rate_limited(
                    exc, extra_headers=hdrs)
                return status, rl_hdrs, with_trace(rl_body)
            status = 409 if isinstance(exc, OngoingExecutionError) else 500
            return status, hdrs, with_trace(
                {"errorMessage": f"{type(exc).__name__}: {exc}",
                 "version": 1})

    # ------------------------------------------------------------------
    # per-endpoint operations
    # ------------------------------------------------------------------
    def _operation_for(self, endpoint: str, params: QueryParams,
                       body: Optional[str] = None,
                       cc=None) -> Callable[[], dict]:
        cc = cc if cc is not None else self.cc
        if endpoint == "SCENARIOS":
            # batched what-if analysis (scenario/engine.py): spec list in
            # the JSON body, DRY-RUN ONLY — the engine ranks
            # hypotheticals, it can never execute them.  Body validation
            # happens HERE (request time, 400 on garbage), not inside the
            # async task.
            from cruise_control_tpu_torch.scenario.report import \
                batch_report
            from cruise_control_tpu_torch.scenario.spec import \
                parse_scenarios_payload
            if not getattr(cc, "_scenario_enabled", True):
                # deterministic configuration rejection: answer 400 at
                # request time, not a failed task at poll time
                raise ValueError("the scenario engine is disabled "
                                 "(scenario.engine.enabled=false)")
            specs, goal_override, include_base = \
                parse_scenarios_payload(body)
            verbose = params.get_bool("verbose")
            reason = params.get("reason", "SCENARIOS via REST")

            def scenarios_op() -> dict:
                result = cc.evaluate_scenarios(
                    specs, goals=goal_override,
                    include_base=include_base, reason=reason)
                return batch_report(result, verbose=verbose)
            return scenarios_op

        if endpoint == "PROPOSALS":
            goals = params.get_csv("goals")
            verbose = params.get_bool("verbose")
            ignore_cache = params.get_bool("ignore_proposal_cache")
            excluded = params.get_csv("excluded_topics")
            portfolio_width = params.get_int("portfolio_width")
            options = (OptimizationOptions(
                excluded_topics=frozenset(excluded)) if excluded else None)

            def proposals_op() -> dict:
                result = cc.optimizations(goals, options,
                                          ignore_proposal_cache=ignore_cache,
                                          portfolio_width=portfolio_width)
                return R.optimization_result(result, verbose=verbose)
            return proposals_op

        if endpoint == "LOAD":
            def load_op() -> dict:
                state, topo = cc.cluster_model()
                return R.broker_stats(state, topo)
            return load_op

        if endpoint == "PARTITION_LOAD":
            resource = params.get_resource("resource")
            entries = params.get_int("entries")
            topic = params.get("topic")

            def partition_load_op() -> dict:
                state, topo = cc.cluster_model()
                return {"records": R.partition_load(
                    state, topo, resource=resource, entries=entries,
                    topic_pattern=topic),
                    "version": 1}
            return partition_load_op

        if endpoint == "BOOTSTRAP":
            def bootstrap_op() -> dict:
                # enough synchronous rounds to fill every window
                agg = cc.load_monitor.partition_aggregator
                rounds = agg.num_windows + 1
                cc.load_monitor.task_runner.bootstrap(rounds)
                return {"message": f"bootstrapped {rounds} sampling rounds",
                        "version": 1}
            return bootstrap_op

        if endpoint == "TRAIN":
            def train_op() -> dict:
                cc.load_monitor.train()
                return {"message": "training triggered", "version": 1}
            return train_op

        if endpoint in ("REBALANCE", "ADD_BROKER", "REMOVE_BROKER",
                        "DEMOTE_BROKER", "FIX_OFFLINE_REPLICAS",
                        "TOPIC_CONFIGURATION"):
            return self._mutation_operation(endpoint, params, cc=cc)

        raise HttpError(404, f"unhandled endpoint {endpoint}")

    def _mutation_operation(self, endpoint: str, params: QueryParams,
                            cc=None) -> Callable[[], dict]:
        cc = cc if cc is not None else self.cc
        dryrun = params.get_bool("dryrun", default=True)
        verbose = params.get_bool("verbose")
        goals = params.get_csv("goals")
        reason = params.get("reason", f"{endpoint} via REST")
        throttle = params.get_float("replication_throttle")
        exec_kwargs: dict = {}
        if throttle is not None:
            exec_kwargs["replication_throttle"] = throttle
        conc = params.get_int("concurrent_partition_movements_per_broker")
        if conc is not None:
            exec_kwargs["concurrent_inter_broker_moves"] = conc
        lead = params.get_int("concurrent_leader_movements")
        if lead is not None:
            exec_kwargs["concurrent_leader_movements"] = lead
        strategies = params.get_csv("replica_movement_strategies")
        strategy = strategy_from_names(strategies) if strategies else None

        if endpoint in ("ADD_BROKER", "REMOVE_BROKER", "DEMOTE_BROKER"):
            raw = params.get("brokerid") or ""
            if ";" in raw:
                # K candidate broker sets ("1,2;3,4"): the facade routes
                # these through the scenario engine (dry-run only) and
                # returns the ranked what-if report
                try:
                    broker_ids = [[int(x) for x in grp.split(",")
                                   if x.strip()]
                                  for grp in raw.split(";") if grp.strip()]
                except ValueError:
                    raise ParameterError(
                        "brokerid candidate sets must be CSV integers "
                        "separated by ';'")
            else:
                broker_ids = params.get_csv_ints("brokerid")
            if not broker_ids:
                raise ParameterError(f"{endpoint} requires brokerid")
        else:
            broker_ids = None

        def run() -> dict:
            if endpoint == "REBALANCE":
                excluded = params.get_csv("excluded_topics")
                dests = params.get_csv_ints("destination_broker_ids")
                options = None
                if excluded or dests:
                    options = OptimizationOptions(
                        excluded_topics=frozenset(excluded or ()),
                        requested_destination_broker_ids=frozenset(
                            dests or ()))
                op = cc.rebalance(goals=goals, dryrun=dryrun,
                                  options=options, reason=reason,
                                  strategy=strategy,
                                  ignore_proposal_cache=params.get_bool(
                                      "ignore_proposal_cache"),
                                  kafka_assigner=params.get_bool(
                                      "kafka_assigner"),
                                  portfolio_width=params.get_int(
                                      "portfolio_width"),
                                  **exec_kwargs)
            elif endpoint == "ADD_BROKER":
                op = cc.add_brokers(broker_ids, goals=goals, dryrun=dryrun,
                                    reason=reason, **exec_kwargs)
            elif endpoint == "REMOVE_BROKER":
                op = cc.remove_brokers(broker_ids, goals=goals,
                                       dryrun=dryrun, reason=reason,
                                       **exec_kwargs)
            elif endpoint == "DEMOTE_BROKER":
                op = cc.demote_brokers(broker_ids, dryrun=dryrun,
                                       reason=reason, **exec_kwargs)
            elif endpoint == "FIX_OFFLINE_REPLICAS":
                op = cc.fix_offline_replicas(goals=goals, dryrun=dryrun,
                                             reason=reason, **exec_kwargs)
            else:  # TOPIC_CONFIGURATION
                topic = params.get("topic")
                rf = params.get_int("replication_factor")
                if not topic or rf is None:
                    raise ParameterError(
                        "TOPIC_CONFIGURATION requires topic and "
                        "replication_factor")
                op = cc.update_topic_replication_factor(
                    topic, rf, goals=goals, dryrun=dryrun, reason=reason,
                    **exec_kwargs)
            if op.optimizer_result is not None:
                body = R.optimization_result(op.optimizer_result,
                                             verbose=verbose)
            else:   # direct-proposal operations (RF change, what-ifs)
                body = {"summary": {
                    "numReplicaMovements": sum(
                        1 for p in op.proposals if p.has_replica_action),
                    "numProposals": len(op.proposals)},
                    "goalSummary": []}
                if verbose:
                    body["proposals"] = [p.to_json() for p in op.proposals]
            if op.scenario_report is not None:
                # multiple candidate broker sets were ranked by the
                # scenario engine: the full report rides along, the
                # summary/proposals above describe the best candidate
                body["scenarioReport"] = op.scenario_report
            body["dryRun"] = op.dryrun
            if op.execution_uuid:
                body["executionId"] = op.execution_uuid
            return body
        return run

    # ------------------------------------------------------------------
    # sync endpoints
    # ------------------------------------------------------------------
    def _handle_sync(self, endpoint: str, params: QueryParams,
                     cc=None) -> dict:
        cc = cc if cc is not None else self.cc
        if endpoint == "FLEET":
            raise HttpError(404, "fleet serving is not configured "
                                 "(start with --fleet-config)")
        if endpoint == "TRACES":
            # flight-recorder query (obs/recorder.py): pinned incident
            # traces a query RETURNS count as exported and drop their
            # pin.  (`?cluster=` answered 404 in tenant resolution.)
            cluster = params.get("cluster")
            limit = params.get_int("limit")
            # a query only counts as an EXPORT (dropping pins) when it
            # delivers the span trees — a compact listing that stripped
            # them would unpin incident traces without ever handing
            # their evidence over
            deliver_trees = (params.get("trace_id") is not None
                             or params.get_bool("verbose"))
            traces = obs_recorder.get_recorder().query(
                trace_id=params.get("trace_id"), cluster=cluster,
                outcome=params.get("outcome"),
                limit=limit if limit is not None else 32,
                export=deliver_trees,
                since_ms=params.get_float("since"),
                min_duration_ms=params.get_float("min_duration_ms"))
            out = {"traces": traces,
                   "recorder": obs_recorder.get_recorder().to_json(),
                   "version": 1}
            if not deliver_trees:
                # compact listing: ids / outcomes / durations only (the
                # tree of ONE trace is what ?trace_id= fetches)
                out["traces"] = [
                    {k: v for k, v in t.items() if k != "root"}
                    for t in traces]
            return out
        if endpoint == "STATE":
            # the port facade's default substates (the reference's without
            # anomaly_detector and portfolio, whose modules wait)
            out = cc.state(params.get_csv("substates"))
            out["version"] = 1
            return out
        if endpoint == "KAFKA_CLUSTER_STATE":
            out = R.kafka_cluster_state(
                cc.load_monitor.metadata.refresh_metadata())
            out["version"] = 1
            return out
        if endpoint == "USER_TASKS":
            ids = params.get_csv("user_task_ids")
            tasks = self.user_tasks.all_tasks()
            if ids:
                tasks = [t for t in tasks if t.task_id in set(ids)]
            return {"userTasks": [t.to_json() for t in tasks], "version": 1}
        if endpoint == "REVIEW_BOARD":
            if self.purgatory is None:
                raise HttpError(400, "two-step verification is disabled")
            ids = params.get_csv_ints("review_ids")
            return {"requestInfo": [r.to_json() for r
                                    in self.purgatory.all_requests(ids)],
                    "version": 1}
        if endpoint == "REVIEW":
            if self.purgatory is None:
                raise HttpError(400, "two-step verification is disabled")
            approve = params.get_csv_ints("approve") or []
            discard = params.get_csv_ints("discard") or []
            reason = params.get("reason", "")
            changed = self.purgatory.review(approve, discard, reason)
            return {"requestInfo": [r.to_json() for r in changed],
                    "version": 1}
        if endpoint == "STOP_PROPOSAL_EXECUTION":
            cc.stop_execution(force=params.get_bool("force_stop"))
            return {"message": "execution stop requested", "version": 1}
        if endpoint == "PAUSE_SAMPLING":
            cc.pause_sampling(params.get("reason", "paused via REST"))
            return {"message": "sampling paused", "version": 1}
        if endpoint == "RESUME_SAMPLING":
            cc.resume_sampling(params.get("reason", "resumed via REST"))
            return {"message": "sampling resumed", "version": 1}
        if endpoint == "ADMIN":
            for param in ("enable_self_healing_for",
                          "disable_self_healing_for"):
                if params.get_csv(param):
                    # the self-healing switches live in the anomaly
                    # detector, which the port does not have yet
                    raise _not_ported(f"ADMIN {param}", "detector/ package")
            return {"version": 1}
        raise HttpError(404, f"unhandled sync endpoint {endpoint}")

    # ------------------------------------------------------------------
    # HTTP transport
    # ------------------------------------------------------------------
    def start(self, host: str = "127.0.0.1", port: int = 9090,
              ssl_context: Optional["ssl.SSLContext"] = None) -> int:
        """Start the HTTP(S) server; returns the bound port.

        `ssl_context` wraps the listening socket for TLS (reference
        KafkaCruiseControlApp.java:100-173 optional SSL connector); build
        one from config with `make_server_ssl_context`."""
        app = self

        class Handler(BaseHTTPRequestHandler):
            MAX_BODY_BYTES = 16 * 1024 * 1024

            def _dispatch(self, method: str) -> None:
                parsed = urllib.parse.urlsplit(self.path)
                request_body: Optional[str] = None
                if method == "POST":
                    try:
                        length = int(self.headers.get("Content-Length",
                                                      0) or 0)
                    except ValueError:
                        length = 0
                    if length > self.MAX_BODY_BYTES:
                        self.send_error(413, "request body too large")
                        return
                    if length > 0:
                        request_body = self.rfile.read(length).decode(
                            "utf-8", errors="replace")
                status, hdrs, body = app.handle_request(
                    method, parsed.path, parsed.query,
                    dict(self.headers.items()),
                    client=self.client_address[0],
                    body=request_body)
                hdrs = {**hdrs, **app._cors_headers}
                if isinstance(body, dict) and "__raw__" in body:
                    data = body["__raw__"]
                    ctype = body.get("__content_type__",
                                     "application/octet-stream")
                else:
                    data = json.dumps(body, indent=2).encode()
                    ctype = "application/json"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in hdrs.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self) -> None:  # noqa: N802 - stdlib API
                self._dispatch("GET")

            def do_POST(self) -> None:  # noqa: N802
                self._dispatch("POST")

            def do_OPTIONS(self) -> None:  # noqa: N802
                # CORS preflight: browsers send OPTIONS before any
                # cross-origin request carrying Authorization/User-Task-ID
                self.send_response(204)
                for k, v in app._cors_headers.items():
                    self.send_header(k, v)
                if app._cors_headers:
                    self.send_header("Access-Control-Allow-Methods",
                                     "GET, POST, OPTIONS")
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_request(self, code="-", size="-") -> None:
                # NCSA common-log line per request (reference
                # KafkaCruiseControlApp.java:133-148 NCSA access log),
                # logger name `accessLogger` so deployments route it to
                # its own file
                if app._access_log:
                    code = getattr(code, "value", code)
                    now = _time.localtime()
                    # fixed English month names: %b is locale-dependent
                    # and would break NCSA parsers under non-C locales
                    stamp = ("%02d/%s/%04d:%02d:%02d:%02d %s" % (
                        now.tm_mday, _NCSA_MONTHS[now.tm_mon - 1],
                        now.tm_year, now.tm_hour, now.tm_min, now.tm_sec,
                        _time.strftime("%z", now)))
                    ACCESS_LOG.info(
                        '%s - - [%s] "%s" %s %s', self.client_address[0],
                        stamp, self.requestline, code, size)

            def log_message(self, fmt: str, *args) -> None:
                LOG.debug("http: " + fmt, *args)

        self._http = ThreadingHTTPServer((host, port), Handler)
        if ssl_context is not None:
            self._http.socket = ssl_context.wrap_socket(
                self._http.socket, server_side=True)
        threading.Thread(target=self._http.serve_forever,
                         name="rest-server", daemon=True).start()
        return self._http.server_address[1]

    def stop(self) -> None:
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None
        self.user_tasks.shutdown()
