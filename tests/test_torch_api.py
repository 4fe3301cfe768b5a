"""The PyTorch port's REST layer (cruise_control_tpu_torch/api/, with
common/config.py) against the JAX reference's, on the CPU.

- The reference's unit cases (tests/test_api.py) run on the port:
  `QueryParams` and its errors, the Basic and token security providers,
  the purgatory's review flow and its re-arm, `UserTaskManager` dedup,
  scoping and expiry; the endpoint wiring keys of `request_config_def`
  and `ConfigDef` parsing equal the reference's.
- The security providers (Basic from a credentials file, none, token,
  trusted proxy) of both packages, built alike, give the same principal,
  role or error for the same headers, equal token bytes, and the same
  authorization for every endpoint and role.
- Dispatch parity: one request sequence goes through the reference's
  `CruiseControlApp.handle_request` over the JAX facade and through the
  port's over the port's facade, both built by `make_stack`
  (tests/test_torch_facade_sampled.py: 4 brokers, 12 partitions, the
  sampled monitor on a virtual clock, 8 sampling rounds), each app on its
  facade's clock.  The sequence covers STATE on the shared substates,
  LOAD, PARTITION_LOAD, KAFKA_CLUSTER_STATE, PROPOSALS (terse, verbose,
  cached), a REBALANCE dry run with `excluded_topics`, REMOVE_BROKER,
  DEMOTE_BROKER, TOPIC_CONFIGURATION, one SCENARIOS body (one batch
  size), USER_TASKS, the two-step flow (REVIEW_BOARD, REVIEW), TRACES and
  every error status the reference maps: 400, 401, 403, 404, 405, 409,
  429 (with the two-step approval re-armed), 503 (a drain) and 500.
  Status codes, the headers that are not masked and the JSON bodies are
  equal, floats bit for bit, after masking only the fields named in
  MASKED_HEADERS and MASKED_FIELDS (task ids, trace ids, cookies and
  wall-clock times), and dropping sloStatus' `detector` block (the
  reference's SLO burn detector; the port's waits for detector/).
- What the port answers where a module is missing: the ADMIN
  self-healing switches (500 naming detector/), `portfolio_width > 1`
  (500 naming portfolio search), STATE's `anomaly_detector` substate,
  `CruiseControlApp(fleet=...)`.
"""
import base64
import json
import time

import jsonschema
import pytest

from cruise_control_tpu.api import parameters as jparameters
from cruise_control_tpu.api import security as jsecurity
from cruise_control_tpu.api import server as jserver
from cruise_control_tpu.api import request_registry as jregistry
from cruise_control_tpu.common import config as jconfig
from cruise_control_tpu_torch.api import (BasicSecurityProvider,
                                          ParameterError, Purgatory,
                                          QueryParams, Role,
                                          TokenSecurityProvider,
                                          USER_TASK_ID_HEADER,
                                          UserTaskManager)
from cruise_control_tpu_torch.api import request_registry as pregistry
from cruise_control_tpu_torch.api import security as psecurity
from cruise_control_tpu_torch.api import server as pserver
from cruise_control_tpu_torch.api.schema import AUX_SCHEMAS, ENDPOINT_SCHEMAS
from cruise_control_tpu_torch.api.security import (AuthenticationError,
                                                   AuthorizationError)
from cruise_control_tpu_torch.api.user_tasks import body_fingerprint
from cruise_control_tpu_torch.common import config as pconfig
from test_torch_facade_sampled import feed_samples, make_stack


# ---------------------------------------------------------------------------
# the reference's unit cases on the port
# ---------------------------------------------------------------------------
class TestQueryParams:
    def test_unknown_param_rejected(self):
        with pytest.raises(ParameterError):
            QueryParams("REBALANCE", {"no_such_param": ["1"]})

    def test_typed_accessors(self):
        p = QueryParams("REBALANCE", {
            "dryrun": ["false"], "goals": ["RackAwareGoal,DiskCapacityGoal"],
            "concurrent_leader_movements": ["12"],
            "replication_throttle": ["1.5e6"]})
        assert p.get_bool("dryrun", default=True) is False
        assert p.get_csv("goals") == ["RackAwareGoal", "DiskCapacityGoal"]
        assert p.get_int("concurrent_leader_movements") == 12
        assert p.get_float("replication_throttle") == 1.5e6
        r = QueryParams("PARTITION_LOAD", {"resource": ["NW_OUT"]})
        assert int(r.get_resource("resource")) == 2

    def test_bad_values(self):
        with pytest.raises(ParameterError):
            QueryParams("REBALANCE", {"dryrun": ["maybe"]}).get_bool("dryrun")
        with pytest.raises(ParameterError):
            QueryParams("ADD_BROKER",
                        {"brokerid": ["x"]}).get_csv_ints("brokerid")
        with pytest.raises(ParameterError):
            QueryParams("PARTITION_LOAD",
                        {"resource": ["gpu"]}).get_resource("resource")
        with pytest.raises(ParameterError):
            QueryParams("NO_SUCH_ENDPOINT", {})


class TestSecurity:
    def test_basic_auth_roles(self):
        provider = BasicSecurityProvider({
            "admin": ("secret", Role.ADMIN),
            "viewer": ("pw", Role.VIEWER)})

        def hdr(user, pw):
            tok = base64.b64encode(f"{user}:{pw}".encode()).decode()
            return {"Authorization": f"Basic {tok}"}

        admin = provider.authenticate(hdr("admin", "secret"))
        assert admin.role == Role.ADMIN
        provider.authorize(admin, "REBALANCE")   # no raise
        viewer = provider.authenticate(hdr("viewer", "pw"))
        with pytest.raises(AuthorizationError):
            provider.authorize(viewer, "REBALANCE")
        provider.authorize(viewer, "STATE")
        with pytest.raises(AuthenticationError):
            provider.authenticate(hdr("admin", "wrong"))
        with pytest.raises(AuthenticationError):
            provider.authenticate({})

    def test_token_provider_roundtrip_and_expiry(self):
        clock = {"t": 1000.0}
        provider = TokenSecurityProvider(b"k3y", time_fn=lambda: clock["t"])
        token = provider.issue("alice", Role.USER, ttl_s=60.0)
        p = provider.authenticate({"Authorization": f"Bearer {token}"})
        assert p.name == "alice" and p.role == Role.USER
        clock["t"] += 61.0
        with pytest.raises(AuthenticationError):
            provider.authenticate({"Authorization": f"Bearer {token}"})
        with pytest.raises(AuthenticationError):
            provider.authenticate(
                {"Authorization": f"Bearer {token[:-2]}xx"})



# the same providers of both packages, and the same requests through them

CREDENTIALS = "# user: password,ROLE\nadmin: secret,ADMIN\n" \
    "viewer: pw,viewer\nproxy: px,USER\n"


def _verdict(provider, headers):
    """A provider's answer to one request's headers, comparable across the
    two packages (each has its own Role enum and exception classes)."""
    try:
        principal = provider.authenticate(headers)
    except Exception as exc:      # noqa: BLE001 - the verdict is the point
        return ("raised", type(exc).__name__, str(exc))
    return ("principal", principal.name, principal.role.name)


def _providers(mod, kind, path, clock):
    if kind == "token":
        return mod.TokenSecurityProvider(b"k3y", time_fn=lambda: clock["t"])
    basic = mod.BasicSecurityProvider.from_credentials_file(path)
    if kind == "basic":
        return basic
    if kind == "no_security":
        return mod.NoSecurityProvider()
    return mod.TrustedProxySecurityProvider(
        basic, ["proxy"], ip_regex=r"10\.0\.0\.\d+",
        role_fn=lambda name: mod.Role.ADMIN if name == "root"
        else mod.Role.VIEWER)


def _basic_hdr(cred, **extra):
    return {"Authorization": "Basic " + base64.b64encode(
        cred.encode()).decode(), **extra}


SECURITY_REQUESTS = {
    "basic": [_basic_hdr("admin:secret"), _basic_hdr("viewer:pw"),
              _basic_hdr("admin:wrong"), _basic_hdr("nobody:x"),
              _basic_hdr("no-colon"), {"Authorization": "Basic !!"},
              {"authorization": "Bearer x"}, {}],
    "no_security": [{}, _basic_hdr("admin:secret")],
    "trusted_proxy": [
        _basic_hdr("proxy:px", doAs="root", **{"X-Remote-Addr": "10.0.0.7"}),
        _basic_hdr("proxy:px", **{"X-DoAs-User": "carol",
                                  "X-Remote-Addr": "10.0.0.8"}),
        _basic_hdr("proxy:px", doAs="root", **{"X-Remote-Addr": "10.0.1.7"}),
        _basic_hdr("proxy:px", **{"X-Remote-Addr": "10.0.0.7"}),
        _basic_hdr("admin:secret", doAs="root",
                   **{"X-Remote-Addr": "10.0.0.7"}),
        _basic_hdr("proxy:bad", doAs="root"), {}],
}


@pytest.mark.parametrize("kind", ["basic", "no_security", "token",
                                  "trusted_proxy"])
def test_security_providers_equal_the_reference(kind, tmp_path):
    """Each provider of both packages, built from the same credentials
    file, secret or proxy list, gives the same principal, role or error
    for the same headers, and the same authorization per endpoint."""
    path = tmp_path / "credentials.properties"
    path.write_text(CREDENTIALS)
    clock = {"t": 1000.0}
    ref, port = (_providers(m, kind, str(path), clock)
                 for m in (jsecurity, psecurity))
    requests = list(SECURITY_REQUESTS.get(kind, []))
    if kind == "token":
        tokens = [p.issue(name, mod.Role[role], ttl_s=60.0)
                  for mod, p in ((jsecurity, ref), (psecurity, port))
                  for name, role in (("alice", "USER"), ("root", "ADMIN"))]
        assert tokens[2:] == tokens[:2]          # equal token bytes
        requests = [{"Authorization": f"Bearer {t}"} for t in tokens] + [
            {"Authorization": f"Bearer {tokens[0][:-2]}xx"},
            {"Authorization": "Bearer no-dot"}, {}]
    for hdrs in requests:
        assert _verdict(port, hdrs) == _verdict(ref, hdrs), hdrs
    if kind == "token":
        clock["t"] += 61.0                       # every token expired now
        for hdrs in requests:
            assert _verdict(port, hdrs) == _verdict(ref, hdrs), hdrs
    assert port.auth_challenge_headers() == ref.auth_challenge_headers()
    for endpoint in sorted(jparameters.VALID_PARAMS):
        assert psecurity.required_role(endpoint).name == \
            jsecurity.required_role(endpoint).name
        for role in ("VIEWER", "USER", "ADMIN"):
            answers = []
            for mod, p in ((jsecurity, ref), (psecurity, port)):
                try:
                    p.authorize(mod.Principal("u", mod.Role[role]),
                                endpoint)
                    answers.append("allowed")
                except mod.AuthorizationError as exc:
                    answers.append(str(exc))
            assert answers[1] == answers[0], (endpoint, role)


class TestPurgatory:
    def test_review_flow(self):
        purgatory = Purgatory()
        req = purgatory.submit("REBALANCE", "dryrun=false", "alice")
        assert req.status.value == "PENDING_REVIEW"
        purgatory.review([req.review_id], [], reason="lgtm")
        taken = purgatory.take_approved(req.review_id, "REBALANCE",
                                        "dryrun=false")
        assert taken.status.value == "SUBMITTED"
        # one-shot: cannot take again
        with pytest.raises(ValueError):
            purgatory.take_approved(req.review_id, "REBALANCE",
                                    "dryrun=false")

    def test_re_arm_restores_consumed_approval(self):
        purgatory = Purgatory()
        req = purgatory.submit("REBALANCE", "dryrun=false", "alice")
        purgatory.review([req.review_id], [], reason="lgtm")
        purgatory.take_approved(req.review_id, "REBALANCE", "dryrun=false")
        purgatory.re_arm(req.review_id)
        assert req.status.value == "APPROVED"
        taken = purgatory.take_approved(req.review_id, "REBALANCE",
                                        "dryrun=false")
        assert taken.status.value == "SUBMITTED"
        # no-ops: a not-yet-consumed review and an unknown id
        req2 = purgatory.submit("REBALANCE", "", "bob")
        purgatory.re_arm(req2.review_id)
        assert req2.status.value == "PENDING_REVIEW"
        purgatory.re_arm(999999)

    def test_discard_and_wrong_endpoint(self):
        purgatory = Purgatory()
        req = purgatory.submit("REMOVE_BROKER", "brokerid=1", "bob")
        purgatory.review([], [req.review_id])
        with pytest.raises(ValueError):
            purgatory.take_approved(req.review_id, "REMOVE_BROKER",
                                    "brokerid=1")
        req2 = purgatory.submit("REBALANCE", "", "bob")
        purgatory.review([req2.review_id], [])
        with pytest.raises(ValueError):
            purgatory.take_approved(req2.review_id, "REMOVE_BROKER", "")

    def test_approval_bound_to_parameters_and_capped(self):
        purgatory = Purgatory(max_requests=2)
        req = purgatory.submit("REBALANCE", "dryrun=true", "mallory")
        purgatory.review([req.review_id], [])
        with pytest.raises(ValueError):
            purgatory.take_approved(req.review_id, "REBALANCE",
                                    "dryrun=false")
        # review_id itself is excluded from the comparison
        taken = purgatory.take_approved(
            req.review_id, "REBALANCE",
            f"dryrun=true&review_id={req.review_id}")
        assert taken.status.value == "SUBMITTED"
        purgatory.submit("REBALANCE", "", "a")
        purgatory.submit("REBALANCE", "", "b")
        with pytest.raises(ValueError, match="purgatory full"):
            purgatory.submit("REBALANCE", "", "c")


class TestUserTaskManager:
    def test_attach_by_same_request(self):
        utm = UserTaskManager()
        calls = []

        def op():
            calls.append(1)
            time.sleep(0.2)
            return {"ok": True}

        a = utm.get_or_create("PROPOSALS", "q=1", "client", op)
        b = utm.get_or_create("PROPOSALS", "q=1", "client", op)
        # a different body never coalesces with the first
        c = utm.get_or_create("PROPOSALS", "q=1", "client",
                              lambda: {"ok": False}, body='{"x": 1}')
        assert a.task_id == b.task_id != c.task_id
        assert a.future.result(timeout=5.0) == {"ok": True}
        assert c.future.result(timeout=5.0) == {"ok": False}
        assert calls == [1]
        assert c.body_hash == body_fingerprint('{"x": 1}') != ""
        utm.shutdown()

    def test_lookup_by_task_id(self):
        utm = UserTaskManager()
        info = utm.get_or_create("PROPOSALS", "q=1", "c", lambda: 42)
        same = utm.get_or_create("PROPOSALS", "q=1", "c2", lambda: 0,
                                 task_id=info.task_id)
        assert same.task_id == info.task_id
        with pytest.raises(KeyError):
            utm.get_or_create("PROPOSALS", "q=1", "c", lambda: 0,
                              task_id="nope")
        # a task id is scoped to its request
        with pytest.raises(ValueError):
            utm.get_or_create("REBALANCE", "dryrun=false", "c", lambda: 0,
                              task_id=info.task_id)
        utm.shutdown()

    def test_expiry_and_caps(self):
        clock = {"t": 100.0}
        utm = UserTaskManager(completed_retention_s=10.0, max_active_tasks=2,
                              max_cached_completed_tasks=2,
                              time_fn=lambda: clock["t"])
        for i in range(3):
            utm.get_or_create("LOAD", f"q={i}", "c",
                              lambda i=i: i).future.result(timeout=5.0)
            _wait_done(utm, i + 1)
        # the cap keeps the two newest completed tasks
        assert len(utm.all_tasks()) == 2
        clock["t"] += 11.0
        assert utm.all_tasks() == []
        import threading
        gate = threading.Event()
        utm.get_or_create("LOAD", "a", "c", gate.wait)
        utm.get_or_create("LOAD", "b", "c", gate.wait)
        with pytest.raises(RuntimeError, match="too many active"):
            utm.get_or_create("LOAD", "c", "c", gate.wait)
        gate.set()
        utm.shutdown()


def _wait_done(utm, n):
    deadline = time.monotonic() + 10.0
    while sum(1 for t in utm._tasks.values()
              if t.status.value != "Active") < n:
        assert time.monotonic() < deadline
        time.sleep(0.005)


def test_request_config_keys_equal_the_reference():
    jd, pd = jconfig.ConfigDef(), pconfig.ConfigDef()
    jregistry.request_config_def(jd)
    pregistry.request_config_def(pd)
    jkeys, pkeys = jd.keys(), pd.keys()
    assert sorted(jkeys) == sorted(pkeys) and len(pkeys) == 40
    for name, key in pkeys.items():
        want = jkeys[name]
        assert (key.type.value, key.importance.value, key.doc) == \
            (want.type.value, want.importance.value, want.doc)
        assert key.default == want.default.replace(
            "cruise_control_tpu.", "cruise_control_tpu_torch.")
    config = pconfig.AbstractConfig(pd, {
        "load.request.class":
            "cruise_control_tpu_torch.api.request_registry.Request"})
    classes = pregistry.resolve_endpoint_classes(config)
    assert set(classes) == set(pregistry.ENDPOINT_KEY_STEMS)
    assert all(c == (pregistry.Request, QueryParams)
               for c in classes.values())
    bad = pconfig.AbstractConfig(pd, {
        "load.request.class": "cruise_control_tpu_torch.api.purgatory."
                              "Purgatory"})
    with pytest.raises(TypeError):
        pregistry.resolve_endpoint_classes(bad)


@pytest.mark.parametrize("value,type_name", [
    ("true", "BOOLEAN"), ("12", "INT"), ("1.5e6", "DOUBLE"),
    ("a, b,,c", "LIST"), ("x.y.Z", "CLASS"), ("maybe", "BOOLEAN"),
    ("1.5", "INT")])
def test_config_parsing_equals_the_reference(value, type_name):
    def parse(mod):
        d = mod.ConfigDef().define("k", mod.Type[type_name], None,
                                   importance=mod.Importance.LOW)
        try:
            return ("ok", d.parse({"k": value})["k"])
        except mod.ConfigException as exc:
            return ("error", str(exc))
    assert parse(pconfig) == parse(jconfig)


# ---------------------------------------------------------------------------
# dispatch parity: the reference's app over the JAX facade, the port's over
# the port's facade
# ---------------------------------------------------------------------------
#: response headers masked before the comparison: the async task's id,
#: its session cookie (which carries the id) and the request's trace id
MASKED_HEADERS = ("User-Task-ID", "Set-Cookie", "Trace-Id")
#: body fields masked before the comparison, at any depth: task and trace
#: ids (`traceId` on a solve body, `UserTaskId` and `TraceId` on a
#: USER_TASKS entry), and wall-clock times (the scenario engine's
#: `lastCompileS` and `lastSolveS` in STATE; a SCENARIOS batch's
#: `compileS`, `solveS` and `durationS`; a trace's `startMs` and
#: `durationMs`), plus the `ResultSizeBytes` of the SCENARIOS task, whose
#: JSON size counts those three batch times
MASKED_FIELDS = ("traceId", "UserTaskId", "TraceId", "lastCompileS",
                 "lastSolveS", "compileS", "solveS", "durationS", "startMs",
                 "durationMs")
SUBSTATES = "monitor,executor,analyzer,scenario,scheduler,incremental,slo"
ADMIN_USER = ("admin", "secret")
VIEWER_USER = ("viewer", "pw")
#: one what-if beside the base, under a one-goal override: the reference's
#: engine traces its programs once per goal list and batch size, ~10 s
#: each, so one batch size and the shortest goal list keep this cheap
SCENARIOS_BODY = json.dumps({"scenarios": [
    {"name": "remove 3", "removeBrokers": [3]}],
    "goals": ["ReplicaDistributionGoal"]})


def _basic(user):
    tok = base64.b64encode(f"{user[0]}:{user[1]}".encode()).decode()
    return {"Authorization": f"Basic {tok}"}


def _mask(doc):
    if isinstance(doc, dict):
        out = {k: ("<masked>" if k in MASKED_FIELDS else _mask(v))
               for k, v in doc.items()}
        if str(out.get("RequestURL", "")).startswith("SCENARIOS") \
                and "ResultSizeBytes" in out:
            out["ResultSizeBytes"] = "<masked>"
        slo = out.get("sloStatus")
        if isinstance(slo, dict):
            slo.pop("detector", None)
        return out
    if isinstance(doc, list):
        return [_mask(v) for v in doc]
    return doc


class Rig:
    """One package's facade and apps: plain, two-step, secured, drained."""

    def __init__(self, jax: bool):
        App = jserver.CruiseControlApp if jax else pserver.CruiseControlApp
        self.sim, self.cc, self.clock = make_stack(jax)
        feed_samples(self.cc, self.clock)
        clock = self.clock
        common = dict(async_response_timeout_s=120.0, access_log=False,
                      time_fn=lambda: clock["now"])
        users = {ADMIN_USER[0]: (ADMIN_USER[1], Role.ADMIN),
                 VIEWER_USER[0]: (VIEWER_USER[1], Role.VIEWER)}
        if jax:
            from cruise_control_tpu.api.security import \
                BasicSecurityProvider as JBasic
            from cruise_control_tpu.api.security import Role as JRole
            users = {k: (pw, JRole[r.name]) for k, (pw, r) in users.items()}
            basic = JBasic(users)
        else:
            basic = BasicSecurityProvider(users)
        self.apps = {"plain": App(self.cc, **common),
                     "two-step": App(self.cc, two_step_verification=True,
                                     **common),
                     "secured": App(self.cc, security=basic, **common),
                     "drained": App(self.cc, **common)}
        self.apps["drained"].drain(retry_after_s=17)
        #: (endpoint, status, body) of every answer, unmasked
        self.answers = []

    def request(self, app, method, endpoint, query="", headers=None,
                body=None):
        """(status, headers, body) after polling a 202 by its task id."""
        path = (endpoint if endpoint.startswith("/")
                else f"/kafkacruisecontrol/{endpoint}")
        hdrs = dict(headers or {})
        deadline = time.monotonic() + 300.0
        while True:
            status, out_h, out = self.apps[app].handle_request(
                method, path, query, hdrs, client="127.0.0.1", body=body)
            if status != 202 or "reviewResult" in out:
                return status, out_h, out
            assert time.monotonic() < deadline, "never completed"
            hdrs = {**hdrs, USER_TASK_ID_HEADER: out_h[USER_TASK_ID_HEADER]}
            time.sleep(0.01)

    def close(self):
        for app in self.apps.values():
            app.stop()
        self.cc.shutdown()


def _sequence():
    """(label, app, method, endpoint, query, headers, body) in order."""
    admin, viewer = _basic(ADMIN_USER), _basic(VIEWER_USER)
    return [
        ("state", "plain", "GET", "state", f"substates={SUBSTATES}"),
        ("load", "plain", "GET", "load", ""),
        ("partition load nw_in top 5", "plain", "GET", "partition_load",
         "resource=nw_in&entries=5"),
        ("partition load", "plain", "GET", "partition_load", ""),
        ("kafka cluster state", "plain", "GET", "kafka_cluster_state", ""),
        ("proposals", "plain", "GET", "proposals", ""),
        ("proposals verbose (cache)", "plain", "GET", "proposals",
         "verbose=true"),
        ("rebalance excluded topics", "plain", "POST", "rebalance",
         "dryrun=true&verbose=true&excluded_topics=t0"),
        ("remove broker", "plain", "POST", "remove_broker",
         "brokerid=1&verbose=true"),
        ("demote broker", "plain", "POST", "demote_broker",
         "brokerid=0&verbose=true"),
        ("topic configuration", "plain", "POST", "topic_configuration",
         "topic=t0&replication_factor=3&verbose=true"),
        ("scenarios", "plain", "POST", "scenarios", "verbose=true", None,
         SCENARIOS_BODY),
        ("user tasks", "plain", "GET", "user_tasks", ""),
        ("two-step parks", "two-step", "POST", "rebalance", "dryrun=true"),
        ("review board", "two-step", "GET", "review_board", ""),
        ("review approves", "two-step", "POST", "review", "approve=0"),
        ("approved rebalance", "two-step", "POST", "rebalance",
         "dryrun=true&review_id=0"),
        ("review board after", "two-step", "GET", "review_board", ""),
        ("pause sampling parks", "two-step", "POST", "pause_sampling",
         "reason=x"),
        ("400 unknown parameter", "plain", "GET", "state", "bogus=1"),
        ("400 missing brokerid", "plain", "POST", "remove_broker", ""),
        ("400 bad resource", "plain", "GET", "partition_load",
         "resource=gpu"),
        ("400 review without two-step", "plain", "GET", "review_board", ""),
        ("400 scenarios without body", "plain", "POST", "scenarios", ""),
        ("400 approval for other parameters", "two-step", "POST",
         "rebalance", "dryrun=false&review_id=0"),
        ("401 no credentials", "secured", "GET", "state", ""),
        ("401 metrics without credentials", "secured", "GET", "/metrics",
         ""),
        ("403 viewer rebalance", "secured", "POST", "rebalance", "", viewer),
        ("200 viewer state", "secured", "GET", "state",
         f"substates={SUBSTATES}", viewer),
        ("200 admin kafka cluster state", "secured", "GET",
         "kafka_cluster_state", "", admin),
        ("404 unknown endpoint", "plain", "GET", "nonsense", ""),
        ("404 outside the prefix", "plain", "GET", "/elsewhere/state", ""),
        ("404 cluster", "plain", "GET", "state", "cluster=other"),
        ("404 fleet", "plain", "GET", "fleet", ""),
        ("405 GET on a POST endpoint", "plain", "GET", "rebalance", ""),
        ("405 POST on a GET endpoint", "plain", "POST", "load", ""),
        ("500 topic configuration without rf", "plain", "POST",
         "topic_configuration", "topic=t0"),
        ("503 draining write", "drained", "POST", "rebalance",
         "dryrun=true"),
        ("200 draining read", "drained", "GET", "kafka_cluster_state", ""),
        ("admin without switches", "plain", "POST", "admin", ""),
        ("stop execution", "plain", "POST", "stop_proposal_execution", ""),
        ("pause sampling", "plain", "POST", "pause_sampling", "reason=r"),
        ("resume sampling", "plain", "POST", "resume_sampling", "reason=r"),
    ]


def _run(rig, seq):
    out = []
    for label, app, method, endpoint, query, *rest in seq:
        headers = rest[0] if rest else None
        body = rest[1] if len(rest) > 1 else None
        status, hdrs, doc = rig.request(app, method, endpoint, query,
                                        headers, body)
        rig.answers.append((endpoint.upper(), status, doc))
        hdrs = {k: ("<masked>" if k in MASKED_HEADERS else v)
                for k, v in hdrs.items()}
        out.append((label, status, hdrs, _mask(doc)))
    return out


def _schema_of(endpoint, status, doc):
    """The port's schema of one answer, or None (the /metrics page)."""
    if "__raw__" in doc:
        return None
    if status == 200:
        return ENDPOINT_SCHEMAS[endpoint]
    if status == 202:
        return AUX_SCHEMAS["review_parked_202" if "reviewResult" in doc
                           else "async_progress_202"]
    if "retryAfterSeconds" in doc:
        return AUX_SCHEMAS["rate_limited_429"]
    return AUX_SCHEMAS["error"]


def _ongoing(rig, monkeypatch):
    """An execution in progress, as the executor reports it."""
    monkeypatch.setattr(type(rig.cc.executor), "has_ongoing_execution",
                        property(lambda self: True))


def _queue_full(rig, monkeypatch):
    """The interactive class's queue cap at 0 in the scheduler's
    admission queue: it rejects every interactive solve."""
    import dataclasses
    queue = rig.cc.solve_scheduler.queue
    policy = queue._policy
    classes = {k: (dataclasses.replace(c, queue_cap=0)
                   if k.name == "USER_INTERACTIVE" else c)
               for k, c in policy.classes.items()}
    monkeypatch.setattr(queue, "_policy",
                        dataclasses.replace(policy, classes=classes))


#: the requests under a patched facade: (label, patch, sequence)
PATCHED = [
    ("409", _ongoing, [
        ("409 rebalance during an execution", "plain", "POST", "rebalance",
         "dryrun=false")]),
    ("429", _queue_full, [
        ("429 fresh proposals", "plain", "GET", "proposals",
         "ignore_proposal_cache=true"),
        ("two-step parks again", "two-step", "POST", "rebalance",
         "dryrun=true&verbose=true&ignore_proposal_cache=true"),
        ("review approves again", "two-step", "POST", "review",
         "approve=2"),
        ("429 approved rebalance", "two-step", "POST", "rebalance",
         "dryrun=true&verbose=true&ignore_proposal_cache=true&review_id=2"),
        ("review board: re-armed", "two-step", "GET", "review_board",
         "review_ids=2")]),
]


@pytest.fixture(scope="module")
def rigs():
    start_ms = time.time() * 1000.0
    made = {"jax": Rig(True), "port": Rig(False)}
    made["start_ms"] = start_ms
    yield made
    made["jax"].close()
    made["port"].close()


@pytest.fixture(scope="module")
def answers(rigs):
    seq = _sequence()
    return {k: _run(rigs[k], seq) for k in ("jax", "port")}


def test_dispatch_sequence_equals_the_reference(answers):
    jax, port = answers["jax"], answers["port"]
    assert [a[0] for a in port] == [a[0] for a in jax]
    for j, p in zip(jax, port):
        assert json.dumps(p, sort_keys=True) == json.dumps(j, sort_keys=True)
    by_label = {a[0]: a for a in port}
    statuses = {label: status for label, status, *_ in port}
    assert {s for s in statuses.values()} == {200, 202, 400, 401, 403, 404,
                                               405, 500, 503}
    proposals = by_label["proposals verbose (cache)"][3]
    assert proposals["summary"]["numProposals"] == len(
        proposals["proposals"]) > 0
    assert by_label["503 draining write"][2]["Retry-After"] == "17"
    assert by_label["401 no credentials"][3]["errorMessage"].startswith(
        "AuthenticationError")
    assert by_label["approved rebalance"][1] == 200
    tasks = by_label["user tasks"][3]["userTasks"]
    assert len(tasks) == 10 and all(t["Status"] == "Completed"
                                     for t in tasks)


@pytest.mark.parametrize("label,patch,seq", PATCHED,
                         ids=[p[0] for p in PATCHED])
def test_patched_facade_statuses_equal_the_reference(rigs, answers, label,
                                                     patch, seq):
    got = {}
    for k in ("jax", "port"):
        with pytest.MonkeyPatch.context() as mp:
            patch(rigs[k], mp)
            got[k] = _run(rigs[k], seq)
    assert json.dumps(got["port"], sort_keys=True) == \
        json.dumps(got["jax"], sort_keys=True)
    statuses = [a[1] for a in got["port"]]
    if label == "409":
        assert statuses == [409]
    else:
        assert statuses == [429, 202, 200, 429, 200]
        assert got["port"][0][2]["Retry-After"] == "1"
        assert got["port"][-1][3]["requestInfo"][0]["Status"] == "APPROVED"


def test_every_port_answer_validates_against_its_schema(rigs, answers):
    checked = 0
    for endpoint, status, doc in rigs["port"].answers:
        schema = _schema_of(endpoint, status, doc)
        if schema is not None:
            jsonschema.validate(doc, schema)
            checked += 1
    assert checked >= len(_sequence()) - 1


def test_traces_and_metrics_equal_the_reference(rigs, answers):
    since = f"since={rigs['start_ms']}&limit=1000"
    listing = {}
    for k in ("jax", "port"):
        status, _, doc = rigs[k].request("plain", "GET", "traces", since)
        assert status == 200
        listing[k] = [(t["name"], t["outcome"]) for t in doc["traces"]]
    assert listing["port"] == listing["jax"]
    assert ("rest.PROPOSALS", "ok") in listing["port"]
    assert ("rest.REBALANCE", "rejected") in listing["port"]
    status, hdrs, page = rigs["port"].request("plain", "GET", "/metrics")
    text = page["__raw__"].decode()
    assert status == 200 and text.endswith("# EOF\n")
    assert page["__content_type__"].startswith("application/openmetrics")
    # the per-endpoint request meters, counted alike in both packages
    status, _, jpage = rigs["jax"].request("plain", "GET", "/metrics")
    meters = {k: sorted(line for line in p["__raw__"].decode().splitlines()
                        if "_request_rate_total " in line)
              for k, p in (("port", page), ("jax", jpage))}
    assert meters["port"] == meters["jax"]
    assert "cc_tpu_proposals_request_rate_total 3" in meters["port"]


def test_what_the_port_does_not_have_yet(rigs, answers):
    rig = rigs["port"]
    status, _, doc = rig.request("plain", "POST", "admin",
                                 "enable_self_healing_for=broker_failure")
    assert status == 500 and "detector/" in doc["errorMessage"]
    status, _, doc = rig.request("plain", "GET", "proposals",
                                 "portfolio_width=2")
    assert status == 500 and "portfolio search" in doc["errorMessage"]
    status, _, doc = rig.request("plain", "GET", "state",
                                 "substates=anomaly_detector")
    assert status == 500 and "detector/" in doc["errorMessage"]
    status, _, doc = rig.request("plain", "GET", "state")
    assert status == 200 and "AnomalyDetectorState" not in doc \
        and "PortfolioState" not in doc and "MonitorState" in doc
    with pytest.raises(NotImplementedError, match="fleet/"):
        pserver.CruiseControlApp(rig.cc, fleet=object())
