"""The PyTorch port's REST client and CLI (cruise_control_tpu_torch/
client/) against the port's server over real HTTP, on the CPU.

The reference's client cases (tests/test_client.py) run on the port: the
endpoint wrappers, async long-polling, error surfacing, the 429 and 503
retries after Retry-After (with a fake transport), the `--cluster` flag
and the CLI.  The live server is the port's `CruiseControlApp` on port 0
over the port's facade on `make_stack` (tests/test_torch_facade_sampled.py,
4 brokers, `device="cpu"`).  Over real HTTP: a PROPOSALS request that
first answers 202 with a User-Task-ID and is polled to 200, equal to the
facade's own answer; a drain that answers 503 with Retry-After; the
/metrics page; and an HTTPS round trip (its certificate made with
`cryptography`, skipped without it).  The reference's JWT cases
(tests/test_security_jwt.py) run on the port's JwtSecurityProvider: HS256
through the standard library's hmac, RS256 through `cryptography`
(skipped without it), claims, leeway, the cookie and the login challenge.

Against the reference, the same inputs go through both packages: claims
through both JWT providers (equal token bytes, each token judged alike by
both), fake-transport answer scripts through both clients with the same
jitter token (equal requests, sleeps and outcomes), every endpoint
wrapper of both clients, and argv lists through both CLIs (equal parsed
namespaces, requests, output and exit codes).
"""
import datetime
import json
import ssl
import urllib.request

import pytest

import cruise_control_tpu.api.security as ref_security
import cruise_control_tpu.client.cli as ref_cli
import cruise_control_tpu.client.client as ref_client
import cruise_control_tpu_torch.api.security as port_security
import cruise_control_tpu_torch.client.cli as port_cli
import cruise_control_tpu_torch.client.client as port_client
from cruise_control_tpu_torch.api import responses as R
from cruise_control_tpu_torch.api.security import (AuthenticationError,
                                                   JwtSecurityProvider, Role)
from cruise_control_tpu_torch.api.server import (CruiseControlApp,
                                                 make_server_ssl_context)
from cruise_control_tpu_torch.api.user_tasks import USER_TASK_ID_HEADER
from cruise_control_tpu_torch.client.cli import build_parser
from cruise_control_tpu_torch.client.cli import main as cli_main
from cruise_control_tpu_torch.client.client import (CruiseControlClient,
                                                    CruiseControlClientError)
from test_torch_facade_sampled import feed_samples, make_stack


@pytest.fixture(scope="module")
def live_server():
    sim, cc, clock = make_stack(False)
    feed_samples(cc, clock)
    app = CruiseControlApp(cc, async_response_timeout_s=5.0,
                           access_log=False)
    port = app.start(port=0)
    yield sim, cc, f"http://127.0.0.1:{port}/kafkacruisecontrol"
    app.stop()
    cc.shutdown()


class TestClient:
    def test_state_and_load(self, live_server):
        _, _, url = live_server
        client = CruiseControlClient(url)
        st = client.state()
        assert st["MonitorState"]["numValidWindows"] > 0
        load = client.load()
        assert len(load["brokers"]) == 4

    def test_proposals_long_poll(self, live_server):
        _, _, url = live_server
        client = CruiseControlClient(url, poll_interval_s=0.05,
                                     timeout_s=600.0)
        out = client.proposals(verbose=True)
        assert out["summary"]["numProposals"] > 0
        assert "proposals" in out

    def test_dryrun_rebalance(self, live_server):
        _, _, url = live_server
        client = CruiseControlClient(url, poll_interval_s=0.05,
                                     timeout_s=600.0)
        out = client.rebalance(dryrun=True)
        assert out["dryRun"] is True

    def test_error_surfacing(self, live_server):
        _, _, url = live_server
        client = CruiseControlClient(url)
        with pytest.raises(CruiseControlClientError) as err:
            client.remove_broker([])     # missing brokerid
        assert err.value.status == 400
        with pytest.raises(ValueError):
            client.request("STATE", {"bogus": 1})
        with pytest.raises(CruiseControlClientError) as err:
            client.admin(enable_self_healing_for=["broker_failure"])
        assert err.value.status == 500 and "detector/" in err.value.message

    def test_user_tasks_listed(self, live_server):
        _, _, url = live_server
        client = CruiseControlClient(url)
        client.state()
        tasks = client.user_tasks()
        assert "userTasks" in tasks


class TestRealHttp:
    """The port's server and client over a socket."""

    def test_async_proposals_answer_202_then_200(self, live_server):
        _, cc, _ = live_server
        app = CruiseControlApp(cc, async_response_timeout_s=0.0,
                               access_log=False)
        base = f"http://127.0.0.1:{app.start(port=0)}/kafkacruisecontrol"
        try:
            client = CruiseControlClient(base, poll_interval_s=0.05,
                                         timeout_s=600.0)
            query = "verbose=true&ignore_proposal_cache=true"
            status, headers, body = client._http(
                "GET", f"{base}/proposals?{query}", None)
            assert status == 202, body
            task_id = headers[USER_TASK_ID_HEADER]
            assert body["progress"][0] == {"operation": "PROPOSALS",
                                           "status": "InProgress"}
            while status == 202:
                status, headers, body = client._http(
                    "GET", f"{base}/proposals?{query}", task_id)
            assert status == 200 and headers[USER_TASK_ID_HEADER] == task_id
            assert body["traceId"] == headers["Trace-Id"]
            # the answer the facade gives in process, from its cache now
            want = R.optimization_result(cc.optimizations(), verbose=True)
            assert {k: v for k, v in body.items() if k != "traceId"} == \
                json.loads(json.dumps(want))
            tasks = [t for t in client.user_tasks()["userTasks"]
                     if t["UserTaskId"] == task_id]
            assert tasks and tasks[0]["Status"] == "Completed"
            assert tasks[0]["TraceId"] == body["traceId"]
        finally:
            app.stop()

    def test_drain_answers_503_with_retry_after(self, live_server):
        _, cc, _ = live_server
        app = CruiseControlApp(cc, async_response_timeout_s=5.0,
                               access_log=False)
        base = f"http://127.0.0.1:{app.start(port=0)}/kafkacruisecontrol"
        try:
            app.drain(retry_after_s=3)
            client = CruiseControlClient(base, max_retries_429=0)
            status, headers, body = client._http(
                "POST", f"{base}/rebalance?dryrun=true", None)
            assert status == 503 and headers["Retry-After"] == "3"
            assert body["retryAfterSeconds"] == 3
            with pytest.raises(CruiseControlClientError) as err:
                client.rebalance(dryrun=True)
            assert err.value.status == 503 and err.value.backpressure
            # reads keep answering while the process drains
            assert client.kafka_cluster_state()["version"] == 1
            page = client.metrics_text()
            assert page.endswith("# EOF\n")
            assert "cc_tpu_kafka_cluster_state_request_rate_total" in page
        finally:
            app.stop()


class TestRetry429:
    """Scheduler backpressure handling: HTTP 429 + Retry-After gets
    capped exponential backoff with DETERMINISTIC jitter, then the
    request is resubmitted (previously a 429 was a hard failure)."""

    def make_client(self, responses, sleeps, token="pinned-test-client"):
        client = CruiseControlClient(
            "http://cc.test/kafkacruisecontrol",
            retry_backoff_base_s=1.0, retry_backoff_max_s=30.0,
            retry_jitter_token=token,
            sleep_fn=sleeps.append)
        calls = []

        def fake_http(method, url, task_id, data=None):
            calls.append((method, url, task_id, data))
            return responses[min(len(calls) - 1, len(responses) - 1)]
        client._http = fake_http
        return client, calls

    def test_429_retries_honor_retry_after_and_succeed(self):
        sleeps = []
        rejected = (429, {"Retry-After": "7"},
                    {"errorMessage": "QueueFullError: solve queue full",
                     "retryAfterSeconds": 7, "version": 1})
        ok = (200, {}, {"version": 1, "summary": {}})
        client, calls = self.make_client([rejected, rejected, ok], sleeps)
        out = client.request("PROPOSALS")
        assert out["version"] == 1
        assert len(calls) == 3
        # Retry-After (7s) floors the 1s/2s exponential backoff, and
        # per-client jitter scales it UP — never sleep less than the
        # server's floor, never exactly the floor for every client
        assert len(sleeps) == 2
        for delay in sleeps:
            assert 7.0 <= delay < 7.0 * 1.5

    def test_429_backoff_is_exponential_with_deterministic_jitter(self):
        def run():
            sleeps = []
            rejected = (429, {}, {"errorMessage": "full", "version": 1})
            ok = (200, {}, {"version": 1})
            client, _ = self.make_client(
                [rejected, rejected, rejected, ok], sleeps)
            client.request("PROPOSALS")
            return sleeps

        first, second = run(), run()
        assert first == second                 # deterministic per token
        assert len(first) == 3
        # capped exponential shape: each delay within [0.5, 1.0) x
        # base * 2^attempt, and strictly growing
        for attempt, delay in enumerate(first):
            assert 0.5 * 2 ** attempt <= delay < 1.0 * 2 ** attempt
        assert first[0] < first[1] < first[2]

    def test_429_jitter_desynchronizes_distinct_clients(self):
        """A fleet rejected at the same instant must NOT retry in
        lockstep (that would refill the queue and 429 everyone again):
        distinct client tokens hash to distinct delays, and the
        auto-generated token is distinct per client instance."""
        def run(token, headers=None):
            sleeps = []
            rejected = (429, headers or {},
                        {"errorMessage": "full", "version": 1})
            ok = (200, {}, {"version": 1})
            client, _ = self.make_client(
                [rejected, rejected, rejected, ok], sleeps, token=token)
            client.request("PROPOSALS")
            return sleeps

        assert run("client-a") != run("client-b")
        # jitter must survive a dominating Retry-After: an unjittered
        # max(retry_after, backoff*jitter) would give every client
        # exactly 7.0 and re-stampede the queue in lockstep
        floored = {"Retry-After": "7"}
        a, b = run("client-a", floored), run("client-b", floored)
        assert a != b
        assert all(d >= 7.0 for d in a + b)
        c1 = CruiseControlClient("http://cc.test")
        c2 = CruiseControlClient("http://cc.test")
        assert c1._jitter_token != c2._jitter_token

    def test_429_retry_discards_the_failed_task_id_and_resends_body(self):
        """The 429 response carries the FAILED task's User-Task-ID for
        diagnostics; the retry must NOT reuse it (it would attach to the
        dead task and replay its cached rejection) and must resend the
        request body."""
        from cruise_control_tpu_torch.api.user_tasks import \
            USER_TASK_ID_HEADER
        sleeps = []
        rejected = (429, {USER_TASK_ID_HEADER: "dead-task",
                          "Retry-After": "1"},
                    {"errorMessage": "QueueFullError: full", "version": 1})
        ok = (200, {}, {"version": 1, "scenarios": [], "batch": {},
                        "dryRun": True})
        client, calls = self.make_client([rejected, ok], sleeps)
        out = client.request("SCENARIOS", body={"scenarios": []})
        assert out["version"] == 1
        assert len(calls) == 2
        # retry went out WITHOUT the dead task id and WITH the body
        assert calls[1][2] is None
        assert calls[1][3] is not None

    def test_429_gives_up_after_max_retries(self):
        sleeps = []
        rejected = (429, {"Retry-After": "1"},
                    {"errorMessage": "QueueFullError: full", "version": 1})
        client, calls = self.make_client([rejected], sleeps)
        client._max_retries_429 = 2
        with pytest.raises(CruiseControlClientError) as err:
            client.request("PROPOSALS")
        assert err.value.status == 429
        assert "gave up after 2 retries" in err.value.message
        assert len(calls) == 3                 # initial + 2 retries

    def test_zero_retries_fails_fast(self):
        sleeps = []
        rejected = (429, {}, {"errorMessage": "full", "version": 1})
        client, calls = self.make_client([rejected], sleeps)
        client._max_retries_429 = 0
        with pytest.raises(CruiseControlClientError):
            client.request("PROPOSALS")
        assert len(calls) == 1 and not sleeps

    def test_cli_exposes_max_retries(self):
        args = build_parser().parse_args(["--max-retries", "0", "state"])
        assert args.max_retries == 0
        args = build_parser().parse_args(["state"])
        assert args.max_retries == 4


class TestRetry503Draining:
    """Graceful-drain handling: a 503 WITH a
    Retry-After hint (the api/server drain signature) gets the exact
    429 treatment — capped backoff, deterministic jitter, resubmit
    against the replacement process.  A bare 503 stays a hard error."""

    make_client = TestRetry429.make_client

    def test_503_draining_retries_like_429(self):
        sleeps = []
        draining = (503, {"Retry-After": "5"},
                    {"errorMessage": "ServerDraining: shutting down",
                     "retryAfterSeconds": 5, "version": 1})
        ok = (200, {}, {"version": 1, "summary": {}})
        client, calls = self.make_client([draining, draining, ok], sleeps)
        out = client.request("REBALANCE")
        assert out["version"] == 1
        assert len(calls) == 3
        assert len(sleeps) == 2
        # Retry-After floors the backoff, jittered upward — the same
        # contract the 429 path pins
        for delay in sleeps:
            assert 5.0 <= delay < 5.0 * 1.5

    def test_503_draining_body_hint_suffices(self):
        sleeps = []
        draining = (503, {}, {"errorMessage": "ServerDraining",
                              "retryAfterSeconds": 3, "version": 1})
        ok = (200, {}, {"version": 1})
        client, calls = self.make_client([draining, ok], sleeps)
        assert client.request("PROPOSALS")["version"] == 1
        assert len(calls) == 2 and len(sleeps) == 1

    def test_bare_503_is_a_hard_error(self):
        """No Retry-After hint = not draining (e.g. a fleet tenant
        drained for good): retrying blind would hammer a server that
        never asked for patience."""
        sleeps = []
        hard = (503, {}, {"errorMessage": "TenantDrainingError: gone",
                          "version": 1})
        client, calls = self.make_client([hard], sleeps)
        with pytest.raises(CruiseControlClientError) as err:
            client.request("REBALANCE")
        assert err.value.status == 503
        assert len(calls) == 1 and not sleeps

    def test_503_draining_gives_up_after_max_retries(self):
        sleeps = []
        draining = (503, {"Retry-After": "1"},
                    {"errorMessage": "ServerDraining",
                     "retryAfterSeconds": 1, "version": 1})
        client, calls = self.make_client([draining], sleeps)
        client._max_retries_429 = 2
        with pytest.raises(CruiseControlClientError) as err:
            client.request("PROPOSALS")
        assert err.value.status == 503
        assert len(calls) == 3


class TestServerDrain:
    """The REST half of graceful shutdown: app.drain() turns every
    mutating endpoint into 503 + Retry-After while reads keep
    answering."""

    def test_drain_rejects_writes_keeps_reads(self, live_server):
        _, cc, _url = live_server
        app = CruiseControlApp(cc, async_response_timeout_s=5.0)
        status, _, _ = app.handle_request(
            "POST", "/kafkacruisecontrol/rebalance", "dryrun=true")
        assert status in (200, 202)
        app.drain(retry_after_s=17)
        assert app.draining
        status, headers, body = app.handle_request(
            "POST", "/kafkacruisecontrol/rebalance", "dryrun=true")
        assert status == 503
        assert headers["Retry-After"] == "17"
        assert body["retryAfterSeconds"] == 17
        assert "ServerDraining" in body["errorMessage"]
        status, _, body = app.handle_request(
            "GET", "/kafkacruisecontrol/state", "")
        assert status == 200 and body
        app.stop()


class TestClusterFlag:
    """Fleet tenancy from the client side: `--cluster` threads
    `cluster=<id>` through every subcommand, and an unknown tenant's
    404 surfaces as a clean CruiseControlClientError."""

    def make_client(self, cluster):
        client = CruiseControlClient("http://cc.test/kafkacruisecontrol",
                                     cluster=cluster)
        urls = []

        def fake_http(method, url, task_id, data=None):
            urls.append(url)
            return 200, {}, {"version": 1, "summary": {},
                             "userTasks": [], "clusters": []}
        client._http = fake_http
        return client, urls

    def test_cluster_rides_on_every_subcommand(self):
        client, urls = self.make_client("prod-7")
        client.state()
        client.proposals()
        client.rebalance(dryrun=True)
        client.user_tasks()
        client.remove_broker([3])
        for url in urls:
            assert "cluster=prod-7" in url
        # FLEET spans the whole fleet: no cluster param
        client.fleet()
        assert "cluster=" not in urls[-1]

    def test_explicit_param_beats_client_default(self):
        client, urls = self.make_client("prod-7")
        client.request("STATE", {"cluster": "other"})
        assert "cluster=other" in urls[0]
        assert "cluster=prod-7" not in urls[0]

    def test_no_cluster_means_no_param(self):
        client, urls = self.make_client(None)
        client.state()
        assert "cluster=" not in urls[0]

    def test_unknown_tenant_404_is_a_clean_client_error(self,
                                                        live_server):
        """The live (fleet-less) server rejects any ?cluster= with 404;
        the client surfaces it as CruiseControlClientError(404), not a
        poll loop or a JSON decode crash."""
        _, _, url = live_server
        client = CruiseControlClient(url, cluster="nope")
        with pytest.raises(CruiseControlClientError) as err:
            client.state()
        assert err.value.status == 404
        assert "nope" in err.value.message

    def test_cli_cluster_flag(self):
        args = build_parser().parse_args(
            ["--cluster", "prod-7", "rebalance"])
        assert args.cluster == "prod-7"
        args = build_parser().parse_args(["fleet", "--verbose"])
        assert args.command == "fleet" and args.verbose
        args = build_parser().parse_args(["state"])
        assert args.cluster is None


class TestCli:
    def test_parser_covers_endpoints(self):
        parser = build_parser()
        for argv in (["state"], ["load"], ["proposals", "--verbose"],
                     ["rebalance", "--execute"],
                     ["add_broker", "1,2"], ["remove_broker", "3"],
                     ["demote_broker", "0"],
                     ["topic_configuration", "t", "3"],
                     ["stop_execution", "--force"],
                     ["admin", "--enable-self-healing-for",
                      "broker_failure"],
                     ["review", "--approve", "1,2"],
                     ["traces", "--outcome", "degraded"], ["metrics"],
                     ["scenarios", "--spec", "[]"], ["loadgen"]):
            args = parser.parse_args(argv)
            assert args.command == argv[0]

    def test_cli_end_to_end(self, live_server, capsys):
        _, _, url = live_server
        rc = cli_main(["-a", url, "state"])
        assert rc == 0
        out = json.loads(capsys.readouterr().out)
        assert "MonitorState" in out
        rc = cli_main(["-a", url, "metrics"])
        assert rc == 0 and capsys.readouterr().out.endswith("# EOF\n")

    def test_cli_error_exit_code(self, live_server, capsys):
        _, _, url = live_server
        rc = cli_main(["-a", url, "remove_broker", ""])
        assert rc == 1
        assert json.loads(capsys.readouterr().err)["status"] == 400
        # portfolio search waits for portfolio/: the server answers 500
        rc = cli_main(["-a", url, "portfolio"])
        assert rc == 1
        assert json.loads(capsys.readouterr().err)["status"] == 500
        with pytest.raises(SystemExit, match="loadgen/"):
            cli_main(["-a", url, "loadgen"])


def _self_signed_cert(tmp_path):
    pytest.importorskip("cryptography")
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "localhost")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now)
            .not_valid_after(now + datetime.timedelta(days=1))
            .sign(key, hashes.SHA256()))
    pem = tmp_path / "server.pem"
    pem.write_bytes(
        key.private_bytes(serialization.Encoding.PEM,
                          serialization.PrivateFormat.TraditionalOpenSSL,
                          serialization.NoEncryption())
        + cert.public_bytes(serialization.Encoding.PEM))
    return str(pem)


def test_https_round_trip(live_server, tmp_path):
    """The port's server with TLS, STATE over https."""
    _, cc, _ = live_server
    pem = _self_signed_cert(tmp_path)
    app = CruiseControlApp(cc, access_log=False)
    try:
        port = app.start(host="127.0.0.1", port=0,
                         ssl_context=make_server_ssl_context(pem))
        client_ctx = ssl.create_default_context()
        client_ctx.check_hostname = False
        client_ctx.verify_mode = ssl.CERT_NONE
        with urllib.request.urlopen(
                f"https://127.0.0.1:{port}/kafkacruisecontrol/state",
                context=client_ctx, timeout=30) as resp:
            body = json.loads(resp.read())
        assert resp.status == 200
        assert "MonitorState" in body
    finally:
        app.stop()
    with pytest.raises(ValueError, match="TLSv1.2"):
        make_server_ssl_context(pem, protocol="SSLv3")


# ---------------------------------------------------------------------------
# JWT
# ---------------------------------------------------------------------------
SECRET = b"test-hs256-secret"


def _provider(**kw):
    kw.setdefault("hs256_secret", SECRET)
    return JwtSecurityProvider(**kw)


def _headers(token):
    return {"Authorization": f"Bearer {token}"}


class TestHs256:
    def test_roundtrip_and_role(self):
        p = _provider(time_fn=lambda: 1000.0)
        tok = p.issue_hs256({"sub": "alice", "role": "ADMIN", "exp": 2000})
        principal = p.authenticate(_headers(tok))
        assert principal.name == "alice"
        assert principal.role == Role.ADMIN

    def test_default_role_when_claim_absent(self):
        p = _provider(default_role=Role.VIEWER, time_fn=lambda: 0.0)
        tok = p.issue_hs256({"sub": "bob"})
        assert p.authenticate(_headers(tok)).role == Role.VIEWER

    def test_expired_and_leeway(self):
        p = _provider(leeway_s=10.0, time_fn=lambda: 1000.0)
        tok = p.issue_hs256({"sub": "a", "exp": 995})
        p.authenticate(_headers(tok))          # inside leeway
        tok = p.issue_hs256({"sub": "a", "exp": 900})
        with pytest.raises(AuthenticationError, match="expired"):
            p.authenticate(_headers(tok))

    def test_nbf(self):
        p = _provider(leeway_s=0.0, time_fn=lambda: 1000.0)
        tok = p.issue_hs256({"sub": "a", "nbf": 2000})
        with pytest.raises(AuthenticationError, match="not yet valid"):
            p.authenticate(_headers(tok))

    def test_bad_signature(self):
        p = _provider(time_fn=lambda: 0.0)
        other = JwtSecurityProvider(hs256_secret=b"other",
                                    time_fn=lambda: 0.0)
        tok = other.issue_hs256({"sub": "a"})
        with pytest.raises(AuthenticationError, match="signature"):
            p.authenticate(_headers(tok))

    def test_alg_none_rejected(self):
        from cruise_control_tpu_torch.api.security import _b64url
        p = _provider(time_fn=lambda: 0.0)
        header = _b64url(json.dumps({"alg": "none"}).encode())
        body = _b64url(json.dumps({"sub": "evil"}).encode())
        with pytest.raises(AuthenticationError, match="not accepted"):
            p.authenticate(_headers(f"{header}.{body}."))

    def test_issuer_audience(self):
        p = _provider(issuer="cc", audience="ops", time_fn=lambda: 0.0)
        good = p.issue_hs256({"sub": "a", "iss": "cc", "aud": ["ops", "x"]})
        p.authenticate(_headers(good))
        bad = p.issue_hs256({"sub": "a", "iss": "cc", "aud": "other"})
        with pytest.raises(AuthenticationError, match="audience"):
            p.authenticate(_headers(bad))
        bad = p.issue_hs256({"sub": "a", "iss": "zz", "aud": "ops"})
        with pytest.raises(AuthenticationError, match="issuer"):
            p.authenticate(_headers(bad))

    def test_unknown_role_rejected(self):
        p = _provider(time_fn=lambda: 0.0)
        tok = p.issue_hs256({"sub": "a", "role": "SUPERUSER"})
        with pytest.raises(AuthenticationError, match="unknown role"):
            p.authenticate(_headers(tok))


def _rsa_keypair():
    # optional dependency: RS256/TLS tests need `cryptography` to forge
    # keys/certs (the server-side verification under test is stdlib-only)
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    pub = key.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.SubjectPublicKeyInfo)
    return key, pub


def _sign_rs256(private_key, claims):
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    from cruise_control_tpu_torch.api.security import _b64url
    header = _b64url(json.dumps({"alg": "RS256", "typ": "JWT"}).encode())
    body = _b64url(json.dumps(claims).encode())
    signing_input = f"{header}.{body}".encode()
    sig = private_key.sign(signing_input, padding.PKCS1v15(),
                           hashes.SHA256())
    return f"{header}.{body}.{_b64url(sig)}"


class TestRs256:
    def test_roundtrip(self):
        key, pub = _rsa_keypair()
        p = JwtSecurityProvider(rs256_public_key_pem=pub,
                                time_fn=lambda: 0.0)
        tok = _sign_rs256(key, {"sub": "carol", "role": "USER"})
        principal = p.authenticate(_headers(tok))
        assert principal.name == "carol"
        assert principal.role == Role.USER

    def test_wrong_key_rejected(self):
        key, _ = _rsa_keypair()
        _, other_pub = _rsa_keypair()
        p = JwtSecurityProvider(rs256_public_key_pem=other_pub,
                                time_fn=lambda: 0.0)
        tok = _sign_rs256(key, {"sub": "carol"})
        with pytest.raises(AuthenticationError, match="signature"):
            p.authenticate(_headers(tok))

    def test_hs256_token_against_rs256_only_provider(self):
        """Algorithm confusion: an HS256 token signed with the PEM bytes
        must not pass an RS256-only provider."""
        _, pub = _rsa_keypair()
        p = JwtSecurityProvider(rs256_public_key_pem=pub,
                                time_fn=lambda: 0.0)
        forger = JwtSecurityProvider(hs256_secret=pub, time_fn=lambda: 0.0)
        tok = forger.issue_hs256({"sub": "evil", "role": "ADMIN"})
        with pytest.raises(AuthenticationError, match="not accepted"):
            p.authenticate(_headers(tok))


class TestTransport:
    def test_cookie_token_and_login_challenge(self):
        p = _provider(cookie_name="cc-jwt", login_url="https://login",
                      audiences=["ops"], time_fn=lambda: 0.0)
        tok = p.issue_hs256({"sub": "dave", "aud": "ops", "role": "viewer"})
        principal = p.authenticate({"Cookie": f"a=b; cc-jwt={tok}"})
        assert principal.name == "dave" and principal.role == Role.VIEWER
        assert p.auth_challenge_headers() == {
            "WWW-Authenticate": 'Bearer realm="https://login"'}
        with pytest.raises(AuthenticationError, match="missing"):
            p.authenticate({"Cookie": "a=b"})

    def test_malformed_tokens_and_claims(self):
        p = _provider(time_fn=lambda: 0.0)
        with pytest.raises(AuthenticationError, match="malformed JWT"):
            p.authenticate(_headers("only.two"))
        tok = p.issue_hs256({"sub": "a", "exp": "soon"})
        with pytest.raises(AuthenticationError, match="malformed exp"):
            p.authenticate(_headers(tok))
        tok = p.issue_hs256({"role": "USER"})
        with pytest.raises(AuthenticationError, match="sub"):
            p.authenticate(_headers(tok))
        with pytest.raises(ValueError):
            JwtSecurityProvider()

    def test_server_answers_401_with_the_challenge(self):
        from cruise_control_tpu_torch.api.server import CruiseControlApp
        p = _provider(login_url="https://login", time_fn=lambda: 0.0)
        # authentication comes before the facade is read
        app = CruiseControlApp(None, security=p, access_log=False)
        status, hdrs, body = app.handle_request(
            "GET", "/kafkacruisecontrol/state")
        assert status == 401
        assert hdrs["WWW-Authenticate"] == 'Bearer realm="https://login"'
        assert body["errorMessage"].startswith("AuthenticationError")
        status, hdrs, _ = app.handle_request("GET", "/metrics")
        assert status == 401 and "WWW-Authenticate" in hdrs
        app.stop()


# ---------------------------------------------------------------------------
# Against the reference: the same inputs through both packages
# ---------------------------------------------------------------------------


def _verdict(provider, headers):
    """What a provider makes of one request's headers, comparable across
    the two packages (each has its own Role enum and exception classes)."""
    try:
        principal = provider.authenticate(headers)
    except Exception as exc:      # noqa: BLE001 - the verdict is the point
        return ("raised", type(exc).__name__, str(exc))
    return ("principal", principal.name, principal.role.name,
            int(principal.role))


def _jwt_pair(**kw):
    """A JwtSecurityProvider of each package from the same arguments;
    `default_role` is given by name."""
    kw.setdefault("hs256_secret", SECRET)
    kw.setdefault("time_fn", lambda: 0.0)
    pair = []
    for mod in (ref_security, port_security):
        args = dict(kw)
        if "default_role" in args:
            args["default_role"] = mod.Role[args["default_role"]]
        pair.append(mod.JwtSecurityProvider(**args))
    return pair


# (provider arguments, claims, header form): the reference's JWT cases
# from tests/test_security_jwt.py, each issued by both packages
JWT_CASES = {
    "role": ({"time_fn": lambda: 1000.0},
             {"sub": "alice", "role": "ADMIN", "exp": 2000}, "bearer"),
    "default_role": ({"default_role": "VIEWER"}, {"sub": "bob"}, "bearer"),
    "inside_leeway": ({"leeway_s": 10.0, "time_fn": lambda: 1000.0},
                      {"sub": "a", "exp": 995}, "bearer"),
    "expired": ({"leeway_s": 10.0, "time_fn": lambda: 1000.0},
                {"sub": "a", "exp": 900}, "bearer"),
    "nbf": ({"leeway_s": 0.0, "time_fn": lambda: 1000.0},
            {"sub": "a", "nbf": 2000}, "bearer"),
    "issuer_audience": ({"issuer": "cc", "audience": "ops"},
                        {"sub": "a", "iss": "cc", "aud": ["ops", "x"]},
                        "bearer"),
    "wrong_audience": ({"issuer": "cc", "audience": "ops"},
                       {"sub": "a", "iss": "cc", "aud": "other"}, "bearer"),
    "wrong_issuer": ({"issuer": "cc", "audience": "ops"},
                     {"sub": "a", "iss": "zz", "aud": "ops"}, "bearer"),
    "unknown_role": ({}, {"sub": "a", "role": "SUPERUSER"}, "bearer"),
    "malformed_exp": ({}, {"sub": "a", "exp": "soon"}, "bearer"),
    "no_sub": ({}, {"role": "USER"}, "bearer"),
    "cookie": ({"cookie_name": "cc-jwt", "login_url": "https://login",
                "audiences": ["ops"]},
               {"sub": "dave", "aud": "ops", "role": "viewer"}, "cookie"),
}


@pytest.mark.parametrize("case", sorted(JWT_CASES))
def test_jwt_hs256_equals_the_reference(case):
    """The same claims through both providers' issue_hs256 give the same
    token bytes, and each token is judged the same way by both: the same
    principal and role, or the same error."""
    kw, claims, form = JWT_CASES[case]
    ref, port = _jwt_pair(**kw)
    ref_tok, port_tok = ref.issue_hs256(claims), port.issue_hs256(claims)
    assert port_tok == ref_tok

    def headers(tok):
        return ({"Cookie": f"a=b; cc-jwt={tok}"} if form == "cookie"
                else _headers(tok))

    verdicts = {(who, tok_of): _verdict(p, headers(tok))
                for who, p in (("ref", ref), ("port", port))
                for tok_of, tok in (("ref", ref_tok), ("port", port_tok))}
    assert len(set(verdicts.values())) == 1, verdicts
    assert port.auth_challenge_headers() == ref.auth_challenge_headers()


def _raw_jwt(header, claims, sig=""):
    b64 = port_security._b64url
    return (f"{b64(json.dumps(header).encode())}."
            f"{b64(json.dumps(claims).encode())}.{sig}")


# tokens no provider issues, judged by both packages
JWT_FORGED = {
    "alg_none": lambda: _headers(_raw_jwt({"alg": "none"},
                                          {"sub": "evil"})),
    "two_segments": lambda: _headers("only.two"),
    "other_secret": lambda: _headers(JwtSecurityProvider(
        hs256_secret=b"other", time_fn=lambda: 0.0).issue_hs256(
            {"sub": "a"})),
    "no_credentials": lambda: {},
    "cookie_missing": lambda: {"Cookie": "a=b"},
    "basic_instead_of_bearer": lambda: {"Authorization": "Basic eDp5"},
}


@pytest.mark.parametrize("case", sorted(JWT_FORGED))
def test_jwt_rejections_equal_the_reference(case):
    ref, port = _jwt_pair(cookie_name="cc-jwt")
    hdrs = JWT_FORGED[case]()
    want = _verdict(ref, hdrs)
    assert want[0] == "raised"
    assert _verdict(port, hdrs) == want


def test_jwt_rs256_equals_the_reference():
    """RS256 tokens (signed here with `cryptography`) and the algorithm
    confusion case are judged the same way by both packages."""
    key, pub = _rsa_keypair()
    _, other_pub = _rsa_keypair()
    forged = JwtSecurityProvider(hs256_secret=pub, time_fn=lambda: 0.0)
    tokens = [_sign_rs256(key, {"sub": "carol", "role": "USER"}),
              _sign_rs256(key, {"sub": "carol", "exp": -100}),
              forged.issue_hs256({"sub": "evil", "role": "ADMIN"})]
    for key_pem in (pub, other_pub):
        ref, port = _jwt_pair(hs256_secret=None,
                              rs256_public_key_pem=key_pem)
        for tok in tokens:
            assert _verdict(port, _headers(tok)) == \
                _verdict(ref, _headers(tok))
    assert _verdict(port, _headers(tokens[0]))[0] == "raised"   # other key


def test_jwt_needs_a_key_like_the_reference():
    with pytest.raises(ValueError) as ref_err:
        ref_security.JwtSecurityProvider()
    with pytest.raises(ValueError) as port_err:
        port_security.JwtSecurityProvider()
    assert str(port_err.value) == str(ref_err.value)


# fake-transport scripts: (status, headers, body) answers in order, the
# endpoint, its body, and the client's retry cap
_OK = (200, {}, {"version": 1, "summary": {}})
_FULL7 = (429, {"Retry-After": "7"},
          {"errorMessage": "QueueFullError: solve queue full",
           "retryAfterSeconds": 7, "version": 1})
_FULL = (429, {}, {"errorMessage": "full", "version": 1})
_DRAIN5 = (503, {"Retry-After": "5"},
           {"errorMessage": "ServerDraining: shutting down",
            "retryAfterSeconds": 5, "version": 1})
CLIENT_SCRIPTS = {
    "429_retry_after": ([_FULL7, _FULL7, _OK], "PROPOSALS", None, 4),
    "429_backoff": ([_FULL, _FULL, _FULL, _OK], "PROPOSALS", None, 4),
    "429_backoff_capped": ([_FULL] * 7 + [_OK], "REBALANCE", None, 9),
    "429_dead_task_resends_body": (
        [(429, {USER_TASK_ID_HEADER: "dead-task", "Retry-After": "1"},
          {"errorMessage": "QueueFullError: full", "version": 1}),
         (200, {}, {"version": 1, "scenarios": []})],
        "SCENARIOS", {"scenarios": []}, 4),
    "429_gives_up": ([_FULL7], "PROPOSALS", None, 2),
    "429_zero_retries": ([_FULL], "PROPOSALS", None, 0),
    "503_draining": ([_DRAIN5, _DRAIN5, _OK], "REBALANCE", None, 4),
    "503_body_hint": ([(503, {}, {"errorMessage": "ServerDraining",
                                  "retryAfterSeconds": 3, "version": 1}),
                       _OK], "PROPOSALS", None, 4),
    "503_bare": ([(503, {}, {"errorMessage": "TenantDrainingError: gone",
                             "version": 1})], "REBALANCE", None, 4),
    "503_gives_up": ([_DRAIN5], "PROPOSALS", None, 2),
    "202_polled_to_200": (
        [(202, {USER_TASK_ID_HEADER: "t-1"},
          {"progress": [{"operation": "PROPOSALS",
                         "status": "InProgress"}]}),
         (202, {USER_TASK_ID_HEADER: "t-1"}, {"progress": []}),
         (200, {USER_TASK_ID_HEADER: "t-1"}, {"version": 1})],
        "PROPOSALS", None, 4),
    "202_parked_for_review": (
        [(202, {}, {"reviewResult": {"Id": 1}, "version": 1})],
        "REBALANCE", None, 4),
    "400": ([(400, {}, {"errorMessage": "ParameterError: bad"})],
            "STATE", None, 4),
}


def _scripted_client(mod, answers, max_retries, cluster=None):
    """One client of `mod` on a fake transport that answers `answers` in
    order (the last one repeats), recording its calls, sleeps and retry
    callbacks."""
    seen = {"calls": [], "sleeps": [], "retries": []}
    client = mod.CruiseControlClient(
        "http://cc.test/kafkacruisecontrol", poll_interval_s=0.0,
        max_retries_429=max_retries, retry_backoff_base_s=1.0,
        retry_backoff_max_s=30.0, retry_jitter_token="pinned-test-client",
        cluster=cluster, sleep_fn=seen["sleeps"].append,
        on_retry=lambda *a: seen["retries"].append(a))

    def fake_http(method, url, task_id, data=None):
        seen["calls"].append((method, url, task_id, data))
        return answers[min(len(seen["calls"]) - 1, len(answers) - 1)]
    client._http = fake_http
    return client, seen


@pytest.mark.parametrize("case", sorted(CLIENT_SCRIPTS))
def test_client_script_equals_the_reference(case):
    """The same answers to both packages' clients with the same jitter
    token: the same requests (method, URL, task id, body bytes), the same
    sleeps to the bit, the same retry callbacks and the same outcome."""
    answers, endpoint, body, max_retries = CLIENT_SCRIPTS[case]
    runs = []
    for mod in (ref_client, port_client):
        client, seen = _scripted_client(mod, answers, max_retries)
        try:
            seen["out"] = ("returned", client.request(endpoint, body=body))
        except mod.CruiseControlClientError as exc:
            seen["out"] = ("raised", exc.status, exc.message,
                           exc.backpressure)
        runs.append(seen)
    ref, port = runs
    assert port == ref
    assert ref["calls"]


def _every_wrapper(client):
    """Each endpoint wrapper of the client, called with arguments that
    reach each of its query parameters."""
    client.state(["monitor", "executor"])
    client.state()
    client.fleet(verbose=True)
    client.load()
    client.partition_load("cpu", entries=5, topic="t0")
    client.proposals(["RackAwareGoal", "DiskCapacityGoal"], verbose=True,
                     ignore_proposal_cache=True, portfolio_width=2)
    client.kafka_cluster_state()
    client.user_tasks()
    client.rebalance(dryrun=False, goals=["RackAwareGoal"], verbose=True,
                     excluded_topics="t.*", reason="r", review_id=3)
    client.add_broker([4, 5], dryrun=True, goals=["RackAwareGoal"])
    client.remove_broker([3], dryrun=False, reason="decommission")
    client.demote_broker([0, 1], verbose=True)
    client.fix_offline_replicas(dryrun=True, verbose=True)
    client.stop_execution(force=True)
    client.pause_sampling("maintenance")
    client.resume_sampling()
    client.admin(enable_self_healing_for=["broker_failure"])
    client.topic_configuration("t0", 3, dryrun=False)
    client.review(approve=[1, 2], discard=[3], reason="ok")
    client.review_board()
    client.traces(trace_id="abc", outcome="degraded", limit=3, verbose=True,
                  since_ms=5.0, min_duration_ms=2.5)
    client.slo_status()
    client.portfolio_status()
    client.scenarios([{"name": "s", "brokersAdded": 1}], goals=["A"],
                     include_base=False, verbose=True, reason="what-if")
    client.request("STATE", {"cluster": "other"})
    with pytest.raises(ValueError) as err:
        client.request("STATE", {"bogus": 1})
    return str(err.value)


@pytest.mark.parametrize("cluster", [None, "prod-7"])
def test_client_wrappers_equal_the_reference(cluster):
    """Every endpoint wrapper of both clients sends the same requests."""
    runs = []
    for mod in (ref_client, port_client):
        client, seen = _scripted_client(
            mod, [(200, {}, {"version": 1, "sloStatus": {"x": 1},
                             "PortfolioState": {"y": 2}})], 4,
            cluster=cluster)
        seen["bogus"] = _every_wrapper(client)
        runs.append(seen)
    assert runs[1] == runs[0]
    assert len(runs[0]["calls"]) == 25


# argv lists through both CLIs; `loadgen` is left out, since the port's
# takes none of the reference's loadgen/ arguments (test_cli_error_exit_code)
CLI_ARGVS = [
    ["state"], ["state", "--substates", "monitor,executor"],
    ["--max-retries", "0", "--no-wait", "state"],
    ["--cluster", "prod-7", "--user", "u:p", "rebalance"],
    ["load"], ["partition_load", "--resource", "cpu", "--entries", "5",
               "--topic", "t0"],
    ["proposals", "--verbose", "--goals", "A,B", "--ignore-proposal-cache",
     "--portfolio-width", "2"],
    ["kafka_cluster_state"], ["user_tasks"], ["review_board"],
    ["fleet", "--verbose"],
    ["rebalance", "--execute", "--goals", "A", "--portfolio-width", "3",
     "--verbose", "--reason", "r", "--review-id", "7"],
    ["add_broker", "1,2", "--goals", "A"], ["remove_broker", "3", "--execute"],
    ["demote_broker", "0", "--verbose"], ["fix_offline_replicas", "--goals",
                                          "A,B"],
    ["scenarios", "--spec", '[{"name": "s"}]', "--no-base", "--goals", "A",
     "--verbose", "--reason", "w", "--review-id", "2"],
    ["topic_configuration", "t", "3", "--execute"],
    ["stop_execution", "--force"], ["pause_sampling"],
    ["resume_sampling", "--reason", "done"],
    ["admin", "--enable-self-healing-for", "broker_failure",
     "--disable-self-healing-for", "disk_failure,goal_violation"],
    ["review", "--approve", "1,2", "--discard", "3", "--reason", "x"],
    ["traces", "--trace-id", "abc", "--outcome", "degraded", "--limit", "3",
     "--verbose", "--since", "5", "--min-duration-ms", "2.5"],
    ["slo"], ["portfolio"],
]


@pytest.mark.parametrize("argv", CLI_ARGVS, ids=lambda a: "_".join(a)[:40])
def test_cli_equals_the_reference(argv, monkeypatch, capsys):
    """The same argv through both CLIs: the same parsed namespace, and
    `main` over a fake transport sends the same requests, prints the same
    output and exits with the same code."""
    assert vars(port_cli.build_parser().parse_args(argv)) == \
        vars(ref_cli.build_parser().parse_args(argv))
    runs = []
    for mod, cli in ((ref_client, ref_cli), (port_client, port_cli)):
        calls = []

        def fake_http(self, method, url, task_id, data=None, calls=calls):
            calls.append((method, url, task_id, data, self._auth))
            if "review_id=7" in url:
                return 400, {}, {"errorMessage": "ParameterError: no 7"}
            return 200, {}, {"version": 1, "sloStatus": {"x": 1}}
        monkeypatch.setattr(mod.CruiseControlClient, "_http", fake_http)
        rc = cli.main(argv)
        runs.append((rc, calls, capsys.readouterr()))
    assert runs[1] == runs[0]
