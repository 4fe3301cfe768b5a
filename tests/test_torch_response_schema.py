"""The PyTorch port's response schemas (cruise_control_tpu_torch/api/
schema.py) and its live responses against them, on the CPU.

The port of the reference's tests/test_response_schema.py: every schema
is valid JSON Schema; the port's `document()` equals the committed
docs/RESPONSE_SCHEMAS.json and the reference's `document()`, and
`python -m cruise_control_tpu_torch.api.schema` prints it; every body the
port's server answers here validates against its endpoint's schema (the
202 async-progress bodies met while polling, the purgatory's 202, the 429
and 503 backpressure bodies and the error body too); the answers of
tests/test_torch_api.py's request sequence are validated there.  The
server is the port's `CruiseControlApp` over the port's facade on
`make_stack` (tests/test_torch_facade_sampled.py, 4 brokers,
`device="cpu"`).
"""
import dataclasses
import json
import pathlib
import runpy
import time

import jsonschema
import pytest

from cruise_control_tpu.api import schema as jschema
from cruise_control_tpu_torch.api.schema import (AUX_SCHEMAS,
                                                 ENDPOINT_SCHEMAS, document)
from cruise_control_tpu_torch.api.server import CruiseControlApp
from cruise_control_tpu_torch.api.user_tasks import USER_TASK_ID_HEADER
from test_torch_facade_sampled import feed_samples, make_stack

SCENARIOS_BODY = json.dumps({"scenarios": [
    {"name": "remove 3", "removeBrokers": [3]},
    {"name": "cpu x 1.5", "loadScale": {"cpu": 1.5}}]})


@pytest.fixture(scope="module")
def apps():
    sim, cc, clock = make_stack(False)
    feed_samples(cc, clock)
    plain = CruiseControlApp(cc, async_response_timeout_s=0.0,
                             access_log=False)
    two_step = CruiseControlApp(cc, two_step_verification=True,
                                access_log=False)
    yield plain, two_step
    plain.stop()
    two_step.stop()
    cc.shutdown()


def _request(app, method, endpoint, query="", body=None, deadline_s=300.0):
    """Issue a request, polling 202 async-progress answers by their
    User-Task-ID; every 202 body must conform to the async-progress
    schema."""
    headers = {}
    end = time.time() + deadline_s
    while True:
        status, hdrs, out = app.handle_request(
            method, f"/kafkacruisecontrol/{endpoint.lower()}", query,
            headers, client="127.0.0.1", body=body)
        if status != 202 or "reviewResult" in out or time.time() > end:
            return status, hdrs, out
        jsonschema.validate(out, AUX_SCHEMAS["async_progress_202"])
        headers = {USER_TASK_ID_HEADER: hdrs[USER_TASK_ID_HEADER]}
        time.sleep(0.01)


def test_schemas_are_valid_jsonschema():
    for schema in {**ENDPOINT_SCHEMAS, **AUX_SCHEMAS}.values():
        jsonschema.Draft202012Validator.check_schema(schema)


def test_document_equals_the_committed_file_and_the_reference(capsys):
    path = (pathlib.Path(__file__).resolve().parent.parent
            / "docs" / "RESPONSE_SCHEMAS.json")
    doc = json.loads(json.dumps(document(), sort_keys=True))
    assert doc == json.loads(path.read_text())
    assert doc == json.loads(json.dumps(jschema.document(), sort_keys=True))
    from cruise_control_tpu_torch.api import schema as pschema
    runpy.run_path(pschema.__file__, run_name="__main__")
    assert json.loads(capsys.readouterr().out) == doc


@pytest.mark.parametrize("endpoint,query", [
    ("STATE", ""),
    ("STATE", "substates=sensors,scheduler,slo,incremental"),
    ("KAFKA_CLUSTER_STATE", ""),
    ("LOAD", ""),
    ("PARTITION_LOAD", "resource=cpu&entries=3"),
    ("PROPOSALS", "verbose=true"),
    ("USER_TASKS", ""),
    ("TRACES", "verbose=true&limit=4"),
])
def test_get_endpoints_conform(apps, endpoint, query):
    status, _, body = _request(apps[0], "GET", endpoint, query)
    assert status == 200, body
    jsonschema.validate(body, ENDPOINT_SCHEMAS[endpoint])


@pytest.mark.parametrize("endpoint,query,body", [
    ("REBALANCE", "dryrun=true&verbose=true", None),
    ("TOPIC_CONFIGURATION", "topic=t0&replication_factor=3&verbose=true",
     None),
    ("SCENARIOS", "verbose=true", SCENARIOS_BODY),
    ("PAUSE_SAMPLING", "", None),
    ("RESUME_SAMPLING", "", None),
    ("STOP_PROPOSAL_EXECUTION", "", None),
    ("ADMIN", "", None),
])
def test_post_endpoints_conform(apps, endpoint, query, body):
    status, _, out = _request(apps[0], "POST", endpoint, query, body)
    assert status == 200, out
    jsonschema.validate(out, ENDPOINT_SCHEMAS[endpoint])


def test_review_bodies_conform(apps):
    two_step = apps[1]
    status, _, parked = _request(two_step, "POST", "REBALANCE",
                                 "dryrun=true")
    assert status == 202
    jsonschema.validate(parked, AUX_SCHEMAS["review_parked_202"])
    rid = parked["reviewResult"]["Id"]
    for endpoint, method, query in (("REVIEW", "POST", f"approve={rid}"),
                                    ("REVIEW_BOARD", "GET", "")):
        status, _, out = _request(two_step, method, endpoint, query)
        assert status == 200, out
        jsonschema.validate(out, ENDPOINT_SCHEMAS[endpoint])


def test_backpressure_and_error_bodies_conform(apps, monkeypatch):
    plain = apps[0]
    status, _, body = _request(plain, "GET", "LOAD", "bogus_param=1")
    assert status == 400
    jsonschema.validate(body, AUX_SCHEMAS["error"])
    status, _, body = _request(plain, "POST", "ADMIN",
                               "enable_self_healing_for=broker_failure")
    assert status == 500 and "detector/" in body["errorMessage"]
    jsonschema.validate(body, AUX_SCHEMAS["error"])
    queue = plain.cc.solve_scheduler.queue
    classes = {k: dataclasses.replace(c, queue_cap=0)
               for k, c in queue._policy.classes.items()}
    monkeypatch.setattr(queue, "_policy", dataclasses.replace(
        queue._policy, classes=classes))
    status, hdrs, body = _request(plain, "GET", "PROPOSALS",
                                  "ignore_proposal_cache=true")
    assert status == 429 and hdrs["Retry-After"] == "1"
    jsonschema.validate(body, AUX_SCHEMAS["rate_limited_429"])
    monkeypatch.undo()
    drained = CruiseControlApp(plain.cc, access_log=False)
    drained.drain(retry_after_s=5)
    status, hdrs, body = _request(drained, "POST", "REBALANCE")
    assert status == 503 and hdrs["Retry-After"] == "5"
    jsonschema.validate(body, AUX_SCHEMAS["rate_limited_429"])
    drained.stop()
