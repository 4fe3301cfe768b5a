"""Config-driven endpoint -> handler/parameter class wiring (port of
cruise_control_tpu/api/request_registry.py).

Reference CC/config/constants/CruiseControlRequestConfig.java and
CruiseControlParametersConfig.java: the servlet instantiates each
endpoint's Request and Parameters classes from config
(`<endpoint>.request.class` / `<endpoint>.parameters.class`, 20 + 20
keys), so deployments can swap per-endpoint behavior without forking the
server.  Here the same keys resolve dotted Python classes: the
parameters class builds the endpoint's QueryParams (subclass to accept
extra parameters or re-validate), and the request class produces the
response body (subclass `Request` to override an endpoint end to end).
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple, Type

from cruise_control_tpu_torch.api.parameters import QueryParams

#: endpoint -> config-key stem (reference key names use the stem with
#: ".request.class" / ".parameters.class" suffixes)
ENDPOINT_KEY_STEMS: Dict[str, str] = {
    "BOOTSTRAP": "bootstrap",
    "TRAIN": "train",
    "LOAD": "load",
    "PARTITION_LOAD": "partition.load",
    "PROPOSALS": "proposals",
    "STATE": "state",
    "KAFKA_CLUSTER_STATE": "kafka.cluster.state",
    "USER_TASKS": "user.tasks",
    "REVIEW_BOARD": "review.board",
    "ADD_BROKER": "add.broker",
    "REMOVE_BROKER": "remove.broker",
    "FIX_OFFLINE_REPLICAS": "fix.offline.replicas",
    "DEMOTE_BROKER": "demote.broker",
    "REBALANCE": "rebalance",
    "STOP_PROPOSAL_EXECUTION": "stop.proposal",
    "PAUSE_SAMPLING": "pause.sampling",
    "RESUME_SAMPLING": "resume.sampling",
    "ADMIN": "admin",
    "REVIEW": "review",
    "TOPIC_CONFIGURATION": "topic.configuration",
}

DEFAULT_REQUEST_CLASS = (
    "cruise_control_tpu_torch.api.request_registry.Request")
DEFAULT_PARAMETERS_CLASS = (
    "cruise_control_tpu_torch.api.parameters.QueryParams")


class Request:
    """Default request handler: delegates to the app's built-in dispatch
    (reference handler/sync + handler/async Request classes; subclasses
    override `handle_sync` or `operation`)."""

    def __init__(self, endpoint: str) -> None:
        self.endpoint = endpoint

    def handle_sync(self, app, params) -> dict:
        """Synchronous endpoints: return the JSON body."""
        return app.default_sync_handler(self.endpoint, params)

    def operation(self, app, params):
        """Async endpoints: return the zero-arg callable the user-task
        executor runs."""
        return app.default_operation(self.endpoint, params)


def _import_class(dotted: str):
    mod, _, name = dotted.rpartition(".")
    return getattr(importlib.import_module(mod), name)


def resolve_endpoint_classes(config) -> Dict[str, Tuple[Type[Request],
                                                        Type[QueryParams]]]:
    """{endpoint: (request class, parameters class)} from the 40 config
    keys; invalid classes raise at startup (reference
    getConfiguredInstance semantics)."""
    out = {}
    for endpoint, stem in ENDPOINT_KEY_STEMS.items():
        req_cls = _import_class(config.get_string(f"{stem}.request.class"))
        par_cls = _import_class(
            config.get_string(f"{stem}.parameters.class"))
        if not issubclass(req_cls, Request):
            raise TypeError(f"{stem}.request.class {req_cls} does not "
                            f"extend api.request_registry.Request")
        if not issubclass(par_cls, QueryParams):
            raise TypeError(f"{stem}.parameters.class {par_cls} does not "
                            f"extend api.parameters.QueryParams")
        out[endpoint] = (req_cls, par_cls)
    return out


def request_config_def(d) -> None:
    """Define the 40 endpoint wiring keys (reference
    CruiseControlRequestConfig + CruiseControlParametersConfig)."""
    from cruise_control_tpu_torch.common.config import (Importance,
                                                        Type as CType)
    for stem in sorted(set(ENDPOINT_KEY_STEMS.values())):
        d.define(f"{stem}.request.class", CType.CLASS,
                 DEFAULT_REQUEST_CLASS, None, Importance.LOW,
                 f"Request handler class for the {stem} endpoint.")
        d.define(f"{stem}.parameters.class", CType.CLASS,
                 DEFAULT_PARAMETERS_CLASS, None, Importance.LOW,
                 f"Parameter validation class for the {stem} endpoint.")
