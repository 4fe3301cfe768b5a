"""Query-parameter parsing and validation (port of cruise_control_tpu/
api/parameters.py).

Reference CC/servlet/parameters/ (24 classes + ParameterUtils.java:1-1038):
every endpoint declares its legal parameter names; unknown parameters are
rejected; values are parsed with typed helpers (booleans, CSV integer
lists, regex patterns, doubles).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from cruise_control_tpu_torch.common.resources import Resource


class ParameterError(ValueError):
    """400-level: bad query parameter."""


#: legal query parameters per endpoint (reference each *Parameters class)
VALID_PARAMS: Dict[str, Set[str]] = {
    "STATE": {"substates", "verbose", "json"},   # substates incl. sensors
    "LOAD": {"allow_capacity_estimation", "json"},
    "PARTITION_LOAD": {"resource", "entries", "topic", "min_valid_partition_ratio",
                       "max_load", "json"},
    "PROPOSALS": {"goals", "ignore_proposal_cache", "verbose",
                  "excluded_topics", "portfolio_width", "json"},
    "KAFKA_CLUSTER_STATE": {"verbose", "json"},
    "USER_TASKS": {"user_task_ids", "json"},
    "REVIEW_BOARD": {"review_ids", "json"},
    "BOOTSTRAP": {"start", "end", "clearmetrics", "json"},
    "TRAIN": {"start", "end", "json"},
    "REBALANCE": {"goals", "dryrun", "verbose", "excluded_topics",
                  "concurrent_partition_movements_per_broker",
                  "concurrent_leader_movements", "json", "reason",
                  "ignore_proposal_cache", "destination_broker_ids",
                  "replication_throttle", "replica_movement_strategies",
                  "kafka_assigner", "portfolio_width", "review_id"},
    "ADD_BROKER": {"brokerid", "goals", "dryrun", "verbose", "json",
                   "reason", "throttle_added_broker",
                   "replication_throttle", "review_id"},
    "REMOVE_BROKER": {"brokerid", "goals", "dryrun", "verbose", "json",
                      "reason", "throttle_removed_broker",
                      "destination_broker_ids", "replication_throttle",
                      "review_id"},
    "DEMOTE_BROKER": {"brokerid", "dryrun", "verbose", "json", "reason",
                      "skip_urp_demotion", "exclude_follower_demotion",
                      "replication_throttle", "review_id"},
    "FIX_OFFLINE_REPLICAS": {"goals", "dryrun", "verbose", "json", "reason",
                             "review_id"},
    "STOP_PROPOSAL_EXECUTION": {"force_stop", "json", "review_id"},
    "PAUSE_SAMPLING": {"reason", "json", "review_id"},
    "RESUME_SAMPLING": {"reason", "json", "review_id"},
    "ADMIN": {"disable_self_healing_for", "enable_self_healing_for",
              "concurrent_partition_movements_per_broker",
              "concurrent_leader_movements", "json", "review_id"},
    "REVIEW": {"approve", "discard", "reason", "json"},
    "TOPIC_CONFIGURATION": {"topic", "replication_factor", "goals",
                            "dryrun", "verbose", "json", "reason",
                            "review_id"},
    # batched what-if analysis (framework extension, scenario/ engine):
    # the scenario list rides in the JSON request BODY (see
    # scenario/spec.py SCENARIOS_REQUEST_SCHEMA), not the query string
    "SCENARIOS": {"verbose", "json", "reason", "review_id"},
    # flight-recorder queries (framework extension, obs/): the span
    # trees of recent solves — `?trace_id=` fetches the tree a solve
    # response's `traceId` named, `?outcome=degraded` the pinned
    # incident traces (docs/OBSERVABILITY.md)
    # `since` (epoch ms) + `min_duration_ms` bound drill queries under
    # load so --follow tails never page the full ring
    "TRACES": {"trace_id", "outcome", "limit", "verbose", "json",
               "since", "min_duration_ms"},
}

#: fleet tenancy (the reference's fleet/): EVERY endpoint accepts
#: `cluster=<id>`; the port has no fleet, so its server answers any
#: `cluster=` with 404, as the reference's single-tenant server does
for _params in VALID_PARAMS.values():
    _params.add("cluster")

#: fleet-level tenant listing (GET; no `cluster` param); 404 without a
#: fleet
VALID_PARAMS["FLEET"] = {"verbose", "json"}

#: POST endpoints subject to purgatory review when two-step is enabled
POST_ENDPOINTS = {
    "REBALANCE", "ADD_BROKER", "REMOVE_BROKER", "DEMOTE_BROKER",
    "FIX_OFFLINE_REPLICAS", "STOP_PROPOSAL_EXECUTION", "PAUSE_SAMPLING",
    "RESUME_SAMPLING", "ADMIN", "TOPIC_CONFIGURATION", "SCENARIOS",
}
GET_ENDPOINTS = set(VALID_PARAMS) - POST_ENDPOINTS - {"REVIEW"}


class QueryParams:
    """Typed accessors over a parsed query dict (values = last occurrence)."""

    def __init__(self, endpoint: str, raw: Dict[str, List[str]]) -> None:
        self.endpoint = endpoint
        legal = VALID_PARAMS.get(endpoint)
        if legal is None:
            raise ParameterError(f"unknown endpoint {endpoint!r}")
        unknown = {k.lower() for k in raw} - legal
        if unknown:
            raise ParameterError(
                f"unrecognized parameters {sorted(unknown)} for "
                f"{endpoint}; legal: {sorted(legal)}")
        self._raw = {k.lower(): v[-1] for k, v in raw.items()}

    def get(self, name: str, default: Optional[str] = None) -> Optional[str]:
        return self._raw.get(name, default)

    def get_bool(self, name: str, default: bool = False) -> bool:
        v = self._raw.get(name)
        if v is None:
            return default
        if v.lower() in ("true", "1", "yes"):
            return True
        if v.lower() in ("false", "0", "no"):
            return False
        raise ParameterError(f"{name} must be boolean, got {v!r}")

    def get_int(self, name: str, default: Optional[int] = None
                ) -> Optional[int]:
        v = self._raw.get(name)
        if v is None:
            return default
        try:
            return int(v)
        except ValueError:
            raise ParameterError(f"{name} must be an integer, got {v!r}")

    def get_float(self, name: str, default: Optional[float] = None
                  ) -> Optional[float]:
        v = self._raw.get(name)
        if v is None:
            return default
        try:
            return float(v)
        except ValueError:
            raise ParameterError(f"{name} must be a number, got {v!r}")

    def get_csv(self, name: str) -> Optional[List[str]]:
        v = self._raw.get(name)
        if v is None or v == "":
            return None
        return [s.strip() for s in v.split(",") if s.strip()]

    def get_csv_ints(self, name: str) -> Optional[List[int]]:
        vals = self.get_csv(name)
        if vals is None:
            return None
        try:
            return [int(s) for s in vals]
        except ValueError:
            raise ParameterError(f"{name} must be CSV integers")

    def get_resource(self, name: str, default: int = Resource.DISK) -> int:
        v = self._raw.get(name)
        if v is None:
            return default
        try:
            return {"cpu": Resource.CPU, "nw_in": Resource.NW_IN,
                    "networkinbound": Resource.NW_IN,
                    "nw_out": Resource.NW_OUT,
                    "networkoutbound": Resource.NW_OUT,
                    "disk": Resource.DISK}[v.lower()]
        except KeyError:
            raise ParameterError(f"unknown resource {v!r}")
