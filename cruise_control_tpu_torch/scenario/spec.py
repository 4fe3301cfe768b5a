"""Declarative what-if scenario specifications (port of
cruise_control_tpu/scenario/spec.py).

A `ScenarioSpec` describes one hypothetical cluster variant relative to
the live model: brokers added (hypothetical rows, or existing brokers
marked freshly joined), removed (modeled dead so the solve drains them)
or demoted; per-resource load scaling; capacity overrides; and an
optional goal-list override.  Specs are pure data: the compiler
(scenario/compiler.py) materializes them into padded `ClusterState`
variants and the engine (scenario/engine.py) solves a batch of them.

The JSON form (`SCENARIO_SPEC_SCHEMA`) is the SCENARIOS request body;
`parse_scenarios_payload` is its one parser.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES

#: resource name <-> index (Resource order: CPU, NW_IN, NW_OUT, DISK)
RESOURCE_NAMES = ("cpu", "nw_in", "nw_out", "disk")

#: the no-op base scenario the facade puts first (`is_noop()` is True)
BASE_SCENARIO_NAME = "__base__"


class ScenarioSpecError(ValueError):
    """Malformed or inconsistent specification (an HTTP 400)."""


@dataclasses.dataclass(frozen=True)
class BrokerAdd:
    """One broker addition.  An id already present in the topology marks
    the existing broker as new (freshly joined, empty); an unknown id
    materializes a hypothetical broker row, by default with the mean
    capacity of the alive brokers and on the racks in turn."""

    broker_id: int
    rack: Optional[str] = None
    capacity: Optional[Dict[str, float]] = None

    def to_json(self) -> dict:
        out: dict = {"brokerId": self.broker_id}
        if self.rack is not None:
            out["rack"] = self.rack
        if self.capacity is not None:
            out["capacity"] = dict(self.capacity)
        return out

    @classmethod
    def from_json(cls, obj) -> "BrokerAdd":
        if isinstance(obj, int):
            return cls(broker_id=obj)
        if not isinstance(obj, dict) or "brokerId" not in obj:
            raise ScenarioSpecError(
                f"broker addition must be an int or an object with "
                f"brokerId, got {obj!r}")
        cap = obj.get("capacity")
        if cap is not None:
            check_resource_map("capacity", cap, allow_zero=False)
        return cls(broker_id=int(obj["brokerId"]),
                   rack=obj.get("rack"),
                   capacity=None if cap is None
                   else {k: float(v) for k, v in cap.items()})


def check_resource_map(what: str, m, allow_zero: bool = True) -> None:
    """Raise ScenarioSpecError unless `m` maps resource names to
    non-negative numbers (positive without `allow_zero`)."""
    if not isinstance(m, dict):
        raise ScenarioSpecError(f"{what} must map resource name -> number")
    for k, v in m.items():
        if k not in RESOURCE_NAMES:
            raise ScenarioSpecError(
                f"{what} names unknown resource {k!r}; "
                f"legal: {list(RESOURCE_NAMES)}")
        try:
            v = float(v)
        except (TypeError, ValueError):
            raise ScenarioSpecError(f"{what}[{k}] must be a number")
        if v < 0 or (not allow_zero and v == 0):
            raise ScenarioSpecError(f"{what}[{k}] must be positive")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One hypothetical cluster variant (pure data; see module doc)."""

    name: str
    add_brokers: Tuple[BrokerAdd, ...] = ()
    remove_brokers: Tuple[int, ...] = ()
    demote_brokers: Tuple[int, ...] = ()
    #: per-resource load multipliers, applied to every replica's base
    #: load and every partition's leadership bonus
    load_scale: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: broker id -> {resource: absolute capacity}
    capacity_overrides: Dict[int, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    #: goal-list override (None: the engine's default); scenarios
    #: sharing a goal list share one batch
    goals: Optional[Tuple[str, ...]] = None
    #: only the added brokers may receive moved replicas
    only_move_to_added: bool = False

    def is_noop(self) -> bool:
        """True for the identity scenario (the base solve)."""
        return not (self.add_brokers or self.remove_brokers
                    or self.demote_brokers or self.load_scale
                    or self.capacity_overrides)

    def validate(self, topology=None) -> None:
        """Raise ScenarioSpecError on an inconsistent spec; with a
        `topology` also check that broker ids exist where they must."""
        if not self.name or not isinstance(self.name, str):
            raise ScenarioSpecError("scenario needs a non-empty name")
        check_resource_map("loadScale", self.load_scale, allow_zero=False)
        for b, caps in self.capacity_overrides.items():
            check_resource_map(f"capacityOverrides[{b}]", caps,
                               allow_zero=False)
        added = {a.broker_id for a in self.add_brokers}
        if len(added) != len(self.add_brokers):
            raise ScenarioSpecError(
                f"{self.name}: duplicate broker ids in add_brokers")
        overlap = added & set(self.remove_brokers)
        if overlap:
            raise ScenarioSpecError(
                f"{self.name}: brokers {sorted(overlap)} both added and "
                f"removed")
        if self.only_move_to_added and not self.add_brokers:
            raise ScenarioSpecError(
                f"{self.name}: only_move_to_added without add_brokers")
        if topology is not None:
            known = set(topology.broker_ids)
            for what, ids in (("remove_brokers", self.remove_brokers),
                              ("demote_brokers", self.demote_brokers),
                              ("capacity_overrides",
                               self.capacity_overrides)):
                unknown = [b for b in ids if b not in known
                           and b not in added]
                if unknown:
                    raise ScenarioSpecError(
                        f"{self.name}: {what} names unknown brokers "
                        f"{sorted(unknown)}")

    def to_json(self) -> dict:
        out: dict = {"name": self.name}
        if self.add_brokers:
            out["addBrokers"] = [a.to_json() for a in self.add_brokers]
        if self.remove_brokers:
            out["removeBrokers"] = list(self.remove_brokers)
        if self.demote_brokers:
            out["demoteBrokers"] = list(self.demote_brokers)
        if self.load_scale:
            out["loadScale"] = dict(self.load_scale)
        if self.capacity_overrides:
            out["capacityOverrides"] = {
                str(b): dict(c) for b, c in self.capacity_overrides.items()}
        if self.goals is not None:
            out["goals"] = list(self.goals)
        if self.only_move_to_added:
            out["onlyMoveToAdded"] = True
        return out

    @classmethod
    def from_json(cls, obj) -> "ScenarioSpec":
        if not isinstance(obj, dict):
            raise ScenarioSpecError(f"scenario must be an object, "
                                    f"got {type(obj).__name__}")
        unknown = set(obj) - {"name", "addBrokers", "removeBrokers",
                              "demoteBrokers", "loadScale",
                              "capacityOverrides", "goals",
                              "onlyMoveToAdded"}
        if unknown:
            raise ScenarioSpecError(
                f"unknown scenario fields {sorted(unknown)}")
        try:
            cap_over = {int(b): {k: float(v) for k, v in caps.items()}
                        for b, caps
                        in (obj.get("capacityOverrides") or {}).items()}
        except (TypeError, ValueError, AttributeError):
            raise ScenarioSpecError(
                "capacityOverrides must map broker id -> "
                "{resource: number}")
        spec = cls(
            name=str(obj.get("name", "")),
            add_brokers=tuple(BrokerAdd.from_json(a)
                              for a in obj.get("addBrokers") or ()),
            remove_brokers=tuple(int(b)
                                 for b in obj.get("removeBrokers") or ()),
            demote_brokers=tuple(int(b)
                                 for b in obj.get("demoteBrokers") or ()),
            load_scale={k: float(v)
                        for k, v in (obj.get("loadScale") or {}).items()},
            capacity_overrides=cap_over,
            goals=(tuple(str(g) for g in obj["goals"])
                   if obj.get("goals") is not None else None),
            only_move_to_added=bool(obj.get("onlyMoveToAdded", False)),
        )
        spec.validate()
        return spec

    def load_scale_vector(self) -> np.ndarray:
        """f32[RES] multipliers (1.0 where unnamed)."""
        vec = np.ones(NUM_RESOURCES, dtype=np.float32)
        for k, v in self.load_scale.items():
            vec[RESOURCE_NAMES.index(k)] = v
        return vec


#: JSON Schema (draft 2020-12) of one scenario object
_RES_MAP = {"type": "object",
            "properties": {r: {"type": "number", "exclusiveMinimum": 0}
                           for r in RESOURCE_NAMES},
            "additionalProperties": False}
SCENARIO_SPEC_SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string", "minLength": 1},
        "addBrokers": {"type": "array", "items": {"oneOf": [
            {"type": "integer"},
            {"type": "object",
             "properties": {"brokerId": {"type": "integer"},
                            "rack": {"type": "string"},
                            "capacity": _RES_MAP},
             "required": ["brokerId"], "additionalProperties": False},
        ]}},
        "removeBrokers": {"type": "array", "items": {"type": "integer"}},
        "demoteBrokers": {"type": "array", "items": {"type": "integer"}},
        "loadScale": _RES_MAP,
        "capacityOverrides": {"type": "object",
                              "additionalProperties": _RES_MAP},
        "goals": {"type": "array", "items": {"type": "string"}},
        "onlyMoveToAdded": {"type": "boolean"},
    },
    "required": ["name"],
    "additionalProperties": False,
}

#: request body of the SCENARIOS endpoint
SCENARIOS_REQUEST_SCHEMA = {
    "type": "object",
    "properties": {
        "scenarios": {"type": "array", "items": SCENARIO_SPEC_SCHEMA,
                      "minItems": 1},
        "goals": {"type": "array", "items": {"type": "string"}},
        "includeBase": {"type": "boolean"},
    },
    "required": ["scenarios"],
    "additionalProperties": False,
}


def parse_scenarios_payload(body) -> Tuple[List[ScenarioSpec],
                                           Optional[List[str]],
                                           Optional[bool]]:
    """(specs, goal override, include_base) from a SCENARIOS request body
    (str or bytes JSON, or a parsed dict).  `include_base` is None when
    the body does not say.  ScenarioSpecError on anything malformed."""
    if body is None or body == "" or body == b"":
        raise ScenarioSpecError(
            "SCENARIOS requires a JSON body: "
            '{"scenarios": [{"name": ..., ...}]}')
    if isinstance(body, (bytes, bytearray)):
        body = body.decode("utf-8", errors="replace")
    if isinstance(body, str):
        try:
            body = json.loads(body)
        except json.JSONDecodeError as exc:
            raise ScenarioSpecError(f"request body is not JSON: {exc}")
    if not isinstance(body, dict) or not isinstance(
            body.get("scenarios"), list) or not body["scenarios"]:
        raise ScenarioSpecError(
            'request body must be {"scenarios": [...]} with at least one '
            'scenario')
    unknown = set(body) - {"scenarios", "goals", "includeBase"}
    if unknown:
        raise ScenarioSpecError(f"unknown body fields {sorted(unknown)}")
    specs = [ScenarioSpec.from_json(s) for s in body["scenarios"]]
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ScenarioSpecError("scenario names must be unique")
    goals = body.get("goals")
    if goals is not None and (not isinstance(goals, list)
                              or not all(isinstance(g, str)
                                         for g in goals)):
        raise ScenarioSpecError("goals must be a list of goal names")
    include_base = body.get("includeBase")
    if include_base is not None:
        include_base = bool(include_base)
    return specs, goals, include_base


def candidate_broker_sets(broker_ids: Sequence) -> Optional[List[List[int]]]:
    """None when `broker_ids` is a flat id list (one solve); the K
    candidate sets when it is a sequence of sequences."""
    ids = list(broker_ids)
    if not ids or not any(isinstance(b, (list, tuple, set, frozenset))
                          for b in ids):
        return None
    if not all(isinstance(b, (list, tuple, set, frozenset)) for b in ids):
        raise ScenarioSpecError(
            "broker ids must be all ints (one candidate set) or all "
            "lists (multiple candidate sets), not a mix")
    return [sorted(int(x) for x in s) for s in ids]
