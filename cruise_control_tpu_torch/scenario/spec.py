"""What the model deltas borrow from the what-if scenario vocabulary
(port of `RESOURCE_NAMES`, `ScenarioSpecError`, `BrokerAdd`, the
resource-map check and `candidate_broker_sets` of cruise_control_tpu/
scenario/spec.py; the scenario engine itself is not ported)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

#: resource name <-> index (Resource order: CPU, NW_IN, NW_OUT, DISK)
RESOURCE_NAMES = ("cpu", "nw_in", "nw_out", "disk")


class ScenarioSpecError(ValueError):
    """Malformed or inconsistent specification."""


@dataclasses.dataclass(frozen=True)
class BrokerAdd:
    """One broker addition.  An id already present in the topology marks
    the existing broker as new (freshly joined, empty); `rack` and
    `capacity` describe a hypothetical broker row, which only the
    scenario engine materializes."""

    broker_id: int
    rack: Optional[str] = None
    capacity: Optional[Dict[str, float]] = None


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
