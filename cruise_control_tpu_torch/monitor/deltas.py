"""Structured workload-model deltas (port of cruise_control_tpu/monitor/
deltas.py).

Each `ModelDelta` describes one small change to the monitor's model:
brokers marked new, removed (modeled dead so a solve drains them) or
demoted, absolute per-broker capacity overrides, and per-partition
expected-load updates.  The monitor applies a delta to its host-side
overlay (`LoadMonitor.apply_model_delta`) and logs it as a `DeltaRecord`
on the model-generation chain; the device model store
(`model/store.DeviceModelStore`) replays a contiguous chain on the
resident tensors instead of rebuilding them.  Any change that was not
logged breaks the chain, and the store rebuilds.

`capacity_rows` and `leader_load_split` are shared by the rebuild and the
device path, so the two can never round differently.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.scenario.spec import (RESOURCE_NAMES,
                                                    BrokerAdd,
                                                    ScenarioSpecError,
                                                    check_resource_map)

__all__ = ["BrokerAdd", "ModelDeltaError", "PartitionLoadUpdate",
           "ModelDelta", "DeltaRecord", "capacity_rows",
           "leader_load_split", "chain_between"]


class ModelDeltaError(ValueError):
    """Malformed or inapplicable model delta."""


@dataclasses.dataclass(frozen=True)
class PartitionLoadUpdate:
    """A new expected leader utilization for one partition; follower
    loads and the leadership bonus re-derive from it as a rebuild derives
    them."""

    topic: str
    partition: int
    #: leader expected utilization in Resource order (cpu, nw_in,
    #: nw_out, disk)
    load: Tuple[float, ...]

    def __post_init__(self) -> None:
        if len(self.load) != NUM_RESOURCES:
            raise ModelDeltaError(
                f"partition load needs {NUM_RESOURCES} entries "
                f"({', '.join(RESOURCE_NAMES)}), got {len(self.load)}")
        for v in self.load:
            if not (float(v) >= 0.0):
                raise ModelDeltaError(
                    f"partition load must be finite and >= 0, got {v!r}")


@dataclasses.dataclass(frozen=True)
class ModelDelta:
    """One structured change to the monitor's workload model."""

    #: mark existing brokers as freshly joined (`broker_new`); a broker
    #: unknown to the metadata is a shape change and forces a rebuild
    add_brokers: Tuple[BrokerAdd, ...] = ()
    #: model these brokers dead (their replicas drain by self-healing)
    remove_brokers: Tuple[int, ...] = ()
    demote_brokers: Tuple[int, ...] = ()
    #: broker id -> {resource name: absolute capacity}
    capacity_overrides: Dict[int, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    load_updates: Tuple[PartitionLoadUpdate, ...] = ()
    reason: str = ""

    def is_noop(self) -> bool:
        return not (self.add_brokers or self.remove_brokers
                    or self.demote_brokers or self.capacity_overrides
                    or self.load_updates)

    def validate(self) -> None:
        if self.is_noop():
            raise ModelDeltaError("empty model delta")
        for a in self.add_brokers:
            if a.rack is not None or a.capacity is not None:
                raise ModelDeltaError(
                    f"add_brokers[{a.broker_id}] carries rack/capacity: "
                    f"a delta only marks an EXISTING broker as freshly "
                    f"joined — materializing a hypothetical row is a "
                    f"shape change (rebuild), and capacity belongs in "
                    f"capacity_overrides")
        try:
            for b, caps in self.capacity_overrides.items():
                check_resource_map(f"capacityOverrides[{int(b)}]", caps,
                                   allow_zero=False)
        except ScenarioSpecError as exc:
            raise ModelDeltaError(str(exc))
        added = {a.broker_id for a in self.add_brokers}
        overlap = added & set(self.remove_brokers)
        if overlap:
            raise ModelDeltaError(
                f"brokers {sorted(overlap)} both added and removed in "
                f"one delta")

    def broker_ids_touched(self) -> Tuple[int, ...]:
        """Broker ids the delta names directly (a load update dirties the
        brokers that host the partition too; the store resolves those
        against the resident placement)."""
        ids = ({a.broker_id for a in self.add_brokers}
               | set(self.remove_brokers) | set(self.demote_brokers)
               | set(self.capacity_overrides))
        return tuple(sorted(ids))

    def describe(self) -> str:
        parts = []
        if self.add_brokers:
            added = sorted(a.broker_id for a in self.add_brokers)
            parts.append(f"add={added}")
        if self.remove_brokers:
            parts.append(f"remove={sorted(self.remove_brokers)}")
        if self.demote_brokers:
            parts.append(f"demote={sorted(self.demote_brokers)}")
        if self.capacity_overrides:
            parts.append(f"capacity={sorted(self.capacity_overrides)}")
        if self.load_updates:
            parts.append(f"loads={len(self.load_updates)}p")
        return " ".join(parts) or "noop"


@dataclasses.dataclass(frozen=True)
class DeltaRecord:
    """One applied delta on the model-generation chain: the generation
    moved `from_generation` -> `to_generation` by applying exactly
    `delta`; `seq` increases by one a record."""

    seq: int
    from_generation: object          #: load_monitor.ModelGeneration
    to_generation: object
    delta: ModelDelta


def capacity_rows(capacity_overrides: Dict[int, Dict[str, float]],
                  broker_index: Dict[int, int]):
    """(rows i32[N], mask bool[N, RES], values f32[N, RES]): capacity
    overrides in numeric form, in broker-id order.  Brokers absent from
    `broker_index` are skipped."""
    rows, mask, values = [], [], []
    for b in sorted(capacity_overrides):
        if b not in broker_index:
            continue
        caps = capacity_overrides[b]
        m = np.zeros(NUM_RESOURCES, dtype=bool)
        v = np.zeros(NUM_RESOURCES, dtype=np.float32)
        for name, value in caps.items():
            r = RESOURCE_NAMES.index(name)
            m[r] = True
            v[r] = np.float32(value)
        rows.append(broker_index[b])
        mask.append(m)
        values.append(v)
    if not rows:
        return (np.zeros(0, np.int32), np.zeros((0, NUM_RESOURCES), bool),
                np.zeros((0, NUM_RESOURCES), np.float32))
    return (np.asarray(rows, np.int32), np.stack(mask), np.stack(values))


def leader_load_split(load, follower_cpu):
    """(leader_base f32[RES], follower_base f32[RES], bonus f32[RES]):
    the builder's split of one partition's expected leader utilization,
    in the same float64-then-float32 arithmetic.  The leader's base CPU
    is the clamped estimate (the builder clamps); the followers carry the
    estimator's raw value (the monitor's follower attribution)."""
    vec = np.asarray(load, dtype=np.float64)
    raw_f = float(follower_cpu(vec[Resource.CPU], vec[Resource.NW_IN],
                               vec[Resource.NW_OUT]))
    clipped_f = float(np.clip(raw_f, 0.0, vec[Resource.CPU]))
    leader_base = vec.copy()
    leader_base[Resource.CPU] = clipped_f
    leader_base[Resource.NW_OUT] = 0.0
    follower_base = vec.copy()
    follower_base[Resource.CPU] = raw_f
    follower_base[Resource.NW_OUT] = 0.0
    bonus = np.zeros(NUM_RESOURCES, dtype=np.float64)
    bonus[Resource.CPU] = vec[Resource.CPU] - clipped_f
    bonus[Resource.NW_OUT] = vec[Resource.NW_OUT]
    return (leader_base.astype(np.float32),
            follower_base.astype(np.float32),
            bonus.astype(np.float32))


def chain_between(records, from_generation, to_generation
                  ) -> Optional[list]:
    """The contiguous DeltaRecord chain from `from_generation` to
    `to_generation`, or None when there is none (an unlogged change, a
    log trimmed past `from_generation`, unrelated generations); `from ==
    to` is the empty chain."""
    if from_generation == to_generation:
        return []
    chain: list = []
    cur = from_generation
    for rec in records:
        if rec.from_generation == cur:
            chain.append(rec)
            cur = rec.to_generation
            if cur == to_generation:
                return chain
        elif chain:
            # continuity broken mid-walk: something moved the generation
            # without a record
            return None
    return None
