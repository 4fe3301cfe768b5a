"""Model deltas on the device (port of the device half of
cruise_control_tpu/model/store.py).

A `DeltaPlan` is the numeric, fixed-shape form of one model delta: broker
flags (new, removed, demoted), capacity rows and per-partition load rows.
`apply_delta` applies it to a resident `ClusterState` and returns the
dirty-broker mask that a dirty-region solve
(`GoalOptimizer.optimizations(dirty_brokers=...)`) restricts its search
to.  Id arrays are padded to power-of-two lengths with an out-of-range id
(`num_brokers`, `num_partitions`); the reference's scatters drop such
rows (JAX's ``mode="drop"``), and so do the port's (`ops.scatter_set`).

`DeviceModelStore` keeps the current `ClusterState` resident on the
device between requests, keyed by the monitor's `ModelGeneration`: an
exact-generation consult returns it as it is; a generation that moved
through a contiguous chain of logged deltas (monitor/deltas.py) is
reached by applying each delta's plan here, all or nothing; anything
else (a generation gap, a delta the resident axes cannot address, a
failure mid-apply) is a counted fallback, and the caller rebuilds from
the monitor.  A failure mid-apply (fault site `store.apply_delta`)
quarantines the resident model: a half-applied model is never served.  The store also keeps each applied
delta's dirty-broker mask, so `dirty_since(generation)` gives the region
a warm solve seeded at `generation` must revisit.

The resident state is shared with every caller: a caller that solves on
it hands the solver its own copy (the port's facade does).
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch import ops
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.model.state import (ClusterState,
                                                  set_broker_capacities)
from cruise_control_tpu_torch.monitor.deltas import (capacity_rows,
                                                     leader_load_split)
from cruise_control_tpu_torch.obs import trace as obs_trace
from cruise_control_tpu_torch.utils import faults

LOG = logging.getLogger(__name__)

#: the dirty-broker masks kept for `dirty_since`, newest last
MAX_DIRTY_ENTRIES = 256


class UnsupportedDeltaError(ValueError):
    """The delta names a broker or partition that the resident topology
    does not know: a rebuild serves it instead (a counted fallback)."""

#: tensor fields of a DeltaPlan, in declaration order
PLAN_FIELDS = ("new_brokers", "removed_brokers", "demoted_brokers",
               "cap_rows", "cap_mask", "cap_values", "load_parts",
               "load_leader_base", "load_follower_base", "load_bonus")


@dataclasses.dataclass(frozen=True)
class DeltaPlan:
    """One model delta, host-built and device-applied."""

    new_brokers: torch.Tensor         # i32[Nb], pad = num_brokers
    removed_brokers: torch.Tensor     # i32[Nb]
    demoted_brokers: torch.Tensor     # i32[Nb]
    cap_rows: torch.Tensor            # i32[Nc], pad = num_brokers
    cap_mask: torch.Tensor            # bool[Nc, RES]
    cap_values: torch.Tensor          # f32[Nc, RES]
    load_parts: torch.Tensor          # i32[Np], pad = num_partitions
    load_leader_base: torch.Tensor    # f32[Np, RES]
    load_follower_base: torch.Tensor  # f32[Np, RES]
    load_bonus: torch.Tensor          # f32[Np, RES]

    def to(self, device) -> "DeltaPlan":
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in PLAN_FIELDS})


def _pad_pow2(n: int, floor: int = 4) -> int:
    if n <= floor:
        return floor
    return 1 << (n - 1).bit_length()


def _id_array(ids, fill: int, width: int) -> np.ndarray:
    out = np.full(width, fill, dtype=np.int32)
    out[:len(ids)] = np.asarray(sorted(ids), dtype=np.int32)
    return out


def plan_arrays(num_brokers: int, num_partitions: int, *, new=(),
                removed=(), demoted=(), capacities=None,
                loads=None) -> Dict[str, np.ndarray]:
    """The numpy fields of a DeltaPlan, padded as the reference's store
    pads them: broker rows `new`, `removed`, `demoted`; `capacities`
    {broker row: {resource index: value}}; `loads` {partition row:
    (leader base [RES], follower base [RES], leadership bonus [RES])}.
    Broker id arrays share one power-of-two width (at least 4), as do
    the capacity rows and the load rows."""
    capacities = capacities or {}
    loads = loads or {}
    nb = _pad_pow2(max(len(new), len(removed), len(demoted)))
    nc = _pad_pow2(len(capacities))
    npr = _pad_pow2(len(loads))
    cap_rows = np.full(nc, num_brokers, dtype=np.int32)
    cap_mask = np.zeros((nc, NUM_RESOURCES), dtype=bool)
    cap_values = np.zeros((nc, NUM_RESOURCES), dtype=np.float32)
    for i, row in enumerate(sorted(capacities)):
        cap_rows[i] = row
        for res, value in capacities[row].items():
            cap_mask[i, res] = True
            cap_values[i, res] = np.float32(value)
    rows = sorted(loads)

    def load_rows(k: int) -> np.ndarray:
        out = np.zeros((npr, NUM_RESOURCES), dtype=np.float32)
        for i, row in enumerate(rows):
            out[i] = np.asarray(loads[row][k], dtype=np.float32)
        return out

    return dict(
        new_brokers=_id_array(new, num_brokers, nb),
        removed_brokers=_id_array(removed, num_brokers, nb),
        demoted_brokers=_id_array(demoted, num_brokers, nb),
        cap_rows=cap_rows, cap_mask=cap_mask, cap_values=cap_values,
        load_parts=_id_array(rows, num_partitions, npr),
        load_leader_base=load_rows(0), load_follower_base=load_rows(1),
        load_bonus=load_rows(2))


def plan_from_numpy(arrays: Dict[str, np.ndarray], device=None
                    ) -> DeltaPlan:
    """A DeltaPlan of `plan_arrays`' fields on `device` (the card unless
    "cpu" is asked for)."""
    dev = resolve_device(device)
    return DeltaPlan(**{f: torch.from_numpy(np.ascontiguousarray(
        arrays[f])).to(dev) for f in PLAN_FIELDS})


def apply_delta(state: ClusterState, plan: DeltaPlan
                ) -> Tuple[ClusterState, torch.Tensor]:
    """(new state, dirty-broker mask bool[B]): one delta applied to the
    resident tensors on their device.  Broker flags are set, replicas on
    removed brokers go offline, the listed partitions take their new
    leadership bonus and each of their replicas its new base load (the
    leader's or the followers' row by its current role), capacity rows go
    through `set_broker_capacities`, and a broker is dirty when it is
    new, removed, demoted, has a capacity row or holds a replica of a
    listed partition."""
    num_b = state.num_brokers
    num_p = state.num_partitions
    dev = state.device
    plan = plan.to(dev)

    def flags(base, ids, value: bool):
        return ops.scatter_set(base, ids, value)

    new = flags(state.broker_new, plan.new_brokers, True)
    demoted = flags(state.broker_demoted, plan.demoted_brokers, True)
    alive = flags(state.broker_alive, plan.removed_brokers, False)
    removed_mask = flags(torch.zeros(num_b, dtype=torch.bool, device=dev),
                         plan.removed_brokers, True)
    on_removed = removed_mask[state.replica_broker] & state.replica_valid
    offline = state.replica_offline | on_removed
    original_offline = state.replica_original_offline | on_removed

    part_sel = flags(torch.zeros(num_p, dtype=torch.bool, device=dev),
                     plan.load_parts, True)
    zeros = torch.zeros((num_p, NUM_RESOURCES), dtype=torch.float32,
                        device=dev)
    lb = ops.scatter_set(zeros, plan.load_parts, plan.load_leader_base)
    fb = ops.scatter_set(zeros, plan.load_parts, plan.load_follower_base)
    bn = ops.scatter_set(zeros, plan.load_parts, plan.load_bonus)
    bonus = torch.where(part_sel[:, None], bn, state.partition_leader_bonus)
    p_of_r = state.replica_partition.long()
    r_sel = part_sel[p_of_r] & state.replica_valid
    base_new = torch.where(state.replica_is_leader[:, None], lb[p_of_r],
                           fb[p_of_r])
    base = torch.where(r_sel[:, None], base_new, state.replica_base_load)

    out = state.replace(
        broker_new=new, broker_demoted=demoted, broker_alive=alive,
        replica_offline=offline,
        replica_original_offline=original_offline,
        partition_leader_bonus=bonus, replica_base_load=base)
    out = set_broker_capacities(out, plan.cap_rows, plan.cap_mask,
                                plan.cap_values)

    dirty = removed_mask
    for ids in (plan.new_brokers, plan.demoted_brokers, plan.cap_rows):
        dirty = flags(dirty, ids, True)
    # a broker holding no replica keeps the integer minimum: not dirty
    touched = ops.segment_max(r_sel.to(torch.int32), state.replica_broker,
                              num_b)
    return out, dirty | (touched > 0)


class DeviceModelStore:
    """The resident, generation-keyed model (see the module docstring);
    one per facade.  The counters count as the reference's do: a consult
    that finds the resident generation, or fast-forwards to it, is a hit;
    a consult with no resident model, or one that cannot use it, is a
    miss (and then also a fallback)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._generation = None
        self._cap_flag: Optional[bool] = None
        self._state: Optional[ClusterState] = None
        self._topology = None
        self._follower_cpu = None
        self._partition_index: Dict[tuple, int] = {}
        #: (from_generation, to_generation, dirty bool[B]) per advance
        self._dirty_log: List[tuple] = []
        self.hits = 0
        self.misses = 0
        self.fallbacks = 0
        self.delta_applies = 0
        self.invalidations = 0
        self.quarantines = 0
        self.last_dirty_brokers = 0
        self.last_fallback_reason = ""

    @property
    def generation(self):
        with self._lock:
            return self._generation

    @property
    def capacity_flag(self):
        """The allow_capacity_estimation flag of the resident build (None
        when empty): a consult with the other flag rebuilds."""
        with self._lock:
            return self._cap_flag

    def get(self, generation, allow_capacity_estimation: bool):
        """(state, topology) resident at exactly `generation` with the
        same capacity-estimation flag, else None."""
        with self._lock:
            if (self._state is not None
                    and self._generation == generation
                    and self._cap_flag == bool(allow_capacity_estimation)):
                self.hits += 1
                return self._state, self._topology
            return None

    def install(self, generation, state: ClusterState, topology,
                allow_capacity_estimation: bool, follower_cpu) -> None:
        """Adopt a rebuilt model as the resident one; the dirty chain
        restarts (a rebuild may hold changes no delta described)."""
        with self._lock:
            self._generation = generation
            self._cap_flag = bool(allow_capacity_estimation)
            self._state = state
            self._topology = topology
            self._follower_cpu = follower_cpu
            self._partition_index = {
                (p.topic, p.partition): i
                for i, p in enumerate(topology.partitions)}
            self._dirty_log = []

    def advance(self, records, to_generation):
        """Fast-forward the resident model through a contiguous delta
        chain; (state, topology) at `to_generation`, or None after a
        fallback (the store cleared nothing) or a quarantine (a failure
        mid-apply cleared it).  All or nothing."""
        with self._lock:
            if self._state is None or not records \
                    or records[0].from_generation != self._generation:
                self._fallback("generation-gap")
                return None
            state = self._state
            dirty_entries = []
            try:
                for rec in records:
                    faults.inject("store.apply_delta")
                    plan = self._build_plan(rec.delta)
                    state, dirty = apply_delta(state, plan)
                    dirty_entries.append(
                        (rec.from_generation, rec.to_generation, dirty))
            except UnsupportedDeltaError as exc:
                self._fallback(f"unsupported-delta: {exc}")
                return None
            except Exception as exc:  # noqa: BLE001 - a failure mid-apply
                self.quarantine(f"{type(exc).__name__}: {exc}")
                return None
            self._state = state
            self._generation = to_generation
            self._dirty_log.extend(dirty_entries)
            del self._dirty_log[:-MAX_DIRTY_ENTRIES]
            self.delta_applies += len(records)
            self.hits += 1
            self.last_dirty_brokers = int(torch.sum(
                dirty_entries[-1][2].to(torch.int32)))
            return self._state, self._topology

    def dirty_since(self, generation) -> Optional[torch.Tensor]:
        """The union dirty-broker mask (bool[B], on the device) of every
        delta applied between `generation` and the resident generation,
        or None when the chain does not reach back to `generation`; the
        resident generation itself gives the all-clean mask."""
        with self._lock:
            if self._state is None:
                return None
            num_b = self._state.num_brokers
            if generation == self._generation:
                return torch.zeros(num_b, dtype=torch.bool,
                                   device=self._state.device)
            mask = None
            cur = generation
            for frm, to, dirty in self._dirty_log:
                if frm == cur:
                    mask = dirty if mask is None else (mask | dirty)
                    cur = to
                    if cur == self._generation:
                        return mask
                elif mask is not None:
                    return None
            return None

    def invalidate(self, reason: str) -> None:
        """Drop the resident model."""
        with self._lock:
            if self._state is None:
                return
            self._clear()
            self.invalidations += 1
            LOG.info("device model store invalidated (%s)", reason)

    def quarantine(self, reason: str) -> None:
        """Drop the resident model because applying a delta failed."""
        with self._lock:
            self._clear()
            self.quarantines += 1
            self.fallbacks += 1
            self.last_fallback_reason = f"quarantined: {reason}"
            LOG.warning("device model store quarantined (%s); next solve "
                        "rebuilds from the monitor", reason)

    def record_fallback(self, reason: str) -> None:
        """Count a consult that had a resident model but could not use it
        (a gap, a long chain, the other capacity flag, a dirty region too
        large).  The reason also lands on the active request's trace."""
        obs_trace.event("model-store.fallback", reason=reason)
        with self._lock:
            self._fallback(reason)

    def _fallback(self, reason: str) -> None:
        self.misses += 1
        self.fallbacks += 1
        self.last_fallback_reason = reason

    def count_miss(self) -> None:
        with self._lock:
            self.misses += 1

    def _clear(self) -> None:
        self._generation = None
        self._cap_flag = None
        self._state = None
        self._topology = None
        self._follower_cpu = None
        self._partition_index = {}
        self._dirty_log = []

    def _build_plan(self, delta) -> DeltaPlan:
        """One delta's plan against the resident topology, on the
        resident device; UnsupportedDeltaError when the delta names a
        broker or a partition the resident axes cannot address."""
        topo = self._topology
        bidx = topo.broker_index

        def rows_of(ids, what: str):
            missing = [b for b in ids if b not in bidx]
            if missing:
                raise UnsupportedDeltaError(
                    f"{what} names brokers {sorted(missing)} absent "
                    f"from the resident model")
            return [bidx[b] for b in ids]

        new_rows = rows_of([a.broker_id for a in delta.add_brokers],
                           "add_brokers")
        removed_rows = rows_of(delta.remove_brokers, "remove_brokers")
        demoted_rows = rows_of(delta.demote_brokers, "demote_brokers")
        cap_rows, cap_mask, cap_values = capacity_rows(
            delta.capacity_overrides, bidx)
        if len(cap_rows) != len(delta.capacity_overrides):
            raise UnsupportedDeltaError(
                "capacity_overrides name brokers absent from the "
                "resident model")
        # the last update of a partition wins, as in the monitor's overlay
        loads: Dict[int, tuple] = {}
        for u in delta.load_updates:
            key = (u.topic, int(u.partition))
            if key not in self._partition_index:
                raise UnsupportedDeltaError(
                    f"load update for {key[0]}-{key[1]}: partition "
                    f"absent from the resident model (no samples at "
                    f"build time)")
            loads[self._partition_index[key]] = leader_load_split(
                u.load, self._follower_cpu)
        capacities = {int(r): {k: cap_values[i, k]
                               for k in range(NUM_RESOURCES)
                               if cap_mask[i, k]}
                      for i, r in enumerate(cap_rows)}
        arrays = plan_arrays(len(topo.broker_ids), len(topo.partitions),
                             new=new_rows, removed=removed_rows,
                             demoted=demoted_rows, capacities=capacities,
                             loads=loads)
        return plan_from_numpy(arrays, self._state.device)

    def to_json(self) -> dict:
        with self._lock:
            gen = self._generation
            return {
                "resident": self._state is not None,
                "generation": (None if gen is None else {
                    "cluster": gen.cluster_generation,
                    "load": gen.load_generation,
                    "delta": gen.delta_generation}),
                "numBrokers": (0 if self._state is None
                               else self._state.num_brokers),
                "numReplicas": (0 if self._state is None
                                else self._state.num_replicas),
                "hits": self.hits,
                "misses": self.misses,
                "fallbacks": self.fallbacks,
                "deltaApplies": self.delta_applies,
                "invalidations": self.invalidations,
                "quarantines": self.quarantines,
                "lastDirtyBrokers": self.last_dirty_brokers,
                "lastFallbackReason": self.last_fallback_reason,
                "dirtyChainLength": len(self._dirty_log),
            }
