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

The store that keeps the resident model between requests and builds the
plans from the monitor's delta records is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch import ops
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES
from cruise_control_tpu_torch.model.state import (ClusterState,
                                                  set_broker_capacities)

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
    """A DeltaPlan of `plan_arrays`' fields on `device`."""
    return DeltaPlan(**{f: torch.from_numpy(np.ascontiguousarray(
        arrays[f])).to(device or "cpu") for f in PLAN_FIELDS})


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
