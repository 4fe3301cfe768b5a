"""Scenario compiler (port of cruise_control_tpu/scenario/compiler.py):
K specs and one base model -> K variant models of one padded geometry.

Assembly is host-side numpy, as in the reference: each spec is
materialized into a variant `ClusterState` sharing one padded shape with
every other variant of the batch (scenarios adding hypothetical brokers
pad the broker, rack and host axes to the batch's largest), and each
finished variant is moved to the device once, with its context.  Every
lane of a batch keeps that padded geometry — brokers, racks, hosts and
table slots — so a lane sees exactly the shapes the reference's vmapped
lane sees: the port's float sums follow XLA:CPU's order for each shape
(`ops.sum_f32`, K12, K13), so another padding would change the bits.

Padded broker rows are dead (`broker_alive=False`) with zero capacity
and hold no replicas: every statistic and goal masks on `broker_alive`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.context import (
    BalancingConstraint, OptimizationContext, OptimizationOptions,
    make_context, partition_replica_index)
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES
from cruise_control_tpu_torch.model.state import ClusterState
from cruise_control_tpu_torch.model.topology import ClusterTopology
from cruise_control_tpu_torch.scenario.spec import (RESOURCE_NAMES,
                                                    ScenarioSpec,
                                                    ScenarioSpecError)

#: the dead-row fills of the broker axis (the reference's
#: parallel/mesh.py DEAD_ROW_FILLS)
DEAD_BROKER_FILLS = {"broker_alive": False, "broker_new": False,
                     "broker_demoted": False, "broker_bad_disks": False,
                     "broker_capacity": 0.0, "broker_rack": 0,
                     "broker_host": 0}


@dataclasses.dataclass
class CompiledBatch:
    """K materialized variants of one base model, on the device.

    `states` and `contexts` are lists of per-scenario records with
    identical shapes and static fields; `topologies` carries the
    per-scenario name <-> index maps (added brokers extend them) for the
    host-side proposal diff."""

    specs: List[ScenarioSpec]
    states: List[ClusterState]
    contexts: List[OptimizationContext]
    topologies: List[ClusterTopology]
    num_brokers: int
    #: i32[P, RF] partition -> replica rows: specs change brokers and
    #: loads, never membership, so one table serves every lane's diff
    partition_rows: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 1), np.int32))
    #: every lane shares one base model's membership and placement
    shared_membership: bool = True
    #: per-lane partition -> replica rows when membership differs
    partition_rows_per: Optional[List[np.ndarray]] = None

    def rows_of(self, i: int) -> np.ndarray:
        """Partition -> replica rows for lane i's host diff."""
        if self.partition_rows_per is not None:
            return self.partition_rows_per[i]
        return self.partition_rows

    def with_table_slots(self, slots: int) -> "CompiledBatch":
        """The same batch with every context re-widened to `slots`."""
        return dataclasses.replace(
            self, contexts=[c if c.table_slots == slots
                            else dataclasses.replace(c, table_slots=slots)
                            for c in self.contexts])

    def slice(self, start: int, stop: Optional[int]) -> "CompiledBatch":
        """Sub-batch view of lanes start:stop (the same tensors).  The
        engine's out-of-memory halving does not use it: it frees the
        whole batch and materializes each half again (engine.py)."""
        return CompiledBatch(
            specs=self.specs[start:stop], states=self.states[start:stop],
            contexts=self.contexts[start:stop],
            topologies=self.topologies[start:stop],
            num_brokers=self.num_brokers,
            partition_rows=self.partition_rows,
            shared_membership=self.shared_membership,
            partition_rows_per=(None if self.partition_rows_per is None
                                else self.partition_rows_per[start:stop]))


def _batch_geometry(base_state: ClusterState, topology: ClusterTopology,
                    specs: Sequence[ScenarioSpec]):
    """(broker count, rack index, rack count, host count) of the batch:
    hypothetical brokers may bring new racks, and each gets a host of its
    own."""
    base_b = base_state.num_brokers
    known = set(topology.broker_ids)
    rack_index = {r: i for i, r in enumerate(topology.rack_ids)}
    new_racks: List[str] = []
    max_new = 0
    for spec in specs:
        hypothetical = [a for a in spec.add_brokers
                        if a.broker_id not in known]
        max_new = max(max_new, len(hypothetical))
        for a in hypothetical:
            if (a.rack is not None and a.rack not in rack_index
                    and a.rack not in new_racks):
                new_racks.append(a.rack)
    for i, r in enumerate(new_racks):
        rack_index[r] = len(topology.rack_ids) + i
    return (base_b + max_new, rack_index,
            base_state.num_racks + len(new_racks),
            base_state.num_hosts + max_new)


def _pad_broker_axis(arrays: dict, pad: int) -> dict:
    """Each [B, ...] array grown by `pad` dead rows."""
    out = {}
    for k, v in arrays.items():
        fill = np.full((pad,) + v.shape[1:], DEAD_BROKER_FILLS[k],
                       dtype=v.dtype)
        out[k] = np.concatenate([v, fill], axis=0)
    return out


def materialize(base_state: ClusterState, topology: ClusterTopology,
                spec: ScenarioSpec, num_brokers: int, rack_index: dict,
                num_racks: int, num_hosts: int, device=None
                ) -> Tuple[ClusterState, ClusterTopology,
                           OptimizationOptions]:
    """One variant (state, topology, per-scenario options) at the shared
    padded geometry, assembled in numpy and moved to `device` (default:
    the base state's) once.  Every tensor of the variant is its own."""
    spec.validate(topology)
    dev = base_state.device if device is None else torch.device(device)
    base_b = base_state.num_brokers
    pad = num_brokers - base_b
    broker_index = dict(topology.broker_index)
    broker_ids = list(topology.broker_ids)
    host_names = list(topology.host_names)
    rack_ids = sorted(rack_index, key=rack_index.get)

    def host(name):
        return getattr(base_state, name).cpu().numpy()

    arrays = _pad_broker_axis(
        {k: host(k) for k in DEAD_BROKER_FILLS}, pad)
    arrays = {k: np.array(v) for k, v in arrays.items()}
    alive = arrays["broker_alive"]
    mean_cap = (host("broker_capacity")[alive[:base_b]].mean(axis=0)
                if alive[:base_b].any() else np.zeros(NUM_RESOURCES))

    # additions: known ids are marked new in place (freshly joined),
    # unknown ids take the next padded slot
    next_slot = base_b
    added_ids: List[int] = []
    for add in spec.add_brokers:
        added_ids.append(add.broker_id)
        if add.broker_id in topology.broker_index:
            b = topology.broker_index[add.broker_id]
            if add.capacity:
                for name, v in add.capacity.items():
                    arrays["broker_capacity"][b,
                                              RESOURCE_NAMES.index(name)] = v
        else:
            if next_slot >= num_brokers:
                raise ScenarioSpecError(
                    f"{spec.name}: more hypothetical brokers than the "
                    f"batch geometry allows")
            b = next_slot
            next_slot += 1
            broker_index[add.broker_id] = b
            broker_ids.append(add.broker_id)
            host_names.append(f"scenario-host-{add.broker_id}")
            arrays["broker_alive"][b] = True
            rack = (rack_index[add.rack] if add.rack is not None
                    else b % max(len(topology.rack_ids), 1))
            arrays["broker_rack"][b] = rack
            arrays["broker_host"][b] = base_state.num_hosts + (b - base_b)
            cap = np.asarray(mean_cap, dtype=np.float32).copy()
            if add.capacity:
                for name, v in add.capacity.items():
                    cap[RESOURCE_NAMES.index(name)] = v
            arrays["broker_capacity"][b] = cap
        arrays["broker_new"][b] = True

    replica_offline = np.array(host("replica_offline"))
    original_offline = np.array(host("replica_original_offline"))
    replica_broker = host("replica_broker")
    replica_valid = host("replica_valid")

    for b_ext in spec.remove_brokers:
        b = broker_index[b_ext]
        arrays["broker_alive"][b] = False
        on_broker = (replica_broker == b) & replica_valid
        # removal only ever adds offline flags
        replica_offline |= on_broker
        original_offline |= on_broker
    for b_ext in spec.demote_brokers:
        arrays["broker_demoted"][broker_index[b_ext]] = True
    for b_ext, caps in spec.capacity_overrides.items():
        for name, v in caps.items():
            arrays["broker_capacity"][broker_index[b_ext],
                                      RESOURCE_NAMES.index(name)] = v

    scale = spec.load_scale_vector()
    base_load = host("replica_base_load")
    bonus = host("partition_leader_bonus")
    if spec.load_scale:
        base_load = base_load * scale[None, :]
        bonus = bonus * scale[None, :]

    def t(x, dtype=None):
        x = np.ascontiguousarray(x if dtype is None else x.astype(dtype))
        return torch.from_numpy(np.array(x)).to(dev)

    state = ClusterState(
        replica_valid=t(replica_valid),
        replica_partition=t(host("replica_partition")),
        replica_broker=t(replica_broker),
        replica_disk=t(host("replica_disk")),
        replica_is_leader=t(host("replica_is_leader")),
        replica_offline=t(replica_offline),
        replica_original_offline=t(original_offline),
        replica_base_load=t(base_load, np.float32),
        partition_topic=t(host("partition_topic")),
        partition_leader_bonus=t(bonus, np.float32),
        broker_alive=t(arrays["broker_alive"]),
        broker_new=t(arrays["broker_new"]),
        broker_demoted=t(arrays["broker_demoted"]),
        broker_bad_disks=t(arrays["broker_bad_disks"]),
        broker_capacity=t(arrays["broker_capacity"], np.float32),
        broker_rack=t(arrays["broker_rack"], np.int32),
        broker_host=t(arrays["broker_host"], np.int32),
        disk_broker=t(host("disk_broker")),
        disk_capacity=t(host("disk_capacity")),
        disk_alive=t(host("disk_alive")),
        num_racks=num_racks,
        num_hosts=num_hosts,
        num_topics=base_state.num_topics,
    )
    variant_topo = ClusterTopology(
        broker_ids=broker_ids,
        rack_ids=rack_ids,
        host_names=host_names,
        topics=list(topology.topics),
        partitions=list(topology.partitions),
        disk_names=list(topology.disk_names),
    )
    options = OptimizationOptions(
        requested_destination_broker_ids=(
            frozenset(added_ids) if spec.only_move_to_added
            else frozenset()))
    return state, variant_topo, options


def merged_options(base_options: OptimizationOptions,
                   spec_options: OptimizationOptions
                   ) -> OptimizationOptions:
    """The batch's options with a spec's destination restriction."""
    if spec_options.requested_destination_broker_ids:
        return dataclasses.replace(
            base_options, requested_destination_broker_ids=(
                spec_options.requested_destination_broker_ids))
    return base_options


def compile_batch(base_state: ClusterState, topology: ClusterTopology,
                  specs: Sequence[ScenarioSpec],
                  constraint: Optional[BalancingConstraint] = None,
                  options: Optional[OptimizationOptions] = None,
                  table_slots_override: Optional[int] = None,
                  device=None, geometry=None) -> CompiledBatch:
    """Materialize and build the context of every spec at one shared
    geometry on `device` (default: the base state's).  Contexts differ
    in their planes (dead brokers, destination restrictions) but share
    their static fields: `table_slots` is the batch's largest.
    `geometry` (a `_batch_geometry` of a wider batch) pads the lanes as
    that batch's: the engine's out-of-memory halves keep their batch's
    shapes."""
    constraint = constraint or BalancingConstraint()
    base_options = options or OptimizationOptions()
    if geometry is None:
        geometry = _batch_geometry(base_state, topology, specs)
    num_brokers, rack_index, num_racks, num_hosts = geometry

    states: List[ClusterState] = []
    contexts: List[OptimizationContext] = []
    topologies: List[ClusterTopology] = []
    for spec in specs:
        state, topo, spec_options = materialize(
            base_state, topology, spec, num_brokers, rack_index,
            num_racks, num_hosts, device=device)
        contexts.append(make_context(
            state, constraint, merged_options(base_options, spec_options),
            topo))
        states.append(state)
        topologies.append(topo)

    slots = (table_slots_override if table_slots_override is not None
             else max((c.table_slots for c in contexts), default=0))
    contexts = [c if c.table_slots == slots
                else dataclasses.replace(c, table_slots=slots)
                for c in contexts]
    return CompiledBatch(specs=list(specs), states=states,
                         contexts=contexts, topologies=topologies,
                         num_brokers=num_brokers,
                         partition_rows=partition_replica_index(states[0]))
