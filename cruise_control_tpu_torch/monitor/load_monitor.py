"""The monitor's model half (port of the model build and the delta
overlay of cruise_control_tpu/monitor/load_monitor.py).

`LoadMonitor` turns cluster metadata, per-partition expected leader loads
and broker capacities into the tensor model (`cluster_model`), and keeps
the overlay of structured model deltas (`apply_model_delta`) with the
generation chain the device model store fast-forwards through.

Three inputs stand in for the reference's sampling plane, which is not
ported yet, and each moves the model generation where its source does in
the reference:
- a `ClusterSnapshot` for the metadata client: its own `generation` is
  the cluster generation (`update_cluster`);
- a mapping (topic, partition) -> expected leader load, in Resource
  order, for the partition aggregator's windows; each new mapping moves
  the load generation by one and supersedes the load overrides stamped
  with an older one (`update_loads`);
- a mapping broker id -> `BrokerCapacity` for the capacity resolver; like
  a resolver, it moves no generation.
A partition without a load is left out of the model, as a partition
without samples is.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.cluster.types import ClusterSnapshot
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.config.capacity import BrokerCapacity
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.model.builder import (ClusterModelBuilder,
                                                    ClusterTopology,
                                                    estimate_follower_cpu)
from cruise_control_tpu_torch.model.state import (ClusterState,
                                                  set_broker_capacities)
from cruise_control_tpu_torch.monitor.deltas import (DeltaRecord,
                                                     ModelDelta,
                                                     ModelDeltaError,
                                                     capacity_rows,
                                                     chain_between)

LOG = logging.getLogger(__name__)

#: the delta records kept for `deltas_between`, newest last
DELTA_LOG_SIZE = 256


@dataclasses.dataclass(frozen=True, order=True)
class ModelGeneration:
    """(cluster metadata generation, load generation, applied model-delta
    count): the staleness key of the proposal cache and the device model
    store.  A delta changes what `cluster_model()` builds, so it moves the
    generation as a metadata or load change does."""

    cluster_generation: int
    load_generation: int
    delta_generation: int = 0


class LoadMonitor:
    """Metadata, loads and capacities in, the tensor model out (on
    `device`, the card unless "cpu" is asked for).  `cpu_util_weights`
    are the (leader in, leader out, follower in) CPU attribution weights,
    None for the module defaults."""

    def __init__(self, snapshot: ClusterSnapshot,
                 leader_loads: Mapping[Tuple[str, int], object],
                 capacities: Mapping[int, BrokerCapacity],
                 cpu_util_weights: Optional[tuple] = None,
                 device=None) -> None:
        self.device = resolve_device(device)
        self._snapshot = snapshot
        self._loads = self._load_map(leader_loads)
        self._load_generation = 0
        self._capacities = dict(capacities)
        self._cpu_util_weights = cpu_util_weights
        self._delta_lock = threading.Lock()
        self._delta_generation = 0
        self._delta_seq = 0
        self._delta_log: list = []          #: DeltaRecord, oldest first
        self._overlay_new: set = set()      #: broker ids marked new
        self._overlay_removed: set = set()  #: broker ids modeled dead
        self._overlay_demoted: set = set()
        #: broker id -> {resource name: absolute capacity}
        self._overlay_capacity: Dict[int, Dict[str, float]] = {}
        #: (topic, partition) -> (expected leader load f64[RES], load
        #: generation it was applied at)
        self._overlay_loads: Dict[Tuple[str, int], tuple] = {}
        #: host seconds of the last build: the builder's description,
        #: its arrays, the move to the device, the capacity overlay
        self.last_build_seconds: Dict[str, float] = {}
        #: why metric sampling is paused (an execution runs), else None;
        #: the port has no sampler yet, so this is the whole effect
        self.sampling_paused_reason: Optional[str] = None

    @staticmethod
    def _load_map(leader_loads) -> Dict[Tuple[str, int], np.ndarray]:
        return {(str(t), int(p)): np.asarray(v, dtype=np.float64)
                for (t, p), v in leader_loads.items()}

    # ------------------------------------------------------------------
    # the inputs
    # ------------------------------------------------------------------
    def cluster(self) -> ClusterSnapshot:
        return self._snapshot

    def update_cluster(self, snapshot: ClusterSnapshot) -> "ModelGeneration":
        """New metadata; its generation becomes the cluster generation."""
        with self._delta_lock:
            self._snapshot = snapshot
        return self.model_generation()

    def update_loads(self, leader_loads) -> "ModelGeneration":
        """New expected leader loads: the load generation moves by one."""
        loads = self._load_map(leader_loads)
        with self._delta_lock:
            self._loads = loads
            self._load_generation += 1
        return self.model_generation()

    def model_generation(self) -> ModelGeneration:
        return ModelGeneration(self._snapshot.generation,
                               self._load_generation,
                               self._delta_generation)

    # ------------------------------------------------------------------
    # structured deltas
    # ------------------------------------------------------------------
    def apply_model_delta(self, delta) -> ModelGeneration:
        """Check one delta against the current metadata, apply it to the
        overlay (every later `cluster_model()` reflects it) and log it on
        the generation chain; returns the new generation."""
        if not isinstance(delta, ModelDelta):
            raise ModelDeltaError(f"expected a ModelDelta, got "
                                  f"{type(delta).__name__}")
        delta.validate()
        snapshot = self._snapshot
        known = set(snapshot.all_broker_ids)
        topics = {p.tp.topic for p in snapshot.partitions}
        unknown = [b for b in delta.broker_ids_touched() if b not in known]
        if unknown:
            raise ModelDeltaError(
                f"delta names brokers {sorted(unknown)} unknown to the "
                f"cluster metadata (a genuinely new broker is a shape "
                f"change: refresh metadata and rebuild instead)")
        bad_topics = sorted({u.topic for u in delta.load_updates} - topics)
        if bad_topics:
            raise ModelDeltaError(
                f"delta updates loads of unknown topics {bad_topics}")
        with self._delta_lock:
            frm = self.model_generation()
            self._overlay_new.update(a.broker_id for a in delta.add_brokers)
            self._overlay_removed.update(delta.remove_brokers)
            self._overlay_demoted.update(delta.demote_brokers)
            for b, caps in delta.capacity_overrides.items():
                merged = dict(self._overlay_capacity.get(int(b), {}))
                merged.update({k: float(v) for k, v in caps.items()})
                self._overlay_capacity[int(b)] = merged
            for u in delta.load_updates:
                self._overlay_loads[(u.topic, int(u.partition))] = (
                    np.asarray(u.load, dtype=np.float64),
                    self._load_generation)
            self._delta_generation += 1
            self._delta_seq += 1
            # `to` is `frm` with only the delta step: re-reading the live
            # generation could fold an unlogged change into the record
            to = ModelGeneration(frm.cluster_generation,
                                 frm.load_generation,
                                 self._delta_generation)
            self._delta_log.append(DeltaRecord(
                seq=self._delta_seq, from_generation=frm,
                to_generation=to, delta=delta))
            del self._delta_log[:-DELTA_LOG_SIZE]
        LOG.info("model delta applied (%s): generation %s -> %s",
                 delta.describe(), frm, to)
        return to

    def deltas_between(self, from_generation, to_generation):
        """The contiguous DeltaRecord chain between the two generations,
        or None when there is none."""
        with self._delta_lock:
            records = list(self._delta_log)
        return chain_between(records, from_generation, to_generation)

    def clear_model_overlay(self) -> ModelGeneration:
        """Drop every overlay entry; the generation moves, unlogged, so
        the store rebuilds."""
        with self._delta_lock:
            self._overlay_new.clear()
            self._overlay_removed.clear()
            self._overlay_demoted.clear()
            self._overlay_capacity.clear()
            self._overlay_loads.clear()
            self._delta_generation += 1
            return self.model_generation()

    def follower_cpu_estimator(self):
        """The follower-CPU attribution of the next build (the configured
        static weights, else the module defaults); the store splits a
        delta's loads with the same function."""
        if self._cpu_util_weights is not None:
            lw_in, lw_out, fw_in = self._cpu_util_weights
            return (lambda cpu, nw_in, nw_out:
                    estimate_follower_cpu(
                        cpu, nw_in, nw_out,
                        leader_in_weight=lw_in,
                        leader_out_weight=lw_out,
                        follower_in_weight=fw_in))
        return estimate_follower_cpu

    def pause_metric_sampling(self, reason: str) -> None:
        self.sampling_paused_reason = reason

    def resume_metric_sampling(self, reason: str) -> None:
        LOG.debug("metric sampling resumed: %s", reason)
        self.sampling_paused_reason = None

    # ------------------------------------------------------------------
    # model building
    # ------------------------------------------------------------------
    def _capacity_for(self, broker_id: int,
                      allow_estimation: bool) -> BrokerCapacity:
        if broker_id not in self._capacities:
            raise KeyError(f"no capacity given for broker {broker_id}")
        cap = self._capacities[broker_id]
        if cap.is_estimated and not allow_estimation:
            raise KeyError(f"the capacity of broker {broker_id} is "
                           f"estimated and estimation is not allowed")
        return cap

    def cluster_model(self, allow_capacity_estimation: bool = True
                      ) -> Tuple[ClusterState, ClusterTopology]:
        """(ClusterState on the monitor's device, ClusterTopology): the
        current metadata, loads and capacities with the delta overlay."""
        t0 = time.perf_counter()
        follower_cpu = self.follower_cpu_estimator()
        builder = ClusterModelBuilder(follower_cpu_estimator=follower_cpu)
        with self._delta_lock:
            snapshot = self._snapshot
            loads = self._loads
            load_gen_now = self._load_generation
            self._overlay_loads = {
                k: vs for k, vs in self._overlay_loads.items()
                if vs[1] == load_gen_now}
            ov_new = set(self._overlay_new)
            ov_removed = set(self._overlay_removed)
            ov_demoted = set(self._overlay_demoted)
            ov_capacity = {b: dict(c)
                           for b, c in self._overlay_capacity.items()}
            ov_loads = {k: vs[0] for k, vs in self._overlay_loads.items()}
        jbod_dirs: Dict[int, frozenset] = {}
        for binfo in snapshot.brokers:
            cap = self._capacity_for(binfo.broker_id,
                                     allow_capacity_estimation)
            disks = None
            if cap.disk_capacity_by_logdir:
                disks = dict(cap.disk_capacity_by_logdir)
                # a dead broker reports no logdirs
                if binfo.alive:
                    for ld in binfo.logdirs:
                        if ld.offline and ld.path in disks:
                            disks[ld.path] = 0.0
                jbod_dirs[binfo.broker_id] = frozenset(disks)
            builder.add_broker(
                binfo.broker_id, rack_id=binfo.rack or binfo.host,
                capacity=cap.capacity, host=binfo.host,
                alive=binfo.alive and binfo.broker_id not in ov_removed,
                new=binfo.broker_id in ov_new,
                demoted=binfo.broker_id in ov_demoted,
                disks=disks)
        n_skipped = 0
        for pinfo in snapshot.partitions:
            key = (pinfo.tp.topic, pinfo.tp.partition)
            sample = loads.get(key)
            if sample is None:
                n_skipped += 1
                continue
            override = ov_loads.get(key)
            leader_load = override if override is not None else sample
            offline = set(pinfo.offline_replicas)
            for broker_id in pinfo.replicas:
                is_leader = broker_id == pinfo.leader
                if is_leader:
                    load = leader_load
                else:
                    load = leader_load.copy()
                    load[Resource.NW_OUT] = 0.0
                    load[Resource.CPU] = follower_cpu(
                        leader_load[Resource.CPU],
                        leader_load[Resource.NW_IN],
                        leader_load[Resource.NW_OUT])
                logdir = pinfo.logdir_by_broker.get(broker_id)
                has_jbod = (logdir is not None
                            and logdir in jbod_dirs.get(broker_id, ()))
                builder.add_replica(
                    pinfo.tp.topic, pinfo.tp.partition, broker_id,
                    is_leader, load, offline=broker_id in offline,
                    logdir=logdir if has_jbod else None)
        t1 = time.perf_counter()
        fields, sizes, topology = builder.build_arrays()
        t2 = time.perf_counter()
        state = ClusterState(
            **{k: torch.from_numpy(v).to(self.device)
               for k, v in fields.items()}, **sizes)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t3 = time.perf_counter()
        if ov_capacity:
            state = _apply_capacity_overlay(state, topology, ov_capacity)
        self.last_build_seconds = {
            "describe": t1 - t0, "arrays": t2 - t1, "to_device": t3 - t2,
            "overlay": time.perf_counter() - t3}
        LOG.debug("generated cluster model in %.0f ms (B=%d P=%d R=%d, "
                  "%d partitions without loads)",
                  (time.perf_counter() - t0) * 1e3, state.num_brokers,
                  state.num_partitions, state.num_replicas, n_skipped)
        return state, topology


def _apply_capacity_overlay(state: ClusterState, topology,
                            capacity_overrides) -> ClusterState:
    """The capacity overrides applied to a built state with the ops the
    store's delta application uses (`capacity_rows`, then
    `set_broker_capacities`), so a rebuild and a fast-forward agree."""
    rows, mask, values = capacity_rows(capacity_overrides,
                                       topology.broker_index)
    if rows.size == 0:
        return state
    return set_broker_capacities(state, rows, mask, values)
