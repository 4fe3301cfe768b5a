"""The load monitor: metric samples in, the tensor cluster model out (port
of cruise_control_tpu/monitor/load_monitor.py).

`LoadMonitor` is the reference's monitor plane (Cruise Control's
LoadMonitor.java): it owns the metadata client, the capacity resolver,
the partition and broker aggregators, the metric fetchers and the
sampling task runner.  `cluster_model(...)` refreshes the metadata,
aggregates the partition samples under a completeness requirement,
resolves each broker's capacity (a dead logdir's set to 0), derives each
replica's load from its partition's windows and builds the model, whose
arrays go to `device` (the card unless "cpu" is asked for).  Its load
generation is the partition aggregator's generation.

`SnapshotLoadMonitor` builds the same model from inputs the caller hands
it in place of the sampling plane: a `ClusterSnapshot` for the metadata
client (its `generation` is the cluster generation, `update_cluster`), a
mapping (topic, partition) -> expected leader load in Resource order for
the aggregated windows (each new mapping moves the load generation by
one, `update_loads`) and a mapping broker id -> `BrokerCapacity` for the
resolver.  A partition without a load is left out of the model, as a
partition without samples is.

Both keep the overlay of structured model deltas (`apply_model_delta`)
with the generation chain the device model store fast-forwards through,
and build through the same code (`_ModelOverlay`), so a rebuild and a
fast-forward agree bit for bit in either.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.cluster.admin import ClusterAdminClient
from cruise_control_tpu_torch.cluster.metadata import MetadataClient
from cruise_control_tpu_torch.cluster.types import ClusterSnapshot
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.config.capacity import (
    BrokerCapacity, BrokerCapacityConfigResolver, StaticCapacityResolver)
from cruise_control_tpu_torch.core.aggregator import (
    NotEnoughValidWindowsError, ValuesAndExtrapolations)
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.model.builder import (ClusterModelBuilder,
                                                    ClusterTopology,
                                                    estimate_follower_cpu)
from cruise_control_tpu_torch.model.cpu_model import LinearRegressionCpuModel
from cruise_control_tpu_torch.model.state import (ClusterState,
                                                  set_broker_capacities)
from cruise_control_tpu_torch.monitor import metricdef as MD
from cruise_control_tpu_torch.monitor.aggregators import (
    BrokerMetricSampleAggregator, PartitionMetricSampleAggregator)
from cruise_control_tpu_torch.monitor.completeness import \
    ModelCompletenessRequirements
from cruise_control_tpu_torch.monitor.deltas import (DeltaRecord,
                                                     ModelDelta,
                                                     ModelDeltaError,
                                                     capacity_rows,
                                                     chain_between)
from cruise_control_tpu_torch.monitor.entities import PartitionEntity
from cruise_control_tpu_torch.monitor.sampling.fetcher import \
    MetricFetcherManager
from cruise_control_tpu_torch.monitor.sampling.sample_store import (
    SampleLoader, SampleStore)
from cruise_control_tpu_torch.monitor.sampling.sampler import (MetricSampler,
                                                               Samples)
from cruise_control_tpu_torch.monitor.task_runner import LoadMonitorTaskRunner

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

    def is_stale(self, other: "ModelGeneration") -> bool:
        return (self.cluster_generation < other.cluster_generation
                or self.load_generation < other.load_generation
                or self.delta_generation < other.delta_generation)


@dataclasses.dataclass
class LoadMonitorState:
    """What the monitor reports of itself (Cruise Control's
    LoadMonitorState.java)."""

    state: str
    num_valid_windows: int
    total_num_windows: int
    monitored_partitions_percentage: float
    num_monitored_partitions: int
    num_total_partitions: int
    reason_of_pause: Optional[str] = None
    last_sampling_ms: float = 0.0


class ModelBuildPermit:
    """Context manager around the model-build semaphore."""

    def __init__(self, semaphore: threading.BoundedSemaphore):
        self._semaphore = semaphore

    def __enter__(self) -> "ModelBuildPermit":
        self._semaphore.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._semaphore.release()


class _ModelOverlay:
    """The structured-delta overlay, its generation chain and the model
    build, shared by `LoadMonitor` and `SnapshotLoadMonitor`.  A subclass
    supplies `model_generation`, `_delta_snapshot` (the metadata a delta
    is checked against), `_current_load_generation` (the stamp of a load
    override) and `_follower_cpu_coefficients`."""

    def _init_overlay(self, device, cpu_util_weights: Optional[tuple],
                      delta_log_size: int = DELTA_LOG_SIZE,
                      max_concurrent_model_builds: int = 2) -> None:
        self.device = resolve_device(device)
        #: static CPU attribution weights (leader in, leader out, follower
        #: in); None for the module defaults
        self._cpu_util_weights = cpu_util_weights
        self._model_semaphore = threading.BoundedSemaphore(
            max_concurrent_model_builds)
        self._delta_lock = threading.Lock()
        self._delta_generation = 0
        self._delta_seq = 0
        self._delta_log: list = []          #: DeltaRecord, oldest first
        self._delta_log_size = max(1, delta_log_size)
        self._overlay_new: set = set()      #: broker ids marked new
        self._overlay_removed: set = set()  #: broker ids modeled dead
        self._overlay_demoted: set = set()
        #: broker id -> {resource name: absolute capacity}
        self._overlay_capacity: Dict[int, Dict[str, float]] = {}
        #: (topic, partition) -> (expected leader load f64[RES], load
        #: generation it was applied at); superseded, and dropped, once
        #: the load generation moves past its stamp
        self._overlay_loads: Dict[Tuple[str, int], tuple] = {}
        #: host seconds of the last build: the builder's description loop,
        #: its arrays, the move to the device, the capacity overlay (and
        #: for a sampled model the aggregation before them)
        self.last_build_seconds: Dict[str, float] = {}

    def acquire_for_model_generation(self) -> ModelBuildPermit:
        """Bounded concurrency on model builds (Cruise Control's
        acquireForModelGeneration)."""
        return ModelBuildPermit(self._model_semaphore)

    # ------------------------------------------------------------------
    # structured deltas
    # ------------------------------------------------------------------
    def apply_model_delta(self, delta) -> ModelGeneration:
        """Check one delta against the current metadata, apply it to the
        overlay (every later `cluster_model()` reflects it) and log it on
        the generation chain; returns the new generation.  The metadata
        is read first, so a pending unlogged change moves the generation
        before the delta's `from_generation` is taken: the chain breaks at
        the unlogged change, never across it."""
        if not isinstance(delta, ModelDelta):
            raise ModelDeltaError(f"expected a ModelDelta, got "
                                  f"{type(delta).__name__}")
        delta.validate()
        snapshot = self._delta_snapshot()
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
            load_gen = self._current_load_generation()
            for u in delta.load_updates:
                self._overlay_loads[(u.topic, int(u.partition))] = (
                    np.asarray(u.load, dtype=np.float64), load_gen)
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
            del self._delta_log[:-self._delta_log_size]
        LOG.info("model delta applied (%s): generation %s -> %s",
                 delta.describe(), frm, to)
        return to

    def deltas_between(self, from_generation, to_generation):
        """The contiguous DeltaRecord chain between the two generations,
        or None when there is none (an unlogged change, a trimmed log)."""
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

    def _follower_cpu_coefficients(self):
        return None

    def follower_cpu_estimator(self):
        """The follower-CPU attribution of the next build: the trained
        regression (clamped to [0, leader CPU]) once training ran, else
        the configured static weights, else the module defaults.  The
        store splits a delta's loads with the same function."""
        coefs = self._follower_cpu_coefficients()
        if coefs is not None:
            return (lambda cpu, nw_in, nw_out:
                    min(max(coefs.estimate_follower_cpu(nw_in), 0.0),
                        float(cpu)))
        if self._cpu_util_weights is not None:
            lw_in, lw_out, fw_in = self._cpu_util_weights
            return (lambda cpu, nw_in, nw_out:
                    estimate_follower_cpu(
                        cpu, nw_in, nw_out,
                        leader_in_weight=lw_in,
                        leader_out_weight=lw_out,
                        follower_in_weight=fw_in))
        return estimate_follower_cpu

    # ------------------------------------------------------------------
    # the build
    # ------------------------------------------------------------------
    def _overlay_for_build(self, load_gen_now: int):
        """A consistent copy of the overlay for one build; the load
        overrides stamped with an older load generation are pruned."""
        with self._delta_lock:
            self._overlay_loads = {
                k: vs for k, vs in self._overlay_loads.items()
                if vs[1] == load_gen_now}
            return (set(self._overlay_new), set(self._overlay_removed),
                    set(self._overlay_demoted),
                    {b: dict(c) for b, c in self._overlay_capacity.items()},
                    {k: vs[0] for k, vs in self._overlay_loads.items()})

    def _build(self, snapshot: ClusterSnapshot, overlay,
               capacity_of: Callable, logdirs_of: Callable,
               leader_load_of: Callable, t0: float,
               seconds: Optional[Dict[str, float]] = None
               ) -> Tuple[ClusterState, ClusterTopology]:
        """(ClusterState on the monitor's device, ClusterTopology) of
        `snapshot` with the overlay: `capacity_of(broker info)` is its
        `BrokerCapacity`, `logdirs_of(broker info)` its logdirs as the
        admin client describes them (an offline one is given 0 capacity),
        `leader_load_of(partition info)` its expected leader load (a load
        override replaces it), or None to leave the partition out.  `t0`
        is when the build began; `seconds` holds earlier parts of its
        split."""
        ov_new, ov_removed, ov_demoted, ov_capacity, ov_loads = overlay
        follower_cpu = self.follower_cpu_estimator()
        builder = ClusterModelBuilder(follower_cpu_estimator=follower_cpu)
        t_loop = time.perf_counter()
        jbod_dirs: Dict[int, frozenset] = {}
        for binfo in snapshot.brokers:
            cap = capacity_of(binfo)
            disks = None
            if cap.disk_capacity_by_logdir:
                disks = dict(cap.disk_capacity_by_logdir)
                for ld in logdirs_of(binfo):
                    if ld.offline and ld.path in disks:
                        disks[ld.path] = 0.0   # dead logdir
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
            leader_load = leader_load_of(pinfo)
            if leader_load is None:
                n_skipped += 1
                continue
            override = ov_loads.get((pinfo.tp.topic, pinfo.tp.partition))
            if override is not None:
                leader_load = override
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
        self.last_build_seconds = dict(
            seconds or {}, describe=t1 - t_loop, arrays=t2 - t1,
            to_device=t3 - t2, overlay=time.perf_counter() - t3)
        LOG.debug("generated cluster model in %.0f ms (B=%d P=%d R=%d, "
                  "%d partitions left out)",
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


# ---------------------------------------------------------------------------
# the sampled monitor
# ---------------------------------------------------------------------------
class _LoaderShim(SampleLoader):
    def __init__(self, monitor: "LoadMonitor"):
        self._monitor = monitor

    def load_samples(self, samples: Samples) -> None:
        self._monitor._partition_aggregator.add_partition_samples(
            samples.partition_samples)
        self._monitor._broker_aggregator.add_broker_samples(
            samples.broker_samples)


class LoadMonitor(_ModelOverlay):
    """The monitor plane over the cluster's `admin` client and a metric
    `sampler`, with the reference's settings and defaults; the model's
    arrays go to `device` (the card unless "cpu" is asked for)."""

    def __init__(self, admin: ClusterAdminClient,
                 sampler: MetricSampler,
                 capacity_resolver: Optional[
                     BrokerCapacityConfigResolver] = None,
                 sample_store: Optional[SampleStore] = None,
                 num_windows: int = 5,
                 window_ms: float = 3_600_000,
                 min_samples_per_window: int = 3,
                 broker_num_windows: int = 20,
                 broker_window_ms: Optional[float] = None,
                 broker_min_samples_per_window: int = 1,
                 sampling_interval_ms: float = 120_000,
                 num_fetchers: int = 1,
                 metadata_ttl_ms: float = 5_000,
                 max_concurrent_model_builds: int = 2,
                 max_allowed_extrapolations_per_partition: int = 5,
                 max_allowed_extrapolations_per_broker: int = 5,
                 allow_cpu_capacity_estimation: bool = True,
                 state_update_interval_ms: float = 0.0,
                 completeness_cache_size: int = 5,
                 broker_completeness_cache_size: int = 5,
                 min_valid_partition_ratio: float = 0.0,
                 partition_assignor=None,
                 use_linear_regression_model: bool = True,
                 linear_regression_kwargs: Optional[dict] = None,
                 cpu_util_weights: Optional[tuple] = None,
                 delta_log_size: int = DELTA_LOG_SIZE,
                 time_fn: Callable[[], float] = time.time,
                 device=None):
        self._init_overlay(device, cpu_util_weights, delta_log_size,
                           max_concurrent_model_builds)
        self._admin = admin
        self._metadata = MetadataClient(admin, metadata_ttl_ms, time_fn)
        self._capacity_resolver = (capacity_resolver
                                   or StaticCapacityResolver())
        self._sample_store = sample_store
        self._time_fn = time_fn
        self._partition_aggregator = PartitionMetricSampleAggregator(
            num_windows, int(window_ms), min_samples_per_window,
            completeness_cache_size=completeness_cache_size)
        self._broker_aggregator = BrokerMetricSampleAggregator(
            broker_num_windows, int(broker_window_ms or window_ms),
            broker_min_samples_per_window,
            completeness_cache_size=broker_completeness_cache_size)
        #: the monitored-partition completeness of a request that names
        #: none (min.valid.partition.ratio)
        self._min_valid_partition_ratio = min_valid_partition_ratio
        self._max_extrapolations_partition = \
            max_allowed_extrapolations_per_partition
        self._max_extrapolations_broker = \
            max_allowed_extrapolations_per_broker
        self._allow_cpu_capacity_estimation = allow_cpu_capacity_estimation
        #: get_state()'s cache TTL (monitor.state.update.interval.ms)
        self._state_ttl_s = state_update_interval_ms / 1e3
        self._state_cache = None
        self._state_cache_at = -1e18
        self._fetcher = MetricFetcherManager(
            sampler, self._partition_aggregator, self._broker_aggregator,
            sample_store, num_fetchers,
            partition_assignor=partition_assignor)
        self.task_runner = LoadMonitorTaskRunner(
            self._metadata, self._fetcher, sampling_interval_ms, time_fn)
        cdef = MD.common_metric_def()
        self._cpu_id = cdef.metric_id(MD.CPU_USAGE)
        self._nw_in_id = cdef.metric_id(MD.LEADER_BYTES_IN)
        self._nw_out_id = cdef.metric_id(MD.LEADER_BYTES_OUT)
        self._disk_id = cdef.metric_id(MD.DISK_USAGE)
        #: the trainable CPU attribution model
        self.cpu_model = LinearRegressionCpuModel(
            **(linear_regression_kwargs or {}))
        #: use.linear.regression.model: when False a trained model is
        #: kept but the build sticks to the static coefficients
        self._use_linear_regression = use_linear_regression_model

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start_up(self, do_sampling: bool = True,
                 skip_loading_samples: bool = False) -> None:
        """Reload the stored samples, then start the sampling loop (a
        thread, unless `do_sampling` is False: then rounds run only
        through `task_runner.sample_once()`)."""
        if self._sample_store is not None and not skip_loading_samples:
            self.task_runner.set_loading(True)
            try:
                self._sample_store.load_samples(_LoaderShim(self))
            finally:
                self.task_runner.set_loading(False)
        self.task_runner.start(do_sampling)

    def shutdown(self) -> None:
        """Stop the sampling thread and the fetcher pool, close the
        store."""
        self.task_runner.shutdown()
        self._fetcher.shutdown()
        if self._sample_store is not None:
            self._sample_store.close()

    # ------------------------------------------------------------------
    # accessors
    # ------------------------------------------------------------------
    @property
    def num_quarantined_samples(self) -> int:
        """Samples dropped by the ingest quarantine (NaN, Inf or negative
        values)."""
        return self._fetcher.num_quarantined_samples

    @property
    def metadata(self) -> MetadataClient:
        return self._metadata

    @property
    def partition_aggregator(self) -> PartitionMetricSampleAggregator:
        return self._partition_aggregator

    @property
    def broker_aggregator(self) -> BrokerMetricSampleAggregator:
        return self._broker_aggregator

    def model_generation(self) -> ModelGeneration:
        return ModelGeneration(self._metadata.cluster_generation,
                               self._partition_aggregator.generation,
                               self._delta_generation)

    def _delta_snapshot(self) -> ClusterSnapshot:
        return self._metadata.refresh_metadata()

    def _current_load_generation(self) -> int:
        return self._partition_aggregator.generation

    def pause_metric_sampling(self, reason: str) -> None:
        self.task_runner.pause_sampling(reason)

    def resume_metric_sampling(self, reason: str) -> None:
        self.task_runner.resume_sampling(reason)

    # ------------------------------------------------------------------
    # completeness
    # ------------------------------------------------------------------
    def meet_completeness_requirements(
            self, req: ModelCompletenessRequirements) -> bool:
        try:
            result = self._partition_aggregator.aggregate_with_requirements(
                self._time_fn() * 1000.0, req)
        except NotEnoughValidWindowsError:
            return False
        comp = result.completeness
        return (len(comp.valid_window_indices) >= req.min_required_num_windows
                and comp.valid_entity_ratio
                >= req.min_monitored_partitions_percentage)

    def get_state(self) -> LoadMonitorState:
        with self._delta_lock:
            cached, cached_at = self._state_cache, self._state_cache_at
        if (cached is not None
                and self._time_fn() - cached_at < self._state_ttl_s):
            return cached
        snapshot = self._metadata.cluster()
        total = len(snapshot.partitions)
        try:
            result = self._partition_aggregator.aggregate_with_requirements(
                self._time_fn() * 1000.0, ModelCompletenessRequirements())
            valid_windows = len(result.completeness.valid_window_indices)
            ratio = result.completeness.valid_entity_ratio
            monitored = len(result.entity_values)
        except NotEnoughValidWindowsError:
            valid_windows, ratio, monitored = 0, 0.0, 0
        state_out = LoadMonitorState(
            state=self.task_runner.state.value,
            num_valid_windows=valid_windows,
            total_num_windows=self._partition_aggregator.num_windows,
            monitored_partitions_percentage=ratio,
            num_monitored_partitions=monitored,
            num_total_partitions=total,
            reason_of_pause=self.task_runner.reason_of_pause,
            last_sampling_ms=self._fetcher.last_sampling_ms)
        # cache and timestamp published together
        with self._delta_lock:
            self._state_cache = state_out
            self._state_cache_at = self._time_fn()
        return state_out

    # ------------------------------------------------------------------
    # CPU model training
    # ------------------------------------------------------------------
    def train(self) -> None:
        """Fit the linear CPU model from the broker metric history: each
        (broker, window) cell is one training row of (cpu, leader bytes
        in, leader bytes out, replication bytes in).  With the regression
        in use, the follower-CPU attribution changes, so the model
        generation moves, unlogged: the store rebuilds rather than
        fast-forwards."""
        bdef = MD.broker_metric_def()
        cpu = bdef.metric_id(MD.CPU_USAGE)
        lin = bdef.metric_id(MD.LEADER_BYTES_IN)
        lout = bdef.metric_id(MD.LEADER_BYTES_OUT)
        rin = bdef.metric_id(MD.REPLICATION_BYTES_IN_RATE)
        result = self._broker_aggregator.aggregate(-np.inf, np.inf)
        # each training round feeds the full current history
        self.cpu_model.clear_samples()
        for vae in result.entity_values.values():
            vals = vae.values
            for w in range(vals.shape[0]):
                self.cpu_model.add_sample(
                    float(vals[w, cpu]), float(vals[w, lin]),
                    float(vals[w, lout]), float(vals[w, rin]))
        self.cpu_model.train()
        if self._use_linear_regression:
            with self._delta_lock:
                self._delta_generation += 1

    # ------------------------------------------------------------------
    # model building
    # ------------------------------------------------------------------
    def _follower_cpu_coefficients(self):
        return (self.cpu_model.coefficients
                if self._use_linear_regression else None)

    def _expected_utilization(self, vae: ValuesAndExtrapolations
                              ) -> np.ndarray:
        """Windows collapsed to one load vector: the mean for CPU and
        network, the latest window for DISK (rows oldest first).  The
        means are numpy's over float32 rows, as in the JAX package."""
        values = vae.values
        out = np.zeros(NUM_RESOURCES, dtype=np.float64)
        out[Resource.CPU] = values[:, self._cpu_id].mean()
        out[Resource.NW_IN] = values[:, self._nw_in_id].mean()
        out[Resource.NW_OUT] = values[:, self._nw_out_id].mean()
        out[Resource.DISK] = values[-1, self._disk_id]
        return out

    def cluster_model(self,
                      requirements: Optional[
                          ModelCompletenessRequirements] = None,
                      allow_capacity_estimation: bool = True,
                      now_ms: Optional[float] = None
                      ) -> Tuple[ClusterState, ClusterTopology]:
        """(ClusterState on the monitor's device, ClusterTopology) from
        the refreshed metadata, the partition windows aggregated under
        `requirements` (default: the configured monitored-partition
        ratio, one window), the resolved capacities and the delta
        overlay; NotEnoughValidWindowsError when the windows fall short."""
        req = requirements or ModelCompletenessRequirements(
            min_monitored_partitions_percentage=(
                self._min_valid_partition_ratio))
        now_ms = now_ms if now_ms is not None else self._time_fn() * 1000.0
        t0 = time.perf_counter()
        snapshot = self._metadata.refresh_metadata()
        result = self._partition_aggregator.aggregate_with_requirements(
            now_ms, req,
            max_allowed_extrapolations=self._max_extrapolations_partition)
        comp = result.completeness
        if (len(comp.valid_window_indices) < req.min_required_num_windows
                or comp.valid_entity_ratio
                < req.min_monitored_partitions_percentage):
            raise NotEnoughValidWindowsError(
                f"completeness not met: {len(comp.valid_window_indices)} "
                f"valid windows, {comp.valid_entity_ratio:.1%} monitored "
                f"partitions (need {req.min_required_num_windows} / "
                f"{req.min_monitored_partitions_percentage:.1%})")
        t1 = time.perf_counter()
        overlay = self._overlay_for_build(
            self._partition_aggregator.generation)
        logdirs_by_broker = self._admin.describe_log_dirs(
            sorted(snapshot.all_broker_ids))
        allow = (allow_capacity_estimation
                 and self._allow_cpu_capacity_estimation)
        values = result.entity_values

        def leader_load_of(pinfo):
            vae = values.get(PartitionEntity(pinfo.tp.topic,
                                             pinfo.tp.partition))
            return None if vae is None else self._expected_utilization(vae)

        return self._build(
            snapshot, overlay,
            lambda b: self._capacity_resolver.capacity_for_broker(
                b.rack, b.host, b.broker_id, allow),
            lambda b: logdirs_by_broker.get(b.broker_id, []),
            leader_load_of, t0, seconds={"aggregate": t1 - t0})


# ---------------------------------------------------------------------------
# the snapshot-fed monitor
# ---------------------------------------------------------------------------
class SnapshotLoadMonitor(_ModelOverlay):
    """Metadata, loads and capacities handed in, the tensor model out (on
    `device`, the card unless "cpu" is asked for).  `cpu_util_weights`
    are the (leader in, leader out, follower in) CPU attribution weights,
    None for the module defaults."""

    def __init__(self, snapshot: ClusterSnapshot,
                 leader_loads: Mapping[Tuple[str, int], object],
                 capacities: Mapping[int, BrokerCapacity],
                 cpu_util_weights: Optional[tuple] = None,
                 device=None) -> None:
        self._init_overlay(device, cpu_util_weights)
        self._snapshot = snapshot
        self._loads = self._load_map(leader_loads)
        self._load_generation = 0
        self._capacities = dict(capacities)
        #: why metric sampling is paused (an execution runs), else None;
        #: this monitor samples nothing, so that is the whole effect
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

    def update_cluster(self, snapshot: ClusterSnapshot) -> ModelGeneration:
        """New metadata; its generation becomes the cluster generation."""
        with self._delta_lock:
            self._snapshot = snapshot
        return self.model_generation()

    def update_loads(self, leader_loads) -> ModelGeneration:
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

    def _delta_snapshot(self) -> ClusterSnapshot:
        return self._snapshot

    def _current_load_generation(self) -> int:
        return self._load_generation

    def start_up(self, do_sampling: bool = True,
                 skip_loading_samples: bool = False) -> None:
        """Nothing to start: this monitor samples nothing."""

    def shutdown(self) -> None:
        """Nothing to stop."""

    def pause_metric_sampling(self, reason: str) -> None:
        self.sampling_paused_reason = reason

    def resume_metric_sampling(self, reason: str) -> None:
        LOG.debug("metric sampling resumed: %s", reason)
        self.sampling_paused_reason = None

    def get_state(self) -> LoadMonitorState:
        """The handed-in loads are one complete window over every
        partition: a model can always be built."""
        total = len(self._snapshot.partitions)
        paused = self.sampling_paused_reason
        return LoadMonitorState(
            state="PAUSED" if paused is not None else "RUNNING",
            num_valid_windows=1, total_num_windows=1,
            monitored_partitions_percentage=1.0,
            num_monitored_partitions=total, num_total_partitions=total,
            reason_of_pause=paused)

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

    def cluster_model(self, requirements: Optional[
            ModelCompletenessRequirements] = None,
            allow_capacity_estimation: bool = True
            ) -> Tuple[ClusterState, ClusterTopology]:
        """(ClusterState on the monitor's device, ClusterTopology): the
        current metadata, loads and capacities with the delta overlay.
        The loads stand for windows that already met their completeness,
        so `requirements` asks nothing more of them."""
        t0 = time.perf_counter()
        with self._delta_lock:
            snapshot = self._snapshot
            loads = self._loads
            load_gen_now = self._load_generation
        overlay = self._overlay_for_build(load_gen_now)
        # a dead broker reports no logdirs
        return self._build(
            snapshot, overlay,
            lambda b: self._capacity_for(b.broker_id,
                                         allow_capacity_estimation),
            lambda b: b.logdirs if b.alive else (),
            lambda p: loads.get((p.tp.topic, p.tp.partition)), t0)
